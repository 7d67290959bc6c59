"""Render pipeline and its factory."""
