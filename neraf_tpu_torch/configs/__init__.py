"""Experiment configuration."""
