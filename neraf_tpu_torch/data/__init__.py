"""Data: camera arrays and ray generation."""
