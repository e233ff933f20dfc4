"""Inverse-design driver pieces: target generation."""
