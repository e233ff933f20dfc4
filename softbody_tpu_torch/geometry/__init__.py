"""Procedural bodies (numpy)."""
