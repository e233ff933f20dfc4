"""Procedural bodies, multi-body composition and asset IO (numpy)."""
