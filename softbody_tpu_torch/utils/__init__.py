"""Host-side utilities (checkpoint / resume)."""
