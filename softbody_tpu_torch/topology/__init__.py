"""Static rest-space topology: neighbours and the sparse slot layout (numpy)."""
