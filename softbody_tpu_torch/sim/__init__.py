"""Scene build, elastic forces and the episode runner."""
