"""Host-side utilities: checkpoint / resume, the Eigen binary formats and
folder helpers, the host allocator, profiling."""
