"""Step timing and profiling helpers."""
