"""Shared parts of the harness: the cell's files by name, seeded weights and
frames, the device readings, the profiler trace and the comparison."""
