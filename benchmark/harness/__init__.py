"""The general machinery of the benchmark: finding a cell's files by name,
drawing weights and traffic from the seed, the closed loop, the spans and
the device trace, the end-to-end metrics and the comparison that decides
``correct``."""
