"""Per-layer metrics, one reader each: ``read(view)`` returns the number,
or None where the run holds nothing for it to read (the harness then
leaves the metric out of the line)."""
