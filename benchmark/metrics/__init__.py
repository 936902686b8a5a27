"""Per-layer metric readers: metrics/<metric name>.py holds read(reading),
which returns the metric's value or None when the run gave it nothing to
read.  `reading` is the dict the harness fills (see harness.run_cell)."""
