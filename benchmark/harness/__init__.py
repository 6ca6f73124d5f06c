"""The benchmark's general code: the cell's files found by name, the
frame generator, the closed-loop window, the reading of the traced run,
the counts and the table of peaks.  Nothing here belongs to one
configuration, traffic mix or per-layer metric: those are files of
their own under `configs/`, `traffic/`, `metrics/` and `reference/`."""
