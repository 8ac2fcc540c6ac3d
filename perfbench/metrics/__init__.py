"""Per-layer metrics: one reader a metric, `read(rec)` of a
`trace.Record`, which returns the value, or None where the run has
nothing to read."""
