"""One reader a metric, `metrics/<name>.py`, found by the metric's name in
`BENCHMARK.json`: `read(run)` takes a `harness.Run` and returns the number,
or None where the run holds nothing to read (the metric is then left out of
the result line)."""
