"""One service a proof system, found by the configuration's `system` name:
`zkbench/systems/<system>.py` holds `Service` (set-up and "make one proof",
on the program) and `judge` (the sampled proofs against the reference)."""
