"""Seconds from the process's start to the first timed proof: CUDA's
start, the kernel libraries, the circuit, preprocessing or key generation,
the witness pool and the warm-up proof (host clock, device drained)."""


def read(run):
    return run.setup_s
