"""The traced part of a `--trace 1` run: a few steady proofs under
`torch.profiler`, reduced to what the per-layer readers take.

- every operation that ran on the device (kernels, copies, fills), as
  intervals: their union over the profiled wall time is `busy_s`;
- the kernels by name, with their launches and device seconds;
- the phases of each profiled proof (the program's `PhaseClock`, or the
  phase seconds the prover records), laid from the proof's start, and the
  device's idle time inside each phase.

The device intervals come from the profiler's own events
(`kineto_results`), on the profiler's clock; nothing is written to disk.
"""
from __future__ import annotations

import dataclasses
import time

_START = "zkbench.proof_start"


@dataclasses.dataclass
class Trace:
    proofs: int
    window_s: float
    busy_s: float
    launches: int
    kernels: dict            # name -> [launches, device seconds]
    phase_seconds: list      # per proof: [(phase, seconds)] in order
    idle_by_phase: dict      # phase -> idle seconds, summed over the proofs


def _device_events(prof) -> tuple[list, list]:
    """([(name, start_s, end_s)] of the device's operations, [start_s] of
    each proof's start marker), both on the profiler's clock."""
    ops, starts = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        on_card = "cuda" in str(e.device_type()).lower()
        if name == _START:
            if not on_card:
                starts.append(t0)
        elif on_card:
            ops.append((name, t0, t0 + dur))
    return ops, starts


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_proofs(service, n: int, clock_factory) -> Trace:
    """Profile `n` proofs of `service` (requests -2, -3, ...: steady, never
    judged), each with a fresh clock from `clock_factory()`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    phases = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            with record_function(_START):
                pass
            clock = clock_factory()
            service.prove(-2 - i, clock)
            phases.append(service.phases())
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ops, starts = _device_events(prof)
    if not starts:
        raise RuntimeError("the profiler recorded no proof start")
    lo = starts[0]
    busy = _merge([(a, b) for _, a, b in ops])
    kernels: dict = {}
    for name, a, b in ops:
        if _is_kernel(name):
            row = kernels.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += b - a
    # idle intervals inside the profiled window, attributed to phases
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    idle: dict = {}
    for start, proof_phases in zip(starts, phases):
        t = start
        for name, sec in proof_phases:
            a, b = t, t + sec
            for g0, g1 in gaps:
                overlap = min(b, g1) - max(a, g0)
                if overlap > 0:
                    idle[name] = idle.get(name, 0.0) + overlap
            t = b
    return Trace(proofs=n, window_s=window_s,
                 busy_s=sum(b - a for a, b in busy),
                 launches=sum(v[0] for v in kernels.values()),
                 kernels=kernels, phase_seconds=phases, idle_by_phase=idle)
