"""The span-traced block of a `--trace 1` run: the card's idle time put
down to the program's spans, on the profiler's one clock.

After the harness's traced proofs (each drained by the program's
`PhaseClock`, `tracing.py`), three more proofs of the same service are
profiled with the program's spans on (`crypto3_zk_tpu_torch.utils.
profiling.spans_on`) and no clock: the served program plus only its spans.
From the profiler's events (kineto's clock for the host's ranges and the
card's operations alike):

- the card's operations (kernels, copies, fills), merged into busy
  intervals; the profiler also mirrors each host range that launched work
  onto the card's timeline (first launch to last), and those mirrors are
  no operations;
- each proof's range (`zkbench.proof`, opened here around `prove`) and the
  program's spans (`zk.<layer>.<step>`) on the proving thread, nested by
  interval: a span's parent is the innermost span that encloses it;
- the runtime's kernel launches, host waits (stream, device and event
  synchronisation) and device-to-host copies, where CUPTI records them.

For each span name, over the proofs: inclusive and self wall seconds (self
is what its children leave), the card's idle seconds inclusive (the
complement of busy inside the span) and self (idle while it is the
innermost span open), and the launches, waits and copies under it. The
table goes to standard error with the share of the proofs' idle seconds
that falls under no span; the result hangs on the run as `span_trace`.

The first `program_span` reader that asks (`span_trace(run)`) runs the
block. The harness hands a reader only the `Run`, so the block takes the
running service from `harness.run_cell`'s frame (a traced run without that
frame is an error), and checks the harness's guard on loaded modules again
after it. A program without `spans_on` gives no block, and the readers
return None.
"""
from __future__ import annotations

import bisect
import dataclasses
import fnmatch
import statistics
import sys
import time

from .tracing import _merge

PROOF = "zkbench.proof"
SPAN_PROOFS = 3
FIRST_REQUEST = -5          # the drained block took -2, -3, -4
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
COUNTS = ("launches", "waits", "d2h")
_ABSENT = object()


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    proof: int
    parent: int | None            # index of the enclosing span, or None
    idle: float = 0.0             # card idle inside the span
    self_s: float = 0.0           # wall seconds its children leave
    self_idle: float = 0.0        # idle while it is the innermost span
    counts: dict = dataclasses.field(default_factory=dict)   # inclusive


@dataclasses.dataclass
class SpanTrace:
    proofs: int
    proof_seconds: list           # each span-traced proof's wall seconds
    idle_s: float                 # card idle inside the proofs' ranges
    unattributed_idle_s: float    # of which under no span
    spans: list                   # every `Span`, in start order
    table: dict                   # name -> sums over the proofs


class _Busy:
    """Merged busy intervals, and the busy time inside any interval."""

    def __init__(self, intervals):
        merged = _merge(intervals)
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.before = [0.0]                      # busy time before each
        for a, b in merged:
            self.before.append(self.before[-1] + (b - a))

    def _upto(self, t) -> float:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]

    def idle(self, a, b) -> float:
        return (b - a) - (self._upto(b) - self._upto(a))


def attribute(proofs: list, spans: list, busy: list,
              runtime: dict | None = None,
              proof_seconds: list | None = None) -> SpanTrace:
    """`proofs`: each proof's (start, end); `spans`: (name, start, end) of
    the proving thread; `busy`: the card's operations as (start, end);
    `runtime`: kind (`COUNTS`) -> host times of the runtime's calls.
    All on one clock, in seconds."""
    runtime = {k: sorted(v) for k, v in (runtime or {}).items()}
    clock = _Busy(busy)
    proofs = sorted(proofs)
    proof_starts = [a for a, _ in proofs]
    out: list[Span] = []
    stack: list[int] = []
    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        k = bisect.bisect_right(proof_starts, a) - 1
        if k < 0 or a > proofs[k][1]:
            continue                          # outside every proof
        while stack and not (out[stack[-1]].start <= a
                             and b <= out[stack[-1]].end
                             and out[stack[-1]].proof == k):
            stack.pop()
        s = Span(name, a, b, k, stack[-1] if stack else None)
        s.idle = clock.idle(a, b)
        s.self_s, s.self_idle = b - a, s.idle
        s.counts = {kind: bisect.bisect_right(times, b)
                    - bisect.bisect_left(times, a)
                    for kind, times in runtime.items()}
        out.append(s)
        stack.append(len(out) - 1)
    for s in out:
        if s.parent is not None:
            out[s.parent].self_s -= s.end - s.start
            out[s.parent].self_idle -= s.idle
    table: dict = {}
    for s in out:
        row = table.setdefault(s.name, {
            "calls": 0, "incl_s": 0.0, "self_s": 0.0, "idle_s": 0.0,
            "self_idle_s": 0.0, **{k: 0 for k in COUNTS}})
        row["calls"] += 1
        row["incl_s"] += s.end - s.start
        row["self_s"] += s.self_s
        row["idle_s"] += s.idle
        row["self_idle_s"] += s.self_idle
        for kind, c in s.counts.items():
            row[kind] += c
    idle = sum(clock.idle(a, b) for a, b in proofs)
    covered = sum(s.idle for s in out if s.parent is None)
    return SpanTrace(proofs=len(proofs),
                     proof_seconds=list(proof_seconds or
                                        [b - a for a, b in proofs]),
                     idle_s=idle, unattributed_idle_s=idle - covered,
                     spans=out, table=table)


def idle_under(trace: SpanTrace, patterns) -> float | None:
    """The card's idle seconds a proof under the spans whose names match
    one of `patterns` (`fnmatch`), inclusive, each moment once (a match
    inside another match is not counted again); None where no span
    matches."""
    def hit(s):
        return any(fnmatch.fnmatchcase(s.name, p) for p in patterns)

    total, found = 0.0, False
    for s in trace.spans:
        if not hit(s):
            continue
        found = True
        p = s.parent
        while p is not None and not hit(trace.spans[p]):
            p = trace.spans[p].parent
        if p is None:
            total += s.idle
    if not found or not trace.proofs:
        return None
    return total / trace.proofs


def _events(prof) -> tuple[list, list, list, dict]:
    """(proof ranges, spans of the proving thread, the card's operations,
    runtime times by kind) from the profiler's events, in seconds."""
    ns = 1e-9
    ranges, device, calls = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() * ns
        b = a + e.duration_ns() * ns
        ours = name == PROOF or name.startswith("zk.")
        if "cuda" in str(e.device_type()).lower():
            if not ours:        # a range's mirror on the card's timeline
                device.append((name, a, b, e.correlation_id()))
        elif ours:
            ranges.append((name, a, b, e.start_thread_id()))
        elif name in LAUNCHES or name in WAITS \
                or name.startswith(("cudaMemcpy", "cuMemcpy")):
            calls.append((name, a, e.correlation_id()))
    proofs = [(a, b) for name, a, b, _ in ranges if name == PROOF]
    threads = {t for name, _, _, t in ranges if name == PROOF}
    spans = [(name, a, b) for name, a, b, t in ranges
             if name != PROOF and t in threads]
    issued = {c: a for _, a, c in calls}
    runtime = {"launches": [a for name, a, _ in calls if name in LAUNCHES],
               "waits": [a for name, a, _ in calls if name in WAITS],
               "d2h": [issued.get(c, a) for name, a, _, c in device
                       if "dtoh" in name.lower()]}
    return proofs, spans, [(a, b) for _, a, b, _ in device], runtime


def profile_spans(service, device) -> SpanTrace | None:
    """Profile `SPAN_PROOFS` proofs of `service` (requests
    `FIRST_REQUEST`, `FIRST_REQUEST` - 1, ...: steady, never judged) with
    the program's spans on and no clock. None where the program has no
    spans."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from crypto3_zk_tpu_torch.utils import profiling
    from .harness import sync

    spans_on = getattr(profiling, "spans_on", None)
    if spans_on is None:
        return None
    on_card = str(device).startswith("cuda")
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    seconds = []
    with profile(activities=activities) as prof:
        sync(device)
        with spans_on():
            for i in range(SPAN_PROOFS):
                t0 = time.perf_counter()
                with record_function(PROOF):
                    service.prove(FIRST_REQUEST - i)
                seconds.append(time.perf_counter() - t0)
        sync(device)
    proofs, spans, busy, runtime = _events(prof)
    if not proofs:
        raise RuntimeError("the profiler recorded no proof range")
    return attribute(proofs, spans, busy, runtime, seconds)


def _running_service():
    """(service, device) of the `harness.run_cell` call on this thread's
    stack."""
    from . import harness
    code = harness.run_cell.__code__
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code is code:
            service = frame.f_locals.get("service")
            if service is not None:
                return service, frame.f_locals.get("device")
        frame = frame.f_back
    raise RuntimeError("a traced run's span reader found no "
                       "harness.run_cell service on its stack")


def span_trace(run) -> SpanTrace | None:
    """The run's span-traced block, made once (on the first ask) and kept
    on the run; None in an untraced run."""
    got = run.__dict__.get("span_trace", _ABSENT)
    if got is _ABSENT:
        got = None
        if run.trace is not None:
            from .harness import banned_modules
            got = profile_spans(*_running_service())
            found = banned_modules()
            if found:
                raise RuntimeError("loaded by the span-traced proofs: "
                                   + ", ".join(found))
        run.span_trace = got
        if got is not None:
            report(got, run)
    return got


def idle_per_proof(run, patterns) -> float | None:
    """What a `program_span` reader reads: `idle_under` of the run's
    span-traced block."""
    trace = span_trace(run)
    return None if trace is None else idle_under(trace, patterns)


def report(trace: SpanTrace, run=None, out=None) -> None:
    """The per-span table, a proof's share of each sum, on standard
    error."""
    out = out or sys.stderr
    n = max(trace.proofs, 1)
    w = max([len(k) for k in trace.table] + [4])
    print(f"span-traced proofs {trace.proofs}, spans a proof "
          f"{len(trace.spans) / n:.1f}, seconds "
          + " ".join(f"{x:.3f}" for x in trace.proof_seconds), file=out)
    if run is not None and run.trace is not None and run.trace.proofs:
        drained = run.trace.window_s / run.trace.proofs
        median = statistics.median(run.proof_seconds) \
            if run.proof_seconds else float("nan")
        print(f"drained traced proofs {drained:.3f} s a proof, window "
              f"median {median:.3f} s", file=out)
    print(f"{'span':<{w}} {'calls':>6} {'incl_s':>9} {'self_s':>9} "
          f"{'idle_s':>9} {'self_idle':>9} {'launches':>9} {'waits':>6} "
          f"{'d2h':>5}   (a proof)", file=out)
    for name, r in sorted(trace.table.items(),
                          key=lambda kv: -kv[1]["self_idle_s"]):
        print(f"{name:<{w}} {r['calls'] / n:>6.1f} {r['incl_s'] / n:>9.4f} "
              f"{r['self_s'] / n:>9.4f} {r['idle_s'] / n:>9.4f} "
              f"{r['self_idle_s'] / n:>9.4f} {r['launches'] / n:>9.1f} "
              f"{r['waits'] / n:>6.1f} {r['d2h'] / n:>5.1f}", file=out)
    share = trace.unattributed_idle_s / trace.idle_s if trace.idle_s else 0
    print(f"idle {trace.idle_s / n:.4f} s a proof, under no span "
          f"{trace.unattributed_idle_s / n:.4f} s ({100 * share:.2f} %)",
          file=out, flush=True)
