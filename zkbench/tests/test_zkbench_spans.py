"""The span-traced block (`span_tracing.py`): the attribution of the card's
idle time to nested spans on synthetic events, a CPU run of each cell at a
small size that reports the `program_span` metrics (the Groth16 cell under
the CPU profiler, the Placeholder cells with their ranges kept without it),
a program without spans that leaves them out, and on the card, that a span
and the kernel it launched lie on one clock."""
import time
import types

import pytest

from zkbench import harness, span_tracing, tracing

SEED = 2 ** 33 + 17
SMALL = {"groth16_bn254.c16": {"constraints": 30},
         "placeholder_lpc.r18.lookup": {"rows_log2": 5},
         "placeholder_lpc.r18.gates": {"rows_log2": 5}}
SPAN_METRICS = ("process_private_idle_s", "lookup_idle_s", "lpc_idle_s",
                "witness_map_idle_s", "msm_idle_s", "limbs_convert_idle_s",
                "limbs_convert_idle_s.groth16")


def _two_proofs():
    """Two proofs on one clock: proof 0 over [0, 10] holds `a` [1, 6]
    with child `b` [2, 4], then `c` [7, 9]; proof 1 over [20, 30] holds
    `a` [21, 29]. The card is busy over [3, 5] and [8, 12] (merged from
    [8, 9] and [8.5, 12]) and [25, 26]."""
    proofs = [(0.0, 10.0), (20.0, 30.0)]
    spans = [("a", 1.0, 6.0), ("b", 2.0, 4.0), ("c", 7.0, 9.0),
             ("a", 21.0, 29.0)]
    busy = [(3.0, 5.0), (8.0, 9.0), (8.5, 12.0), (25.0, 26.0)]
    runtime = {"launches": [2.5, 3.5, 7.5, 22.0], "waits": [3.9],
               "d2h": [5.5]}
    return span_tracing.attribute(proofs, spans, busy, runtime)


def test_attribution_of_nested_spans():
    t = _two_proofs()
    a0, b, c, a1 = t.spans
    assert (a0.parent, b.parent, c.parent, a1.parent) == (None, 0, None,
                                                          None)
    assert (a0.proof, a1.proof) == (0, 1)
    # idle inclusive: a0 [1, 6] busy [3, 5] -> 3; b [2, 4] busy [3, 4] -> 1
    assert (a0.idle, b.idle, c.idle, a1.idle) == (3.0, 1.0, 1.0, 7.0)
    assert (a0.self_s, a0.self_idle) == (3.0, 2.0)
    assert b.counts == {"launches": 2, "waits": 1, "d2h": 0}
    row = t.table["a"]
    assert row["calls"] == 2 and row["incl_s"] == 13.0
    assert row["self_s"] == 11.0 and row["idle_s"] == 10.0
    assert row["self_idle_s"] == 9.0
    assert (row["launches"], row["waits"], row["d2h"]) == (3, 1, 1)
    # the proofs: [0, 10] busy 2 + 2 -> 6 idle; [20, 30] busy 1 -> 9 idle
    assert t.idle_s == 15.0
    assert t.unattributed_idle_s == 15.0 - (3.0 + 1.0 + 7.0)


def test_idle_under_counts_each_moment_once():
    t = _two_proofs()
    assert span_tracing.idle_under(t, ("a",)) == (3.0 + 7.0) / 2
    assert span_tracing.idle_under(t, ("a", "b")) == (3.0 + 7.0) / 2
    assert span_tracing.idle_under(t, ("b", "c")) == (1.0 + 1.0) / 2
    assert span_tracing.idle_under(t, ("zk.none",)) is None


def test_a_span_outside_every_proof_is_left_out():
    t = span_tracing.attribute([(0.0, 1.0)], [("x", 2.0, 3.0)], [])
    assert t.spans == [] and t.idle_s == 1.0
    assert t.unattributed_idle_s == 1.0


def test_a_traced_run_needs_the_running_service():
    """A reader asked outside `harness.run_cell` reads nothing in an
    untraced run and raises in a traced one, rather than leaving the span
    metrics out unseen."""
    untraced = types.SimpleNamespace(trace=None)
    assert span_tracing.span_trace(untraced) is None
    assert span_tracing.idle_per_proof(untraced, ("zk.*",)) is None
    with pytest.raises(RuntimeError, match="run_cell"):
        span_tracing.span_trace(types.SimpleNamespace(trace=object()))


class _Event:
    """One of the profiler's events, as `_events` reads it."""

    def __init__(self, name, start_ns, duration_ns, device, correlation=0):
        self._name, self._start, self._duration = name, start_ns, duration_ns
        self._device, self._correlation = device, correlation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._duration

    def device_type(self):
        return self._device

    def start_thread_id(self):
        return 1

    def correlation_id(self):
        return self._correlation


def test_events_of_the_profiler(monkeypatch):
    """A range mirrored onto the card's timeline (first launch to last) is
    no operation of the card; a device-to-host copy counts at the host
    call that issued it."""
    cpu, card = "DeviceType.CPU", "DeviceType.CUDA"
    events = [_Event("zkbench.proof", 0, 100, cpu),
              _Event("zk.a", 10, 50, cpu), _Event("zk.a", 20, 25, card),
              _Event("kernel", 20, 5, card, 7),
              _Event("Memcpy DtoH (Device -> Pageable)", 40, 5, card, 8),
              _Event("cudaLaunchKernel", 15, 1, cpu, 7),
              _Event("cudaMemcpyAsync", 38, 10, cpu, 8),
              _Event("cudaStreamSynchronize", 70, 1, cpu)]
    prof = type("P", (), {})()
    prof.profiler = type("P", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events":
                                                  lambda self: events})()
    proofs, spans, busy, runtime = span_tracing._events(prof)
    ns = 1e-9
    assert proofs == [(0, 0 + 100 * ns)]
    assert spans == [("zk.a", 10 * ns, 10 * ns + 50 * ns)]
    assert busy == [(20 * ns, 20 * ns + 5 * ns), (40 * ns, 40 * ns + 5 * ns)]
    assert runtime == {"launches": [15 * ns], "waits": [70 * ns],
                       "d2h": [38 * ns]}
    t = span_tracing.attribute(proofs, spans, busy, runtime)
    assert t.table["zk.a"]["d2h"] == 1 and t.table["zk.a"]["waits"] == 0
    assert abs(t.spans[0].idle - 40 * ns) < 1e-15


def _cpu_trace(service, n, clock_factory):
    """`tracing.profile_proofs` without the card: the drained proofs are
    not profiled, so the device-trace readers read nothing."""
    for i in range(n):
        service.prove(-2 - i, clock_factory())
    return tracing.Trace(proofs=n, window_s=1.0, busy_s=0.0, launches=0,
                         kernels={}, phase_seconds=[[] for _ in range(n)],
                         idle_by_phase={})


class _Ranges:
    """`torch.profiler.record_function` that keeps each range on the host
    clock, and nothing else."""
    kept: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _Ranges.kept.append((self.name, self.start, time.perf_counter()))
        return False


def _ranges_only(service, device):
    """`span_tracing.profile_spans` without the profiler, for the
    Placeholder cells on the CPU: their plain kernels issue tens of
    millions of torch operations a proof, more than the profiler's
    memory holds. The ranges are the program's spans all the same."""
    import torch
    from crypto3_zk_tpu_torch.utils import profiling

    _Ranges.kept = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _Ranges)
        with profiling.spans_on():
            for i in range(span_tracing.SPAN_PROOFS):
                with _Ranges(span_tracing.PROOF):
                    service.prove(span_tracing.FIRST_REQUEST - i)
    proofs = [(a, b) for name, a, b in _Ranges.kept
              if name == span_tracing.PROOF]
    spans = [r for r in _Ranges.kept if r[0] != span_tracing.PROOF]
    return span_tracing.attribute(proofs, spans, [])


@pytest.mark.parametrize("cell", list(SMALL))
def test_cpu_run_reports_the_span_metrics(monkeypatch, cell):
    monkeypatch.setattr(tracing, "profile_proofs", _cpu_trace)
    if cell.startswith("placeholder"):
        monkeypatch.setattr(span_tracing, "profile_spans", _ranges_only)
    monkeypatch.setattr(harness, "TRACED_PROOFS", 1)
    seen = []
    report = span_tracing.report
    monkeypatch.setattr(span_tracing, "report",
                        lambda t, run=None, out=None:
                        seen.append(t) or report(t, run, out))
    result = harness.run_cell(cell, SEED, 0.1, True, time.perf_counter(),
                              device="cpu", circuit=SMALL[cell],
                              log=lambda msg: None)
    assert result["correct"], result["checks"]
    bench = harness.load_benchmark()
    want = {m["name"] for m in harness.cell_metrics(bench, cell, True)
            if m["name"] in SPAN_METRICS}
    assert len(want) >= 3
    for name in want:
        value = result["metrics"][name]["value"]
        assert value > 0, name                   # no card: every span idles
    [t] = seen
    assert t.proofs == span_tracing.SPAN_PROOFS
    names = {s.name for s in t.spans}
    parent = {s.name: t.spans[s.parent].name for s in t.spans
              if s.parent is not None and s.name != "zk.limbs.encode"
              and s.name != "zk.limbs.decode"}
    if cell.startswith("groth16"):
        assert {"zk.groth16.prove", "zk.groth16.witness_map",
                "zk.groth16.assembly"} <= names
        assert {f"zk.groth16.msm.{q}" for q in ("A", "B1", "B2", "H", "L")} \
            <= names
        assert parent["zk.groth16.msm.B2"] == "zk.groth16.prove"
    else:
        assert "zk.placeholder.process_private" in names
        assert parent["zk.placeholder.variable_commit"] \
            == "zk.placeholder.prove"
        assert parent["zk.lpc.proof_eval"] == "zk.placeholder.prove"
        for step in ("eval_polys", "combined_q", "q_precommit"):
            assert parent[f"zk.lpc.{step}"] == "zk.lpc.proof_eval"
        for step in ("commit_phase", "query_phase"):
            assert parent[f"zk.fri.{step}"] == "zk.lpc.proof_eval"
        if cell.endswith("lookup"):
            for step in ("prepare", "to_host", "sort", "encode", "commit"):
                assert parent[f"zk.lookup.{step}"] == "zk.placeholder.lookup"
            assert parent["zk.placeholder.lookup"] == "zk.placeholder.prove"
        else:
            assert "zk.placeholder.lookup" not in names
            assert parent["zk.placeholder.permutation_argument"] \
                == "zk.placeholder.prove"
    assert t.unattributed_idle_s <= 0.05 * t.idle_s
    assert len(t.spans) / t.proofs <= 500


def test_a_program_without_spans_leaves_the_metrics_out(monkeypatch):
    """As the parent of the change that brought the spans: no
    `spans_on`, so no span-traced block runs and the readers give
    None."""
    from crypto3_zk_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans_on")
    monkeypatch.setattr(tracing, "profile_proofs", _cpu_trace)
    monkeypatch.setattr(harness, "TRACED_PROOFS", 1)
    cell = "groth16_bn254.c16"
    result = harness.run_cell(cell, SEED, 0.1, True, time.perf_counter(),
                              device="cpu", circuit={"constraints": 14},
                              log=lambda msg: None)
    assert result["correct"]
    assert not set(result["metrics"]) & set(SPAN_METRICS)
    assert "proof_s.groth16" in result["metrics"]


def test_span_and_its_kernel_share_one_clock(card):
    """A span around a kernel launch and a `synchronize` holds the
    kernel's device interval among the profiler's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from crypto3_zk_tpu_torch.utils import profiling

    x = torch.ones(1 << 24, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.spans_on(), profiling.span("zk.test.launch"):
            y = x * 3
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events if "cuda" in str(e.device_type()).lower()]
    [s] = [e for e in events
           if e.name() == "zk.test.launch" and e not in on_card]
    kernels = [e for e in on_card if e.name() != "zk.test.launch"
               and "memcpy" not in e.name().lower()]
    assert kernels and y.sum().item() == 3 * (1 << 24)
    lo, hi = s.start_ns(), s.start_ns() + s.duration_ns()
    for k in kernels:
        a, b = k.start_ns(), k.start_ns() + k.duration_ns()
        print(f"span [{lo}, {hi}] ns holds {k.name()[:60]} [{a}, {b}] ns")
        assert lo <= a <= b <= hi
