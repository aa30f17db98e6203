"""One run of one cell: set-up, the measured window, the traced proofs, the
judging, and the result.

Everything is found by name: the cell's file `workloads/<cell>.json` names
its configuration `configs/<config>.json`, whose `system` names the service
`systems/<system>.py`; `BENCHMARK.json` lists the metrics each cell
reports, and each metric is read by `metrics/<metric>.py`. A later change
adds a configuration, a cell or a metric by adding files.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load, compared whole
BANNED = ("jax", "jaxlib", "flax", "crypto3_zk_tpu")
TRACED_PROOFS = 3


def banned_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name is banned."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)


def load_json(kind: str, name: str, root: pathlib.Path = HERE) -> dict:
    path = root / kind / f"{name}.json"
    with open(path) as f:
        data = json.load(f)
    if data.get("name") != name:
        raise ValueError(f"{path} names itself {data.get('name')!r}")
    return data


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def system_module(name: str):
    return importlib.import_module(f"zkbench.systems.{name}")


def metric_module(name: str):
    """`metrics/<name>.py` (a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"zkbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with `workloads` only in those."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    config: dict
    workload: dict
    seed: int
    setup_s: float
    window_s: float                  # window start to the last completion
    proof_seconds: list              # each completed proof's wall time
    peak_bytes: int | None
    spans: dict                      # set-up steps timed by the harness
    trace: object = None             # a `tracing.Trace` in traced runs


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             process_start: float, device="cuda", control: bool = False,
             bench: dict | None = None, log=None,
             circuit: dict | None = None) -> dict:
    """One run; returns the result object (see README.md). `device` "cpu"
    and `circuit` (keys that replace the workload's circuit's, for a size a
    test can hold) serve the CPU tests only: the command refuses to run
    without a card and passes no `circuit`."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = load_benchmark() if bench is None else bench
    workload = load_json("workloads", cell)
    if circuit:
        workload["circuit"] = {**workload["circuit"], **circuit}
    config = load_json("configs", workload["config"])
    system = system_module(config["system"])
    service = system.Service(config, workload, seed, device, control=control)
    on_card = str(device).startswith("cuda")
    if on_card:
        import torch
        torch.cuda.reset_peak_memory_stats()

    spans: dict = {}
    service.setup(spans)
    sync(device)
    setup_s = time.perf_counter() - process_start

    done, proof_seconds, failed, attempted = [], [], 0, 0
    cpu_seconds, phase_seconds = [], []
    host_before = host_state()
    start = time.perf_counter()
    end = start + seconds
    last = start
    k = 0
    while time.perf_counter() < end:
        attempted += 1
        t0, c0 = time.perf_counter(), time.process_time()
        try:
            proof = service.prove(k)
        except Exception as exc:                       # noqa: BLE001
            failed += 1
            log(f"proof {k} failed: {exc!r}")
        else:
            last = time.perf_counter()
            proof_seconds.append(last - t0)
            cpu_seconds.append(time.process_time() - c0)
            phase_seconds.append(dict(service.phases()))
            done.append((k, proof))
        k += 1
    window_s = last - start
    host = host_window(host_before, host_state(), window_s)
    log("proof seconds: " + " ".join(f"{x:.3f}" for x in proof_seconds))
    log("proof cpu seconds: " + " ".join(f"{x:.3f}" for x in cpu_seconds))
    for name in phase_seconds[0] if phase_seconds else ():
        log(f"phase {name} seconds: " + " ".join(
            f"{p.get(name, 0.0):.3f}" for p in phase_seconds))
    log("host in the window: " + json.dumps(host))
    peak = None
    if on_card:
        import torch
        peak = torch.cuda.max_memory_allocated()

    traced = None
    if trace:
        from . import tracing
        from crypto3_zk_tpu_torch.commitments.fri import PhaseClock
        traced = tracing.profile_proofs(
            service, TRACED_PROOFS, lambda: PhaseClock(device))

    found = banned_modules()
    if found:
        raise RuntimeError("loaded after the window: " + ", ".join(found))

    run = Run(config, workload, seed, setup_s, window_s, proof_seconds,
              peak, spans, traced)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        log(f"proof_p90_s over {len(proof_seconds)} proofs")

    # the program's state is freed before the reference runs
    claims = service.claims()
    service.release()
    sync(device)
    t_judge = time.perf_counter()
    judged = _judge_sample(workload, seed, done)
    plain = [(k, system.plain_proof(proof)) for k, proof in judged]
    done = judged = None
    numbers = system.judge(config, workload, seed, plain, claims) \
        if plain else {}
    limits = config["limits"]
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in limits.items()}
    checks["proofs_failed"] = {"value": failed, "limit": 0}
    correct = bool(plain) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    log(f"proofs judged {len(plain)} of {len(proof_seconds)} completed, in "
        f"{time.perf_counter() - t_judge:.1f} s")

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": _device(device, peak, traced),
              "host": host}
    if traced is not None:
        result["breakdown"] = _breakdown(traced)
    result["checks"] = checks
    return result


def host_state() -> dict:
    """What the host gave the process so far: CPU seconds of the process
    and of its main thread, the cores it may run on, and their mean clock
    as the machine reports it (which tells machines of different speed
    apart)."""
    cores = sorted(os.sched_getaffinity(0))
    state = {"cpu_s": time.process_time(), "main_cpu_s": time.thread_time(),
             "cores": len(cores)}
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        state["mhz"] = sum(mhz[c] for c in cores if c < len(mhz)) \
            / max(1, sum(c < len(mhz) for c in cores))
    except (OSError, ValueError, IndexError):
        pass
    return state


def host_window(before: dict, after: dict, window_s: float) -> dict:
    """The window's CPU seconds, and the clock at both of its ends."""
    return {"window_s": window_s,
            "cpu_s": after["cpu_s"] - before["cpu_s"],
            "main_cpu_s": after["main_cpu_s"] - before["main_cpu_s"],
            "cores": after["cores"],
            "mhz": [before.get("mhz"), after.get("mhz")]}


def _judge_sample(workload: dict, seed: int, done: list) -> list:
    """The window's proofs that the reference judges: all of them, or
    `judged_proofs` drawn from the seed so that they cover as many
    distinct witnesses of the pool as they can: slots in an order drawn
    from the seed, a proof drawn from each in turn."""
    from . import draws
    n = workload["judged_proofs"]
    if n == "all" or n >= len(done):
        return list(done)
    rng = draws.stream(seed, "judge")
    slots: dict = {}
    for i, (k, _) in enumerate(done):
        slots.setdefault(k % workload["pool"], []).append(i)
    order = rng.sample(sorted(slots), len(slots))
    picks: list = []
    while len(picks) < n:
        for slot in order:
            left = [i for i in slots[slot] if i not in picks]
            if left and len(picks) < n:
                picks.append(rng.choice(left))
    return [done[i] for i in sorted(picks)]


def _device(device, peak, traced) -> dict:
    if str(device).startswith("cuda"):
        import torch
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": peak}
    if traced is not None:
        out["busy_s"] = traced.busy_s
        out["window_s"] = traced.window_s
    return out


def _breakdown(traced) -> dict:
    ops = sorted(((name, row[1]) for name, row in traced.kernels.items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(traced.idle_by_phase.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
