"""Where one Groth16 prove, one LPC `proof_eval` or one Placeholder prove
spends its time on the GPU.

    python3 -m crypto3_zk_tpu_torch.tools.profile_prove [--lpc | --placeholder]
        [--rows-log2 K] [--merkle-hash sha2_256] [--out f.json]

By default it generates a key for the product-chain circuit of 2^16
constraints over alt_bn128 (the size `chip_smoke.py` proves). With `--lpc`
it builds the LPC deployment `chip_smoke.py` drives instead
(`tools/lpc_fixture.py`: 12 polynomials of degree < 2^16 over bls12-381 Fr,
D0 = 2^18, lambda 40, Poseidon trees, or with `--merkle-hash sha2_256`
sha2 trees, kernel 7) and commits both batches; "prove" below is then one
`LPCScheme.proof_eval`. With `--placeholder` it preprocesses the
Placeholder deployment `chip_smoke.py` drives (`tools/placeholder_fixture.py`:
`placeholder_chain` at 2^16 rows over bls12-381 Fr, D0 = 2^18, lambda 40,
Poseidon trees; `--rows-log2` sets another size), and "prove" is one
Placeholder `prove`. Each way it proves
once to warm up
(kernel build, base encoding, cached tables), then proves three more times:

1. plain, for the wall time and the prover's own phase seconds;
2. under `torch.profiler`, for the time the device was busy (the sum of all
   kernel times), the idle share, the kernels ranked by device time, and
   every kernel of the port's own (`port_kernels`), however small;
3. under `cProfile`, for the host functions ranked by cumulative time.

The device profile sums kernel 5 by form (`poseidon`) and kernel 7 by form
(`sha256`), and lists the 25 kernels of most device time, the library's
(torch's own elementwise and copy kernels) among them.

Both profilers slow the host down, so the idle share is given against the
profiled wall time and against the plain one. Prints one JSON object, and
writes it to `--out` if given. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import random
import subprocess
import sys
import time

import torch

from ..arithmetization.circuits import product_chain
from ..fields import curves as CV
from ..models import groth16 as G16

LOG2_CONSTRAINTS = 16
# the port's own kernels as the profiler names them (csrc/*.cu)
_OWN_KERNELS = ("void elementwise_kernel<", "void ntt_rows_kernel<",
                "void inv_scans_kernel<", "void inv_tail_kernel<",
                "void mul3_kernel<", "void poseidon_kernel<",
                "void poseidon_shared_kernel<", "void poseidon_tree_kernel<",
                "void scalar_mul_kernel<", "sha256_blocks_kernel(",
                "sha256_nodes_kernel(", "void sha256_field_rows_kernel<",
                "void mxu_pass_kernel<")
TOXIC = {"t": 0x1234567, "alpha": 0x2345678, "beta": 0x3456789,
         "gamma": 0x456789A, "delta": 0x56789AB}


def _timed(prove):
    t0 = time.perf_counter()
    proof = prove()
    torch.cuda.synchronize()
    return proof, time.perf_counter() - t0


def poseidon_device_ms(device: dict) -> dict:
    """Device ms and calls of each form of kernel 5 in a `_device_profile`
    result."""
    out = {}
    for k in device["port_kernels"]:
        if k["name"].startswith("void poseidon"):
            form = k["name"].split("<", 1)[0][len("void "):]
            ms, calls = out.get(form, (0.0, 0))
            out[form] = (ms + k["device_ms"], calls + k["calls"])
    return {form: {"device_ms": ms, "calls": calls}
            for form, (ms, calls) in out.items()}


def sha256_device_ms(device: dict) -> dict:
    """Device ms and calls of each form of kernel 7 in a `_device_profile`
    result."""
    out = {}
    for k in device["port_kernels"]:
        if "sha256_" in k["name"]:
            form = k["name"].split("sha256_", 1)[1].split("_kernel", 1)[0]
            ms, calls = out.get(form, (0.0, 0))
            out[form] = (ms + k["device_ms"], calls + k["calls"])
    return {form: {"device_ms": ms, "calls": calls}
            for form, (ms, calls) in out.items()}


def _device_profile(prove) -> dict:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(prove)
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append({"name": evt.key[:80], "calls": evt.count,
                            "device_ms": us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy = sum(k["device_ms"] for k in kernels) / 1e3
    own = [k for k in kernels
           if any(name in k["name"] for name in _OWN_KERNELS)]
    return {"wall_s_profiled": wall, "device_busy_s": busy,
            "device_kernel_launches": sum(k["calls"] for k in kernels),
            "top_kernels": kernels[:25], "port_kernels": own}


def _host_profile(prove) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    _, wall = _timed(prove)
    prof.disable()
    stats = pstats.Stats(prof)
    rows = []
    for (path, line, name), (_, ncalls, tottime, cumtime, _) \
            in stats.stats.items():
        rows.append({"function": f"{path.rsplit('/', 1)[-1]}:{line}:{name}",
                     "calls": ncalls, "self_s": tottime, "cum_s": cumtime})
    by_cum = sorted(rows, key=lambda r: -r["cum_s"])[:30]
    by_self = sorted(rows, key=lambda r: -r["self_s"])[:20]
    return {"wall_s_profiled": wall, "by_cumulative": by_cum,
            "by_self": by_self}


def _groth16_setup() -> tuple:
    """The Groth16 workload: (facts for the result, prove(), accept(proof),
    phases())."""
    curve = CV.ALT_BN128
    cs, primary, aux = product_chain(curve.fr.p, 1 << LOG2_CONSTRAINTS)
    t0 = time.perf_counter()
    kp = G16.generate(curve, cs, toxic=TOXIC)
    facts = {"workload": "groth16", "log2_constraints": LOG2_CONSTRAINTS,
             "keygen_s": time.perf_counter() - t0}

    def prove():
        return G16.prove(kp.pk, primary, aux, rng=random.Random(12))

    def accept(proof):
        return G16.verify(kp.vk, primary, proof)

    return facts, prove, accept, lambda: dict(G16.LAST_PROVE_SECONDS)


def _lpc_setup(merkle_hash: str = "poseidon") -> tuple:
    """The LPC workload over `merkle_hash` trees, as `_groth16_setup`."""
    from ..commitments.fri import PhaseClock
    from .lpc_fixture import LPCRun

    run = LPCRun(LOG2_CONSTRAINTS, 40, "cuda", merkle_hash=merkle_hash)
    run.commit(torch.cuda.synchronize)
    facts = {"workload": "lpc_proof_eval", "merkle_hash": merkle_hash,
             "log2_degree": LOG2_CONSTRAINTS,
             "domain_size": run.params.D[0].n, "lambda": 40,
             "polynomials": [len(s) for s in run.sizes],
             "commit_s": dict(run.seconds)}

    def prove():
        return run.prove(lambda: None)[0]

    def accept(proof):
        return run.verify(proof)[0]

    def phases():
        """One more `proof_eval`, with a clock that drains the device at
        each phase's end (the timed and profiled ones run without)."""
        clock = PhaseClock("cuda")
        run.prove(lambda: None, clock)
        return dict(clock.seconds)

    return facts, prove, accept, phases


def _placeholder_setup(rows_log: int = LOG2_CONSTRAINTS) -> tuple:
    """The Placeholder workload at 2^rows_log rows, as `_groth16_setup`."""
    from ..commitments.fri import PhaseClock
    from .placeholder_fixture import PlaceholderRun

    run = PlaceholderRun(rows_log, "cuda")
    clock = PhaseClock("cuda")
    run.preprocess(clock)
    facts = {"workload": "placeholder_prove", "log2_rows": rows_log,
             "domain_size": run.fri_params.D[0].n, "lambda": 40,
             "setup_s": dict(run.seconds),
             "process_public_phases_s": dict(clock.seconds)}

    def prove():
        return run.prove()[0]

    def accept(proof):
        return run.verify(proof)[0]

    def phases():
        clock = PhaseClock("cuda")
        run.prove(clock)
        return dict(clock.seconds)

    return facts, prove, accept, phases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--lpc", action="store_true",
                       help="profile one LPC proof_eval instead of a Groth16 "
                            "prove")
    which.add_argument("--placeholder", action="store_true",
                       help="profile one Placeholder prove at 2^16 rows")
    ap.add_argument("--rows-log2", type=int, default=LOG2_CONSTRAINTS,
                    help="the Placeholder table's rows, log2 (default 16)")
    ap.add_argument("--merkle-hash", default="poseidon",
                    choices=("poseidon", "sha2_256"),
                    help="the LPC trees' hash (with --lpc; sha2_256 runs "
                         "kernel 7)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    facts, prove, accept, phases_of = (
        _lpc_setup(args.merkle_hash) if args.lpc else
        _placeholder_setup(args.rows_log2) if args.placeholder
        else _groth16_setup())
    _timed(prove)                                          # warm-up
    proof, wall = _timed(prove)
    phases = phases_of()
    if not accept(proof):
        raise AssertionError("the proof was rejected")

    device = _device_profile(prove)
    device["idle_share_profiled"] = \
        1 - device["device_busy_s"] / device["wall_s_profiled"]
    device["idle_share_against_plain_wall"] = \
        1 - device["device_busy_s"] / wall
    device["poseidon"] = poseidon_device_ms(device)
    device["sha256"] = sha256_device_ms(device)
    result = {"card": card, **facts, "prove_wall_s": wall,
              "phases_s": phases, "device": device,
              "host": _host_profile(prove)}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
