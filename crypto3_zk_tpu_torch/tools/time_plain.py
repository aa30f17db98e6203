"""How long the plain versions' two forms take, lane count by lane count.

    python3 -m crypto3_zk_tpu_torch.tools.time_plain [--device cpu|cuda]
        [--logs 6,8,10] [--reps 5] [--threads 1] [--out f.json]

`hopper_field`'s plain Montgomery product, add and subtract each have a
whole-tensor form (a fixed number of calls per operation) and a digit-serial
form (one digit row at a time), and `_FEW_LANES` chooses between them by the
number of lanes. This times both forms of each at 2^log lanes of bls12-381 Fr
digit planes, (16, 2^log), checks that they give the same digits, and also
times the plain Poseidon's MDS mix as `mont_matvec_plain` against the nine
broadcast products and the adds it replaces. Each time is the median of
`--reps` calls after one warm-up; on the card each call is drained before
the clock stops. On the CPU it runs `--threads` torch threads (1 by
default, as the test suite's workers do). Prints one JSON object, and
writes it to `--out` if given.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..fields import params as P
from ..ops import hopper_field as HF


def _median_ms(fn, device, reps):
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _digits(fs, shape, rng, device):
    """Random residues below p as int32 digit planes (NL, *shape)."""
    d = rng.integers(0, 1 << P.W, (fs.nl,) + shape, dtype=np.int64)
    d[-1] &= (1 << (fs.p.bit_length() - P.W * (fs.nl - 1) - 1)) - 1
    return torch.from_numpy(d.astype(np.int32)).to(device)


def _both_forms(fn, lanes):
    """fn() with the whole-tensor forms, then with the digit-serial ones."""
    saved = HF._FEW_LANES
    try:
        HF._FEW_LANES = lanes
        whole = fn()
        HF._FEW_LANES = 0
        serial = fn()
    finally:
        HF._FEW_LANES = saved
    return whole, serial


def _mds_products(fs, m, x):
    """sum_j M[i][j] x[j] as nine broadcast products and two adds."""
    prod = HF.mont_mul_plain(fs, m[..., None], x[:, None])  # (NL, 3, 3, n)
    return HF.add_plain(fs, HF.add_plain(fs, prod[:, :, 0], prod[:, :, 1]),
                        prod[:, :, 2])


def time_forms(device, logs, reps):
    fs = P.BLS12_381_FR
    rng = np.random.default_rng(0)
    rows = []
    for log in logs:
        lanes = 1 << log
        a = _digits(fs, (lanes,), rng, device)
        b = _digits(fs, (lanes,), rng, device)
        for op, fn in (("mont_mul", HF.mont_mul_plain),
                       ("add", HF.add_plain), ("sub", HF.sub_plain)):
            whole, serial = _both_forms(lambda: fn(fs, a, b), lanes)
            if not torch.equal(whole, serial):
                raise AssertionError(f"{op}: the two forms differ at 2^{log}")
            ms = _both_forms(lambda: _median_ms(lambda: fn(fs, a, b),
                                                device, reps), lanes)
            rows.append({"op": op, "log_lanes": log, "whole_ms": ms[0],
                         "serial_ms": ms[1]})
        m = _digits(fs, (3, 3), rng, device)
        x = _digits(fs, (3, lanes), rng, device)
        table = torch.from_numpy(HF.matvec_table(
            m.cpu().numpy().astype(np.int64))).to(device)
        got = HF.mont_matvec_plain(fs, table, x)
        if not torch.equal(got, _mds_products(fs, m, x)):
            raise AssertionError(f"mds: the two forms differ at 2^{log}")
        rows.append({
            "op": "mds", "log_lanes": log,
            "matvec_ms": _median_ms(
                lambda: HF.mont_matvec_plain(fs, table, x), device, reps),
            "products_ms": _median_ms(lambda: _mds_products(fs, m, x),
                                      device, reps)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--logs", default="6,7,8,9,10,12,14,16")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    result = {"device": str(device), "few_lanes": HF._FEW_LANES}
    if device.type == "cuda":
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    else:
        torch.set_num_threads(args.threads)
        result["threads"] = args.threads
    result["rows"] = time_forms(
        device, [int(s) for s in args.logs.split(",")], args.reps)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
