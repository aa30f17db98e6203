"""The MSM's time by Pippenger window width, at a KZG commitment's size.

    python3 -m crypto3_zk_tpu_torch.tools.msm_windows [--log2-n 16]
        [--widths 3,4,5,6,8,10] [--rounds 40] [--trials 2] [--seed 11]
        [--prove-widths 5,8 --prove-rounds 6]

Makes 2^log2-n alt_bn128 G1 points on the card (the fixed-base batch, as
`KZGParams.setup` does), and for each trial 2^log2-n random scalars as
canonical digits on the card, then times `MSMBases.run_limbs` at every
width round-robin (`window_sweep`). Prints the card's name and power limit,
then per trial and width the quartiles of the milliseconds. With
`--prove-rounds`, it then times whole Placeholder-over-KZG v2 proves at
2^log2-n rows (`tools/placeholder_fixture.py::PlaceholderKZGRun`) with the
commitment key encoded at each of `--prove-widths`, round-robin in the same
way (`prove_sweep`). This is how `commitments/kzg.py::COMMIT_WINDOW_BITS`
was chosen; `chip_smoke.py` repeats a shorter sweep on a real commitment.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import random
import subprocess
import time

import torch

from ..fields import curves as CV
from ..ops import limbs as L
from ..ops.msm import fixed_base_exp_batch
from ..ops.msm_affine import MSMBases


def window_sweep(curve, points, canonical: torch.Tensor, widths,
                 rounds: int) -> dict:
    """Milliseconds of the MSM of `canonical` (canonical digits on the
    card) over `points` at each width, as lists, and the point. Timed
    round by round, each round timing every width once in an order rotated
    from round to round, so that a drift of the shared host falls on all
    widths alike. Raises unless every width gives the same point."""
    widths = tuple(widths)
    bases = {c: MSMBases(curve, points, "g1", c, "cuda") for c in widths}
    times = {c: [] for c in widths}
    want = None
    for r in range(rounds):
        for j in range(len(widths)):
            c = widths[(r + j) % len(widths)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = bases[c].run_limbs(canonical)
            times[c].append((time.perf_counter() - t0) * 1e3)
            want = got if want is None else want
            if got != want:
                raise AssertionError(f"the {c}-bit window MSM disagrees")
    return {"times_ms": times, "point": want}


def prove_sweep(rows_log2: int, widths, rounds: int) -> dict:
    """Seconds of a Placeholder-over-KZG v2 prove with the commitment key
    encoded at each width (`kzg.COMMIT_WINDOW_BITS` set while its key is
    encoded by a warm-up prove), as lists, timed round-robin as in
    `window_sweep`. Raises unless every prove gives the same proof."""
    from ..commitments import kzg as KZG
    from ..convert import placeholder_proof_as_plain
    from .placeholder_fixture import PlaceholderKZGRun

    widths = tuple(widths)
    run = PlaceholderKZGRun(rows_log2, "cuda", "v2")
    run.preprocess()
    keys, want = {}, None
    chosen = KZG.COMMIT_WINDOW_BITS
    try:
        for c in widths:
            KZG.COMMIT_WINDOW_BITS = c
            run.kzg_params._bases = {}
            want = placeholder_proof_as_plain(run.prove()[0])
            keys[c] = run.kzg_params._bases
    finally:
        KZG.COMMIT_WINDOW_BITS = chosen
    times = {c: [] for c in widths}
    for r in range(rounds):
        for j in range(len(widths)):
            c = widths[(r + j) % len(widths)]
            run.kzg_params._bases = keys[c]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof = run.prove()[0]
            torch.cuda.synchronize()
            times[c].append(time.perf_counter() - t0)
            if placeholder_proof_as_plain(proof) != want:
                raise AssertionError(f"the {c}-bit key gave another proof")
    return times


def quartiles(xs: list[float]) -> tuple[float, float, float]:
    ys = sorted(xs)
    return tuple(ys[(len(ys) - 1) * k // 4] for k in (1, 2, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-n", type=int, default=16)
    ap.add_argument("--widths", default="3,4,5,6,8,10")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--prove-widths", default="5,8")
    ap.add_argument("--prove-rounds", type=int, default=0)
    args = ap.parse_args(argv)
    from .. import kernels as K
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    K.build_all()
    curve = CV.ALT_BN128
    rng = random.Random(args.seed)
    n = 1 << args.log2_n
    points = fixed_base_exp_batch(
        curve, curve.g1, [rng.randrange(1, curve.fr.p) for _ in range(n)],
        device="cuda")
    widths = [int(w) for w in args.widths.split(",")]
    for trial in range(args.trials):
        scalars = [rng.randrange(curve.fr.p) for _ in range(n)]
        canonical = L.encode_canonical(curve.fr, scalars, "cuda")
        sweep = window_sweep(curve, points, canonical, widths, args.rounds)
        print(json.dumps({"trial": trial, "n": n, "rounds": args.rounds,
                          "quartiles_ms": {c: quartiles(v) for c, v in
                                           sweep["times_ms"].items()}}),
              flush=True)
    if args.prove_rounds:
        widths = [int(w) for w in args.prove_widths.split(",")]
        times = prove_sweep(args.log2_n, widths, args.prove_rounds)
        print(json.dumps({"prove_rows": n, "rounds": args.prove_rounds,
                          "quartiles_s": {c: quartiles(v) for c, v in
                                          times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
