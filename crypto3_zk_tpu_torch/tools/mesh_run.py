"""The mesh layer on the cards of one machine: `entry.mesh_path` over N
ranks (one card a rank, NCCL), and with `--dryrun` first
`entry.dryrun_multichip(N)`.

    python3 -m crypto3_zk_tpu_torch.tools.mesh_run [--ranks N] [--dryrun] [--out FILE]

N defaults to every card present. Each step is checked against the
single-card function on the same inputs (`entry.py`); the output is the
card's name and power limit, then one JSON line: each rank's seconds by
step, the launches summed over the ranks, the sharded branches' calls, the
wall seconds of each world (spawn and rendezvous included), and the
dryrun's summary.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def run_mesh_path(ranks: int, timeout: float = 900.0, **kwargs) -> dict:
    """`entry.mesh_path` over `ranks` cards: rank 0's result, the launches
    summed over the ranks, every rank's seconds and the world's wall
    seconds."""
    from .. import launch
    t0 = time.perf_counter()
    per_rank = launch.run(ranks, [("crypto3_zk_tpu_torch.entry:mesh_path",
                                   kwargs)], "cuda", timeout)
    wall = time.perf_counter() - t0
    results = [r[0] for r in per_rank]
    launches: dict[str, int] = {}
    for r in results:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"ranks": ranks, "wall_s": wall, "launches": launches,
            "sharded_calls": results[0]["sharded_calls"],
            "seconds_by_rank": [r["seconds"] for r in results]}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=0)
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_run: no CUDA device")
    ranks = args.ranks or torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = {}
    if args.dryrun:
        from ..entry import dryrun_multichip
        t0 = time.perf_counter()
        out["dryrun"] = dryrun_multichip(ranks)
        out["dryrun"]["wall_s"] = time.perf_counter() - t0
    out["mesh_path"] = run_mesh_path(ranks)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(smi + "\n" + line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
