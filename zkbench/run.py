"""Run one cell of the port's benchmark once and print its result.

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a prover service under closed-loop traffic: set-up builds and
preprocesses the cell's circuit and a pool of witnesses, then the window
proves witness after witness for `--seconds` seconds; the reference judges
the proofs once the window has closed. The last line of standard output is
one JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` also `breakdown`, and last `checks`: each number compared
beside its limit, which standard error's last lines repeat). `--control 1`
runs the program's control path instead (see PERF.md); the benchmark's own
runs never pass it. Needs a CUDA card: without one it exits 1 and prints no
result.
"""
import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# Every cache of torch and of the kernels' toolchain in a fixed directory of
# the checkout: the port builds its kernels into build/crypto3_zk_tpu_torch/.
CACHES = {
    "TORCH_EXTENSIONS_DIR": "build/zkbench/torch_extensions",
    "TRITON_CACHE_DIR": "build/zkbench/triton",
    "TORCHINDUCTOR_CACHE_DIR": "build/zkbench/inductor",
    "CUDA_CACHE_PATH": "build/zkbench/cuda_cache",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT))
    from zkbench import harness

    found = harness.banned_modules()
    if found:
        print("run.py: loaded at start: " + ", ".join(found), file=sys.stderr)
        return 1
    import torch
    bench = harness.load_benchmark()
    workload = harness.load_json("workloads", args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < workload["chips"]:
        print("run.py: the cell needs %d CUDA card(s)" % workload["chips"],
              file=sys.stderr)
        return 1
    try:
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        card = torch.cuda.get_device_name(0) + ", power limit not read"
    print(f"card: {card}", file=sys.stderr, flush=True)

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), PROCESS_START,
                              control=bool(args.control), bench=bench)
    found = harness.banned_modules()
    if found:
        print("run.py: loaded: " + ", ".join(found), file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
