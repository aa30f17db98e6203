"""Kernel 6's window, block size and occupancy, measured on the card.

    python3 -m crypto3_zk_tpu_torch.tools.scalar_mul_shapes
        [--log2-n 16] [--rounds 3] [--reps 3] [--out f.json]
        [--g1 3:64,3:128,4:64,4:128] [--g2 3:32,3:64,4:32,4:64]

Kernel 6 (`csrc/scalar_mul.cuh`) keeps a table of 2^(w-1) points a thread
in shared memory, so its window w and its threads a block set how many
warps an SM holds, and with them the registers a thread may take. Each
variant `w:threads[:blocks]` is a build of the group's source
(`scalar_mul.cu` for G1, `scalar_mul_g2.cu` for G2) with the
`ZK_SCALAR_MUL_WINDOW`, `_THREADS` and `_MIN_BLOCKS` macros set (blocks
an SM default to what the table's shared memory lets in); all builds run
together, with `ptxas -v`. For alt_bn128 and bls12-381 and each group,
every variant then multiplies the same 2^log2-n points (64 random points
tiled, one at infinity, one the negative of another) by the same scalars
(random, with `edge_scalars`' lanes at the shipped window): its affine
points must equal the shipped kernel's on every lane and the host's
`g1_mul` / `g2_mul` on the first 32. Then each is timed with CUDA events,
`--reps` launches a sample, in `--rounds` rounds that visit the variants
in an order rotated from round to round, so that a drift of the card's
clock falls on all alike. Prints the card's name and power limit and one JSON
object: per curve, group and variant the shape, registers and spill bytes
of its instance, and its milliseconds. This is how `ScalarMulShape` was
chosen. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import random
import re
import subprocess

import torch

from .. import kernels as K
from ..fields import curves as CV
from ..ops import hopper_curve as HC
from ..ops import points as PT

SOURCE = {"g1": "scalar_mul.cu", "g2": "scalar_mul_g2.cu"}

_ENTRY_FN = re.compile(r"Compiling entry function '([^']*)'")
_KERNEL6 = re.compile(r"scalar_mul_kernelILi(\d+)ELi(\d+)E")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def edge_scalars(r: int, nbits: int, w: int, rng: random.Random) -> dict:
    """Scalars that drive kernel 6's schedule of w-bit signed windows
    (`hopper_curve.signed_digits`) into each of its branches, by what they
    reach. `mid` is the middle window, `top` the top digit's index."""
    nwin = nbits // w + 1
    mid, top_lo = nwin // 2, w * (nwin - 1) - 1   # bit below the top window

    def clear(k, lo, hi):           # bits lo .. hi - 1 to 0
        return k & ~(((1 << (hi - lo)) - 1) << lo)

    d = (-r) % (1 << w)             # the last digit of r + 2d is d
    d -= 1 << w if d >= 1 << (w - 1) else 0
    return {
        # window mid's w + 1 bits all 0: no addition at that step
        "zero digit in the middle": clear(rng.randrange(r), w * mid - 1,
                                          w * mid + w),
        # no bit from the top window's lowest up: acc starts at infinity
        # and the first nonzero digit's addition takes the table's entry
        "zero top digit": rng.randrange(1 << top_lo),
        # the top window's own bits 0, the bit below it 1: the top digit
        # is 1, the carry out of the window under it
        "top digit from the carry": (1 << top_lo) | rng.randrange(1 << top_lo),
        # window mid's bits all 1, the bit below 0: digit -1 (Y negated)
        # and a carry into the window above
        "window of all ones": clear(rng.randrange(r), w * mid - 1,
                                    w * mid + w) | (((1 << w) - 1) << w * mid),
        # acc before the last addition is (k - d) P = d P: add-2007-bl's
        # doubling case
        "last addition meets acc = T[d]": r + 2 * d,
        # acc before the last addition is (r - d) P = -d P: the opposite
        # case, infinity
        "last addition meets acc = -T[d]": r,
        # every window below the top digit 0 but the lowest (-1)
        "all ones": (1 << nbits) - 1,
    }


def parse_ptxas(log: str) -> dict:
    """`ptxas -v` output -> {(nw, deg): {"registers", "spill_stores",
    "spill_loads"}} for every kernel-6 instance in it."""
    out, key = {}, None
    for line in log.splitlines():
        m = _ENTRY_FN.search(line)
        if m:
            k6 = _KERNEL6.search(m.group(1))
            key = (int(k6.group(1)), int(k6.group(2))) if k6 else None
            if key:
                out[key] = {}
            continue
        if key is None:
            continue
        m = _SPILL.search(line)
        if m:
            out[key]["spill_stores"] = int(m.group(1))
            out[key]["spill_loads"] = int(m.group(2))
        m = _REGS.search(line)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


def shape(fn, nw: int) -> dict:
    """The compiled shape of an instance (`zk_scalar_mul_g*_shape`)."""
    s = (ctypes.c_int * 4)()
    K.check(fn(nw, s), "scalar_mul_shape")
    return dict(zip(("window", "threads", "min_blocks", "smem_bytes"), s))


def build_variants(variants: dict) -> dict:
    """{(group, spec): (entry, shape entry, ptxas log)}: each variant built
    from the group's source with its macros, all `nvcc` runs at once."""
    out_dir = K.build_dir() / "shapes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for group, specs in variants.items():
        src = K.CSRC / SOURCE[group]
        for spec in specs:
            parts = [int(x) for x in spec.split(":")]
            defs = [f"-DZK_SCALAR_MUL_WINDOW={parts[0]}",
                    f"-DZK_SCALAR_MUL_THREADS={parts[1]}"]
            if len(parts) > 2:
                defs.append(f"-DZK_SCALAR_MUL_MIN_BLOCKS={parts[2]}")
            tag = hashlib.sha1(K.headers() + src.read_bytes()
                               + " ".join(defs).encode()).hexdigest()[:12]
            lib = out_dir / f"lib{src.stem}-{tag}.so"
            cmd = [K._nvcc(), "-Xptxas=-v", "-gencode",
                   "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", *defs, "-I",
                   str(K.CSRC), "-o", str(lib), str(src)]
            procs.append((group, spec, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    built = {}
    for group, spec, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {group} {spec}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        name = HC.entry_name(group)
        fn, shape_fn = getattr(dll, name), getattr(dll, name + "_shape")
        for f, argtypes in ((fn, K.SOURCES[SOURCE[group]][name]),
                            (shape_fn, [ctypes.c_int, ctypes.c_void_p])):
            f.argtypes, f.restype = argtypes, ctypes.c_int
        built[group, spec] = (fn, shape_fn, log)
    return built


def inputs(curve, group, n: int, seed: int = 16):
    """n Jacobian points on the card (64 random points tiled, lane 4 at
    infinity, lane 9 the negative of lane 8) and n scalar digits: random
    below r, lanes 0 to 3 0, 1, r - 1, 5, then `edge_scalars` at the
    shipped window (`hopper_curve.WINDOW`) from lane 10. Returns (P, k,
    host points, scalars)."""
    rng = random.Random(seed)
    mul = CV.g1_mul if group == "g1" else CV.g2_mul
    neg = CV.g1_neg if group == "g1" else CV.g2_neg
    gen = curve.g1 if group == "g1" else curve.g2
    r = curve.fr.p
    base = [mul(curve, gen, rng.randrange(1, r)) for _ in range(64)]
    pts = [base[i % 64] for i in range(n)]
    pts[4] = None
    pts[9] = neg(curve, pts[8])
    ks = [rng.randrange(r) for _ in range(n)]
    ks[:4] = [0, 1, r - 1, 5]
    edges = edge_scalars(r, curve.fr.bits, HC.WINDOW[group], rng)
    ks[10:10 + len(edges)] = edges.values()
    P = PT.PointVector(curve, group, host=pts).jacobian("cuda")
    return P, PT.scalar_digits(curve.fr, ks, "cuda"), pts, ks


def affine_equal(ops, P, Q) -> bool:
    """Equal affine points on every lane (one batched inversion each)."""
    def planes(A):
        return [c for coord in A[:2]
                for c in (coord if isinstance(coord, tuple) else (coord,))]

    a, b = PT.normalize(ops, P), PT.normalize(ops, Q)
    return all(torch.equal(x, y) for x, y in zip(planes(a), planes(b))) \
        and torch.equal(a[2], b[2])


def _ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(variants: dict, log2_n: int, rounds: int, reps: int) -> dict:
    built = build_variants(variants)
    n = 1 << log2_n
    res = {}
    for curve in (CV.ALT_BN128, CV.BLS12_381):
        nw = curve.fq.nl // 2
        for group, specs in variants.items():
            ops = HC.group_ops(curve, group, "cuda")
            P, k, pts, ks = inputs(curve, group, n)
            want = HC.scalar_mul_batch_hopper(curve, P, k, group)
            mul = CV.g1_mul if group == "g1" else CV.g2_mul
            host = [None if pt is None else mul(curve, pt, ki)
                    for pt, ki in zip(pts[:32], ks[:32])]
            got_host = PT.PointVector.from_jacobian(
                curve, group, want).slice(0, 32).host()
            if got_host != host:
                raise AssertionError(f"kernel 6 disagrees with the host on "
                                     f"{curve.name} {group}")
            rows = {}
            for spec in specs:
                fn, shape_fn, log = built[group, spec]
                run = (lambda fn=fn: HC.run_entry(fn, curve, P, k, group,
                                                  K.stream_ptr()))
                if not affine_equal(ops, run(), want):
                    raise AssertionError(f"variant {spec} disagrees on "
                                         f"{curve.name} {group}")
                rows[spec] = {**shape(shape_fn, nw),
                              **parse_ptxas(log).get(
                                  (nw, 1 if group == "g1" else 2), {}),
                              "ms": [], "run": run}
            for r in range(rounds):
                for j in range(len(specs)):
                    row = rows[specs[(r + j) % len(specs)]]
                    row["ms"].append(_ms(row["run"], reps))
            for row in rows.values():
                del row["run"]
                row["median_ms"] = sorted(row["ms"])[len(row["ms"]) // 2]
            res[f"{curve.name} {group}"] = rows
            del P, k, want
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-n", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--g1", default="3:64,3:128,4:64,4:128")
    ap.add_argument("--g2", default="3:32,3:64,4:32,4:64")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scalar_mul_shapes needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    K.build_all()
    res = measure({"g1": args.g1.split(","), "g2": args.g2.split(",")},
                  args.log2_n, args.rounds, args.reps)
    res["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(res)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
