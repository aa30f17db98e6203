"""Kernel 5's lanes form (one thread a state) against an earlier form of it,
and by step, timed on the card.

    python3 -m crypto3_zk_tpu_torch.tools.poseidon_times --parent DIR
        [--rounds 5] [--reps 10] [--out f.json]

DIR is the `csrc/` directory of the commit to compare with (its
`poseidon.cu` and headers, e.g. unpacked from `git archive` into a
directory that `.gitignore` lists). Five builds of `poseidon.cu`, all
`nvcc` runs at once, into `build/crypto3_zk_tpu_torch/poseidon_forms/`:

- `parent`: DIR's source, launched with the dense table (`_const_words`);
- `new`: this checkout's source as the library builds it, with the lanes
  form's table (`_lanes_words`: sparse partial rounds in the original
  flavour);
- `new_mont_sqr`: the same with the S-box's squarings by a Montgomery
  squaring instead of the general product (`tools/mont_sqr.cuh`, inserted
  after `field.cuh`; no kernel of the library uses it);
- `new_reduce_each`: the same with each product of a mix row reduced on its
  own (`mont_dot3` as three `mont_mul` and two `add_mod`);
- `new_6_blocks`: the same with `__launch_bounds__(128, 6)` on the lanes
  form (at most 80 registers a thread).

Over bls12-381 Fr it times each build at 2^17 states and at 64, 2^12, 2^13
and 2^14 (where the form is bound by its chain), and `parent` and `new` on
the nil flavour (Pallas Fq, all rounds full, x^7) at 2^17. Each sample is
the mean of `--reps` launches by CUDA events, queued behind a spin kernel so
that it is device time, over input sets that together pass the 50 MB L2;
`--rounds` rounds visit the builds in an order rotated from round to round.
Every build's output is held against `poseidon_permute_plain` first, at 64
and at 2^17 states, exactly. Prints the card's name and power limit,
`ptxas -v`'s registers and spills of each build's lanes-form instances,
the SASS mix a state of the bls12-381 Fr instance of `new` and of `parent`
(`tools/sass_mix.py`, each loop by its trips) with the carry predicates
each loop's IMAD and IADD3 forms name (`carry_chains`), and one JSON
object: every sample and median (ms). `--sass-out` writes that
instance's SASS. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import subprocess
import time

import torch

from .. import kernels as K
from ..fields import params as P
from ..ops import hopper_hash as HH
from ..ops import nil_poseidon as NPO
from ..ops import poseidon as PO
from . import sass_mix as SM

SOURCE = "poseidon.cu"
SIZES = (64, 1 << 12, 1 << 13, 1 << 14, 1 << 17)
FLUSH_BYTES = 64 << 20

# Each comparison build is the library's source with text replaced (once
# each; a replacement that finds nothing fails the build).
FIELD = '#include "field.cuh"\n'
SQUARE = "    mont_mul<NW>(acc, acc, acc, F);            // the square\n"
REDUCE_EACH = r'''
template <int NW>
__device__ __forceinline__ void mont_dot3_each(
    uint32_t (&r)[NW], const uint32_t (&x0)[NW], const uint32_t (&c0)[NW],
    const uint32_t (&x1)[NW], const uint32_t (&c1)[NW],
    const uint32_t (&x2)[NW], const uint32_t (&c2)[NW],
    const FieldConst<NW>& F) {
  uint32_t t[NW];
  mont_mul<NW>(r, x0, c0, F);
  mont_mul<NW>(t, x1, c1, F);
  add_mod<NW>(r, r, t, F);
  mont_mul<NW>(t, x2, c2, F);
  add_mod<NW>(r, r, t, F);
}
#define mont_dot3 mont_dot3_each
'''
MONT_SQR = (pathlib.Path(__file__).with_name("mont_sqr.cuh").read_text()
            + "\n")
LANES = "__global__ void __launch_bounds__(128)\nposeidon_kernel("
BUILDS = {
    "parent": None,
    "new": [],
    # the S-box's squarings by `mont_sqr.cuh`
    "new_mont_sqr": [(FIELD, FIELD + MONT_SQR),
                     (SQUARE, "    mont_sqr<NW>(acc, acc, F);\n")],
    # each product of a mix row reduced on its own
    "new_reduce_each": [(FIELD, FIELD + REDUCE_EACH)],
    # at most 80 registers a thread, so that 6 blocks fit an SM
    "new_6_blocks": [(LANES, LANES.replace("(128)", "(128, 6)"))],
}


def build(parent: pathlib.Path) -> dict:
    """{build: (entry, ptxas log, library)}, all `nvcc` runs at once, and
    `rate.cu` (the multiply-add rate loop, for its SASS) as "rate", with no
    entry."""
    out_dir = K.build_dir() / "poseidon_forms"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [("rate", K.CSRC / "rate.cu", K.CSRC)]
    for name, edits in BUILDS.items():
        if edits is None:
            jobs.append((name, parent / SOURCE, parent))
            continue
        text = (K.CSRC / SOURCE).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {SOURCE}")
            text = text.replace(old, new, 1)
        tag = hashlib.sha1(K.headers() + text.encode()).hexdigest()[:12]
        src = out_dir / f"poseidon_{name}-{tag}.cu"
        src.write_text(text)
        jobs.append((name, src, K.CSRC))
    procs, t0 = [], time.perf_counter()
    for name, src, inc in jobs:
        lib = out_dir / f"lib{name}.so"
        cmd = [K._nvcc(), "-Xptxas=-v", "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", str(inc), "-o",
               str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    built = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s (all "
              f"builds started together)", flush=True)
        fn = None
        if name != "rate":
            fn = ctypes.CDLL(str(lib)).zk_poseidon_permute
            fn.argtypes = K.SOURCES[SOURCE]["zk_poseidon_permute"]
            fn.restype = ctypes.c_int
        built[name] = (fn, log, lib)
    return built


def ptxas_lanes(log: str) -> dict:
    """`ptxas -v` output -> {instance: {"registers", "spill_stores",
    "spill_loads"}} for every `poseidon_kernel` instance in it (by its
    mangled template arguments)."""
    out, key = {}, None
    for line in log.splitlines():
        f = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([^ ']+)", line)
        if f:
            m = re.match(r"_Z\d+poseidon_kernel(I.*?EE)v", f.group(1))
            key = m.group(1) if m else None
            if key:
                out.setdefault(key, {})
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[key]["spill_stores"] = int(m.group(1))
            out[key]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


def sass_per_state(lib: pathlib.Path, pp, parent: bool) -> dict:
    """The SASS mix a state of the lanes form's instance for `pp`, each
    loop by the number of times its body runs in a thread: the new form's
    staging loop, full rounds and partial rounds; the parent's staging
    loop, the loop that finds alpha's top bit, its round loop and its three
    S-box loops (square-and-multiply on alpha's bits below the top one:
    element 0's every round, elements 1 and 2's in full rounds)."""
    nw = K.words(pp.fs.nl)
    rounds = len(pp.round_constants)
    lo, hi = pp.partial_rounds
    if parent:
        name, piece = f"_Z15poseidon_kernelILi{nw}EEv", 1
        entries = rounds * 3 + 9
        bits = pp.alpha.bit_length() - 1
        full = rounds - (hi - lo)
        # after the staging loop, the one that finds alpha's top bit
        trips = [bits, rounds, rounds * bits, full * bits, full * bits]
    else:
        name = f"_Z15poseidon_kernelILi{nw}ELi{pp.alpha}ELb1E"
        piece = 4 if nw % 4 == 0 else 2
        entries = (rounds - (hi - lo)) * 3 + 18 + (hi - lo) * 6
        trips = [rounds - (hi - lo), hi - lo]
    stage = -(-entries * nw // piece // 128)
    found = [v for k, v in SM.disassemble(str(lib)).items()
             if k.startswith(name)]
    if len(found) != 1:
        raise ValueError(f"{name}: {len(found)} kernels in {lib}")
    spans = SM.loops(found[0])
    if len(spans) != len(trips) + 1:
        return {"loops": len(spans), "error": "loop count differs from "
                f"the schedule's {len(trips) + 1}"}
    per = SM.mix(found[0], [stage] + trips)
    per["carry_chains"] = carry_chains(found[0])
    return per


def carry_chains(instructions: list[tuple[int, str, str]]) -> list[dict]:
    """Whether `ptxas` runs independent carry chains side by side, read off
    each loop of a kernel. The carrying IMAD and IADD3 forms name their
    carry-out as the predicate (P0 to P6) beside the destination, and read
    a carry-in, in a `.X` form, as their last plain predicate operand. For
    each read: how many carrying instructions after the write it comes.
    One chain after another reads every carry from the instruction just
    before (`next`); chains run side by side read it from further back
    (`apart`). Also: how many carrying instructions a loop has and how
    often it writes each predicate."""
    out = []
    for start, end in SM.loops(instructions):
        preds: dict[str, int] = {}
        writer: dict[str, int] = {}
        k = adjacent = apart = 0
        for addr, op, args in instructions:
            if not start <= addr <= end or not op.startswith(("IMAD",
                                                              "IADD3")):
                continue
            ops = [x.strip() for x in args.split(",")]
            wrote = ops[1] if len(ops) > 1 and re.fullmatch(r"P[0-6]",
                                                            ops[1]) else None
            ins = [x for x in ops[2:] if re.fullmatch(r"P[0-6]", x)]
            read = ins[-1] if ".X" in op and ins else None
            if wrote is None and read is None:
                continue
            if read in writer:
                adjacent += k - writer[read] == 1
                apart += k - writer[read] > 1
            if wrote:
                writer[wrote] = k
                preds[wrote] = preds.get(wrote, 0) + 1
            k += 1
        out.append({"span": [start, end], "carrying": k, "predicates": preds,
                    "next": adjacent, "apart": apart})
    return out


def rand_states(fs, n: int, gen) -> torch.Tensor:
    """(NL, 3, n) elements below p."""
    x = torch.randint(0, 1 << 16, (fs.nl, 3, n), generator=gen,
                      device="cuda", dtype=torch.int32)
    x[-1] = torch.randint(0, int(fs.p_limbs[-1]), (3, n), generator=gen,
                          device="cuda", dtype=torch.int32)
    return x


def launcher(fn, pp, table: torch.Tensor, sets: list):
    """(launch(i) on input set i, the outputs): the lanes form (form 0) of
    the entry `fn` over whole states, as `poseidon_permute_hopper` calls
    it."""
    fs = pp.fs
    nw, fconsts = K.field_consts(fs)
    sched = HH._schedule(pp, False)
    outs, args = [], []
    for x in sets:
        ptrs, strides = HH.plane_args((x[:, 0], x[:, 1], x[:, 2]),
                                      (None, None))
        out = torch.empty_like(x)
        outs.append(out)
        args.append((nw, fconsts, ptrs, strides, sched, table.data_ptr(),
                     out.data_ptr(), x.shape[-1], 0))

    def launch(i: int) -> None:
        K.check(fn(*args[i % len(args)], K.stream_ptr()),
                "zk_poseidon_permute")

    return launch, outs


def sample_ms(launch, n_sets: int, reps: int) -> float:
    """Mean device ms of `reps` launches queued behind a spin kernel (the
    spin lengthened until it outlasts the host's enqueueing)."""
    launch(0)
    torch.cuda.synchronize()
    spin = 20_000_000
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for r in range(reps):
            launch(r % n_sets)
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        spin *= 4
    raise RuntimeError("the stream drained during a timed loop")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the csrc/ directory of the form to compare with")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass-out", default=None,
                    help="write the SASS of the bls12-381 Fr lanes-form "
                         "instance here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("poseidon_times: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {card}", flush=True)
    built = build(pathlib.Path(args.parent))
    for name, (_, log, _) in built.items():
        if name != "rate":
            print(f"{name}: ptxas -v of the lanes form: {ptxas_lanes(log)}",
                  flush=True)
    pp = PO.get_params(P.BLS12_381_FR)
    npp = NPO.get_params(P.PALLAS_FQ)
    sass = {"new": sass_per_state(built["new"][2], pp, False),
            "parent": sass_per_state(built["parent"][2], pp, True)}
    rate = [v for k, v in SM.disassemble(str(built["rate"][2])).items()
            if "imad_loop_kernel" in k]
    # one trip of its loop: 16 `mad.lo.cc` / `madc.hi.cc` pairs
    sass["rate_loop_trip"] = SM.mix(rate[0], 1) if len(rate) == 1 else None
    print(f"SASS a state, bls12-381 Fr: {json.dumps(sass)}", flush=True)
    if args.sass_out:
        with open(args.sass_out, "w") as f:
            for k, v in SM.disassemble(str(built["new"][2])).items():
                if k.startswith("_Z15poseidon_kernelILi8ELi5ELb1E"):
                    f.write(k + "\n" + "\n".join(
                        f"{a:#06x} {op} {args}" for a, op, args in v) + "\n")
    print(f"counts a state: {HH.lanes_counts(pp)}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    cases = {}
    for label, params, names in (("bls12_381_fr", pp, list(BUILDS)),
                                 ("nil_pallas_fq", npp, ["parent", "new"])):
        fs = params.fs
        sizes = SIZES if label == "bls12_381_fr" else (1 << 17,)
        for n in sizes:
            n_sets = min(64, max(2, -(-FLUSH_BYTES
                                      // (3 * fs.nl * 4 * n))))
            sets = [rand_states(fs, n, gen) for _ in range(n_sets)]
            for name in names:
                table = (HH._const_words if name == "parent"
                         else HH._lanes_words)(params, "cuda")
                launch, outs = launcher(built[name][0], params, table, sets)
                cases[(label, n, name)] = (launch, n_sets)
                if n in (64, 1 << 17):
                    launch(0)
                    torch.cuda.synchronize()
                    want = HH.poseidon_permute_plain(
                        params, (sets[0][:, 0], sets[0][:, 1], sets[0][:, 2]))
                    if not torch.equal(outs[0], want):
                        raise AssertionError(f"{name} differs from the plain "
                                             f"version ({label}, n = {n})")
            print(f"{label} at {n} states: every build equals the plain "
                  f"version" if n in (64, 1 << 17) else
                  f"{label} at {n} states: ready", flush=True)
    keys = list(cases)
    times = {k: [] for k in keys}
    for r in range(args.rounds):
        for k in keys[r % len(keys):] + keys[:r % len(keys)]:
            launch, n_sets = cases[k]
            times[k].append(sample_ms(launch, n_sets, args.reps))
    median = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    for k in keys:
        print(f"{k[0]} {k[1]} states {k[2]}: median {median[k]:.4f} ms, "
              "samples " + ", ".join(f"{t:.4f}" for t in times[k]),
              flush=True)
    result = {"card": card, "rounds": args.rounds, "reps": args.reps,
              "ptxas": {n: ptxas_lanes(b[1]) for n, b in built.items()
                        if n != "rate"},
              "sass_per_state": sass, "counts": HH.lanes_counts(pp),
              "ms": {"/".join(map(str, k)): v for k, v in times.items()},
              "median_ms": {"/".join(map(str, k)): v
                            for k, v in median.items()}}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
