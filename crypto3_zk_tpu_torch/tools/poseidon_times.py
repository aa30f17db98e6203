"""Kernel 5's three forms against an earlier commit's, timed on the card.

    python3 -m crypto3_zk_tpu_torch.tools.poseidon_times --parent DIR
        [--rounds 5] [--reps 10] [--out f.json] [--sass-out DIR]

DIR is the `csrc/` directory of the commit to compare with (its
`poseidon.cu` and headers, e.g. unpacked from `git archive` into a
directory that `.gitignore` lists). Two builds of `poseidon.cu`, both
`nvcc` runs at once, into `build/crypto3_zk_tpu_torch/poseidon_forms/`:
`parent` (DIR's source) and `new` (this checkout's, as the library builds
it). Every form of `new` reads `_table_words` (sparse partial rounds in the
original flavour); the parent's shared and tree forms read it too where
DIR's source has the sparse partial round (`partial_round_shared`), else
the dense table (`_const_words`, the textbook schedule).

Over bls12-381 Fr it times the lanes form of both at `SIZES` (64 to 2^14
states, where the form is bound by its chain, and 2^17), the shared form
from 32 to 2^17 states and the tree form on a first level of 32 states;
on the nil flavour (Pallas Fq, all rounds full, x^7) the lanes form at
2^17 states, the shared form at 2^12 and the tree on 32. Each sample is
the mean of `--reps` launches by CUDA events, queued behind a spin kernel
so that it is device time, over input sets that together pass the 50 MB
L2; `--rounds` rounds visit the cases in an order rotated from round to
round. Every build's output is held against `poseidon_permute_plain` (the
tree's against the plain version level by level) first, exactly, at the
smallest and largest size of each form. Prints the card's name and power
limit, `ptxas -v`'s registers and spills of each build's instances of
every form, the SASS mix a state of the bls12-381 Fr lanes-form instance
of `new` and `parent` and a thread's of the shared form of `new`
(`tools/sass_mix.py`, each loop by its trips) with the carry predicates
each loop's IMAD and IADD3 forms name (`carry_chains`), and one JSON
object: every sample and median (ms). `--sass-out DIR` writes the SASS of
each build's Poseidon kernels there, one file a build. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re

import torch

from .. import kernels as K
from ..fields import params as P
from ..ops import hopper_hash as HH
from ..ops import nil_poseidon as NPO
from ..ops import poseidon as PO
from . import sass_mix as SM
from . import timing as T

SOURCE = "poseidon.cu"
BUILDS = ("parent", "new")
SIZES = (64, 1 << 12, 1 << 13, 1 << 14, 1 << 17)
SHARED_SIZES = (32, 64, 128, 1 << 12, 1 << 13, 1 << 14, 1 << 17)
TREE_STATES = (32,)
FLUSH_BYTES = 64 << 20
# the nil flavour's cases: (form, states)
NIL_PLAN = (("lanes", 1 << 17), ("shared", 1 << 12), ("tree", 32))


def build(parent: pathlib.Path) -> dict:
    """{build: ({entry name: entry}, ptxas log, library)}, all `nvcc` runs
    at once, and `rate.cu` (the multiply-add rate loop, for its SASS) as
    "rate", with no entry."""
    out_dir = K.build_dir() / "poseidon_forms"
    libs = T.nvcc_all([(name, src, out_dir / f"lib{name}.so", ())
                       for name, src in (("rate", K.CSRC / "rate.cu"),
                                         ("parent", parent / SOURCE),
                                         ("new", K.CSRC / SOURCE))])
    return {name: ({} if name == "rate" else T.bind(lib, K.SOURCES[SOURCE]),
                   log, lib) for name, (lib, log) in libs.items()}


def ptxas_forms(log: str) -> dict:
    """`ptxas -v` output -> {kernel instance (mangled name from the form's
    name on): {"registers", "spill_stores", "spill_loads", "stack_frame"}}
    for every instance of each form in it."""
    def key_of(function: str):
        m = re.match(r"_Z\d+(poseidon_\w*?kernel\w*?EE)v", function)
        return m.group(1) if m else None
    return T.ptxas_table(log, key_of)


def sass_per_thread(lib: pathlib.Path, pp, kernel: str) -> dict:
    """The SASS mix a thread of the bls12-381 Fr instance of `kernel`
    ("poseidon_kernel", one thread a state, or "poseidon_shared_kernel",
    three), each loop by the number of times its body runs in a thread:
    the staging loop, the shared form's unit rows (once), the full rounds
    and the partial rounds."""
    nw = K.words(pp.fs.nl)
    rounds = len(pp.round_constants)
    lo, hi = pp.partial_rounds
    name = f"_Z{len(kernel)}{kernel}ILi{nw}ELi{pp.alpha}ELb1E"
    piece = 4 if nw % 4 == 0 else 2
    entries = (rounds - (hi - lo)) * 3 + 18 + (hi - lo) * 6
    trips = [rounds - (hi - lo), hi - lo]
    if kernel == "poseidon_shared_kernel":
        trips = [1] + trips
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


def launcher(fns: dict, pp, table: torch.Tensor, form: str, sets: list):
    """(launch(i) on input set i, the outputs, the plain outputs of set 0):
    the form "lanes" or "shared" of the entry over whole states, as
    `poseidon_permute_hopper` calls it; "tree" on digests (NL, 2S), every
    level, as `poseidon_tree_hopper` calls it."""
    fs = pp.fs
    nw, fconsts = K.field_consts(fs)
    outs, args = [], []
    for x in sets:
        if form == "tree":
            s = x.shape[-1] // 2
            levels = [torch.empty((fs.nl, s >> lvl), dtype=torch.int32,
                                  device=x.device)
                      for lvl in range(s.bit_length())]
            ptrs, strides = HH.plane_args((x[:, 0::2], x[:, 1::2], None),
                                          (None, None))
            lv = (ctypes.c_void_p * len(levels))(*[o.data_ptr()
                                                   for o in levels])
            outs.append(levels)
            args.append((nw, fconsts, ptrs, strides, HH._schedule(pp, True),
                         table.data_ptr(), lv, s, len(levels)))
            continue
        ptrs, strides = HH.plane_args((x[:, 0], x[:, 1], x[:, 2]),
                                      (None, None))
        out = torch.empty_like(x)
        outs.append(out)
        args.append((nw, fconsts, ptrs, strides, HH._schedule(pp, False),
                     table.data_ptr(), out.data_ptr(), x.shape[-1],
                     0 if form == "lanes" else 1))
    entry = "zk_poseidon_tree" if form == "tree" else "zk_poseidon_permute"
    fn = fns[entry]

    def launch(i: int) -> None:
        K.check(fn(*args[i % len(args)], K.stream_ptr()), entry)

    def plain():
        x = sets[0]
        if form != "tree":
            return HH.poseidon_permute_plain(pp, (x[:, 0], x[:, 1], x[:, 2]))
        levels = []              # one plain permutation a level, any S
        while x.shape[1] > 1:
            x = HH.poseidon_permute_plain(pp, (x[:, 0::2], x[:, 1::2], None),
                                          lane0_only=True)
            levels.append(x)
        return levels

    return launch, outs, plain


def rand_digests(fs, n: int, gen) -> torch.Tensor:
    """(NL, n) elements below p."""
    return rand_states(fs, n, gen)[:, 0].contiguous()


def cases_for(built: dict, label: str, pp, gen, dense_parent: bool) -> dict:
    """{(label, form, states, build): (launch, input sets)} for every case
    of the parameter set, each build's output held against the plain
    version first at the smallest and the largest size of each form.
    `dense_parent`: the parent's shared and tree forms read the dense
    table."""
    fs = pp.fs
    if label == "bls12_381_fr":
        plan = [("lanes", n) for n in SIZES]
        plan += [("shared", n) for n in SHARED_SIZES]
        plan += [("tree", s) for s in TREE_STATES]
    else:
        plan = NIL_PLAN
    checked = {}
    for form, n in plan:
        if form == "tree":
            n_sets = 8
            sets = [rand_digests(fs, 2 * n, gen) for _ in range(n_sets)]
        else:
            n_sets = min(64, max(2, -(-FLUSH_BYTES
                                      // (3 * fs.nl * 4 * n))))
            sets = [rand_states(fs, n, gen) for _ in range(n_sets)]
        sizes = [m for f, m in plan if f == form]
        check = n in (min(sizes), max(sizes))
        for name in BUILDS:
            dense = dense_parent and name == "parent" and form != "lanes"
            table = (HH._const_words if dense else HH._table_words)(pp,
                                                                   "cuda")
            launch, outs, plain = launcher(built[name][0], pp, table, form,
                                           sets)
            checked[(label, form, n, name)] = (launch, n_sets)
            if check:
                launch(0)
                torch.cuda.synchronize()
                got, want = outs[0], plain()
                same = (all(torch.equal(g, w) for g, w in zip(got, want))
                        and len(got) == len(want)) if form == "tree" \
                    else torch.equal(got, want)
                if not same:
                    raise AssertionError(f"{name} ({form}) differs from the "
                                         f"plain version ({label}, {n})")
        print(f"{label} {form} at {n} states: "
              + ("every build equals the plain version" if check
                 else "ready"), flush=True)
    return checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the csrc/ directory of the form to compare with")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass-out", default=None,
                    help="a directory for the SASS of each build's "
                         "Poseidon kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("poseidon_times: no CUDA device")
    card = T.card_name()
    print(f"device: {card}", flush=True)
    built = build(pathlib.Path(args.parent))
    ptxas = {n: ptxas_forms(b[1]) for n, b in built.items() if n != "rate"}
    for name, forms in ptxas.items():
        print(f"{name}: ptxas -v: {forms}", flush=True)
    pp = PO.get_params(P.BLS12_381_FR)
    npp = NPO.get_params(P.PALLAS_FQ)
    sass = {"new": sass_per_thread(built["new"][2], pp, "poseidon_kernel"),
            "parent": sass_per_thread(built["parent"][2], pp,
                                      "poseidon_kernel"),
            "new_shared_per_thread": sass_per_thread(
                built["new"][2], pp, "poseidon_shared_kernel")}
    rate = [v for k, v in SM.disassemble(str(built["rate"][2])).items()
            if "imad_loop_kernel" in k]
    # one trip of its loop: 16 `mad.lo.cc` / `madc.hi.cc` pairs
    sass["rate_loop_trip"] = SM.mix(rate[0], 1) if len(rate) == 1 else None
    print(f"SASS, bls12-381 Fr: {json.dumps(sass)}", flush=True)
    if args.sass_out:
        out_dir = pathlib.Path(args.sass_out)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, (_, _, lib) in built.items():
            if name == "rate":
                continue
            with open(out_dir / f"{name}.sass", "w") as f:
                for k, v in SM.disassemble(str(lib)).items():
                    if "poseidon" in k:
                        f.write(k + "\n" + "\n".join(
                            f"{a:#06x} {op} {o}" for a, op, o in v) + "\n")
    counts = {"lanes": HH.lanes_counts(pp), "shared": HH.shared_counts(pp)}
    print(f"counts a state: {counts}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    # a parent from before the shared forms' sparse rounds runs them on the
    # dense table, the textbook schedule
    dense = "partial_round_shared" not in (pathlib.Path(args.parent)
                                           / SOURCE).read_text()
    cases = cases_for(built, "bls12_381_fr", pp, gen, dense)
    cases.update(cases_for(built, "nil_pallas_fq", npp, gen, dense))
    keys = list(cases)
    times = {k: [] for k in keys}
    for r in range(args.rounds):
        for k in keys[r % len(keys):] + keys[:r % len(keys)]:
            launch, n_sets = cases[k]
            times[k].append(T.sample_ms(launch, n_sets, args.reps))
    median = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    for k in keys:
        print(f"{k[0]} {k[1]} {k[2]} states {k[3]}: median {median[k]:.4f} "
              "ms, samples " + ", ".join(f"{t:.4f}" for t in times[k]),
              flush=True)
    result = {"card": card, "rounds": args.rounds, "reps": args.reps,
              "ptxas": ptxas, "sass": sass, "counts": counts,
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
