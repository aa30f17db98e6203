"""Kernel 7's forms against an earlier commit's, timed on the card, beside
the integer streams its design rests on.

    python3 -m crypto3_zk_tpu_torch.tools.sha256_times --parent DIR
        [--rounds 5] [--reps 10] [--out f.json]

DIR is the `csrc/` directory of the commit to compare with (its
`sha256.cu`, e.g. unpacked from `git archive` into a directory that
`.gitignore` lists). Builds of `sha256.cu` and `sha256_leaf.cu` (where
the directory has it), every `nvcc` run at once with the library's own
build (`kernels.build_all`), into
`build/crypto3_zk_tpu_torch/sha256_forms/`: `parent` (DIR's sources) and
`new` (this checkout's, as the library builds it).

It prints the card's name and power limit, the rates of `csrc/rate.cu`'s
eleven streams (funnel shifts, `IMAD`, `IMAD.HI`, `LOP3` and `IADD3`
alone and in pairs; lane-instructions a second, `timing.py::int_rates`)
beside the issue rate (4 schedulers x 32 lanes x SMs x the highest SM
clock) and the SASS of each stream's loop; `ptxas -v`'s registers and
spills of each build's kernel-7 kernels; each build's SASS a message
(`tools/sass_mix.py`, each loop by its trips) with its per-pipe floor.
Then, on 2^18 messages: the block form on 256-byte messages (the sha2
path's leaves, 8 bls12-381 Fr values: 5 blocks read, "blocks", and for
builds that have the padding schedule 4 read and the fifth from it,
"blocks_pad"), the node form (a level of 2^19 random digests read in
place) and the leaf form (2^18 leaves of 8 bls12-381 Fr values from
their digit planes), each build's output first held exactly against the
plain version; the same at the small sizes where most of the sha2 path's
launches are (`SMALL`: node levels of 64 and 2^12 pairs, 64-byte leaves
of two bls12-381 Fr values, 2^10 and 2^16 of them); `--rounds` rounds
visit the cases in an order rotated from round to round, each sample the
mean of `--reps` launches queued behind a spin kernel, over input sets
that together pass the 50 MB L2. Last, leaf hashing from Montgomery rows
to digests, both ways: the parent's (the `int64` glue of
`field_rows_to_bytes` and `pad_messages`, then the parent's block form)
and this checkout's (`from_mont`, then the leaf form), device wall ms
(the host's launches included) and device ms by kernel
(`torch.profiler`). One JSON object at the end. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib

import torch

from .. import kernels as K
from ..fields import params as P
from ..ops import limbs as L
from ..ops import sha256 as SH
from . import sass_mix as SM
from . import timing as T

SOURCES = ("sha256.cu", "sha256_leaf.cu")
N = 1 << 18                  # messages: the sha2 path's leaves and levels
LEAF_K = 8                   # bls12-381 Fr elements a leaf (256 bytes)
FLUSH_BYTES = 64 << 20
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the entry points of a source without the padding schedule (the first form)
_OLD_ENTRIES = {"zk_sha256_blocks": [_P, _LL, _I, _P, _P],
                "zk_sha256_nodes": [_P, _LL, _P, _P]}


def build(parent: pathlib.Path) -> dict:
    """{build: (entries, ptxas log, {source: library}, has the padding
    schedule)}: each build compiles `sha256.cu` and, where its directory has
    it, `sha256_leaf.cu`; the library's own build (`kernels.build_all`) runs
    beside them."""
    out_dir = K.build_dir() / "sha256_forms"
    dirs = {"parent": parent, "new": K.CSRC}
    jobs = [(f"{name} {source}", d / source,
             out_dir / f"lib{name}-{pathlib.Path(source).stem}.so", ())
            for name, d in dirs.items() for source in SOURCES
            if (d / source).exists()]
    libs = T.nvcc_all(jobs, meanwhile=K.build_all)
    built = {}
    for name, d in dirs.items():
        padded = _has_pad(d)
        fns, log, lib_of = {}, "", {}
        for source in SOURCES:
            if f"{name} {source}" not in libs:
                continue
            lib, text = libs[f"{name} {source}"]
            fns.update(T.bind(lib, K.SOURCES[source] if padded
                              else _OLD_ENTRIES))
            log += text
            lib_of[source] = lib
        built[name] = (fns, log, lib_of, padded)
    return built


def _has_pad(src_dir: pathlib.Path) -> bool:
    """Whether the `sha256.cu` of `src_dir` takes the padding schedule (the
    first form of kernel 7 does not)."""
    text = (src_dir / "sha256.cu").read_text()
    if (src_dir / "sha256.cuh").exists():
        text += (src_dir / "sha256.cuh").read_text()
    return "ZkSha256Pad" in text


def ptxas_kernels(log: str) -> dict:
    """`ptxas -v` output -> {kernel-7 kernel (mangled): registers, spills}."""
    return T.ptxas_table(log, lambda f: f if "sha256" in f else None)


def kernel_mix(lib, kernel: str, trips) -> dict:
    found = [v for k, v in SM.disassemble(str(lib)).items() if kernel in k]
    if len(found) != 1:
        raise ValueError(f"{kernel}: {len(found)} matches in {lib}")
    return SM.mix(found[0], trips)


def sass_mixes(libs: dict, padded: bool) -> dict:
    """A message's SASS mix of each form at the timed shapes: the block
    form on 5 blocks (4 and the padding block where it has the schedule),
    the node form, the leaf form's 16-halfword instance on 8 elements (4
    full blocks, no tail block)."""
    lib = libs["sha256.cu"]
    out = {"blocks": kernel_mix(lib, "sha256_blocks_kernel",
                                4 if padded else 5),
           "nodes": kernel_mix(lib, "sha256_nodes_kernel", 1)}
    if "sha256_leaf.cu" in libs:
        out["leaf"] = kernel_mix(libs["sha256_leaf.cu"],
                                 "sha256_field_rows_kernelILi16E", [4, 0])
    return out


def leaf_digits(gen, k: int, n: int):
    """(Montgomery rows (k, NL, n), their digits (NL, k, n)) of bls12-381
    Fr values below p."""
    fs = P.BLS12_381_FR
    x = torch.randint(0, 1 << 16, (k, fs.nl, n), generator=gen,
                      device="cuda", dtype=torch.int32)
    x[:, -1] = torch.randint(0, int(fs.p_limbs[-1]), (k, n), generator=gen,
                             device="cuda", dtype=torch.int32)
    return x, L.from_mont(fs, x.permute(1, 0, 2))


def forms_of(fns: dict, padded: bool, words, levels, rows, out) -> dict:
    """{form: call(i) on input set i} of one build's entry points."""
    nb = SH.padded_blocks(32 * LEAF_K)
    kw64 = ctypes.addressof(SH._padding_arg(64))
    kw256 = ctypes.addressof(SH._padding_arg(32 * LEAF_K))
    blocks, nodes = fns["zk_sha256_blocks"], fns["zk_sha256_nodes"]
    st = K.stream_ptr

    def o():
        return out.data_ptr()      # the closure keeps `out` alive

    if not padded:
        return {"blocks": lambda i: blocks(words[i].data_ptr(), N, nb, o(),
                                           st()),
                "nodes": lambda i: nodes(levels[i].data_ptr(), N, o(), st())}
    forms = {"blocks": lambda i: blocks(words[i].data_ptr(), N, nb, None, o(),
                                        st()),
             "blocks_pad": lambda i: blocks(words[i].data_ptr(), N, nb - 1,
                                            kw256, o(), st()),
             "nodes": lambda i: nodes(levels[i].data_ptr(), N, kw64, o(),
                                      st())}
    if "zk_sha256_field_rows" in fns:
        leaf = fns["zk_sha256_field_rows"]
        forms["leaf"] = lambda i: leaf(rows[i][1].data_ptr(), N, LEAF_K, 16,
                                       LEAF_K * N, N, kw256, o(), st())
    return forms


def cases_for(built: dict, gen) -> tuple[dict, dict]:
    """({(form, build): (launch, n_sets)}, {form: plain output of set 0});
    each build's output held exactly against the plain version first."""
    fs = P.BLS12_381_FR
    nb = SH.padded_blocks(32 * LEAF_K)
    n_sets = max(2, -(-FLUSH_BYTES // (16 * nb * 4 * N)))
    msgs = [torch.randint(0, 256, (N, 32 * LEAF_K), generator=gen,
                          device="cuda", dtype=torch.int64)
            for _ in range(n_sets)]
    words = [SH.pad_messages(m) for m in msgs]
    del msgs
    levels = [torch.randint(-(1 << 31), 1 << 31, (8, 2 * N), generator=gen,
                            device="cuda", dtype=torch.int32)
              for _ in range(n_sets)]
    rows = [leaf_digits(gen, LEAF_K, N) for _ in range(n_sets)]
    want = {"blocks": SH.sha256_blocks_plain(words[0]),
            "nodes": SH.sha256_nodes_plain(levels[0]),
            "leaf": SH.sha256_field_rows_plain(fs, rows[0][0])}
    want["blocks_pad"] = want["blocks"]
    out = torch.empty((8, N), dtype=torch.int32, device="cuda")
    cases = {}
    for name, (fns, _, _, padded) in built.items():
        for form, fn in forms_of(fns, padded, words, levels, rows,
                                 out).items():
            def launch(i, fn=fn, what=f"{name} {form}"):
                K.check(fn(i), what)
            launch(0)
            torch.cuda.synchronize()
            if not torch.equal(out, want[form]):
                raise AssertionError(f"{name} ({form}) differs from the "
                                     f"plain version")
            cases[(form, name)] = (launch, n_sets)
        print(f"{name}: equal to the plain version at {N} messages",
              flush=True)
    return cases, {"rows": rows, "words_per_set": words}


def device_kernels(fn) -> dict:
    """One call of `fn` under `torch.profiler`: the device ms of every kernel
    and copy it launched, by name, and their sum."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            kernels[evt.key[:80]] = {"calls": evt.count, "device_ms": us / 1e3}
    return {"device_ms": sum(k["device_ms"] for k in kernels.values()),
            "kernels": kernels}


# small launches, where the sha2 path's node levels and FRI leaves mostly
# are: (form, messages); "leaf2" is a leaf of two bls12-381 Fr values (64
# bytes, a FRI round's leaf): the leaf form on its digits, or the parent's
# block form on its padded words
SMALL = (("nodes", 64), ("nodes", 1 << 12), ("leaf2", 1 << 10),
         ("leaf2", 1 << 16))


def small_cases(built: dict, gen, n_sets: int = 4) -> dict:
    """{(f"{form}@{n}", build): (launch, n_sets)} for `SMALL`, each build's
    output held exactly against the plain version first."""
    fs = P.BLS12_381_FR
    kw64 = ctypes.addressof(SH._padding_arg(64))
    cases = {}
    for form, n in SMALL:
        out = torch.empty((8, n), dtype=torch.int32, device="cuda")
        if form == "nodes":
            sets = [torch.randint(-(1 << 31), 1 << 31, (8, 2 * n),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32) for _ in range(n_sets)]
            want = SH.sha256_nodes_plain(sets[0])
        else:
            sets = [leaf_digits(gen, 2, n) for _ in range(n_sets)]
            words = [SH.pad_messages(SH.field_rows_to_bytes(fs, r[0]))
                     for r in sets]
            want = SH.sha256_field_rows_plain(fs, sets[0][0])
        for name, (fns, _, _, padded) in built.items():
            # (input tensor, the arguments after its pointer) a set; the
            # closure keeps the tensors alive
            if form == "nodes":
                f = fns["zk_sha256_nodes"]
                args = [(x, (n,) + ((kw64,) if padded else ()))
                        for x in sets]
            elif "zk_sha256_field_rows" in fns:
                f = fns["zk_sha256_field_rows"]
                args = [(x[1], (n, 2, 16, 2 * n, n, kw64)) for x in sets]
            else:
                f = fns["zk_sha256_blocks"]
                args = [(w, (n, 2)) for w in words]

            def launch(i, f=f, args=args, out=out,
                       what=f"{name} {form}@{n}"):
                x, rest = args[i]
                K.check(f(x.data_ptr(), *rest, out.data_ptr(),
                          K.stream_ptr()), what)
            launch(0)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} ({form} at {n}) differs from "
                                     f"the plain version")
            cases[(f"{form}@{n}", name)] = (launch, n_sets)
    print(f"small launches {SMALL}: every build equal to the plain version",
          flush=True)
    return cases


def leaf_hashing(fs, rows: list, reps: int, ways: dict) -> dict:
    """Leaf hashing from Montgomery rows (k, NL, n) to digests, each way in
    `ways` ({name: fn(rows) -> digests}): all equal; wall ms (CUDA events
    around `reps` calls, the host's launches and copies included, the
    median of 5) and the device ms of one call by kernel (`torch.profiler`;
    the ways copy small constants from the host, so they cannot be queued
    behind a spin kernel)."""
    want = None
    out = {}
    for name, fn in ways.items():
        got = fn(rows[0])
        torch.cuda.synchronize()
        if want is None:
            want = got
        elif not torch.equal(got, want):
            raise AssertionError(f"leaf hashing {name} differs")
        times = sorted(T.sample_ms(lambda i: fn(rows[i]), len(rows), reps,
                                 queued=False) for _ in range(5))
        out[name] = {"wall_ms": times[2],
                     **device_kernels(lambda: fn(rows[0]))}
    return out


def leaf_paths(built: dict, rows: list, reps: int) -> dict:
    """`leaf_hashing` the parent's way (the `int64` glue of
    `field_rows_to_bytes` and `pad_messages`, then the parent's block form)
    and this checkout's (`from_mont`, then the leaf form)."""
    fs = P.BLS12_381_FR
    nb = SH.padded_blocks(32 * LEAF_K)
    old_blocks = built["parent"][0]["zk_sha256_blocks"]
    old_padded = built["parent"][3]

    def before(x):
        words = SH.pad_messages(SH.field_rows_to_bytes(fs, x))
        out = torch.empty((8, N), dtype=torch.int32, device="cuda")
        args = (words.data_ptr(), N, nb) + ((None,) if old_padded else ())
        K.check(old_blocks(*args, out.data_ptr(), K.stream_ptr()), "parent")
        return out

    return leaf_hashing(fs, [r[0] for r in rows], reps, {
        "before_glue_and_blocks": before,
        "after_from_mont_and_leaf":
            lambda x: SH.sha256_field_rows_hopper(fs, x)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the csrc/ directory of the form to compare with")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sha256_times: no CUDA device")
    card = T.card_name()
    print(f"device: {card}", flush=True)
    built = build(pathlib.Path(args.parent))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = SM.max_sm_clock_hz()
    issue = SM.LANES_ISSUE * sms * clock
    rates = T.int_rates()
    print(f"issue rate {issue / 1e12:.3f} T lane-instructions/s ({sms} SMs "
          f"x {clock / 1e6:.0f} MHz x 128); streams: "
          + ", ".join(f"{k} {v / 1e12:.3f} T/s (SASS "
                      f"{rates['sass_per_s'][k] / 1e12:.3f})"
                      for k, v in rates["per_s"].items()), flush=True)
    print(f"stream loops, one trip: {json.dumps(rates['loop_trip_sass'])}",
          flush=True)
    ptxas = {n: ptxas_kernels(b[1]) for n, b in built.items()}
    print(f"ptxas -v: {json.dumps(ptxas)}", flush=True)
    sass, floors = {}, {}
    counts = {"blocks": SH.sha256_counts(5), "blocks_pad":
              SH.sha256_counts(4, 1), "nodes": SH.sha256_counts(1, 1),
              "leaf": SH.sha256_counts(4, 1)}
    for name, (_, _, libs, padded) in built.items():
        sass[name] = sass_mixes(libs, padded)
        floors[name] = {f: SM.floor_ms(m, N, sms, clock)
                        for f, m in sass[name].items()}
        for f, m in sass[name].items():
            print(f"{name} {f}: {m['total']} instructions a message (alu "
                  f"{m['alu']}, fma {m['fma']}, mem {m['mem']}, uniform "
                  f"{m['uniform']}, control {m['control']}; "
                  f"{m['top_opcodes']}), per-pipe floor "
                  f"{floors[name][f][0]:.4f} ms by {floors[name][f][1]}",
                  flush=True)
    bounds = {f: c["instructions"] * N / issue * 1e3
              for f, c in counts.items()}
    print(f"issue-rate bounds at the counted schedule (ms): {bounds}",
          flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    cases, data = cases_for(built, gen)
    cases.update(small_cases(built, gen))
    keys = list(cases)
    times = {k: [] for k in keys}
    for r in range(args.rounds):
        for k in keys[r % len(keys):] + keys[:r % len(keys)]:
            launch, n_sets = cases[k]
            times[k].append(T.sample_ms(launch, n_sets, args.reps))
    median = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    for k in keys:
        print(f"{k[0]} {k[1]}: median {median[k]:.4f} ms, samples "
              + ", ".join(f"{t:.4f}" for t in times[k]), flush=True)
    leaf = leaf_paths(built, data["rows"], args.reps)
    print(f"leaf hashing of {N} rows of {LEAF_K} bls12-381 Fr values, "
          f"Montgomery rows to digests: "
          + ", ".join(f"{k}: wall {v['wall_ms']:.4f} ms, device "
                      f"{v['device_ms']:.4f} ms" for k, v in leaf.items()),
          flush=True)
    result = {"card": card, "rounds": args.rounds, "reps": args.reps,
              "issue_per_s": issue, "streams": rates, "ptxas": ptxas,
              "sass": sass, "floors_ms": floors, "counts": counts,
              "issue_bounds_ms": bounds,
              "ms": {"/".join(k): v for k, v in times.items()},
              "median_ms": {"/".join(k): v for k, v in median.items()},
              "leaf_hashing_ms": leaf}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
