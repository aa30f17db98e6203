"""Kernel 8's passes over 2^20 elements, in two twiddle forms and by parts,
timed on the card.

    python3 -m crypto3_zk_tpu_torch.tools.mxu_pass_times
        [--rounds 5] [--reps 5] [--out f.json]

Kernel 8 (`csrc/mxu_ntt.cu`) is built three times from its source, all
`nvcc` runs at once: as the library builds it, and with the build macro
`ZK_MXU_PARTS` at 1 (the products alone) and at 2 (the epilogue alone).
Over bls12-381 Fr, on the 2^20 chain of four passes of side 32
(`chain_geoms([5, 5, 5, 5])`), it launches the entry `zk_mxu_pass` with
the arguments `pass_launch` gives and times these forms:

- `middle`: pass 1 (packed in and out, the twiddle of 2^15 points) as the
  plan runs it (`twiddle_split`: one table, one Montgomery product);
- `middle_two_tables`: the same pass with its twiddle the product of two
  small tables (`TW_ONE_MAX_LOG` lowered for it);
- `first`: pass 0 (int32 digits in, the twiddle of 2^20 points) as the
  plan runs it (one table of 2^20 entries); `first_two_tables`: with two
  small tables;
- `middle_products`, `middle_epilogue`: pass 1's products alone and its
  epilogue alone (the two measurement builds; their outputs are not the
  pass's).

`middle` is checked against `pass_plain`, and each other form of the pass
against its plan form, byte for byte. Each sample is the mean of `--reps`
launches by CUDA events, queued behind a spin kernel so that it is device
time, two input sets alternating; `--rounds` rounds visit the forms in an
order rotated from round to round, so that a drift of the card's clock
falls on all alike. Prints the card's name and power limit, `ptxas -v`'s
registers and spills of each build by side (`ptxas_by_side`, which
`chip_smoke.py` reads too), and one JSON object: every form's samples and
median (ms). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re

import torch

from .. import kernels as K
from ..fields import params as P
from ..ops import mxu_ntt as MX
from . import timing as T

SOURCE = "mxu_ntt.cu"
PARTS = {0: "pass", 1: "products alone", 2: "epilogue alone"}


def build_parts() -> dict:
    """{parts: (entry, ptxas log)}: kernel 8 built with ZK_MXU_PARTS = 0, 1
    and 2, all `nvcc` runs at once."""
    src = K.CSRC / SOURCE
    out_dir = K.build_dir() / "mxu_parts"
    jobs = []
    for parts in PARTS:
        define = f"-DZK_MXU_PARTS={parts}"
        tag = hashlib.sha1(K.headers() + src.read_bytes()
                           + define.encode()).hexdigest()[:12]
        jobs.append((parts, src, out_dir / f"lib{src.stem}-{tag}.so",
                     (define,)))
    return {parts: (T.bind(lib, {"zk_mxu_pass":
                                 K.SOURCES[SOURCE]["zk_mxu_pass"]})
                    ["zk_mxu_pass"], log)
            for parts, (lib, log) in T.nvcc_all(jobs).items()}


def ptxas_by_side(log: str) -> dict:
    """`ptxas -v` output -> {table side: {"registers", "spill_stores",
    "spill_loads", "stack_frame"}} for every instance of kernel 8 in it."""
    def key_of(function: str):
        m = re.search(r"mxu_pass_kernelILi(\d+)E", function)
        return int(m.group(1)) if m else None
    return T.ptxas_table(log, key_of)


def rand_input(fs, g, gen) -> torch.Tensor:
    """Random elements below p in the pass's input form."""
    x = torch.randint(0, 1 << 16, (fs.nl, g.m, g.v), generator=gen,
                      device="cuda", dtype=torch.int32)
    x[-1] = torch.randint(0, int(fs.p_limbs[-1]), (g.m, g.v), generator=gen,
                          device="cuda", dtype=torch.int32)
    if g.in_packed:
        return MX.pack_plain(fs, x, g.lsj, g.lsk)
    return x.reshape(fs.nl, g.n).contiguous()


def launcher(fs, g, fn, inputs, blocks: int, one_max: int):
    """(launch(i) on input set i, the output tensor): the pass's arguments
    made under `TW_ONE_MAX_LOG` = one_max, which is restored after."""
    keep = MX.TW_ONE_MAX_LOG
    try:
        MX.TW_ONE_MAX_LOG = one_max
        calls = [MX.pass_launch(fs, g, x, False, blocks) for x in inputs]
    finally:
        MX.TW_ONE_MAX_LOG = keep
    out = calls[0][0]
    args = [a for _, a in calls]
    for a in args:
        a[-1] = out.data_ptr()

    def launch(i: int) -> None:
        K.check(fn(*args[i], K.stream_ptr()), "zk_mxu_pass")

    return launch, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mxu_pass_times: no CUDA device")
    card = T.card_name()
    print(f"device: {card}", flush=True)

    built = build_parts()
    for parts, (_, log) in built.items():
        print(f"ZK_MXU_PARTS={parts} ({PARTS[parts]}), ptxas -v by side: "
              f"{ptxas_by_side(log)}", flush=True)
    fs = P.BLS12_381_FR
    first, middle = MX.chain_geoms([5, 5, 5, 5])[:2]
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    x_first = [rand_input(fs, first, gen) for _ in range(2)]
    x_middle = [rand_input(fs, middle, gen) for _ in range(2)]
    plan_max, fn = MX.TW_ONE_MAX_LOG, built[0][0]
    forms = {
        "middle": launcher(fs, middle, fn, x_middle, blocks, plan_max),
        "middle_two_tables": launcher(fs, middle, fn, x_middle, blocks, 0),
        "first": launcher(fs, first, fn, x_first, blocks, plan_max),
        "first_two_tables": launcher(fs, first, fn, x_first, blocks, 0),
        "middle_products": launcher(fs, middle, built[1][0], x_middle,
                                    blocks, plan_max),
        "middle_epilogue": launcher(fs, middle, built[2][0], x_middle,
                                    blocks, plan_max),
    }
    for name in ("middle", "middle_two_tables", "first", "first_two_tables"):
        forms[name][0](0)
    torch.cuda.synchronize()
    want = {"middle": MX.pass_plain(fs, middle, x_middle[0], False),
            "first": forms["first"][1].clone()}
    for name, ref in (("middle", "middle"), ("middle_two_tables", "middle"),
                      ("first_two_tables", "first")):
        if not torch.equal(forms[name][1], want[ref]):
            raise AssertionError(f"{name} differs from {ref}'s digits")
    print("middle equals pass_plain; middle_two_tables equals middle; "
          "first_two_tables equals first", flush=True)

    names = list(forms)
    times = {name: [] for name in names}
    for r in range(args.rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            times[name].append(T.sample_ms(forms[name][0], 2,
                                          args.reps))
    result = {"card": card, "rounds": args.rounds, "reps": args.reps,
              "ms": times,
              "median_ms": {k: sorted(v)[len(v) // 2]
                            for k, v in times.items()}}
    for name in names:
        print(f"{name}: median {result['median_ms'][name]:.4f} ms, samples "
              + ", ".join(f"{t:.4f}" for t in times[name]), flush=True)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
