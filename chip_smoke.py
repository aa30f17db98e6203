#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the CUDA kernels from `crypto3_zk_tpu_torch/csrc/`, measures the
card's 32-bit multiply-add rate and its funnel-shift, `IMAD.HI` and mixed
streams (`csrc/rate.cu`), holds each kernel, and
each form of kernel 5, against its plain PyTorch version on the card (exact
equality: every value is an integer) for the 8- and 12-word fields and for
the Goldilocks (2 words, p fills its top word) and MNT4 Fr (19 digits,
R = 2^304) instances, kernel 6 (batched scalar multiplication) on G1
and G2 of alt_bn128 and bls12-381 at 2^16 points, kernel 7 (SHA-256)
in its node, block and leaf forms at 2^18 messages, the leaf form at
every instance and the block form at lengths with and without a block of
pure padding (and samples against `hashlib`), and kernel 8 (a pass of
`ntt_mxu`: 8-bit digit products on `wgmma`) in every form (the block form
at sides 2 to 64 and ragged column counts; the first, a middle and the
last pass of 2^20 chains of sides 16, 32 and 64, with the twiddle, packed
digits in and out), the middle passes
timed over 2^20 elements beside their floors and one `torch._int_mm` of
the same digit products, then drives the port's main paths through the
entry points a user calls:

- `ntt_hopper` past the single four-step's 2^20: against `ntt_plain` at
  2^21 and 2^22, and inverse of forward at 2^24 and 2^26 (bls12-381 Fr);
- `ntt_mxu` (bls12-381 Fr) at 2^20, 2^24 and 2^26 forward, equal to
  `ntt_hopper` digit for digit (a forward call launches kernel 8 and
  nothing else), the inverse at 2^20, inverse of forward at 2^26; both
  forms timed round-robin (3 each, device peak memory) beside their
  transform-level floors;
- `circuit_1` over Goldilocks with Poseidon trees proved on the card and on
  the CPU (equal proofs and next challenges), and Groth16's witness map
  over MNT4 Fr on both (equal);
- Groth16 `generate`, `prove` (twice, the second is reported) and `verify`
  over alt_bn128 on a product-chain circuit of 2^16 constraints, whose A and
  B sides are both dense;
- the LPC commitment scheme over bls12-381 Fr with Poseidon Merkle trees:
  `FRIParams.build(degree_log=16, expand_factor=2, lambda_=40)`, a batch of 8
  polynomials of degree < 2^16 and a fixed batch of 4 of degree < 3*2^14,
  `commit` of both, `proof_eval` (twice, the second is reported) and
  `verify_eval` by an independent verifier-side scheme. D0 has 2^18 points;
- the Placeholder prover over bls12-381 Fr on tables of 2^16 and 2^17 rows
  (`arithmetization.circuits.placeholder_chain`: an add/mul chain over
  3 witness columns with copy constraints, and a range lookup into a table
  of 256; `tools/placeholder_fixture.py`), over LPC with the settings above:
  `process_public` / `process_private`, `prove` (twice, the second is
  reported), `verify` by an independent scheme, one more prove under
  `torch.profiler` for kernel 5's device time by form; then `ntt_hopper`
  against its plain version at the longest transform the prove ran;
- `ops.msm.msm` at 2^10 bases against the host (alt_bn128 and bls12-381,
  G1 and G2), and `circuit_1` over KZG v2 and BDFG proved on the card and
  on the CPU (equal proofs and next challenges);
- the Placeholder prover over KZG (`commitments/kzg.py`) on the 2^16-row
  `placeholder_chain` over alt_bn128 Fr (`tools/placeholder_fixture.py::
  PlaceholderKZGRun`): `KZGParams.setup` of 2^18 + 8 G1 powers on the card,
  a 2^16-term commitment's MSM timed by window width and the tensor commit
  against the host-int round trip, `process_public` / `process_private`,
  two v2 proves (the second reported), `verify` by an independent scheme,
  a wrong public input and a changed quotient opening rejected, one prove
  under `torch.profiler` (device busy, idle share); then BDFG's prove and
  verify on the same table and SRS;
- the classic R1CS provers: small PGHR13, GM17 and USCS keys and proofs
  equal card against CPU, then PGHR13 and GM17 at 2^16 constraints (the
  product chain) and the USCS ppzkSNARK over a TBCS chain of 2^14 gates:
  `generate`, `prove` twice (the second reported), `verify`, a wrong input
  rejected;
- Groth16's setup ceremonies and extensions: a ceremony at m = 8 (every
  batch through kernel 6) equal card against CPU, an ipp2 aggregate of 2
  proofs, an encrypted-input, an ADSNARK and a two-step PCD proof equal
  card against CPU, then the ceremony path at the 2^16-constraint product
  chain's QAP domain of 2^17 (`Accumulator` of 2^18 - 1 G1 powers, two
  contributions verified and a tampered power rejected, the Lagrange-basis
  result, a KZG commit -> open -> verify over 2^16 of its powers, the
  keypair, two phase-2 contributions, the chain verified and a forged one
  rejected, eight proves under the final key that verify there and not
  under the initial one) and an ipp2 aggregate of those 8 proofs, verified,
  a wrong transcript tag and a tampered agg_c rejected;
- the Pasta commitments over Pallas: `msm` at 2^10 on Pallas and Vesta
  against its oracle, Pallas MSMs on the card against the host from 16 to
  128 terms (where `ipa.DEVICE_MSM_MIN` lies), an IPA proof at n = 16, a
  kimchi SRS of 16 with its Lagrange basis and a Pickles synthetic proof
  at n = 16 equal card against CPU (and each verified by the other side),
  then at n = 2^16: the IPA (setup, commit, proof_eval, verify_eval, a
  wrong value rejected), a kimchi SRS of 2^16 with its Lagrange basis by
  the group iNTT (two points held against MSMs), `synthetic_index`, two
  `synthetic_prove`s, `verify` of each, `batch_verify` of both and a
  mutated proof rejected;
- the LPC path's settings with sha2_256 Merkle trees (every level by
  kernel 7: leaves by its leaf form from the rows' digit planes, nodes by
  its node form): a small proof equal card against CPU, then commit,
  `proof_eval` twice, `verify_eval`, a changed value rejected;
- the mesh layer (`parallel/`) on a world of one rank a card (NCCL,
  spawned by `launch.py`, one rank on a one-card machine): the distributed
  NTT at 2^20 and its inverse, the distributed MSM at 2^16 alt_bn128 G1
  points, `msm_checkpointed` whole and resumed after half its windows, the
  distributed precommit at D0 = 2^18 and the query gather of 40 queries,
  and a 2^16-row Placeholder prove under `mesh_context`, each equal to the
  single-card function on the same inputs, the proof verified
  (`entry.mesh_path`).

It fails (non-zero exit, no result line) without a CUDA device, when a kernel
does not build, launch or agree, when a kernel of a path was never launched
by that path (the launch counts are set to 0 just before each path and read
just after), when a verifier's answer is wrong (a proof rejected, a wrong
public input or a changed evaluation accepted, prover and verifier
transcripts that disagree), or when a small proof made on the card differs
from the CPU plain path's.

Output: one line per phase with its seconds; then the times of one whole 2^17
transform, the transforms past 2^20, the `ntt_mxu` round robin and block
passes, the multiply-add rate and kernel 5's device ms in each
Placeholder prove as a JSON object; then, on a line of its
own, a JSON object {"kernels": [...]} with every kernel's numbers
(`launches` is the sum over the whole paths: Groth16 prove, LPC path,
the Placeholder path over LPC, the Placeholder-over-KZG path, the classic
path, the ceremony path, the Pasta path, the sha2 LPC path, the mesh
path, whose launches are summed over its ranks, and the `ntt_mxu` path;
kernel 7's block form runs on none of them: its rows hold 0;
`launches_<path>` its parts; a row named
`kernel[field]` is another field's instance, its launches those of that
field's run; `int_bound_ms` is the bound with the measured integer rate;
kernel 7's `bound_ms` is its shortest schedule's instructions at the issue
rate (`ops/sha256.py::sha256_counts`), and its rows add `issue_bound_ms`,
the floor its own SASS instructions set at the card's per-pipe rates,
`tools/sass_mix.py`, and `ptxas -v`'s registers);
then the card's name and power limit; then the result line.

`--kernels-only` stops after the kernel checks, for a quick look at a kernel
edit: it drives no main path, so its `kernels` line carries no `launches`
and it prints no result line. With no arguments the run is the full one.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import random
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12     # dense int8 tensor-core operations (data sheet;
                             # a multiply-add counts as two)
OPS_PER_S = 67e12            # 32-bit operations outside the tensor cores
                             # (the data sheet's float32 rate; a 32-bit
                             # multiply-add counts as two operations)
FLUSH_BYTES = 64 << 20       # cycle inputs over more than the 50 MB L2
LOG2_CONSTRAINTS = 16        # the main path's circuit (`bench.py`'s size)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs and timing
# ---------------------------------------------------------------------------

def rand_field(torch, fs, shape, gen):
    """Uniform 16-bit digits with the top digit below the modulus's, so every
    element is < p; lanes 0..2 of the flattened batch are 0, R mod p (one)
    and p - 1."""
    top = int(fs.p_limbs[-1])
    x = torch.randint(0, 1 << 16, (fs.nl,) + tuple(shape), generator=gen,
                      device="cuda", dtype=torch.int32)
    x[-1] = torch.randint(0, top, tuple(shape), generator=gen, device="cuda",
                          dtype=torch.int32)
    flat = x.reshape(fs.nl, -1)
    edge = [0, fs.R_mod_p, fs.p - 1]
    for lane, v in enumerate(edge if flat.shape[1] >= 8 else []):
        flat[:, lane] = torch.tensor(
            [(v >> (16 * j)) & 0xFFFF for j in range(fs.nl)],
            dtype=torch.int32, device="cuda")
    return x


def nonzero(torch, x):
    """Replace zero elements by the value 1 (the scans take nonzero input)."""
    z = (x == 0).all(dim=0)
    x = x.clone()
    x[0] = torch.where(z, torch.ones_like(x[0]), x[0])
    return x


def time_ms(torch, fn, n_inputs: int, reps: int,
            queued: bool = False) -> float:
    """Mean milliseconds of `fn(i)` by CUDA events; `i` cycles over the
    input sets so that consecutive launches do not find their data in L2.

    With `queued`, the number is device time and not the host's launch rate:
    a spin kernel holds the stream while the host enqueues all `reps` calls
    behind it, so the timed launches run back to back. That the spin was
    still running when the last call had been enqueued is checked (the start
    event, recorded after the spin, has not completed yet); if the host was
    too slow the spin is lengthened, and after a few attempts it is an
    error."""
    fn(0)
    torch.cuda.synchronize()
    spin_cycles = 20_000_000 if queued else 0      # about 10 ms
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(spin_cycles)
        start.record()
        for r in range(reps):
            fn(r % n_inputs)
        end.record()
        held = not queued or not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        spin_cycles *= 4
    raise AssertionError("the stream drained during a timed loop: the host "
                         "could not enqueue the launches fast enough")


def max_abs_err(torch, got, want) -> int:
    gs = got if isinstance(got, tuple) else (got,)
    ws = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(gs, ws):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype differ: {g.shape} {g.dtype} "
                                 f"vs {w.shape} {w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max().item()))
    return err


def bound(bytes_moved: int, ops: int):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def mont_ops(nl: int) -> int:
    """32-bit operations of one word-level CIOS product: NW*(2NW+1)
    multiply-adds, two operations each (the lo and the hi instruction)."""
    nw = (nl + 1) // 2
    return 2 * nw * (2 * nw + 1)


IMAD = {"per_s": None}       # the card's measured multiply-add issue rate


def imad_rate(torch) -> float:
    """32-bit multiply-add instructions (with carry, as the products issue
    them) the card retires a second, by the loop of `csrc/rate.cu` on 8
    blocks of 256 threads an SM; the median of 5 timed launches."""
    from crypto3_zk_tpu_torch import kernels as K
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 8 * sms, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    fn = K.entry("zk_imad_rate")

    def launch(_):
        K.check(fn(out.data_ptr(), blocks, threads, iters, K.stream_ptr()),
                "zk_imad_rate")

    times = sorted(time_ms(torch, launch, 1, 1) for _ in range(5))
    per_s = blocks * threads * iters * 2 * 16 / (times[2] * 1e-3)
    IMAD["per_s"] = per_s
    return per_s


# `csrc/rate.cu`'s streams that kernel 7's design rests on: funnel shifts,
# `IMAD` and `IMAD.HI` alone, and funnel shifts interleaved with each
# (`tools/sha256_times.py` times all eleven)
INT_STREAMS = ("shf", "imad_lo", "imad_hi", "shf_imad_hi", "shf_imad_lo")


def int_streams(torch) -> dict:
    """The rates of `INT_STREAMS` in lane-instructions a second, beside the
    issue rate, and each loop's SASS (one trip): which instructions issue
    side by side, which kernel 7's split between the ALU and FMA pipes
    rests on (`tools/timing.py::int_rates`)."""
    from crypto3_zk_tpu_torch.tools import timing as T
    out = T.int_rates(INT_STREAMS)
    out["issue_per_s"] = issue_per_s()
    log(f"integer streams, T lane-instructions/s (steps; SASS): "
        + ", ".join(f"{k} {v / 1e12:.3f}; {out['sass_per_s'][k] / 1e12:.3f}"
                    for k, v in out["per_s"].items())
        + f" (issue rate {out['issue_per_s'] / 1e12:.3f}); a loop trip's "
        f"SASS: " + json.dumps({k: (v["alu"], v["fma"], v["top_opcodes"])
                                for k, v in out["loop_trip_sass"].items()}))
    return out


def int_bound_ms(bytes_moved: int, ops: int) -> float:
    """The bound with the measured integer rate in place of the float32
    one: the larger of the bytes' time and the multiply-add instructions'
    (`ops` counts two a word product, the instructions it issues)."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / IMAD["per_s"]) * 1e3


def issue_per_s() -> float:
    """Lane-instructions a second the card's schedulers issue: 4 warps (128
    lanes) a clock an SM, at its SM count and highest SM clock."""
    import torch

    from crypto3_zk_tpu_torch.tools import sass_mix as SM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SM.LANES_ISSUE * sms * SM.max_sm_clock_hz()


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version, on the card
# ---------------------------------------------------------------------------

def check_kernels(torch):
    from crypto3_zk_tpu_torch.fields import params as P
    from crypto3_zk_tpu_torch.ops import hopper_field as HF
    from crypto3_zk_tpu_torch.ops import hopper_msm as HM

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2016)
    fq = P.ALT_BN128_FQ
    fr = P.ALT_BN128_FR
    rows = []

    def compare(name, fs, kernel, plain, inputs):
        got = kernel(fs, *inputs)
        torch.cuda.synchronize()
        want = plain(fs, *inputs)
        err = max_abs_err(torch, got, want)
        shapes = [tuple(t.shape) if hasattr(t, "shape") else t for t in inputs]
        log(f"  {name} {fs.name} {shapes}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version on {fs.name} {shapes}")
        return err

    def measure(name, source, replaces, fs, kernel, plain, make, bytes_moved,
                ops, per_set_bytes, extra_err=0, latency_bound_ms=None,
                plain_reps=2, issue_instructions=None):
        n_sets = max(1, -(-FLUSH_BYTES // per_set_bytes))
        sets = [make() for _ in range(n_sets)]
        err = max(extra_err, compare(name, fs, kernel, plain, sets[0]))
        ms = time_ms(torch, lambda i: kernel(fs, *sets[i]), n_sets, 20,
                     queued=True)
        # the plain version is many library launches; its time is what a
        # caller waits for, the host's share included
        plain_ms = time_ms(torch, lambda i: plain(fs, *sets[i]), n_sets,
                           plain_reps)
        bound_ms, bound_by = bound(bytes_moved, ops)
        if latency_bound_ms is not None:
            # a chain of dependent operations: no rate bounds it
            bound_ms, bound_by = latency_bound_ms, "operations"
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "int_bound_ms": int_bound_ms(bytes_moved, ops),
                     "library_ms": None, "field": fs.name,
                     "shape": [list(t.shape) for t in sets[0]
                               if hasattr(t, "shape")]})
        if latency_bound_ms is not None:
            rows[-1]["bound_note"] = ("latency: dependent products in "
                                      "sequence x the time of one")
            rows[-1]["int_bound_ms"] = latency_bound_ms
        if issue_instructions is not None:
            # integer ALU work that no float32 rate describes: the
            # instructions at the schedulers' issue rate
            by_issue = issue_instructions / issue_per_s() * 1e3
            by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
            rows[-1].update(
                bound_ms=max(by_issue, by_bytes), int_bound_ms=by_issue,
                bound_by="operations" if by_issue >= by_bytes else "bytes",
                bound_note="instructions of the shortest schedule at the "
                           "issue rate, 128 lanes a clock an SM")
        log(f"  {name}: {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms by {rows[-1]['bound_by']}, "
            f"integer-rate bound {rows[-1]['int_bound_ms']:.4f} ms")
        return rows[-1]

    # kernel 1: Montgomery multiply (and the add / subtract entries)
    n = 1 << 20
    bls = P.BLS12_381_FQ
    err = compare("mont_mul", bls, HF.mont_mul_hopper, HF.mont_mul_plain,
                  (rand_field(torch, bls, (1 << 16,), gen),
                   rand_field(torch, bls, (1 << 16,), gen)))
    # operands that broadcast or are views reach the kernel through strides
    a3 = rand_field(torch, fr, (512, 256), gen)
    err = max(err, compare(
        "mont_mul(broadcast)", fr, HF.mont_mul_hopper, HF.mont_mul_plain,
        (a3.transpose(1, 2), rand_field(torch, fr, (1, 1), gen))))
    a2, b2 = rand_field(torch, fq, (n,), gen), rand_field(torch, fq, (n,), gen)
    compare("add", fq, HF.add_hopper, HF.add_plain, (a2, b2))
    compare("sub", fq, HF.sub_hopper, HF.sub_plain, (a2, b2))
    a12 = rand_field(torch, bls, (1 << 12,), gen)
    b12 = rand_field(torch, bls, (1 << 12,), gen)
    compare("add", bls, HF.add_hopper, HF.add_plain, (a12, b12))
    compare("sub", bls, HF.sub_hopper, HF.sub_plain, (a12, b12))
    del a2, b2, a3, a12, b12
    measure("mont_mul", "crypto3_zk_tpu_torch/csrc/mont_mul.cu",
            "crypto3_zk_tpu/ops/pallas_field.py:126", fq,
            HF.mont_mul_hopper, HF.mont_mul_plain,
            lambda: (rand_field(torch, fq, (n,), gen),
                     rand_field(torch, fq, (n,), gen)),
            bytes_moved=3 * fq.nl * 4 * n, ops=mont_ops(fq.nl) * n,
            per_set_bytes=2 * fq.nl * 4 * n, extra_err=err)
    mont_mul_launches = launch_counts()["mont_mul"]

    # kernel 2: row NTT at every row length, few and many rows, both
    # directions
    err = 0
    for log_b in range(1, 11):
        for m_rows in (1, 3, 256):
            for inverse in (False, True):
                err = max(err, compare(
                    "ntt_rows", fr, HF.ntt_rows_hopper, HF.ntt_rows_plain,
                    (rand_field(torch, fr, (m_rows, 1 << log_b), gen),
                     inverse)))
    # the 12-word instance: bls12-381 Fq has roots of unity of order 2 only
    err = max(err, compare("ntt_rows", bls, HF.ntt_rows_hopper,
                           HF.ntt_rows_plain,
                           (rand_field(torch, bls, (4096, 2), gen), False)))
    # strided input (columns of a matrix), each kind of multiplier, and a
    # strided output; the output view is compared after the call
    cols = rand_field(torch, fr, (256, 512), gen).transpose(1, 2)
    table = rand_field(torch, fr, (512, 256), gen)
    for mul in (None, table, rand_field(torch, fr, (1, 1), gen),
                table[:, :, :1], table[:, :1, :]):
        for inverse in (False, True):
            err = max(err, compare(
                "ntt_rows(columns, multiplier)", fr, HF.ntt_rows_hopper,
                HF.ntt_rows_plain, (cols, inverse, mul)))
        flat = torch.empty((fr.nl, 512 * 256), dtype=torch.int32,
                           device="cuda")
        view = flat.reshape(fr.nl, 256, 512).transpose(1, 2)
        got = HF.ntt_rows_hopper(fr, cols, False, mul, view)
        torch.cuda.synchronize()
        if got is not view or max_abs_err(
                torch, view, HF.ntt_rows_plain(fr, cols, False, mul)) != 0:
            raise AssertionError("ntt_rows into a strided view disagrees "
                                 "with its plain version")
    log("  ntt_rows into strided views: max_abs_err 0")
    del cols, table, flat, view, got
    # whole transforms through the four-step's two launches
    for log_n in (11, 17):
        for inverse in (False, True):
            before = HF.LAUNCHES["ntt_rows"]
            err = max(err, compare(
                "ntt_hopper", fr, HF.ntt_hopper, HF.ntt_plain,
                (rand_field(torch, fr, (1 << log_n,), gen), inverse)))
            if launch_counts()["ntt_rows"] - before != 2 \
                    or launch_counts()["mont_mul"] != mont_mul_launches:
                raise AssertionError("a four-step transform is not two "
                                     "launches of kernel 2")
    m_rows, b = 256, 512
    butterflies = m_rows * (b // 2) * 9
    measure("ntt_rows", "crypto3_zk_tpu_torch/csrc/ntt_rows.cu",
            "crypto3_zk_tpu/ops/pallas_field.py:184", fr,
            HF.ntt_rows_hopper, HF.ntt_rows_plain,
            lambda: (rand_field(torch, fr, (m_rows, b), gen), False),
            bytes_moved=fr.nl * 4 * (2 * m_rows * b + b // 2),
            ops=butterflies * (mont_ops(fr.nl) + 2 * fr.nl),
            per_set_bytes=fr.nl * 4 * m_rows * b, extra_err=err)

    # one whole transform at the prove's domain size: device time with the
    # stream held, and what a caller waits for, the host's share included
    n_big = 1 << 17
    sets = [rand_field(torch, fr, (n_big,), gen) for _ in range(8)]
    transforms = {}
    for inverse in (False, True):
        name = "inverse" if inverse else "forward"
        transforms[name] = time_ms(
            torch, lambda i: HF.ntt_hopper(fr, sets[i], inverse), len(sets),
            20, queued=True)
        transforms[name + "_with_host"] = time_ms(
            torch, lambda i: HF.ntt_hopper(fr, sets[i], inverse), len(sets),
            20)
    log("  ntt_hopper 2^17: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in transforms.items()))
    del sets

    # kernels 3 and 4: the scans of the batched inversion, ragged and tiny
    # shapes first, then timed at the width of a 2^21-lane halving pass
    err3 = 0
    for fs in (fq, bls):
        for k in (1, 2, 17, 64):
            for c in (1, 7, 8, 512, (1 << 15) + 3):
                err3 = max(err3, compare(
                    "inv_scans", fs, HM.inv_scans_hopper, HM.inv_scans_plain,
                    (nonzero(torch, rand_field(torch, fs, (k, c), gen)),)))
    k, c = 64, 1 << 15
    scan_bytes = fq.nl * 4 * (3 * k * c + c)
    err4 = compare("mul3", bls, HM.mul3_bcast_hopper, HM.mul3_bcast_plain,
                   (rand_field(torch, bls, (k, 256), gen),
                    rand_field(torch, bls, (k, 256), gen),
                    rand_field(torch, bls, (256,), gen)))
    measure("inv_scans", "crypto3_zk_tpu_torch/csrc/inv_scans.cu",
            "crypto3_zk_tpu/ops/pallas_msm.py:80", fq,
            HM.inv_scans_hopper, HM.inv_scans_plain,
            lambda: (nonzero(torch, rand_field(torch, fq, (k, c), gen)),),
            bytes_moved=scan_bytes, ops=2 * k * c * mont_ops(fq.nl),
            per_set_bytes=fq.nl * 4 * k * c, extra_err=err3)
    measure("mul3", "crypto3_zk_tpu_torch/csrc/mul3.cu",
            "crypto3_zk_tpu/ops/pallas_msm.py:124", fq,
            HM.mul3_bcast_hopper, HM.mul3_bcast_plain,
            lambda: (rand_field(torch, fq, (k, c), gen),
                     rand_field(torch, fq, (k, c), gen),
                     rand_field(torch, fq, (c,), gen)),
            bytes_moved=scan_bytes, ops=2 * k * c * mont_ops(fq.nl),
            per_set_bytes=2 * fq.nl * 4 * k * c, extra_err=err4)

    # the tail of the batched inversion: one launch inverts a small batch.
    # Its bound is a latency: the products that follow one another in the
    # launch, times the time of one dependent product, which is read off a
    # launch on a single element (nothing but the chain runs there).
    err5 = 0
    for fs in (fq, bls):
        for size in (1, 2, 63, 512, HM.INV_TAIL_MAX):
            err5 = max(err5, compare(
                "inv_tail", fs, HM.batch_inverse_small_hopper,
                HM.batch_inverse_small_plain,
                (nonzero(torch, rand_field(torch, fs, (size,), gen)),)))
    size = 512
    single = nonzero(torch, rand_field(torch, fq, (1,), gen))
    chain_ms = time_ms(torch,
                       lambda i: HM.batch_inverse_small_hopper(fq, single),
                       1, 20, queued=True)
    product_ms = chain_ms / HM.tail_products_in_sequence(fq, 1)
    log(f"  inv_tail on one element: {chain_ms:.4f} ms, "
        f"{product_ms * 1e3:.3f} us a dependent product")
    measure("inv_tail", "crypto3_zk_tpu_torch/csrc/inv_scans.cu",
            "crypto3_zk_tpu/ops/pallas_msm.py:80", fq,
            HM.batch_inverse_small_hopper, HM.batch_inverse_small_plain,
            lambda: (nonzero(torch, rand_field(torch, fq, (size,), gen)),),
            bytes_moved=2 * fq.nl * 4 * size, ops=0,
            per_set_bytes=FLUSH_BYTES, extra_err=err5,
            latency_bound_ms=product_ms
            * HM.tail_products_in_sequence(fq, size))

    check_poseidon(torch, gen, compare, measure, rows, product_ms)
    for fs in (P.GOLDILOCKS, P.MNT4_FR):
        check_field(torch, fs, gen, compare, measure)
    check_scalar_mul(torch, gen, compare, measure)
    check_sha256(torch, compare, measure)
    rows.append(check_mxu_kernel(torch, gen, compare))
    return rows, transforms


SCALAR_MUL_POINTS = 1 << 16      # kernel 6 is held and timed at 2^16 points
# ... and held at the ceremony's largest batches: the transform's three G1
# vectors side by side (2m - 1 + m + m points) and its G2 powers with
# beta G2 (m + 1), m = 2^17
SCALAR_MUL_TRANSFORM = {"g1": 4 * (1 << 17) - 1, "g2": (1 << 17) + 1}
CROSSOVER_LOGS = (0, 2, 4, 6)    # batch sizes 2^k where points.mul's routes
                                 # are timed against each other


def scalar_mul_inputs(torch, curve, group, gen, n: int, distinct: int = 64):
    """n Jacobian points on the card (`distinct` random host points, tiled,
    lane 4 at infinity, lane 9 the negative of lane 8's point) and n
    scalars below r: lanes 0 to 3 are 0, 1, r - 1, 5; lanes 5 and 6 are r
    and r + 2; from lane 10 `tools/scalar_mul_shapes.py::edge_scalars` at
    the instance's window (a zero digit in the middle and at the top, a top
    digit that is the carry alone, a window of all ones, last additions
    that meet acc = T[d] and acc = -T[d], 2^bits - 1)."""
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.ops import hopper_curve as HC
    from crypto3_zk_tpu_torch.ops import points as PT
    from crypto3_zk_tpu_torch.tools import scalar_mul_shapes as SMS
    rng = random.Random(n + distinct)
    mul = CV.g1_mul if group == "g1" else CV.g2_mul
    neg = CV.g1_neg if group == "g1" else CV.g2_neg
    g = curve.g1 if group == "g1" else curve.g2
    base = [mul(curve, g, rng.randrange(1, curve.fr.p))
            for _ in range(distinct)]
    pts = [base[i % distinct] for i in range(n)]
    pts[4] = None
    pts[9] = neg(curve, pts[8])
    vec = PT.PointVector(curve, group, host=pts)
    k = rand_field(torch, curve.fr, (n,), gen)
    r = curve.fr.p
    edges = SMS.edge_scalars(r, curve.fr.bits, HC.WINDOW[group], rng)
    lanes = {**dict(enumerate([0, 1, r - 1, 5, 7, r, r + 2])),
             **dict(enumerate(edges.values(), start=10))}
    for lane, v in lanes.items():
        k[:, lane] = torch.tensor([(v >> (16 * j)) & 0xFFFF
                                   for j in range(curve.fr.nl)],
                                  dtype=torch.int32, device="cuda")
    return vec.jacobian("cuda"), k, pts


def _finite(P, group):
    z = P[2] if group == "g1" else P[2][0]
    return (z != 0).any(dim=0)


def scalar_mul_products(torch, curve, group, P, k) -> int:
    """Fq products kernel 6 runs on these inputs (a G1 squaring or product
    is one; a G2 squaring two, a G2 product three): per lane the table
    (T[1] + T[1] up to the doubling case, 2 squarings and 6 products, its
    doubling, then 2^(w-1) - 2 additions of 4 squarings and 12 products),
    w doublings of 5 squarings and 2 products for each window below the
    top, and an addition for each nonzero digit after the first (the first
    is loaded, or added to infinity, which costs nothing). A point at
    infinity runs its doublings only."""
    from crypto3_zk_tpu_torch.ops import hopper_curve as HC
    sq, mu = (1, 1) if group == "g1" else (2, 3)
    dbl, add = 5 * sq + 2 * mu, 4 * sq + 12 * mu
    w = HC.WINDOW[group]
    digits = HC.signed_digits(k, curve.fr.bits, w)
    n = P[0].shape[1] if group == "g1" else P[0][0].shape[1]
    nnz = (digits != 0).sum(dim=0).expand(n)
    finite = _finite(P, group)
    table = 2 * sq + 6 * mu + dbl + ((1 << (w - 1)) - 2) * add
    adds = int(((nnz - 1).clamp(min=0) * finite).sum().item())
    return (digits.shape[0] - 1) * w * dbl * n \
        + table * int(finite.sum().item()) + add * adds


def ladder_products(torch, curve, group, P, k) -> int:
    """The products of the double-and-add ladder kernel 6 ran until this
    design replaced it (kept so that rows compare across versions): 7 a
    doubling for every bit of every lane, 16 an addition where a set bit
    meets a non-infinity accumulator (every set bit after a lane's first)
    and a finite point; three Fq products an Fq2 product."""
    nbits = curve.fr.bits
    bits = sum(((k.to(torch.int64) >> b) & 1).sum(dim=0) for b in range(16))
    adds = int(((bits - 1).clamp(min=0) * _finite(P, group)).sum().item())
    products = 7 * nbits * k.shape[1] + 16 * adds
    return products * (1 if group == "g1" else 3)


def scalar_mul_ptxas() -> dict:
    """Registers and spill bytes of kernel 6's four instances, from the
    `ptxas -v` log kept with each library, beside each instance's compiled
    shape (window, threads, blocks an SM, shared bytes a block)."""
    from crypto3_zk_tpu_torch import kernels as K
    from crypto3_zk_tpu_torch.ops import hopper_curve as HC
    from crypto3_zk_tpu_torch.tools import scalar_mul_shapes as SMS
    out = {}
    for group, deg in (("g1", 1), ("g2", 2)):
        usage = SMS.parse_ptxas(K.build_log(SMS.SOURCE[group]))
        for nw in (8, 12):
            out[f"{group} {nw} words"] = {
                **SMS.shape(K.entry(HC.entry_name(group) + "_shape"), nw),
                **usage.get((nw, deg), {})}
    return out


def check_scalar_mul(torch, gen, compare, measure):
    """Kernel 6 against its plain version (the same schedule of signed
    windows with `ops/curve.py`'s formulas, whose field operations on the
    card are kernel 1's and the add / subtract entries, checked above) at
    2^16 points, G1 and
    G2 on alt_bn128 and bls12-381, digit for digit in Jacobian form (hence
    equal affine points too), with the edge lanes of `scalar_mul_inputs`
    and one broadcast scalar; 32 lanes are also held against the host's
    double-and-add. Then alt_bn128 at the transform's batch sizes
    (`SCALAR_MUL_TRANSFORM`). alt_bn128 G1 is timed (the ceremony's G1
    batches); G2's time, bounds and plain time go into the same row, with
    the bounds of the ladder kernel 6 ran before (`ladder_products`) and
    the four instances' registers and spills. Last,
    `points.mul`'s two routes (kernel 6, the host's double-and-add) are
    timed against each other at small batches
    (`tools/scalar_mul_crossover.py`)."""
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.ops import hopper_curve as HC
    from crypto3_zk_tpu_torch.ops import points as PT

    n = SCALAR_MUL_POINTS

    def flat(P, group):
        return tuple(HC._flat(P, group))

    # kernel and plain version on (coordinates..., scalars), flat tuples
    def kernel_of(curve, group):
        return lambda fs, *a: flat(HC.scalar_mul_batch_hopper(
            curve, HC._point(a[:-1], group), a[-1], group), group)

    def plain_of(curve, group):
        return lambda fs, *a: flat(HC.scalar_mul_batch_plain(
            curve, HC._point(a[:-1], group), a[-1], group), group)

    g2_ms = {}
    for curve in (CV.ALT_BN128, CV.BLS12_381):
        for group in ("g1", "g2"):
            P, k, pts = scalar_mul_inputs(torch, curve, group, gen, n)
            kern, plain = kernel_of(curve, group), plain_of(curve, group)
            compare(f"scalar_mul {group}", curve.fq, kern, plain,
                    flat(P, group) + (k,))
            compare(f"scalar_mul {group} (broadcast)", curve.fq, kern, plain,
                    flat(P, group) + (k[:, 3:4].contiguous(),))
            got = PT.PointVector.from_jacobian(
                curve, group, HC.scalar_mul_batch_hopper(curve, P, k, group))
            mul = CV.g1_mul if group == "g1" else CV.g2_mul
            ks = [sum(int(k[j, i]) << (16 * j) for j in range(16))
                  for i in range(32)]
            want = [None if pt is None else mul(curve, pt, ki)
                    for pt, ki in zip(pts[:32], ks)]
            if got.slice(0, 32).host() != want:
                raise AssertionError(f"kernel 6 disagrees with the host's "
                                     f"double-and-add on {curve.name} "
                                     f"{group}")
            if group == "g2" and curve is CV.ALT_BN128:
                g2_ms["ms"] = time_ms(
                    torch, lambda i: kern(curve.fq, *flat(P, group), k), 1, 5,
                    queued=True)
                g2_ms["plain_ms"] = time_ms(
                    torch, lambda i: plain(curve.fq, *flat(P, group), k), 1,
                    1)
                g2_bytes = 2 * 6 * curve.fq.nl * 4 * n + 64 * n
                g2_ops = scalar_mul_products(torch, curve, group, P, k) \
                    * mont_ops(curve.fq.nl)
                g2_ms["bound_ms"], _ = bound(g2_bytes, g2_ops)
                g2_ms["int_bound_ms"] = int_bound_ms(g2_bytes, g2_ops)
                g2_ms["ladder_int_bound_ms"] = int_bound_ms(
                    g2_bytes, ladder_products(torch, curve, group, P, k)
                    * mont_ops(curve.fq.nl))
            del P, k, got
    curve, fq = CV.ALT_BN128, CV.ALT_BN128.fq
    for group, size in SCALAR_MUL_TRANSFORM.items():
        P, k, _ = scalar_mul_inputs(torch, curve, group, gen, size)
        compare(f"scalar_mul {group}", fq, kernel_of(curve, group),
                plain_of(curve, group), flat(P, group) + (k,))
        del P, k
    P, k, _ = scalar_mul_inputs(torch, curve, "g1", gen, n)
    ops = scalar_mul_products(torch, curve, "g1", P, k) * mont_ops(fq.nl)

    def make():
        perm = torch.randperm(n, device="cuda", generator=gen)
        return tuple(c.index_select(1, perm) for c in P + (k,))

    row = measure("scalar_mul", "crypto3_zk_tpu_torch/csrc/scalar_mul.cuh",
                  "crypto3_zk_tpu/commitments/powers_of_tau.py:64", fq,
                  kernel_of(curve, "g1"), plain_of(curve, "g1"), make,
                  bytes_moved=2 * 3 * fq.nl * 4 * n + 64 * n, ops=ops,
                  per_set_bytes=3 * fq.nl * 4 * n, plain_reps=1)
    row["ladder_int_bound_ms"] = int_bound_ms(
        2 * 3 * fq.nl * 4 * n + 64 * n,
        ladder_products(torch, curve, "g1", P, k) * mont_ops(fq.nl))
    row.update({"g2_" + key: v for key, v in g2_ms.items()})
    row["ptxas"] = scalar_mul_ptxas()
    log(f"  scalar_mul g2 {curve.name} 2^16: {g2_ms['ms']:.4f} ms, plain "
        f"{g2_ms['plain_ms']:.2f} ms, bound {g2_ms['bound_ms']:.4f} ms, "
        f"integer-rate bound {g2_ms['int_bound_ms']:.4f} ms; the ladder's "
        f"integer-rate bounds G1 {row['ladder_int_bound_ms']:.4f}, G2 "
        f"{g2_ms['ladder_int_bound_ms']:.4f} ms")
    log(f"  kernel 6 instances: {json.dumps(row['ptxas'])}")
    from crypto3_zk_tpu_torch.tools import scalar_mul_crossover as SMX
    row["crossover"] = SMX.measure("cuda", CROSSOVER_LOGS, 3)
    log(f"  points.mul routes, kernel 6 against the host (ms): "
        f"{json.dumps(row['crossover'])}")


LPC_LOG2_DEGREE = 16         # the LPC path's polynomials: degree < 2^16
LPC_EXPAND = 2               # its first domain D0 has 2^18 points, and its
                             # first Merkle trees 2^17 leaves (the fixture's
                             # expand factor, `tools/lpc_fixture.py`)
# states each form is timed at: both sides of `hopper_hash.SHARED_MAX`
POSEIDON_SIZES = (64, 1 << 12, 1 << 13, 1 << 14, 1 << 17)


def check_poseidon(torch, gen, compare, measure, rows, product_ms):
    """Kernel 5 against its plain version in each form (one thread a state,
    three threads a state, the tree's tail in one launch): both round
    orders, both word counts, every input form the Merkle layer uses, and
    the x^11 instance (MNT6 Fr); each
    form's time at `POSEIDON_SIZES` states; the tree form on 2 * TREE_MAX
    digests;
    and one whole tree of 2^17 leaves down to the root, the new way and the
    old (a launch of the one-thread form a level)."""
    from crypto3_zk_tpu_torch.commitments import merkle as MK
    from crypto3_zk_tpu_torch.fields import params as P
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    from crypto3_zk_tpu_torch.ops import nil_poseidon as NPO
    from crypto3_zk_tpu_torch.ops import poseidon as PO

    def planes(state):
        return (state[:, 0], state[:, 1], state[:, 2])

    def forms(form):
        def permute(fs, state):
            return HH.poseidon_permute_hopper(pp, planes(state), form=form)

        def level(fs, digests):
            return HH.poseidon_permute_hopper(
                pp, (digests[:, 0::2], digests[:, 1::2], None),
                lane0_only=True, form=form)

        def absorb(fs, state, r0, r1, lane0_only):
            return HH.poseidon_permute_hopper(pp, planes(state), (r0, r1),
                                              lane0_only, form=form)

        def sponge(fs, r0, r1):
            return HH.poseidon_permute_hopper(pp, (None, None, None),
                                              (r0, r1), lane0_only=True,
                                              form=form)
        return permute, level, absorb, sponge

    def permute_plain(fs, state):
        return HH.poseidon_permute_plain(pp, planes(state))

    def level_plain(fs, digests):
        return HH.poseidon_permute_plain(
            pp, (digests[:, 0::2], digests[:, 1::2], None), lane0_only=True)

    def absorb_plain(fs, state, r0, r1, lane0_only):
        return HH.poseidon_permute_plain(pp, planes(state), (r0, r1),
                                         lane0_only)

    def sponge_plain(fs, r0, r1):
        return HH.poseidon_permute_plain(pp, (None, None, None), (r0, r1),
                                         lane0_only=True)

    def tree(fs, digests):
        return tuple(HH.poseidon_tree_hopper(pp, digests))

    def tree_plain(fs, digests):
        return tuple(HH.poseidon_tree_plain(pp, digests))

    top = 1 << (LPC_LOG2_DEGREE + LPC_EXPAND - 1)
    err = {"lanes": 0, "shared": 0, "tree": 0}
    for pp in (PO.get_params(P.BLS12_381_FR), NPO.get_params(P.PALLAS_FQ),
               PO.get_params(P.BLS12_381_FQ)):
        fs = pp.fs
        c = HH.lanes_counts(pp)
        log(f"  poseidon on {fs.name}: alpha {pp.alpha}, "
            f"{len(pp.round_constants)} rounds, partial "
            f"{pp.partial_rounds}, rc first {pp.rc_first}; a state, the "
            f"floor {c['floor_instructions']} multiply-add instructions; "
            f"the lanes form issues {c['instructions']} ({c['products']} "
            f"products, {c['squarings']} squarings among them, "
            f"{c['reductions']} reductions); the textbook schedule (the "
            f"reference, which no form runs) "
            f"{c['textbook_products']} products, "
            f"{c['textbook_instructions']} instructions")
        for form in ("lanes", "shared"):
            permute, level, absorb, _ = forms(form)
            for n in (1, 33, 4096, top):
                err[form] = max(err[form], compare(
                    f"poseidon({form})", fs, permute, permute_plain,
                    (rand_field(torch, fs, (3, n), gen),)))
            for n in (33, 4096) if fs is P.BLS12_381_FR else (33,):
                err[form] = max(err[form], compare(
                    f"poseidon({form}, level)", fs, level, level_plain,
                    (rand_field(torch, fs, (2 * n,), gen),)))
                for r1 in (rand_field(torch, fs, (n,), gen), None):
                    for lane0_only in (False, True):
                        err[form] = max(err[form], compare(
                            f"poseidon({form}, absorb)", fs, absorb,
                            absorb_plain,
                            (rand_field(torch, fs, (3, n), gen),
                             rand_field(torch, fs, (n,), gen), r1,
                             lane0_only)))
        for n2 in (2, 64, 2 * HH.TREE_MAX):
            err["tree"] = max(err["tree"], compare(
                "poseidon(tree)", fs, tree, tree_plain,
                (rand_field(torch, fs, (n2,), gen),)))
    # the x^11 instance (MNT6 Fr, 10 words), on no path of this script
    pp = PO.get_params(P.MNT6_FR)
    fs = pp.fs
    for form in ("lanes", "shared"):
        for n in (1, 33, 4096):
            err[form] = max(err[form], compare(
                f"poseidon({form})", fs, forms(form)[0], permute_plain,
                (rand_field(torch, fs, (3, n), gen),)))
    err["tree"] = max(err["tree"], compare(
        "poseidon(tree)", fs, tree, tree_plain,
        (rand_field(torch, fs, (2 * HH.TREE_MAX,), gen),)))
    # the Merkle forms at the LPC path's own top shapes: the largest node
    # level (strided even and odd digests, no third element, element 0 out)
    # and a two-row leaf sponge (no state, two absorb planes, element 0 out)
    pp = PO.get_params(P.BLS12_381_FR)
    fs = pp.fs
    counts = HH.lanes_counts(pp)
    floor = counts["floor_instructions"]
    for form in ("lanes", "shared"):
        _, level, _, sponge = forms(form)
        err[form] = max(err[form], compare(
            f"poseidon({form}, level)", fs, level, level_plain,
            (rand_field(torch, fs, (top,), gen),)))
        err[form] = max(err[form], compare(
            f"poseidon({form}, absorb)", fs, sponge, sponge_plain,
            (rand_field(torch, fs, (top,), gen),
             rand_field(torch, fs, (top,), gen))))
    # each form timed at each size; the row's own numbers at a size where
    # the wrapper picks it (2^17 for one thread a state, as in earlier runs;
    # 2^12 for three threads a state, inside the wrapper's range up to
    # `SHARED_MAX` = 2^13). Every form's operations are the permutation's
    # floor of multiply-add instructions (`hopper_hash.lanes_counts`); the
    # lanes form's chain is that floor in general products' worth, the
    # shared form's its products in sequence (`hopper_hash.shared_chain`:
    # 3 a partial round and 4 a full one at x^5, a dot counted as one
    # product), beside the textbook schedule's 6 a round.
    shared_counts = HH.shared_counts(pp)
    chain = {"lanes": floor / mont_ops(fs.nl),
             "shared": shared_counts["chain"]}
    form_rows = {}
    for form, name, n_row in (("lanes", "poseidon", top),
                              ("shared", "poseidon_shared", 1 << 12)):
        permute = forms(form)[0]
        row = measure(name, "crypto3_zk_tpu_torch/csrc/poseidon.cu",
                      "crypto3_zk_tpu/ops/poseidon.py:185", fs, permute,
                      permute_plain,
                      lambda: (rand_field(torch, fs, (3, n_row), gen),),
                      bytes_moved=6 * fs.nl * 4 * n_row,
                      ops=floor * n_row,
                      per_set_bytes=3 * fs.nl * 4 * n_row,
                      extra_err=err[form])
        form_rows[form] = row
        row["form"] = form
        if form == "lanes":
            issued = counts["instructions"] * n_row
            textbook = counts["textbook_instructions"] * n_row
            row["counts_per_state"] = counts
            row["issued_int_bound_ms"] = int_bound_ms(
                6 * fs.nl * 4 * n_row, issued)
            row["textbook_bound_ms"] = bound(6 * fs.nl * 4 * n_row,
                                             textbook)[0]
            row["textbook_int_bound_ms"] = int_bound_ms(
                6 * fs.nl * 4 * n_row, textbook)
            log(f"  poseidon (lanes) bounds at {n_row} states: "
                f"{row['bound_ms']:.4f} ms at 67 T/s and "
                f"{row['int_bound_ms']:.4f} ms at the measured integer rate "
                f"for the floor's {floor} instructions a state; the "
                f"{counts['instructions']} the form issues at that rate: "
                f"{row['issued_int_bound_ms']:.4f} ms; the textbook's "
                f"{counts['textbook_instructions']}: "
                f"{row['textbook_bound_ms']:.4f} / "
                f"{row['textbook_int_bound_ms']:.4f} ms")
        row["products_in_sequence"] = chain[form]
        row["latency_bound_ms"] = chain[form] * product_ms
        if form == "shared":
            row["counts_per_state"] = shared_counts
            row["textbook_chain_latency_bound_ms"] = \
                shared_counts["textbook_chain"] * product_ms
            log(f"  poseidon (shared): {chain[form]} products in sequence, "
                f"latency bound {row['latency_bound_ms']:.4f} ms (the "
                f"textbook chain's {shared_counts['textbook_chain']}: "
                f"{row['textbook_chain_latency_bound_ms']:.4f} ms); a state "
                f"{shared_counts['products']} products, "
                f"{shared_counts['reductions']} reductions, "
                f"{shared_counts['instructions']} instructions")
        for n in POSEIDON_SIZES:
            states = [rand_field(torch, fs, (3, n), gen)
                      for _ in range(max(1, -(-FLUSH_BYTES
                                              // (3 * fs.nl * 4 * n))))]
            row[f"ms_{n}_states"] = time_ms(
                torch, lambda i: permute(fs, states[i]), len(states), 20,
                queued=True)
        log(f"  {name} ({form}) at " + ", ".join(
            f"{n} states {row[f'ms_{n}_states']:.4f} ms"
            for n in POSEIDON_SIZES)
            + f"; latency bound {row['latency_bound_ms']:.4f} ms")
    lanes_row = form_rows["lanes"]
    digests = [rand_field(torch, fs, (top,), gen) for _ in range(8)]
    lanes_row["level_ms"] = time_ms(
        torch, lambda i: forms("lanes")[1](fs, digests[i]), len(digests), 20,
        queued=True)
    lanes_row["level_shape"] = [fs.nl, top // 2]
    lanes_row["products_per_state"] = counts["products"]
    log(f"  poseidon, node level of {top // 2} states: "
        f"{lanes_row['level_ms']:.4f} ms")
    del digests
    # the tree form: 2 * TREE_MAX digests, every level in one launch
    n2 = 2 * HH.TREE_MAX
    levels = HH.TREE_MAX.bit_length()
    row = measure("poseidon_tree", "crypto3_zk_tpu_torch/csrc/poseidon.cu",
                  "crypto3_zk_tpu/ops/poseidon.py:185", fs, tree, tree_plain,
                  lambda: (rand_field(torch, fs, (n2,), gen),),
                  bytes_moved=fs.nl * 4 * (n2 + 2 * HH.TREE_MAX - 1),
                  ops=floor * (2 * HH.TREE_MAX - 1),
                  per_set_bytes=FLUSH_BYTES, extra_err=err["tree"],
                  plain_reps=1)
    row["form"] = "tree"
    row["products_in_sequence"] = levels * chain["shared"]
    row["latency_bound_ms"] = levels * chain["shared"] * product_ms
    row["textbook_chain_latency_bound_ms"] = \
        levels * shared_counts["textbook_chain"] * product_ms
    log(f"  poseidon_tree: {levels} levels, latency bound "
        f"{row['latency_bound_ms']:.4f} ms (the textbook chain's "
        f"{row['textbook_chain_latency_bound_ms']:.4f} ms)")

    # one whole tree of 2^17 leaf digests down to the root: what
    # `merkle._device_levels` launches, against one launch of the one-thread
    # form a level (the design before the shared and tree forms)
    hasher = MK.FieldHasher(fs)

    def old_levels(digests):
        out = [digests]
        while out[-1].shape[-1] > 1:
            cur = out[-1]
            out.append(HH.poseidon_permute_hopper(
                pp, (cur[:, 0::2], cur[:, 1::2], None), lane0_only=True,
                form="lanes"))
        return out

    leaves = [rand_field(torch, fs, (top,), gen) for _ in range(4)]
    new, old = MK._device_levels(hasher, leaves[0]), old_levels(leaves[0])
    torch.cuda.synchronize()
    if len(new) != len(old) or any(max_abs_err(torch, a, b) != 0
                                   for a, b in zip(new, old)):
        raise AssertionError("the Merkle levels of the new forms differ "
                             "from one-thread levels")
    before = launch_counts()
    MK._device_levels(hasher, leaves[0])
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if k.startswith("poseidon") and v != before[k]}
    tree_ms = {
        "leaves": top, "levels": len(new) - 1, "launches": launches,
        "ms": time_ms(torch, lambda i: MK._device_levels(hasher, leaves[i]),
                      len(leaves), 10, queued=True),
        "old_form_launches": len(old) - 1,
        "old_form_ms": time_ms(torch, lambda i: old_levels(leaves[i]),
                               len(leaves), 10, queued=True)}
    log(f"  merkle tree of {top} leaves: {tree_ms['ms']:.4f} ms in "
        f"{launches}; one-thread form a level {tree_ms['old_form_ms']:.4f} "
        f"ms in {tree_ms['old_form_launches']} launches")
    rows[-1]["merkle_tree_2p17"] = tree_ms


def check_field(torch, fs, gen, compare, measure):
    """The kernel instances of another field (Goldilocks: two words, p
    fills its top word; MNT4 Fr: 19 digits, R = 2^304): every kernel and
    form against its plain version at small shapes, and a time row for
    each (`field` names the field)."""
    from crypto3_zk_tpu_torch.ops import hopper_field as HF
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    from crypto3_zk_tpu_torch.ops import hopper_msm as HM
    from crypto3_zk_tpu_torch.ops import poseidon as PO

    tag = f"[{fs.name}]"
    log(f"  {fs.name}: {fs.nl} digits, {(fs.nl + 1) // 2} words")
    base_measure = measure

    def measure(*args, **kwargs):      # one timed plain call a row
        return base_measure(*args, plain_reps=1, **kwargs)

    a, b = rand_field(torch, fs, (4096,), gen), rand_field(torch, fs,
                                                          (4096,), gen)
    err1 = 0
    for name, kernel, plain in (("mont_mul", HF.mont_mul_hopper,
                                 HF.mont_mul_plain),
                                ("add", HF.add_hopper, HF.add_plain),
                                ("sub", HF.sub_hopper, HF.sub_plain)):
        err1 = max(err1, compare(name, fs, kernel, plain, (a, b)))
    n = 1 << 20
    measure("mont_mul" + tag, "crypto3_zk_tpu_torch/csrc/mont_mul.cu",
            "crypto3_zk_tpu/ops/pallas_field.py:126", fs,
            HF.mont_mul_hopper, HF.mont_mul_plain,
            lambda: (rand_field(torch, fs, (n,), gen),
                     rand_field(torch, fs, (n,), gen)),
            bytes_moved=3 * fs.nl * 4 * n, ops=mont_ops(fs.nl) * n,
            per_set_bytes=2 * fs.nl * 4 * n, extra_err=err1)
    err2 = 0
    for log_b in (1, 2, 5, 10):
        for m_rows in (3, 256):
            for inverse in (False, True):
                err2 = max(err2, compare(
                    "ntt_rows", fs, HF.ntt_rows_hopper, HF.ntt_rows_plain,
                    (rand_field(torch, fs, (m_rows, 1 << log_b), gen),
                     inverse)))
    for log_n in (11, 17):
        for inverse in (False, True):
            err2 = max(err2, compare(
                "ntt_hopper", fs, HF.ntt_hopper, HF.ntt_plain,
                (rand_field(torch, fs, (1 << log_n,), gen), inverse)))
    m_rows, blen = 256, 512
    measure("ntt_rows" + tag, "crypto3_zk_tpu_torch/csrc/ntt_rows.cu",
            "crypto3_zk_tpu/ops/pallas_field.py:184", fs,
            HF.ntt_rows_hopper, HF.ntt_rows_plain,
            lambda: (rand_field(torch, fs, (m_rows, blen), gen), False),
            bytes_moved=fs.nl * 4 * (2 * m_rows * blen + blen // 2),
            ops=m_rows * (blen // 2) * 9 * (mont_ops(fs.nl) + 2 * fs.nl),
            per_set_bytes=fs.nl * 4 * m_rows * blen, extra_err=err2)
    err3 = err4 = err5 = 0
    for k in (1, 17, 64):
        for c in (7, 512):
            err3 = max(err3, compare(
                "inv_scans", fs, HM.inv_scans_hopper, HM.inv_scans_plain,
                (nonzero(torch, rand_field(torch, fs, (k, c), gen)),)))
    err4 = compare("mul3", fs, HM.mul3_bcast_hopper, HM.mul3_bcast_plain,
                   (rand_field(torch, fs, (64, 256), gen),
                    rand_field(torch, fs, (64, 256), gen),
                    rand_field(torch, fs, (256,), gen)))
    for size in (1, 63, HM.INV_TAIL_MAX):
        err5 = max(err5, compare(
            "inv_tail", fs, HM.batch_inverse_small_hopper,
            HM.batch_inverse_small_plain,
            (nonzero(torch, rand_field(torch, fs, (size,), gen)),)))
    k, c = 64, 1 << 15
    scan_bytes = fs.nl * 4 * (3 * k * c + c)
    measure("inv_scans" + tag, "crypto3_zk_tpu_torch/csrc/inv_scans.cu",
            "crypto3_zk_tpu/ops/pallas_msm.py:80", fs,
            HM.inv_scans_hopper, HM.inv_scans_plain,
            lambda: (nonzero(torch, rand_field(torch, fs, (k, c), gen)),),
            bytes_moved=scan_bytes, ops=2 * k * c * mont_ops(fs.nl),
            per_set_bytes=fs.nl * 4 * k * c, extra_err=err3)
    measure("mul3" + tag, "crypto3_zk_tpu_torch/csrc/mul3.cu",
            "crypto3_zk_tpu/ops/pallas_msm.py:124", fs,
            HM.mul3_bcast_hopper, HM.mul3_bcast_plain,
            lambda: (rand_field(torch, fs, (k, c), gen),
                     rand_field(torch, fs, (k, c), gen),
                     rand_field(torch, fs, (c,), gen)),
            bytes_moved=scan_bytes, ops=2 * k * c * mont_ops(fs.nl),
            per_set_bytes=2 * fs.nl * 4 * k * c, extra_err=err4)
    single = nonzero(torch, rand_field(torch, fs, (1,), gen))
    chain_ms = time_ms(torch,
                       lambda i: HM.batch_inverse_small_hopper(fs, single),
                       1, 20, queued=True)
    product_ms = chain_ms / HM.tail_products_in_sequence(fs, 1)
    log(f"  inv_tail{tag} on one element: {chain_ms:.4f} ms, "
        f"{product_ms * 1e3:.3f} us a dependent product")
    measure("inv_tail" + tag, "crypto3_zk_tpu_torch/csrc/inv_scans.cu",
            "crypto3_zk_tpu/ops/pallas_msm.py:80", fs,
            HM.batch_inverse_small_hopper, HM.batch_inverse_small_plain,
            lambda: (nonzero(torch, rand_field(torch, fs, (512,), gen)),),
            bytes_moved=2 * fs.nl * 4 * 512, ops=0,
            per_set_bytes=FLUSH_BYTES, extra_err=err5,
            latency_bound_ms=product_ms
            * HM.tail_products_in_sequence(fs, 512))
    pp = PO.get_params(fs)
    floor = HH.lanes_counts(pp)["floor_instructions"]

    def planes(state):
        return (state[:, 0], state[:, 1], state[:, 2])

    def permute_plain(fs_, state):
        return HH.poseidon_permute_plain(pp, planes(state))

    errs = {}
    for form in ("lanes", "shared"):
        def permute(fs_, state, form=form):
            return HH.poseidon_permute_hopper(pp, planes(state), form=form)
        errs[form] = 0
        for n in (1, 33, 4096):
            errs[form] = max(errs[form], compare(
                f"poseidon({form})", fs, permute, permute_plain,
                (rand_field(torch, fs, (3, n), gen),)))
    errs["tree"] = compare(
        "poseidon(tree)", fs,
        lambda fs_, d: tuple(HH.poseidon_tree_hopper(pp, d)),
        lambda fs_, d: tuple(HH.poseidon_tree_plain(pp, d)),
        (rand_field(torch, fs, (2 * HH.TREE_MAX,), gen),))
    for form, name, n_row in (("lanes", "poseidon", 1 << 14),
                              ("shared", "poseidon_shared", 1 << 12)):
        row = measure(
            name + tag, "crypto3_zk_tpu_torch/csrc/poseidon.cu",
            "crypto3_zk_tpu/ops/poseidon.py:185", fs,
            lambda fs_, state, form=form: HH.poseidon_permute_hopper(
                pp, planes(state), form=form),
            permute_plain,
            lambda: (rand_field(torch, fs, (3, n_row), gen),),
            bytes_moved=6 * fs.nl * 4 * n_row,
            ops=floor * n_row,
            per_set_bytes=3 * fs.nl * 4 * n_row, extra_err=errs[form])
        row["form"] = form
    n2 = 2 * HH.TREE_MAX
    measure("poseidon_tree" + tag, "crypto3_zk_tpu_torch/csrc/poseidon.cu",
            "crypto3_zk_tpu/ops/poseidon.py:185", fs,
            lambda fs_, d: tuple(HH.poseidon_tree_hopper(pp, d)),
            lambda fs_, d: tuple(HH.poseidon_tree_plain(pp, d)),
            lambda: (rand_field(torch, fs, (n2,), gen),),
            bytes_moved=fs.nl * 4 * (n2 + 2 * HH.TREE_MAX - 1),
            ops=floor * (2 * HH.TREE_MAX - 1),
            per_set_bytes=FLUSH_BYTES, extra_err=errs["tree"])


SHA256_MESSAGES = 1 << 18        # kernel 7: a level of 2^18 node messages
SHA256_LEAF_BYTES = 256          # and 2^18 leaves of 8 bls12-381 Fr values
# the leaf form's small cases (field, elements a leaf): every instance at 1,
# 2 and 8 elements, and the two leaves whose bit length takes a block of
# its own (7 x 8 and 5 x 38 bytes leave 56 and 62 in their last block)
SHA256_LEAF_CASES = tuple(
    (f, kk) for f in ("GOLDILOCKS", "BLS12_381_FR", "MNT4_FR", "BLS12_381_FQ")
    for kk in (1, 2, 8)) + (("GOLDILOCKS", 7), ("MNT4_FR", 5))


def check_sha256(torch, compare, measure):
    """Kernel 7 against its plain version (the same compression in int64
    tensor ops), exact, in its three forms at the sha2 LPC path's widths:
    the node form on 2^18 messages (a level of 2^19 random digests read in
    place), the block form on 2^18 padded messages of 256 bytes (4 blocks
    read, the fifth, pure padding, from `padding_schedule(256)`; and all 5
    read, as for a length not given) and the leaf form on 2^18 leaves of 8
    bls12-381 Fr values (Montgomery rows; the kernel reads the digit planes
    `from_mont` makes); at small ragged sizes for every leaf instance (8,
    32, 38 and 48 bytes an element, 1, 2 and 8 elements a leaf, and 7
    Goldilocks and 5 MNT4 Fr values, 56 and 190 bytes, whose bit length
    takes a block of its own); samples of 64 messages of each form against
    `hashlib`. Bound: the instructions of the shortest schedule
    (`ops/sha256.py::sha256_counts`) at the issue rate, beside the per-pipe
    floor of the kernels' own SASS. Kernel 7's block form runs on no path
    (the leaf form took its place): it is held and timed here only."""
    import hashlib

    from crypto3_zk_tpu_torch.fields import params as P
    from crypto3_zk_tpu_torch.ops import limbs as L
    from crypto3_zk_tpu_torch.ops import sha256 as SH
    from crypto3_zk_tpu_torch.transcript.fiat_shamir import field_to_bytes

    n = SHA256_MESSAGES
    k = SHA256_LEAF_BYTES // 32
    label = P.BLS12_381_FR          # the field of the sha2 path's leaves
    gen = torch.Generator(device="cuda")
    gen.manual_seed(256)

    def words(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                             device="cuda", dtype=torch.int32)

    def leaves():
        msgs = torch.randint(0, 256, (n, SHA256_LEAF_BYTES), generator=gen,
                             device="cuda", dtype=torch.int64)
        return (msgs, SH.pad_messages(msgs))

    def rows_of(fs, kk, m):
        """(kk, NL, m) Montgomery rows of elements below p."""
        return rand_field(torch, fs, (kk, m), gen).permute(1, 0, 2) \
            .contiguous()

    def digits_of(fs, rows):
        return L.from_mont(fs, rows.permute(1, 0, 2))

    def leaf_kernel(fs, rows, digits):
        return SH.sha256_field_digits_hopper(digits, rows.shape[0],
                                             SH.leaf_half(fs))

    def leaf_plain(fs, rows, digits):
        return SH.sha256_field_rows_plain(fs, rows)

    t0 = time.perf_counter()
    for m in (1, 127, 129):          # ragged blocks of threads
        compare("sha256_nodes", label, lambda fs, x: SH.sha256_nodes_hopper(x),
                lambda fs, x: SH.sha256_nodes_plain(x), (words((8, 2 * m)),))
        compare("sha256", label, lambda fs, x: SH.sha256_blocks_hopper(x),
                lambda fs, x: SH.sha256_blocks_plain(x), (words((32, m)),))
        compare("sha256_field_rows", label,
                lambda fs_, r: SH.sha256_field_rows_hopper(fs_, r),
                lambda fs_, r: SH.sha256_field_rows_plain(fs_, r),
                (rows_of(label, k, m),))
    # every length kind and every leaf instance, on two blocks of threads,
    # the second ragged
    for length in (55, 56, 64, 119, 120, 256):
        msgs = torch.randint(0, 256, (129, length), generator=gen,
                             device="cuda", dtype=torch.int64)
        compare(f"sha256(length {length})", label,
                lambda fs, x: SH.sha256_blocks_hopper(x, length),
                lambda fs, x: SH.sha256_blocks_plain(x),
                (SH.pad_messages(msgs),))
    for name, kk in SHA256_LEAF_CASES:
        fs = getattr(P, name)
        compare("sha256_field_rows", fs,
                lambda fs_, r: SH.sha256_field_rows_hopper(fs_, r),
                lambda fs_, r: SH.sha256_field_rows_plain(fs_, r),
                (rows_of(fs, kk, 129),))

    def sample(digests, messages) -> None:
        got = SH.digests_to_bytes(digests[:, :64])
        if got != [hashlib.sha256(m).digest() for m in messages]:
            raise AssertionError("kernel 7 disagrees with hashlib")

    level = words((8, 2 * n))
    pairs = SH.digests_to_bytes(level[:, :128])
    sample(SH.sha256_nodes_hopper(level),
           [pairs[2 * i] + pairs[2 * i + 1] for i in range(64)])
    msgs, padded = leaves()
    raw = msgs[:64].cpu().numpy().astype("uint8")
    sample(SH.sha256_blocks_hopper(padded), [bytes(r) for r in raw])
    sample(SH.sha256_blocks_hopper(padded, SHA256_LEAF_BYTES),
           [bytes(r) for r in raw])
    leaf_samples = [(name, k) for name in ("GOLDILOCKS", "BLS12_381_FR",
                                           "MNT4_FR", "BLS12_381_FQ")]
    leaf_samples += [c for c in SHA256_LEAF_CASES if c[1] not in (1, 2, 8)]
    for name, kk in leaf_samples:
        fs = getattr(P, name)
        rows = rows_of(fs, kk, 64)
        vals = [L.decode(fs, rows[e]) for e in range(kk)]
        sample(SH.sha256_field_rows_hopper(fs, rows),
               [b"".join(field_to_bytes(fs, vals[e][i]) for e in range(kk))
                for i in range(64)])
    log(f"  sha256: 64 node, 2 x 64 block and {len(leaf_samples)} x 64 leaf "
        f"messages equal to hashlib")
    del level, msgs, padded

    nb = SH.padded_blocks(SHA256_LEAF_BYTES)
    nodes = measure("sha256_nodes", "crypto3_zk_tpu_torch/csrc/sha256.cu",
            "crypto3_zk_tpu/ops/sha256.py:39", label,
            lambda fs, x: SH.sha256_nodes_hopper(x),
            lambda fs, x: SH.sha256_nodes_plain(x),
            lambda: (words((8, 2 * n)),),
            bytes_moved=3 * 8 * 4 * n, ops=0,
            per_set_bytes=2 * 8 * 4 * n,
            issue_instructions=SH.sha256_counts(1, 1)["instructions"] * n)
    blocks = measure("sha256", "crypto3_zk_tpu_torch/csrc/sha256.cu",
                     "crypto3_zk_tpu/ops/sha256.py:39", label,
                     lambda fs, x: SH.sha256_blocks_hopper(
                         x, SHA256_LEAF_BYTES),
                     lambda fs, x: SH.sha256_blocks_plain(x),
                     lambda: (leaves()[1],),
                     bytes_moved=(16 * (nb - 1) + 8) * 4 * n, ops=0,
                     per_set_bytes=16 * nb * 4 * n,
                     issue_instructions=SH.sha256_counts(nb - 1, 1)[
                         "instructions"] * n)
    # the same messages with every block read and scheduled (the contract's
    # path for a length not given)
    all_sets = [leaves()[1] for _ in range(2)]
    blocks["all_blocks_read_ms"] = time_ms(
        torch, lambda i: SH.sha256_blocks_hopper(all_sets[i]), 2, 20,
        queued=True)
    del all_sets

    def leaf_set():
        rows = rows_of(label, k, n)
        return (rows, digits_of(label, rows))

    leaf = measure("sha256_field_rows",
                   "crypto3_zk_tpu_torch/csrc/sha256_leaf.cu",
                   "crypto3_zk_tpu/ops/sha256.py:39", label, leaf_kernel,
                   leaf_plain, leaf_set,
                   bytes_moved=(k * 16 + 8) * 4 * n, ops=0,
                   per_set_bytes=2 * k * 16 * 4 * n,
                   issue_instructions=SH.sha256_counts(nb - 1, 1)[
                       "instructions"] * n)
    sha256_issue_bounds(torch, nodes, blocks, leaf, nb, n)
    log(f"  kernel 7's checks: {time.perf_counter() - t0:.2f} s")


def sha256_issue_bounds(torch, nodes: dict, blocks: dict, leaf: dict,
                        nb: int, n: int) -> None:
    """Kernel 7's floor from its own instructions: `cuobjdump -sass` of the
    built library, counted by pipe a message (each loop by its trips:
    the block form's nb - 1 blocks read, the leaf form's nb - 1 full
    blocks and no tail block; the padding block once, `tools/sass_mix.py`),
    at the card's SM count and highest SM clock; and `ptxas -v`'s registers
    and spills. Adds `sass_per_message`, `issue_bound_ms`, `issue_bound_by`
    and `ptxas` to the three rows."""
    from crypto3_zk_tpu_torch import kernels as K
    from crypto3_zk_tpu_torch.tools import sass_mix as SM
    from crypto3_zk_tpu_torch.tools import timing as T
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = SM.max_sm_clock_hz()
    ptxas = {}
    for source in ("sha256.cu", "sha256_leaf.cu"):
        ptxas.update(T.ptxas_table(K.build_log(source),
                                   lambda f: f if "sha256" in f else None))
    for row, source, kernel, trips in (
            (nodes, "sha256.cu", "sha256_nodes_kernel", 1),
            (blocks, "sha256.cu", "sha256_blocks_kernel", nb - 1),
            (leaf, "sha256_leaf.cu", "sha256_field_rows_kernelILi16E",
             [nb - 1, 0])):
        per = SM.kernel_mix(source, kernel, trips)
        ms, by = SM.floor_ms(per, n, sms, clock)
        row.update(sass_per_message=per, issue_bound_ms=ms,
                   issue_bound_by=by, sm_clock_mhz=clock / 1e6,
                   ptxas={k: v for k, v in ptxas.items() if kernel in k})
        log(f"  {row['name']}: {per['total']} instructions a message "
            f"(alu {per['alu']}, fma {per['fma']}, mem {per['mem']}, "
            f"uniform {per['uniform']}, control {per['control']}; "
            f"{per['top_opcodes']}), issue-rate floor {ms:.4f} ms by {by} "
            f"at {sms} SMs x {clock / 1e6:.0f} MHz: {row['ms']:.4f} ms is "
            f"{100 * ms / row['ms']:.0f} % of it; ptxas {row['ptxas']}")


def launch_counts() -> dict:
    from crypto3_zk_tpu_torch.ops import hopper_curve as HC
    from crypto3_zk_tpu_torch.ops import hopper_field as HF
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    from crypto3_zk_tpu_torch.ops import hopper_msm as HM
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    from crypto3_zk_tpu_torch.ops import sha256 as SH
    return {**HF.LAUNCHES, **HM.LAUNCHES, **HH.LAUNCHES, **HC.LAUNCHES,
            **SH.LAUNCHES, **MX.LAUNCHES}


def reset_launch_counts() -> None:
    from crypto3_zk_tpu_torch.ops import hopper_curve as HC
    from crypto3_zk_tpu_torch.ops import hopper_field as HF
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    from crypto3_zk_tpu_torch.ops import hopper_msm as HM
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    from crypto3_zk_tpu_torch.ops import sha256 as SH
    for counts in (HF.LAUNCHES, HF.LARGEST, HM.LAUNCHES, HM.ELEMENTS,
                   HH.LAUNCHES, HH.ELEMENTS, HC.LAUNCHES, HC.ELEMENTS,
                   SH.LAUNCHES, SH.ELEMENTS, MX.LAUNCHES):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

GROTH16_KERNELS = ("mont_mul", "ntt_rows", "inv_scans", "mul3", "inv_tail")
LPC_KERNELS = GROTH16_KERNELS + ("poseidon", "poseidon_shared",
                                  "poseidon_tree")
PLACEHOLDER_KERNELS = LPC_KERNELS

TOXIC = {"t": 0x1234567, "alpha": 0x2345678, "beta": 0x3456789,
         "gamma": 0x456789A, "delta": 0x56789AB}


def small_agreement(torch):
    """The card's proof equals the proof of the plain versions on the CPU on
    a 20-constraint circuit, with the MSM thresholds lowered so that the
    batched-affine MSM runs on both."""
    from crypto3_zk_tpu_torch.arithmetization.circuits import product_chain
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.models import groth16 as G16

    curve = CV.ALT_BN128
    saved = (G16._DEVICE_MSM_MIN, G16._MSM_WINDOW_BITS,
             G16._FIXED_BASE_DEVICE_MIN)
    G16._DEVICE_MSM_MIN, G16._MSM_WINDOW_BITS = 8, 5
    G16._FIXED_BASE_DEVICE_MIN = 8
    try:
        proofs = []
        for device in ("cuda", "cpu"):
            cs, primary, aux = product_chain(curve.fr.p, 20)
            kp = G16.generate(curve, cs, toxic=TOXIC, device=device)
            proofs.append((kp.pk.A_query, kp.pk.B_query_g2, G16.prove(
                kp.pk, primary, aux, zk_rs=(11, 13), device=device)))
        if proofs[0] != proofs[1]:
            raise AssertionError("card and CPU proofs differ on the small "
                                 "circuit")
        if not G16.verify(kp.vk, primary, proofs[0][2]):
            raise AssertionError("small-circuit proof rejected")
    finally:
        (G16._DEVICE_MSM_MIN, G16._MSM_WINDOW_BITS,
         G16._FIXED_BASE_DEVICE_MIN) = saved


def msm_oracle_check(curve, log_n: int = 10, seed: int = 7) -> float:
    """A 2^10 G1 MSM over small multiples of the generator, whose exact
    answer is one scalar reduction."""
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.ops.msm_affine import MSMBases

    n = 1 << log_n
    rng = random.Random(seed)
    base, acc = [], None
    for _ in range(256):
        acc = CV.g1_add(curve, acc, curve.g1)
        base.append(acc)
    sel = [rng.randrange(256) for _ in range(n)]
    scalars = [rng.randrange(curve.fr.p) for _ in range(n)]
    tot = sum(s * (j + 1) for j, s in zip(sel, scalars)) % curve.fr.p
    t0 = time.perf_counter()
    got = MSMBases(curve, [base[j] for j in sel]).run(scalars)
    dt = time.perf_counter() - t0
    if got != CV.g1_mul(curve, curve.g1, tot):
        raise AssertionError(f"MSM 2^{log_n} on {curve.name} disagrees "
                             f"with its oracle")
    return dt


def main_path(torch) -> dict:
    from crypto3_zk_tpu_torch.arithmetization.circuits import product_chain
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.models import groth16 as G16

    curve = CV.ALT_BN128
    ncons = 1 << LOG2_CONSTRAINTS
    t0 = time.perf_counter()
    cs, primary, aux = product_chain(curve.fr.p, ncons)
    log(f"circuit: product chain, {ncons} constraints, "
        f"{cs.num_variables} variables: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    kp = G16.generate(curve, cs, toxic=TOXIC)
    torch.cuda.synchronize()
    log(f"keygen: {time.perf_counter() - t0:.2f} s")
    for name in ("A_query", "B_query_g1", "B_query_g2", "H_query", "L_query"):
        q = getattr(kp.pk, name)
        log(f"  {name}: {len(q)} bases, "
            f"{sum(pt is not None for pt in q)} finite")
    if sum(pt is not None for pt in kp.pk.B_query_g2) < ncons:
        raise AssertionError("the B side of the circuit is not dense")

    zk_rng = random.Random(12)
    for attempt in ("first", "second"):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        proof = G16.prove(kp.pk, primary, aux, rng=zk_rng)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        phases = ", ".join(f"{k} {v:.2f}"
                           for k, v in G16.LAST_PROVE_SECONDS.items())
        log(f"prove ({attempt}): {dt:.2f} s [{phases}] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log(f"kernel launches in the second prove: {counts}")
    from crypto3_zk_tpu_torch.ops import hopper_msm as HM
    log(f"field elements those launches ran on: {HM.ELEMENTS}, a launch: "
        + str({k: v // max(counts[k], 1) for k, v in HM.ELEMENTS.items()}))
    idle = [k for k in GROTH16_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError(f"prove never launched {idle}")

    t0 = time.perf_counter()
    ok = G16.verify(kp.vk, primary, proof)
    log(f"verify: {time.perf_counter() - t0:.2f} s -> {ok}")
    if not ok:
        raise AssertionError("the host verifier rejected the proof")
    if G16.verify(kp.vk, [primary[0] + 1], proof):
        raise AssertionError("the verifier accepted a wrong public input")
    log("verify with public input + 1: rejected")
    return counts


# ---------------------------------------------------------------------------
# phase 5: the LPC path (commit -> proof_eval -> verify_eval)
# ---------------------------------------------------------------------------

def small_agreement_lpc(torch):
    """At degree_log = 6 (D0 = 2^8, trees of 128 leaves and fewer, every
    level by kernel 5) the card's LPC proof, roots and next challenge equal
    the CPU plain path's."""
    from crypto3_zk_tpu_torch.tools.lpc_fixture import LPCRun

    got = []
    for device in ("cuda", "cpu"):
        run = LPCRun(6, 4, device)
        run.commit(lambda: None)
        proof, challenge = run.prove(lambda: None)
        got.append((run.roots, proof.z.z, proof.fri_proof, challenge))
    if got[0] != got[1]:
        raise AssertionError("card and CPU LPC proofs differ")
    ok, challenge = run.verify(proof)
    if not ok or challenge != got[0][3]:
        raise AssertionError("small LPC proof rejected")


def lpc_path(torch) -> tuple[dict, dict]:
    """The LPC path at full size. Returns (launch counts of the whole path,
    launch counts of the second `proof_eval` alone)."""
    import copy
    from crypto3_zk_tpu_torch.commitments.fri import PhaseClock
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    from crypto3_zk_tpu_torch.ops import hopper_msm as HM
    from crypto3_zk_tpu_torch.tools.lpc_fixture import LPCRun

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    run = LPCRun(LPC_LOG2_DEGREE, 40, "cuda")
    sync()
    log(f"lpc: 8 polynomials of degree < 2^{LPC_LOG2_DEGREE} and 4 of degree "
        f"< 3*2^{LPC_LOG2_DEGREE - 2} over {run.fs.name}, D0 = "
        f"{run.params.D[0].n}, lambda 40, steps {run.params.step_list}: "
        f"{time.perf_counter() - t0:.2f} s")
    run.commit(sync)
    log("lpc " + ", ".join(f"{k}: {v:.3f} s" for k, v in run.seconds.items()))
    for attempt in ("first", "second"):
        before = launch_counts()
        clock = PhaseClock("cuda")
        proof, challenge = run.prove(sync, clock)
        phases = ", ".join(f"{k} {v:.3f}" for k, v in clock.seconds.items())
        log(f"lpc proof_eval ({attempt}): {run.seconds['proof_eval']:.3f} s "
            f"[{phases}] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    per_proof = {k: v - before[k] for k, v in launch_counts().items()}
    log(f"kernel launches in the second proof_eval: {per_proof}")

    t0 = time.perf_counter()
    ok, verifier_challenge = run.verify(proof)
    log(f"lpc verify_eval: {time.perf_counter() - t0:.2f} s -> {ok}")
    counts = launch_counts()
    log(f"kernel launches on the LPC path (two commits, two proof_evals, "
        f"verify): {counts}")
    log(f"field elements the inversion and hash launches ran on: "
        f"{ {**HM.ELEMENTS, **HH.ELEMENTS} }")
    if not ok:
        raise AssertionError("the LPC verifier rejected the proof")
    if challenge != verifier_challenge:
        raise AssertionError("prover and verifier transcripts differ")
    log("lpc transcripts: same next challenge")
    idle = [k for k in LPC_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError(f"the LPC path never launched {idle}")

    bad = copy.deepcopy(proof)
    bad.z.z[0][0][0] = (bad.z.z[0][0][0] + 1) % run.fs.p
    t0 = time.perf_counter()
    if run.verify(bad)[0]:
        raise AssertionError("the verifier accepted a tampered evaluation")
    log(f"lpc verify_eval with one z value changed: rejected "
        f"({time.perf_counter() - t0:.2f} s)")
    return counts, per_proof


# ---------------------------------------------------------------------------
# phase 6: the Placeholder path (process -> prove -> verify)
# ---------------------------------------------------------------------------

# the tables: 2^k rows, 2^k - 6 usable. The deeper table was 2^18 rows
# (longest transform 2^21) up to PR 9; it is 2^17 (2^20) since the Pasta
# and sha2 paths joined, to keep the whole run near its earlier length.
PLACEHOLDER_LOG2_ROWS = (16, 17)


def small_agreement_placeholder(torch):
    """At 2^4 rows (a table of 4, lambda 4, Poseidon trees) the card's
    Placeholder proof and next challenge equal the CPU plain path's, and
    the proof verifies."""
    from crypto3_zk_tpu_torch.convert import placeholder_proof_as_plain
    from crypto3_zk_tpu_torch.tools.placeholder_fixture import PlaceholderRun

    got = []
    for device in ("cuda", "cpu"):
        run = PlaceholderRun(4, device, lambda_=4, table_bits=2)
        run.preprocess()
        proof, challenge = run.prove()
        got.append((placeholder_proof_as_plain(proof), challenge))
    if got[0] != got[1]:
        raise AssertionError("card and CPU Placeholder proofs differ")
    ok, challenge = run.verify(proof)
    if not ok or challenge != got[0][1]:
        raise AssertionError("small Placeholder proof rejected")


def placeholder_path(torch, rows_log: int) -> tuple[dict, dict, int, dict]:
    """The Placeholder path at 2^rows_log rows. Returns (launch counts of
    the whole path, launch counts of the second prove alone, the longest
    transform the prove ran, device ms and calls of each form of kernel 5
    in one more prove under `torch.profiler`)."""
    import copy
    from crypto3_zk_tpu_torch.commitments.fri import PhaseClock
    from crypto3_zk_tpu_torch.models.placeholder import common as PC
    from crypto3_zk_tpu_torch.ops import hopper_field as HF
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    from crypto3_zk_tpu_torch.ops import hopper_msm as HM
    from crypto3_zk_tpu_torch.tools import profile_prove as PRF
    from crypto3_zk_tpu_torch.tools.placeholder_fixture import PlaceholderRun

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = PlaceholderRun(rows_log, "cuda")
    desc = run.desc
    log(f"placeholder: placeholder_chain, {desc.rows_amount} rows "
        f"({desc.usable_rows_amount} usable), {desc.witness_columns} "
        f"witness / {desc.public_input_columns} public / "
        f"{desc.constant_columns} constant / {desc.selector_columns} "
        f"selector columns, {len(run.cs.copy_constraints)} copy "
        f"constraints, lookup table of {1 << run.table_bits}, over "
        f"{run.fs.name}, D0 = "
        f"{run.fri_params.D[0].n}, lambda 40: circuit "
        f"{run.seconds['circuit']:.2f} s")
    clock = PhaseClock("cuda")
    run.preprocess(clock)
    log("placeholder process_public: "
        f"{run.seconds['process_public']:.3f} s ["
        + ", ".join(f"{k} {v:.3f}" for k, v in clock.seconds.items())
        + f"], process_private {run.seconds['process_private']:.3f} s")
    for attempt in ("first", "second"):
        before = launch_counts()
        clock = PhaseClock("cuda")
        t0 = time.perf_counter()
        proof, challenge = run.prove(clock)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"placeholder prove ({attempt}): {dt:.3f} s ["
            + ", ".join(f"{k} {v:.3f}" for k, v in clock.seconds.items())
            + f"] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    per_prove = {k: v - before[k] for k, v in launch_counts().items()}
    longest = HF.LARGEST["ntt_hopper"]
    log(f"kernel launches in the second prove: {per_prove}; longest "
        f"transform 2^{longest.bit_length() - 1}; quotient chunks "
        f"{len(proof.eval_proof.eval_proof.z.z[PC.QUOTIENT_BATCH])}")

    t0 = time.perf_counter()
    ok, verifier_challenge = run.verify(proof)
    log(f"placeholder verify: {time.perf_counter() - t0:.2f} s -> {ok}")
    counts = launch_counts()
    log(f"kernel launches on the Placeholder path (preprocess, two proves, "
        f"verify): {counts}")
    log(f"field elements the inversion and hash launches ran on: "
        f"{ {**HM.ELEMENTS, **HH.ELEMENTS} }")
    if not ok:
        raise AssertionError("the Placeholder verifier rejected the proof")
    if challenge != verifier_challenge:
        raise AssertionError("prover and verifier transcripts differ")
    log("placeholder transcripts: same next challenge")
    idle = [k for k in PLACEHOLDER_KERNELS if per_prove[k] <= 0]
    if idle:
        raise AssertionError(f"the Placeholder prove never launched {idle}")

    t0 = time.perf_counter()
    wrong = [[(run.public_input[0][0] + 1) % run.fs.p]]
    if run.verify(proof, wrong)[0]:
        raise AssertionError("the verifier accepted a wrong public input")
    log(f"placeholder verify with public input + 1: rejected "
        f"({time.perf_counter() - t0:.2f} s)")
    bad = copy.deepcopy(proof)
    z = bad.eval_proof.eval_proof.z.z
    z[PC.VARIABLE_VALUES_BATCH][0][0] = \
        (z[PC.VARIABLE_VALUES_BATCH][0][0] + 1) % run.fs.p
    t0 = time.perf_counter()
    if run.verify(bad)[0]:
        raise AssertionError("the verifier accepted a changed opened value")
    log(f"placeholder verify with one opened value changed: rejected "
        f"({time.perf_counter() - t0:.2f} s)")
    device = PRF._device_profile(lambda: run.prove()[0])
    poseidon = PRF.poseidon_device_ms(device)
    log(f"placeholder prove at 2^{rows_log} rows under torch.profiler: "
        f"device busy {device['device_busy_s']:.4f} s of "
        f"{device['wall_s_profiled']:.3f} s; kernel 5 by form: {poseidon}")
    return counts, per_prove, longest, poseidon


# ---------------------------------------------------------------------------
# phase 7: KZG commitments and the Placeholder prover over KZG
# ---------------------------------------------------------------------------

KZG_LOG2_ROWS = 16
KZG_WINDOWS = (4, 5, 6, 8, 10)     # widths timed at a 2^16-term commitment
KZG_WINDOW_ROUNDS = 15             # rounds of the sweep, each timing every width


def msm_against_host(torch, log_n: int = 10) -> None:
    """`ops.msm.msm` on the card at 2^10 bases over alt_bn128 and
    bls12-381, G1 and G2. The bases are small multiples j * g of the
    generator, so msm_host's answer is also (sum s_i j_i) * g: G1 is held
    against `msm_host` itself, G2 (whose host scalar multiplications would
    take minutes) against that one multiplication."""
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.ops.msm import msm, msm_host

    n = 1 << log_n
    for curve in (CV.ALT_BN128, CV.BLS12_381):
        for group in ("g1", "g2"):
            add = CV.g1_add if group == "g1" else CV.g2_add
            mul = CV.g1_mul if group == "g1" else CV.g2_mul
            gen = curve.g1 if group == "g1" else curve.g2
            rng = random.Random(n + len(group))
            table, acc = [], None
            for _ in range(64):
                acc = add(curve, acc, gen)
                table.append(acc)
            sel = [rng.randrange(64) for _ in range(n)]
            scalars = [rng.randrange(curve.fr.p) for _ in range(n)]
            scalars[5] = 0
            pts = [table[j] for j in sel]
            t0 = time.perf_counter()
            got = msm(curve, pts, scalars, group=group, device="cuda")
            dt = time.perf_counter() - t0
            if group == "g1":
                t1 = time.perf_counter()
                want = msm_host(curve, pts, scalars)
                oracle = f"msm_host ({time.perf_counter() - t1:.2f} s)"
            else:
                want = mul(curve, gen, sum(s * (j + 1) for j, s in
                                           zip(sel, scalars)) % curve.fr.p)
                oracle = "(sum s_i j_i) * g2"
            if got != want:
                raise AssertionError(f"msm 2^{log_n} {group} on {curve.name} "
                                     f"disagrees with its oracle")
            log(f"msm 2^{log_n} {group} on {curve.name}: {dt:.2f} s, equal "
                f"to {oracle}")


def small_agreement_placeholder_kzg(torch) -> None:
    """`circuit_1` over alt_bn128 Fr proved over KZG v2 and BDFG on the card
    and on the CPU: the proofs and the next challenges are equal, and the
    card's proof verifies."""
    from crypto3_zk_tpu_torch.arithmetization.circuits import circuit_1
    from crypto3_zk_tpu_torch.commitments import kzg as KZG
    from crypto3_zk_tpu_torch.convert import placeholder_proof_as_plain
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.models.placeholder import common as PCM
    from crypto3_zk_tpu_torch.models.placeholder import preprocessor as PP
    from crypto3_zk_tpu_torch.models.placeholder.prover import prove
    from crypto3_zk_tpu_torch.models.placeholder.verifier import verify
    from crypto3_zk_tpu_torch.transcript.poseidon_transcript import \
        make_transcript

    curve = CV.ALT_BN128
    fs = curve.fr
    for cls in (KZG.KZGSchemeV2, KZG.KZGSchemeBDFG):
        got = []
        for device in ("cuda", "cpu"):
            rng = random.Random(0xCD)
            cs, asg, desc, pub_in = circuit_1(fs.p, rng)
            params = PCM.PlaceholderParams(fs, transcript_hash="keccak_256")
            kparams = KZG.KZGParams.setup(curve, 4 * desc.rows_amount + 8,
                                          tau=rng.randrange(2, fs.p), d2=8,
                                          device=device)
            scheme = cls(kparams, device)
            pub = PP.process_public(params, cs, asg, desc, scheme,
                                    device=device)
            priv = PP.process_private(params, cs, asg, desc, device=device)
            tr = make_transcript("keccak_256", fs, b"")
            proof = prove(params, pub, priv, desc, cs, scheme.fork(), None,
                          tr, device)
            got.append((kparams.commitment_key,
                        placeholder_proof_as_plain(proof), tr.challenge(fs)))
            tr = make_transcript("keccak_256", fs, b"")
            if not verify(params, pub.common_data, proof, desc, cs,
                          cls(kparams), public_input=pub_in, transcript=tr) \
                    or tr.challenge(fs) != got[-1][2]:
                raise AssertionError(f"the {cls.__name__} circuit_1 proof "
                                     f"made on {device} was rejected")
        if got[0] != got[1]:
            raise AssertionError(f"card and CPU {cls.__name__} proofs differ")


def kzg_commit_checks(torch, run) -> dict:
    """At the path's commitment size (a 2^16-coefficient polynomial): the
    MSM's time by window width (`tools/msm_windows.py::window_sweep`,
    `KZG_WINDOW_ROUNDS` rounds), and one commitment by the tensor path
    against the reference's host-int round trip, on a `PhaseClock`."""
    from crypto3_zk_tpu_torch.commitments import kzg as KZG
    from crypto3_zk_tpu_torch.commitments.fri import PhaseClock
    from crypto3_zk_tpu_torch.ops import limbs as L
    from crypto3_zk_tpu_torch.tools.msm_windows import quartiles, window_sweep

    n = run.desc.rows_amount
    poly = run.private.witnesses[0].coefficients()
    if poly.n != n:
        raise AssertionError("a witness column's coefficients are not n long")
    sweep = window_sweep(run.curve, run.kzg_params.commitment_key[:n],
                         L.from_mont(run.fs, poly.c), KZG_WINDOWS,
                         KZG_WINDOW_ROUNDS)
    q = {c: quartiles(v) for c, v in sweep["times_ms"].items()}
    out = {"window_ms": {c: v[1] for c, v in q.items()},
           "window_q1_q3_ms": {c: (v[0], v[2]) for c, v in q.items()}}
    log(f"kzg commit of 2^16 terms by window width, {KZG_WINDOW_ROUNDS} "
        f"rounds (ms, median [quartiles]): "
        + ", ".join(f"{c}: {v[1]:.1f} [{v[0]:.1f}, {v[2]:.1f}]"
                    for c, v in q.items())
        + f"; fastest {min(out['window_ms'], key=out['window_ms'].get)}, "
        f"chosen COMMIT_WINDOW_BITS = {KZG.COMMIT_WINDOW_BITS}")
    KZG.commit_poly(run.kzg_params, poly)          # warm the encoded key
    clock = PhaseClock("cuda")
    a = KZG.commit_poly(run.kzg_params, poly)
    clock.mark("commit_tensor")
    b = KZG.commit_one(run.kzg_params, poly.to_ints(), "cuda")
    clock.mark("commit_host_ints")
    if not a == b == sweep["point"]:
        raise AssertionError("the tensor and host-int commitments differ")
    out.update(clock.seconds)
    log(f"kzg commitment of 2^16 terms: tensor path "
        f"{clock.seconds['commit_tensor']:.3f} s, host int round trip "
        f"{clock.seconds['commit_host_ints']:.3f} s")
    return out


def placeholder_kzg_path(torch) -> tuple[dict, dict, dict]:
    """Placeholder over KZG at 2^16 rows (alt_bn128 Fr, keccak transcript,
    `KZGSchemeV2`), from an SRS made on the card; then `KZGSchemeBDFG` on
    the same table and SRS. Returns (launch counts of the whole path,
    launch counts of the second v2 prove, numbers for the report)."""
    import copy
    from crypto3_zk_tpu_torch.commitments.fri import PhaseClock
    from crypto3_zk_tpu_torch.models.placeholder import common as PC
    from crypto3_zk_tpu_torch.tools import profile_prove as PRF
    from crypto3_zk_tpu_torch.tools.placeholder_fixture import \
        PlaceholderKZGRun

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    report = {}
    run = PlaceholderKZGRun(KZG_LOG2_ROWS, "cuda", "v2")
    torch.cuda.synchronize()
    desc = run.desc
    report["setup_s"] = run.seconds["kzg_setup"]
    log(f"placeholder over kzg: placeholder_chain, {desc.rows_amount} rows "
        f"over {run.fs.name}, SRS of {len(run.kzg_params.commitment_key)} "
        f"G1 powers made on the card in {run.seconds['kzg_setup']:.2f} s, "
        f"{len(run.kzg_params.verification_key)} in G2")
    clock = PhaseClock("cuda")
    run.preprocess(clock)
    report["process_public_s"] = run.seconds["process_public"]
    report["process_public"] = dict(clock.seconds)
    log("placeholder-kzg process_public: "
        f"{run.seconds['process_public']:.3f} s ["
        + ", ".join(f"{k} {v:.3f}" for k, v in clock.seconds.items())
        + f"], process_private {run.seconds['process_private']:.3f} s")
    for attempt in ("first", "second"):
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        clock = PhaseClock("cuda")
        t0 = time.perf_counter()
        proof, challenge = run.prove(clock)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"placeholder-kzg v2 prove ({attempt}): {dt:.3f} s ["
            + ", ".join(f"{k} {v:.3f}" for k, v in clock.seconds.items())
            + f"] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    report["prove_s"] = dt
    report["prove"] = dict(clock.seconds)
    report["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    per_prove = {k: v - before[k] for k, v in launch_counts().items()}
    log(f"kernel launches in the second prove: {per_prove}")
    idle = [k for k in GROTH16_KERNELS if per_prove[k] <= 0]
    if idle:
        raise AssertionError(f"the KZG prove never launched {idle}")

    t0 = time.perf_counter()
    ok, verifier_challenge = run.verify(proof)
    report["verify_s"] = time.perf_counter() - t0
    log(f"placeholder-kzg v2 verify: {report['verify_s']:.2f} s -> {ok}")
    if not ok:
        raise AssertionError("the KZG v2 verifier rejected the proof")
    if challenge != verifier_challenge:
        raise AssertionError("prover and verifier transcripts differ")
    log("placeholder-kzg transcripts: same next challenge")
    wrong = [[(run.public_input[0][0] + 1) % run.fs.p]]
    if run.verify(proof, wrong)[0]:
        raise AssertionError("the verifier accepted a wrong public input")
    log("placeholder-kzg verify with public input + 1: rejected")
    bad = copy.deepcopy(proof)
    z = bad.eval_proof.eval_proof.z.z
    z[PC.QUOTIENT_BATCH][0][0] = (z[PC.QUOTIENT_BATCH][0][0] + 1) % run.fs.p
    if run.verify(bad)[0]:
        raise AssertionError("the verifier accepted a tampered quotient "
                             "opening")
    log("placeholder-kzg verify with a quotient opening changed: rejected")
    device = PRF._device_profile(lambda: run.prove()[0])
    report["device_busy_s"] = device["device_busy_s"]
    report["wall_s_profiled"] = device["wall_s_profiled"]
    report["idle_share"] = 1 - device["device_busy_s"] \
        / device["wall_s_profiled"]
    log(f"placeholder-kzg prove under torch.profiler: device busy "
        f"{device['device_busy_s']:.4f} s of "
        f"{device['wall_s_profiled']:.3f} s, idle share "
        f"{report['idle_share']:.3f}; top kernels "
        f"{[(k['name'][:40], k['calls'], round(k['device_ms'], 2)) for k in device['top_kernels'][:6]]}")

    bdfg = PlaceholderKZGRun(KZG_LOG2_ROWS, "cuda", "bdfg",
                             kzg_params=run.kzg_params)
    bdfg.preprocess()
    clock = PhaseClock("cuda")
    t0 = time.perf_counter()
    proof, challenge = bdfg.prove(clock)
    report["bdfg_prove_s"] = time.perf_counter() - t0
    report["bdfg_prove"] = dict(clock.seconds)
    t0 = time.perf_counter()
    ok, verifier_challenge = bdfg.verify(proof)
    report["bdfg_verify_s"] = time.perf_counter() - t0
    log(f"placeholder-kzg bdfg: process_public "
        f"{bdfg.seconds['process_public']:.3f} s, prove "
        f"{report['bdfg_prove_s']:.3f} s ["
        + ", ".join(f"{k} {v:.3f}" for k, v in clock.seconds.items())
        + f"], verify {report['bdfg_verify_s']:.2f} s -> {ok}")
    if not ok or challenge != verifier_challenge:
        raise AssertionError("the BDFG proof was rejected or the transcripts "
                             "differ")
    counts = launch_counts()
    log(f"kernel launches on the Placeholder-over-KZG path (setup, v2 "
        f"preprocess, three proves, verifies, bdfg preprocess, prove, "
        f"verify): {counts}")
    idle = [k for k in GROTH16_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError(f"the KZG path never launched {idle}")
    report["commit"] = kzg_commit_checks(torch, run)   # after the count
    return counts, per_prove, report


# ---------------------------------------------------------------------------
# phase 8: the classic R1CS provers (PGHR13, GM17, USCS over TBCS)
# ---------------------------------------------------------------------------

CLASSIC_LOG2_CONSTRAINTS = 16    # PGHR13 and GM17 on the product chain
TBCS_LOG2_GATES = 14             # the USCS ppzkSNARK over a TBCS chain


def _classic_systems(log2_size: int, tbcs_log2_gates: int):
    """(name, generate(rng, device), prove(kp, rng, device), verify(kp,
    primary, proof), primary, wrong primary) for each classic system."""
    from crypto3_zk_tpu_torch.arithmetization.circuits import (product_chain,
                                                               tbcs_chain)
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.models import circuit_snarks as CS
    from crypto3_zk_tpu_torch.models import gm17 as GM
    from crypto3_zk_tpu_torch.models import pghr13 as PG

    curve = CV.ALT_BN128
    p = curve.fr.p
    out = []
    for name, mod in (("pghr13", PG), ("gm17", GM)):
        cs, primary, aux = product_chain(p, 1 << log2_size)
        out.append((name,
                    lambda rng, dev, mod=mod, cs=cs: mod.generate(
                        curve, cs, rng, device=dev),
                    lambda kp, rng, dev, mod=mod, x=primary, w=aux:
                        mod.prove(kp.pk, x, w, rng, device=dev),
                    lambda kp, x, pr, mod=mod: mod.verify(kp.vk, x, pr),
                    primary, [primary[0] + 1]))
    circuit, primary, aux = tbcs_chain(1 << tbcs_log2_gates,
                                       random.Random(14))
    out.append(("uscs_tbcs",
                lambda rng, dev: CS.tbcs_generate(curve, circuit, rng,
                                                  device=dev)[0],
                lambda kp, rng, dev: CS.tbcs_prove(kp, circuit, primary, aux,
                                                   rng, device=dev),
                CS.tbcs_verify, primary, [0, 1]))
    return out


def small_agreement_classic(torch) -> None:
    """A 2^5-constraint proof of PGHR13, GM17 and the USCS ppzkSNARK (a
    TBCS chain of 16 gates) on the card and on the CPU: equal keys and
    proofs (the witness maps' transforms and the keys' longer query
    vectors run the device code; the MSMs of so few bases stay on the
    host, as a user's would), and the card's proofs verify."""
    for name, gen, prove, verify, primary, _ in _classic_systems(5, 4):
        got = []
        for device in ("cuda", "cpu"):
            rng = random.Random(5)
            kp = gen(rng, device)
            got.append((kp, prove(kp, rng, device)))
        if got[0] != got[1]:
            raise AssertionError(f"card and CPU {name} keys or proofs "
                                 f"differ")
        if not verify(got[0][0], primary, got[0][1]):
            raise AssertionError(f"the small {name} proof was rejected")


def classic_path(torch) -> tuple[dict, dict]:
    """PGHR13 and GM17 at 2^16 constraints (the product chain, dense A and
    B), the USCS ppzkSNARK over a TBCS chain of 2^14 gates: generate, prove
    twice (the second reported), verify, a wrong input rejected. Returns
    (launch counts of the whole path, seconds by system)."""
    reset_launch_counts()
    report = {}
    for name, gen, prove, verify, primary, wrong in _classic_systems(
            CLASSIC_LOG2_CONSTRAINTS, TBCS_LOG2_GATES):
        rng = random.Random(7)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kp = gen(rng, "cuda")
        torch.cuda.synchronize()
        keygen = time.perf_counter() - t0
        proves = []
        for _ in range(2):
            t0 = time.perf_counter()
            proof = prove(kp, rng, "cuda")
            torch.cuda.synchronize()
            proves.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ok = verify(kp, primary, proof)
        verify_s = time.perf_counter() - t0
        report[name] = {"keygen_s": keygen, "prove_s": proves,
                        "verify_s": verify_s, "peak_mib":
                        torch.cuda.max_memory_allocated() / 2**20}
        log(f"{name}: keygen {keygen:.2f} s, prove {proves[0]:.2f} s then "
            f"{proves[1]:.2f} s, verify {verify_s:.2f} s -> {ok}, peak "
            f"{report[name]['peak_mib']:.0f} MiB")
        if not ok:
            raise AssertionError(f"the {name} verifier rejected the proof")
        if verify(kp, wrong, proof):
            raise AssertionError(f"the {name} verifier accepted a wrong "
                                 f"input")
        log(f"{name} verify with a wrong input: rejected")
        del kp
    counts = launch_counts()
    log(f"kernel launches on the classic path (three keygens, six proves): "
        f"{counts}")
    idle = [k for k in GROTH16_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError(f"the classic path never launched {idle}")
    return counts, report


# ---------------------------------------------------------------------------
# phase 9: the setup ceremonies (powers of tau, phase-2 MPC), ipp2
# aggregation, encrypted-input Groth16, ADSNARK and PCD
# ---------------------------------------------------------------------------

CEREMONY_LOG2 = LOG2_CONSTRAINTS + 1   # the product chain's QAP domain, 2^17
AGGREGATE_PROOFS = 8                   # SnarkPack's smallest batch
CEREMONY_KERNELS = GROTH16_KERNELS + ("scalar_mul",)


def _ceremony_run(device: str, m: int, ncons: int, rng: random.Random,
                  verify: bool) -> dict:
    """Two powers-of-tau contributions, the result, the keypair and two
    phase-2 contributions at domain m, as plain values (`convert`); with
    `verify` each contribution and the chain are verified too."""
    from crypto3_zk_tpu_torch import convert as CONV
    from crypto3_zk_tpu_torch.arithmetization.circuits import product_chain
    from crypto3_zk_tpu_torch.commitments import powers_of_tau as POT
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.models.groth16 import mpc as MPC

    curve = CV.ALT_BN128
    cs, primary, aux = product_chain(curve.fr.p, ncons)
    acc, out = POT.Accumulator(curve, m), {"accumulators": []}
    for _ in range(2):
        key = POT.generate_private_key(curve, rng)
        pub = POT.proof_eval(curve, key, acc, rng)
        nxt = acc.copy()
        nxt.transform(key, device=device)
        if verify and not POT.verify_eval(curve, pub, acc, nxt,
                                          random.Random(1), device=device):
            raise AssertionError(f"a contribution made on {device} was "
                                 f"rejected")
        out["accumulators"].append(CONV.accumulator_fields(nxt))
        acc = nxt
    result = POT.result_from_accumulator(acc, m, device=device)
    out["result"] = CONV.result_fields(result)
    kp = MPC.keypair_from_ceremony(cs, result, device=device)
    state = MPC.init_mpc(kp)
    for _ in range(2):
        state = MPC.contribute(state, rng=rng, device=device)
    out["keys"] = [{f.name: getattr(k, f.name) for f in
                    dataclasses.fields(k) if f.name not in
                    ("curve", "constraint_system")}
                   for pair in (kp, state.keypair) for k in (pair.pk, pair.vk)]
    out["contributions"] = state.contributions
    out["fresh"] = CONV.result_fields(POT.result_from_accumulator(
        POT.Accumulator(curve, m), m, device=device))
    if verify and not MPC.verify_contribution_chain(kp, state,
                                                    device=device):
        raise AssertionError(f"the phase-2 chain made on {device} was "
                             f"rejected")
    return out, (state.keypair, primary, aux)


def small_agreement_ceremony(torch) -> None:
    """A ceremony at m = 8 (a 6-constraint product chain) on the card, every
    batch through kernel 6 (`points.DEVICE_MIN["cuda"]`) and the 14-term
    combination of the tau powers through the device MSM, equals the
    CPU's, whose batches run on the host; the card's contributions and
    chain verify, and a proof under its key verifies."""
    from crypto3_zk_tpu_torch.models import groth16 as G16

    saved = (G16._DEVICE_MSM_MIN, G16._MSM_WINDOW_BITS)
    G16._DEVICE_MSM_MIN, G16._MSM_WINDOW_BITS = 8, 4
    try:
        card, (kp, primary, aux) = _ceremony_run("cuda", 8, 6,
                                                 random.Random(0x72), True)
    finally:
        G16._DEVICE_MSM_MIN, G16._MSM_WINDOW_BITS = saved
    cpu, _ = _ceremony_run("cpu", 8, 6, random.Random(0x72), False)
    if card != cpu:
        raise AssertionError("card and CPU ceremonies differ at m = 8")
    proof = G16.prove(kp.pk, primary, aux, zk_rs=(3, 4))
    if not G16.verify(kp.vk, primary, proof):
        raise AssertionError("a proof under the small ceremony's key was "
                             "rejected")


def small_agreement_extensions(torch) -> None:
    """An ipp2 aggregate of 2 proofs, an encrypted-input proof, an ADSNARK
    proof and a two-step PCD chain made on the card equal the CPU's, from
    the same draws, and verify."""
    from crypto3_zk_tpu_torch.arithmetization import r1cs as R
    from crypto3_zk_tpu_torch.arithmetization.circuits import product_chain
    from crypto3_zk_tpu_torch.convert import aggregate_proof_fields
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.models import adsnark as AD
    from crypto3_zk_tpu_torch.models import api
    from crypto3_zk_tpu_torch.models import groth16 as G16
    from crypto3_zk_tpu_torch.models import pcd as PCD
    from crypto3_zk_tpu_torch.models.groth16 import encrypted_input as EI
    from crypto3_zk_tpu_torch.models.groth16 import ipp2 as IPP2

    curve = CV.ALT_BN128
    p = curve.fr.p

    def product_cs():
        cs = R.R1CSConstraintSystem(primary_input_size=2,
                                    auxiliary_input_size=1)
        cs.add_constraint(R.lc((1, 1)), R.lc((2, 1)), R.lc((3, 1)))
        return cs

    def counter():
        cs = R.R1CSConstraintSystem(primary_input_size=1,
                                    auxiliary_input_size=2)
        cs.add_constraint(R.LinearCombination([(3, 1), (0, 1)]),
                          R.lc((0, 1)), R.lc((1, 1)))
        return PCD.CompliancePredicate(1, 1, cs, 1, 1, [1])

    def run(device):
        rng = random.Random(0xE7)
        cs, primary, aux = product_chain(p, 20)
        kp = G16.generate(curve, cs, rng=rng, device=device)
        proofs = [G16.prove(kp.pk, primary, aux, rng=rng, device=device)
                  for _ in range(2)]
        srs, vsrs = IPP2.setup_fake_srs(curve, 2, rng)
        agg = api.aggregate(api.GROTH16, srs, b"smoke", proofs,
                            device=device)
        ekp, pk_enc, _ = EI.generate_encrypted(curve, product_cs(), 1, rng,
                                               device=device)
        r = rng.randrange(1, p)
        ct = EI.encrypt_with_vk(pk_enc, ekp.vk, [3], r)
        eproof = EI.prove_encrypted(ekp.pk, pk_enc, [3, 25], [75], r, rng,
                                    device=device)
        pub = AD.generate(curve, product_cs(), 1, rng, device=device)
        sak, pak = AD.auth_generator(curve, rng)
        authdata = AD.auth_sign(curve, sak, [b"sensor-1"], [6], rng)
        aproof = AD.prove(pub, authdata, [6, 7], [42], rng, device=device)
        pred = counter()
        pkp = PCD.generator(curve, [pred], rng, device=device)
        step1 = PCD.prover(pkp, pred, PCD.PCDMessage(1, [1]), [0], [], [0],
                           rng, device=device)
        step2 = PCD.prover(pkp, pred, PCD.PCDMessage(1, [2]), [0], [step1],
                           [], rng, device=device)
        return dict(kp=kp, primary=primary, proofs=proofs, vsrs=vsrs,
                    agg=aggregate_proof_fields(agg), agg_obj=agg, ekp=ekp,
                    pk_enc=pk_enc, ct=ct, eproof=eproof, pub=pub, pak=pak,
                    authdata=authdata, aproof=aproof, pkp=pkp, step2=step2)

    card, cpu = run("cuda"), run("cpu")
    for key in ("proofs", "agg", "eproof", "aproof"):
        if card[key] != cpu[key]:
            raise AssertionError(f"card and CPU differ: {key}")
    if card["step2"].proof != cpu["step2"].proof \
            or card["step2"].incoming_steps[0].proof \
            != cpu["step2"].incoming_steps[0].proof:
        raise AssertionError("card and CPU PCD chains differ")
    c = card
    checks = {
        "aggregate": IPP2.verify_aggregate_proof(
            c["vsrs"], c["kp"].vk, [c["primary"]] * 2, c["agg_obj"],
            b"smoke", random.Random(2)),
        "encrypted input": EI.verify_encrypted(c["ekp"].vk, c["pk_enc"],
                                               c["ct"], [25], c["eproof"]),
        "adsnark": AD.verify_public(c["pub"], c["pak"], c["authdata"], [7],
                                    c["aproof"]),
        "pcd chain": PCD.verifier(c["pkp"], c["step2"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"a small card proof was rejected: {checks}")


def ceremony_path(torch) -> tuple[dict, dict]:
    """The setup ceremonies at the smoke circuit's full size: the product
    chain of 2^16 constraints has a QAP domain of 2^17, so the accumulator
    holds 2^18 - 1 G1 powers of tau, 2^17 G2 powers and 2^17 alpha and beta
    powers. Two contributions (each verified, a tampered power rejected),
    the Lagrange-basis result, a KZG commit -> open -> verify over the
    ceremony's powers, the keypair and two phase-2 contributions (the chain
    verified, a forged one rejected), Groth16 proves under the final key
    (the second reported) that verify there and not under the initial key,
    then an ipp2 aggregate of 8 such proofs (verified, a wrong transcript
    tag and a tampered agg_c rejected). Returns (launch counts of the whole
    path, seconds by step)."""
    from crypto3_zk_tpu_torch.arithmetization.circuits import product_chain
    from crypto3_zk_tpu_torch.commitments import kzg as KZG
    from crypto3_zk_tpu_torch.commitments import powers_of_tau as POT
    from crypto3_zk_tpu_torch.fields import curves as CV
    from crypto3_zk_tpu_torch.models import groth16 as G16
    from crypto3_zk_tpu_torch.models.groth16 import ipp2 as IPP2
    from crypto3_zk_tpu_torch.models.groth16 import mpc as MPC
    from crypto3_zk_tpu_torch.poly.polynomial import Poly

    curve = CV.ALT_BN128
    m = 1 << CEREMONY_LOG2
    rng = random.Random(0xCE)
    seconds = {}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        log(f"  ceremony {name}: {seconds[name]:.2f} s")
        return out

    cs, primary, aux = product_chain(curve.fr.p, 1 << LOG2_CONSTRAINTS)
    acc = POT.Accumulator(curve, m)
    for i in (1, 2):
        key = POT.generate_private_key(curve, rng)
        pub = step(f"proof_eval_{i}",
                   lambda: POT.proof_eval(curve, key, acc, rng))
        nxt = acc.copy()
        step(f"transform_{i}", lambda: nxt.transform(key))
        ok = step(f"verify_eval_{i}", lambda: POT.verify_eval(
            curve, pub, acc, nxt, rng))
        if not ok:
            raise AssertionError(f"contribution {i} was rejected")
        before, acc = acc, nxt
    bad = acc.copy()
    bad.tau_powers_g1[2] = CV.g1_add(curve, bad.tau_powers_g1[2], curve.g1)
    if step("verify_eval_tampered", lambda: POT.verify_eval(
            curve, pub, before, bad, rng)):
        raise AssertionError("a tampered accumulator was accepted")
    del bad
    log(f"  ceremony: {len(acc.vectors['tau_powers_g1'])} G1 powers of tau, "
        f"{len(acc.vectors['tau_powers_g2'])} in G2, both contributions "
        f"verified, a tampered power rejected")
    result = step("result", lambda: POT.result_from_accumulator(acc, m))

    d = 1 << LOG2_CONSTRAINTS
    params = step("to_kzg_params", lambda: POT.to_kzg_params(acc, d))
    f = Poly.from_ints(curve.fr, [rng.randrange(curve.fr.p)
                                  for _ in range(d)], "cuda")
    z = rng.randrange(curve.fr.p)
    c = step("kzg_commit", lambda: KZG.commit_one(params, f.to_ints()))
    proof = step("kzg_open", lambda: KZG.proof_eval_one(params, f, z))
    if not KZG.verify_eval_one(params, proof, c, z, f.evaluate(z)) \
            or KZG.verify_eval_one(params, proof, c, z, f.evaluate(z) + 1):
        raise AssertionError("KZG over the ceremony's powers: a wrong "
                             "verifier answer")
    del params, f

    kp0 = step("keypair", lambda: MPC.keypair_from_ceremony(cs, result))
    del result
    state = MPC.init_mpc(kp0)
    for i in (1, 2):
        state = step(f"contribute_{i}",
                     lambda: MPC.contribute(state, rng=rng))
    if not step("verify_chain",
                lambda: MPC.verify_contribution_chain(kp0, state)):
        raise AssertionError("the phase-2 chain was rejected")
    forged = MPC.MPCState(state.keypair, list(state.contributions),
                          state.initial_delta_g1)
    forged.contributions[-1] = MPC.MPCPublicKey(
        CV.g1_mul(curve, curve.g1, 12345), forged.contributions[-1].pok)
    if MPC.verify_contribution_chain(kp0, forged):
        raise AssertionError("a forged phase-2 chain was accepted")
    kp = state.keypair
    proofs = []
    for i in range(AGGREGATE_PROOFS):
        proofs.append(step(f"prove_{i + 1}", lambda: G16.prove(
            kp.pk, primary, aux, rng=rng)))
    seconds["prove_phases"] = dict(G16.LAST_PROVE_SECONDS)
    if not step("verify", lambda: G16.verify(kp.vk, primary, proofs[1])):
        raise AssertionError("a proof under the ceremony's key was rejected")
    if G16.verify(kp0.vk, primary, proofs[1]):
        raise AssertionError("a proof verified under the initial key")
    srs, vsrs = IPP2.setup_fake_srs(curve, AGGREGATE_PROOFS, rng)
    agg = step("aggregate_8", lambda: IPP2.aggregate_proofs(
        srs, b"ceremony", proofs))
    tag_ok = step("verify_aggregate", lambda: IPP2.verify_aggregate_proof(
        vsrs, kp.vk, [primary] * AGGREGATE_PROOFS, agg, b"ceremony", rng))
    if not tag_ok:
        raise AssertionError("the aggregate was rejected")
    if IPP2.verify_aggregate_proof(vsrs, kp.vk, [primary] * AGGREGATE_PROOFS,
                                   agg, b"other", rng):
        raise AssertionError("the aggregate verified under a wrong tag")
    bad = IPP2.AggregateProof(agg.com_ab, agg.com_c, agg.ip_ab,
                              CV.g1_add(curve, agg.agg_c, curve.g1),
                              agg.tmipp)
    if IPP2.verify_aggregate_proof(vsrs, kp.vk, [primary] * AGGREGATE_PROOFS,
                                   bad, b"ceremony", rng):
        raise AssertionError("a tampered aggregate was accepted")
    counts = launch_counts()
    seconds["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    log(f"ceremony path: peak device memory {seconds['peak_mib']:.0f} MiB, "
        f"kernel launches {counts}")
    idle = [k for k in CEREMONY_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError(f"the ceremony path never launched {idle}")
    return counts, seconds


# ---------------------------------------------------------------------------
# phase 10: the Pasta commitments (IPA, kimchi, Pickles) and sha2 LPC trees
# ---------------------------------------------------------------------------

PASTA_LOG2 = 16                  # Mina's step circuits: an SRS and domain
PASTA_KERNELS = ("mont_mul", "inv_scans", "mul3", "inv_tail", "scalar_mul")
LPC_SHA2_KERNELS = GROTH16_KERNELS + ("sha256_field_rows", "sha256_nodes")
PASTA_CROSSOVER_SIZES = (16, 32, 64, 128)


def pasta_msm_crossover(torch) -> dict:
    """An MSM of m Pallas points (random multiples of the generator, made
    by kernel 6) on the card against the host's double-and-add, at each
    size of `PASTA_CROSSOVER_SIZES`, median of 3 each: where
    `ipa.DEVICE_MSM_MIN` should lie. Both give the same point."""
    from crypto3_zk_tpu_torch.commitments import ipa as IPA
    from crypto3_zk_tpu_torch.ops.msm import msm_host
    from crypto3_zk_tpu_torch.ops.msm_affine import MSMBases

    curve = IPA.PALLAS
    p = curve.fr.p
    rng = random.Random(0xC0)
    m_max = PASTA_CROSSOVER_SIZES[-1]
    vec = IPA.random_multiples(curve, [rng.randrange(1, p)
                                       for _ in range(m_max)], "cuda")
    pts = vec.host()
    out = {}
    for m in PASTA_CROSSOVER_SIZES:
        scalars = [rng.randrange(p) for _ in range(m)]
        x, y, inf = vec.slice(0, m).dev("cuda")
        times = {"card": [], "host": []}
        for _ in range(3):
            t0 = time.perf_counter()
            got = MSMBases.from_affine(curve, x, y, inf, "g1",
                                       IPA.MSM_WINDOW_BITS).run(scalars)
            times["card"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            want = msm_host(curve, pts[:m], scalars)
            times["host"].append(time.perf_counter() - t0)
            if got != want:
                raise AssertionError(f"Pallas MSM of {m} differs from the "
                                     f"host's")
        out[m] = {k: sorted(v)[1] * 1e3 for k, v in times.items()}
    log("  Pallas MSM, card / host ms: " + ", ".join(
        f"{m}: {v['card']:.1f} / {v['host']:.1f}" for m, v in out.items()))
    return out


def small_agreement_pasta(torch) -> None:
    """On the card and on the CPU from the same seeds: an IPA proof over
    Pallas at n = 16 (the MSM threshold lowered to 8, so the commitment,
    the first round and the verifier's check run the batched-affine MSM on
    both), a kimchi SRS of 16 with its Lagrange basis (the group iNTT) and
    a Pickles synthetic proof at n = 16. Each equal card against CPU; each
    side's verifier accepts the other side's proof."""
    import dataclasses

    from crypto3_zk_tpu_torch.commitments import ipa as IPA
    from crypto3_zk_tpu_torch.commitments import kimchi_pedersen as KP
    from crypto3_zk_tpu_torch.convert import pickles_proof_as_plain
    from crypto3_zk_tpu_torch.fields.group_map import GroupMap
    from crypto3_zk_tpu_torch.models import pickles as PI

    p = IPA.PALLAS.fr.p
    saved = IPA.DEVICE_MSM_MIN
    IPA.DEVICE_MSM_MIN = 8
    try:
        ipa = {}
        for device in ("cuda", "cpu"):
            rng = random.Random(0x19A)
            params = IPA.setup(IPA.PALLAS, 16, rng, device=device)
            coeffs = [rng.randrange(p) for _ in range(16)]
            comm = IPA.commit(params, coeffs, rng, device=device)
            z = rng.randrange(p)
            proof, v = IPA.proof_eval(params, comm, coeffs, z, rng,
                                      device=device)
            ipa[device] = (params, comm, z, proof, v)
        (pc, cc, z, proof_c, v), (pp, cp, _, proof_p, _) = \
            ipa["cuda"], ipa["cpu"]
        if (pc.g, pc.h, pc.u, dataclasses.astuple(cc),
                dataclasses.astuple(proof_c)) != \
                (pp.g, pp.h, pp.u, dataclasses.astuple(cp),
                 dataclasses.astuple(proof_p)):
            raise AssertionError("card and CPU IPA proofs differ")
        if not (IPA.verify_eval(pc, cc.c, z, v, proof_p)
                and IPA.verify_eval(pp, cc.c, z, v, proof_c, device="cpu")):
            raise AssertionError("an IPA proof was rejected")
        if IPA.verify_eval(pc, cc.c, z, (v + 1) % p, proof_c):
            raise AssertionError("the IPA verifier accepted a wrong value")
    finally:
        IPA.DEVICE_MSM_MIN = saved

    runs = {}
    for device in ("cuda", "cpu"):
        rng = random.Random(1234)
        srs = KP.setup(IPA.PALLAS, 16, rng=rng, device=device)
        gmap = GroupMap(IPA.PALLAS.fq, 0, 5)
        index = PI.synthetic_index(srs, 16, rng, device=device)
        proof = PI.synthetic_prove(index, gmap, rng, device=device)
        runs[device] = (srs, gmap, index, proof)

    def plain(run):
        srs, _, _, proof = run
        return (srs.g, srs.h, [c.unshifted for c in srs.lagrange_bases[16]],
                pickles_proof_as_plain(proof))

    if plain(runs["cuda"]) != plain(runs["cpu"]):
        raise AssertionError("card and CPU kimchi SRS, Lagrange basis or "
                             "Pickles proof differ")
    _, gmap, index_c, proof_c = runs["cuda"]
    _, _, index_p, proof_p = runs["cpu"]
    if not (PI.verify(gmap, index_c, proof_p)
            and PI.verify(gmap, index_p, proof_c, device="cpu")):
        raise AssertionError("a small Pickles proof was rejected")


def pasta_path(torch) -> tuple[dict, dict]:
    """The Pasta commitments at n = 2^16 over Pallas on the card: the IPA
    (setup, commit, proof_eval, verify_eval accepts, a wrong value
    rejected), then kimchi: an SRS of 2^16, its Lagrange basis of 2^16 by
    the group iNTT (two of its points held against an MSM of 2^16 terms),
    `synthetic_index`, two `synthetic_prove`s, `verify` of each,
    `batch_verify` of both, a mutated proof rejected. Returns (launch
    counts of the whole path, seconds by step)."""
    from crypto3_zk_tpu_torch.commitments import ipa as IPA
    from crypto3_zk_tpu_torch.commitments import kimchi_pedersen as KP
    from crypto3_zk_tpu_torch.fields.group_map import GroupMap
    from crypto3_zk_tpu_torch.models import pickles as PI
    from crypto3_zk_tpu_torch.poly.domain import get_domain

    curve = IPA.PALLAS
    p = curve.fr.p
    n = 1 << PASTA_LOG2
    rng = random.Random(0x9A57A)
    seconds = {}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        log(f"  pasta {name}: {seconds[name]:.2f} s")
        return out

    params = step("ipa_setup", lambda: IPA.setup(curve, n, rng))
    coeffs = [rng.randrange(p) for _ in range(n)]
    comm = step("ipa_commit", lambda: IPA.commit(params, coeffs, rng))
    z = rng.randrange(p)
    proof, v = step("ipa_proof_eval", lambda: IPA.proof_eval(
        params, comm, coeffs, z, rng))
    if not step("ipa_verify_eval", lambda: IPA.verify_eval(
            params, comm.c, z, v, proof)):
        raise AssertionError("the IPA verifier rejected the proof")
    if IPA.verify_eval(params, comm.c, z, (v + 1) % p, proof):
        raise AssertionError("the IPA verifier accepted a wrong value")
    log(f"  ipa at n = 2^{PASTA_LOG2}: {len(proof.lr)} rounds, verified, a "
        f"wrong value rejected")
    del params, coeffs

    srs = step("kimchi_setup", lambda: KP.setup(curve, n, rng=rng))
    dom = get_domain(curve.fr, n)
    step("lagrange_basis", lambda: KP.add_lagrange_basis(srs, n, dom.omega))
    n_inv = pow(n, -1, p)
    for i in (1, n - 3):
        w = pow(dom.omega_inv, i, p)
        lag = [n_inv]
        for _ in range(n - 1):
            lag.append(lag[-1] * w % p)
        if srs.lagrange_bases[n][i].unshifted != [IPA.msm(
                curve, [srs.g_vector()], lag, "cuda")]:
            raise AssertionError(f"Lagrange commitment {i} differs from its "
                                 f"MSM")
    log(f"  lagrange basis of 2^{PASTA_LOG2}: two points equal to their "
        f"MSMs of 2^{PASTA_LOG2} terms")
    gmap = GroupMap(curve.fq, 0, 5)
    index = step("synthetic_index", lambda: PI.synthetic_index(srs, n, rng))
    proofs = []
    for i in (1, 2):
        proofs.append(step(f"synthetic_prove_{i}", lambda: PI.synthetic_prove(
            index, gmap, rng)))
        seconds[f"prove_{i}_phases"] = dict(PI.LAST_PROVE_SECONDS)
        seconds[f"prove_{i}_opening"] = dict(KP.LAST_PROOF_EVAL_SECONDS)
        log("    phases: " + ", ".join(
            f"{k} {v:.2f}" for k, v in PI.LAST_PROVE_SECONDS.items())
            + "; opening: " + ", ".join(
            f"{k} {v:.2f}" for k, v in KP.LAST_PROOF_EVAL_SECONDS.items()))
    for i, proof in enumerate(proofs, 1):
        if not step(f"verify_{i}", lambda: PI.verify(gmap, index, proof)):
            raise AssertionError(f"Pickles proof {i} was rejected")
    if not step("batch_verify_2", lambda: PI.batch_verify(
            gmap, [(index, pr) for pr in proofs])):
        raise AssertionError("the batch of two Pickles proofs was rejected")
    bad = copy.deepcopy(proofs[0])
    bad.ft_eval1 = (bad.ft_eval1 + 1) % p
    if step("verify_mutated", lambda: PI.verify(gmap, index, bad)):
        raise AssertionError("a mutated Pickles proof was accepted")
    counts = launch_counts()
    seconds["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    log(f"pasta path: peak device memory {seconds['peak_mib']:.0f} MiB, "
        f"kernel launches "
        f"{ {k: counts[k] for k in PASTA_KERNELS + ('ntt_rows',)} }")
    idle = [k for k in PASTA_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError(f"the Pasta path never launched {idle}")
    return counts, seconds


def small_agreement_lpc_sha2(torch) -> None:
    """At degree_log = 6 with sha2_256 trees (every level by kernel 7 on
    the card, its plain version on the CPU) the card's LPC proof, roots
    and next challenge equal the CPU's."""
    from crypto3_zk_tpu_torch.tools.lpc_fixture import LPCRun

    got = []
    for device in ("cuda", "cpu"):
        run = LPCRun(6, 4, device, merkle_hash="sha2_256")
        run.commit(lambda: None)
        proof, challenge = run.prove(lambda: None)
        got.append((run.roots, proof.z.z, proof.fri_proof, challenge))
    if got[0] != got[1]:
        raise AssertionError("card and CPU sha2 LPC proofs differ")
    ok, challenge = run.verify(proof)
    if not ok or challenge != got[0][3]:
        raise AssertionError("small sha2 LPC proof rejected")


def lpc_sha2_path(torch) -> tuple[dict, dict, dict]:
    """The LPC path's settings (degree 2^16, D0 = 2^18, lambda 40,
    bls12-381 Fr) with sha2_256 Merkle trees: commit, proof_eval twice,
    verify_eval, a changed value rejected. Returns (launch counts of the
    whole path, of the second proof_eval, seconds)."""
    from crypto3_zk_tpu_torch.tools.lpc_fixture import LPCRun

    reset_launch_counts()
    sync = torch.cuda.synchronize
    seconds = {}
    run = LPCRun(LPC_LOG2_DEGREE, 40, "cuda", merkle_hash="sha2_256")
    run.commit(sync)
    seconds.update(run.seconds)
    for attempt in ("first", "second"):
        before = launch_counts()
        proof, challenge = run.prove(sync)
        seconds[f"proof_eval_{attempt}"] = run.seconds["proof_eval"]
    per_proof = {k: v - before[k] for k, v in launch_counts().items()}
    t0 = time.perf_counter()
    ok, verifier_challenge = run.verify(proof)
    seconds["verify_eval"] = time.perf_counter() - t0
    counts = launch_counts()
    log("lpc sha2_256: " + ", ".join(f"{k} {v:.3f} s"
                                     for k, v in seconds.items()))
    log(f"kernel launches on the sha2 LPC path: {counts}; in the second "
        f"proof_eval: {per_proof}")
    if not ok or challenge != verifier_challenge:
        raise AssertionError("the sha2 LPC verifier rejected the proof or "
                             "its transcript differs")
    bad = copy.deepcopy(proof)
    bad.z.z[0][0][0] = (bad.z.z[0][0][0] + 1) % run.fs.p
    if run.verify(bad)[0]:
        raise AssertionError("the sha2 LPC verifier accepted a tampered "
                             "evaluation")
    idle = [k for k in LPC_SHA2_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError(f"the sha2 LPC path never launched {idle}")
    return counts, per_proof, seconds


# ---------------------------------------------------------------------------
# the mesh path: the mesh layer over every card, one rank a card
# ---------------------------------------------------------------------------

MESH_KERNELS = ("mont_mul", "ntt_rows", "inv_scans", "mul3", "inv_tail")
MESH_TIMEOUT = 600           # seconds: rendezvous, each collective, the run


def mesh_path(torch) -> tuple[dict, dict]:
    """`entry.mesh_path` on a world of one rank a card (NCCL, through
    `launch.py`; the kernels were built here before any rank started): the
    distributed NTT at 2^20 and its inverse against `ntt_hopper`, the
    distributed MSM at 2^16 alt_bn128 G1 points and `msm_checkpointed`
    (whole, then resumed after half its windows) against `MSMBases.run`,
    the distributed precommit of the LPC fixture's batch at D0 = 2^18 and
    the query gather of 40 queries against `fri.precommit`, and a
    Placeholder prove at 2^16 rows under `mesh_context` equal to the
    single-card proof and verified. Each rank counts the launches of its
    mesh calls only (not the single-card references); their sum is the
    path's, and kernels 1, 2, 3, 4, the tail and 5 must each be in it.
    A rank's failure fails the phase."""
    from crypto3_zk_tpu_torch.tools.mesh_run import run_mesh_path
    reset_launch_counts()
    out = run_mesh_path(torch.cuda.device_count(), MESH_TIMEOUT)
    counts = out["launches"]
    if any(launch_counts().values()):
        raise AssertionError("the mesh path launched kernels outside its "
                             "ranks")
    missing = [k for k in MESH_KERNELS if not counts.get(k)]
    if not sum(counts.get(k, 0) for k in ("poseidon", "poseidon_shared",
                                          "poseidon_tree")):
        missing.append("poseidon (kernel 5, any form)")
    if missing:
        raise AssertionError(f"the mesh path never launched {missing}")
    log(f"  mesh path over {out['ranks']} rank(s): {out['wall_s']:.2f} s "
        f"wall, sharded calls {out['sharded_calls']}")
    for rank, secs in enumerate(out["seconds_by_rank"]):
        log(f"  rank {rank}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in secs.items()))
    return counts, {k: out[k] for k in ("ranks", "wall_s", "sharded_calls",
                                         "seconds_by_rank")}


def goldilocks_agreement(torch) -> dict:
    """`circuit_1` over Goldilocks with Poseidon trees (the reference's
    Goldilocks case): the card's proof equals the CPU plain path's, every
    challenge included (the whole proof and the next one), and verifies.
    Returns the launch counts of the card's preprocess and prove."""
    from crypto3_zk_tpu_torch.arithmetization.circuits import circuit_1
    from crypto3_zk_tpu_torch.commitments import fri as FRI
    from crypto3_zk_tpu_torch.commitments.lpc import LPCScheme
    from crypto3_zk_tpu_torch.convert import placeholder_proof_as_plain
    from crypto3_zk_tpu_torch.fields import params as P
    from crypto3_zk_tpu_torch.models.placeholder import common as PCM
    from crypto3_zk_tpu_torch.models.placeholder import preprocessor as PP
    from crypto3_zk_tpu_torch.models.placeholder.prover import prove
    from crypto3_zk_tpu_torch.models.placeholder.verifier import verify
    from crypto3_zk_tpu_torch.transcript.poseidon_transcript import \
        make_transcript

    fs = P.GOLDILOCKS
    got, counts = [], None
    for device in ("cuda", "cpu"):
        cs, asg, desc, pub_in = circuit_1(fs.p, random.Random(0xAB))
        params = PCM.PlaceholderParams(fs)
        fri = FRI.FRIParams.build(fs, degree_log=4, lambda_=4,
                                  merkle_hash="poseidon")
        reset_launch_counts()
        scheme = LPCScheme(fri)
        pub = PP.process_public(params, cs, asg, desc, scheme, device=device)
        priv = PP.process_private(params, cs, asg, desc, device=device)
        tr = make_transcript(params.transcript_hash, fs, b"")
        proof = prove(params, pub, priv, desc, cs, scheme.fork(), None, tr,
                      device)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = launch_counts()
        got.append((placeholder_proof_as_plain(proof), tr.challenge(fs)))
        tr = make_transcript(params.transcript_hash, fs, b"")
        if not verify(params, pub.common_data, proof, desc, cs,
                      LPCScheme(fri), public_input=pub_in, transcript=tr):
            raise AssertionError(f"the Goldilocks proof made on {device} "
                                 f"was rejected")
    if got[0] != got[1]:
        raise AssertionError("card and CPU Goldilocks proofs differ")
    return counts


def mnt4_witness_map(torch, log_n: int = 12) -> dict:
    """Groth16's witness map (3 iNTTs, 3 coset NTTs, a coset iNTT) over
    MNT4 Fr, 19 digits, on the card equals the CPU's, on a product chain of
    2^log_n - 2 constraints. Returns the card run's launch counts."""
    from crypto3_zk_tpu_torch.arithmetization import qap as Q
    from crypto3_zk_tpu_torch.arithmetization.circuits import product_chain
    from crypto3_zk_tpu_torch.fields import params as P

    fs = P.MNT4_FR
    cs, primary, aux = product_chain(fs.p, (1 << log_n) - 2)
    got, counts = [], None
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        w = Q.witness_map(fs, cs, primary, aux, 11, 13, 17, device=device)
        if device == "cuda":
            counts = launch_counts()
        got.append((w.degree, w.coefficients_for_H))
    if got[0] != got[1]:
        raise AssertionError("card and CPU witness maps differ over MNT4 Fr")
    return counts


# ---------------------------------------------------------------------------
# the mxu_ntt pass kernel (8-bit digits on wgmma) and the ntt_mxu path
# ---------------------------------------------------------------------------

MXU_LOGS = (20, 24, 26)          # the bench's transform sizes (ntt20/24/26)
MXU_REPS = 3                     # round-robin repetitions of each form
# 2^20 chains whose pass 1 (0-based) is a middle pass of side 2^s: packed
# in and out, twiddle; their first and last passes are checked too
MXU_CHAINS = {4: [4, 4, 4, 4, 4], 5: [5, 5, 5, 5], 6: [4, 6, 6, 4]}
# the block form (int32 in and out, no twiddle): side, columns
MXU_BLOCKS = ((1, 5), (3, 1000), (4, 33), (5, 8), (5, 4096 + 5), (6, 37),
              (6, 4096))


def mxu_pass_counts(fs, g) -> dict:
    """What one pass needs and issues: the fewest 8-bit multiply-adds (32^2
    M an element, `macs`), those the kernel issues (`issued`: 156 wgmma of
    64 x 64 x 32 a tile of 64 vectors and 8 outputs a k-step; a side-16
    pass pads j to 32), the bytes (input and output once, the table and the
    twiddle tables the pass reads once) and the integer multiply-add
    instructions of the epilogue an element (nine rounds of 8 word
    products; for the twiddle one 8-word Montgomery product where
    `twiddle_split` gives the pass one table, two where it gives two; each
    word product two instructions)."""
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    n = g.n
    macs = MX.U8_DIGITS ** 2 * g.m * n
    tm = max(g.m, 16)
    issued = 156 * 64 * 64 * 32 * (tm // 32 if tm >= 64 else 1) \
        * g.tiles * (tm // 8)
    in_b = MX.U8_DIGITS * n if g.in_packed else fs.nl * 4 * n
    out_b = MX.U8_DIGITS * n if g.out_packed else fs.nl * 4 * n
    table = MX.get_mxu_plan(fs, g.m.bit_length() - 1, False).table_u8.size
    tw = tw_products = 0
    if g.twiddle and g.c > 1:
        log_n = (g.m * g.c).bit_length() - 1
        h = MX.twiddle_split(log_n)
        tw_products = 1 if h == log_n else 2
        tw = 32 * ((1 << h) + (1 << (log_n - h) if h < log_n else 0))
    imads = 2 * 9 * 8 + tw_products * 2 * 8 * 16
    return {"macs": macs, "issued": issued, "bytes": in_b + out_b + table + tw,
            "imad": imads * n, "twiddle_products": tw_products}


def mxu_pass_bound(fs, g) -> dict:
    """The pass's floors (ms): products at the int8 peak, bytes at the
    memory rate, the epilogue's integer work at the measured multiply-add
    rate; the bound is the larger of products and bytes."""
    c = mxu_pass_counts(fs, g)
    prod = 2 * c["macs"] / INT8_OPS_PER_S * 1e3
    byt = c["bytes"] / HBM_BYTES_PER_S * 1e3
    integer = c["imad"] / IMAD["per_s"] * 1e3
    return {"products_ms": prod, "bytes_ms": byt, "int_ms": integer,
            "bound_ms": max(prod, byt),
            "bound_by": "operations" if prod >= byt else "bytes", **c}


def int_mm_ms(torch, g) -> float:
    """`library_ms`: the pass's digit products as ONE `torch._int_mm`,
    (32 M, M) @ (M, 32 V) int8 -> int32: every digit pair of every
    (output, vector), unmerged (4 GiB of int32 at 2^20 elements). A
    yardstick timed here only; the port never calls it."""
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    d = MX.U8_DIGITS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    a = torch.randint(0, 128, (d * g.m, g.m), generator=gen, device="cuda",
                      dtype=torch.int8)
    bt = torch.randint(0, 128, (d * g.v, g.m), generator=gen, device="cuda",
                       dtype=torch.int8)
    ms = time_ms(torch, lambda i: torch._int_mm(a, bt.t()), 1, 3,
                 queued=True)
    del a, bt
    torch.cuda.empty_cache()
    return ms


def mxu_equal(torch, fs, g, got, want, what: str) -> int:
    """Kernel output against the plain version's, digit for digit: packed
    outputs through `unpack_plain` (rows past the vectors of a partial
    tile are never written) and, where every tile is full, byte for byte."""
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    if g.out_packed:
        m2, c2, b2 = g.next_view()
        err = max_abs_err(
            torch, MX.unpack_plain(fs, got, m2, c2 * b2, g.lsj2, g.lsk2),
            MX.unpack_plain(fs, want, m2, c2 * b2, g.lsj2, g.lsk2))
        if (c2 * b2) % MX.ROWS == 0:
            err = max(err, max_abs_err(torch, got, want))
    else:
        err = max_abs_err(torch, got, want)
    log(f"  mxu_ntt {what}: max_abs_err {err}")
    if err != 0:
        raise AssertionError(f"kernel mxu_ntt disagrees with its plain "
                             f"version: {what}")
    return err


def mxu_input(torch, fs, g, gen):
    """Random elements (0, 1 and p - 1 first) in the pass's input form."""
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    x = rand_field(torch, fs, (g.m, g.v), gen)
    if g.in_packed:
        return MX.pack_plain(fs, x, g.lsj, g.lsk)
    return x.reshape(fs.nl, g.n).contiguous()


def mxu_ptxas() -> dict:
    """`ptxas -v`'s registers and spills of kernel 8 by table side, from
    the build log."""
    from crypto3_zk_tpu_torch import kernels as K
    from crypto3_zk_tpu_torch.tools import mxu_pass_times as MPT
    return MPT.ptxas_by_side(K.build_log("mxu_ntt.cu"))


def mxu_sass() -> dict:
    """Kernel 8's SASS (`cuobjdump -sass` of the library `kernels.py`
    built): for each instance, its warpgroup MMAs by form (GMMA), any
    `mma.sync` form left (IMMA, HMMA), its local-memory traffic (STL, LDL:
    spills) and the highest register it names. Fails without an unsigned
    8-bit GMMA, or with an `mma.sync` form."""
    import re

    from crypto3_zk_tpu_torch import kernels as K
    from crypto3_zk_tpu_torch.tools import sass_mix as SM
    out = {}
    for name, ins in SM.disassemble(str(K.library("mxu_ntt.cu"))).items():
        if "mxu_pass_kernel" not in name:
            continue
        gmma: dict[str, int] = {}
        row = {"gmma": gmma, "mma_sync": 0, "stl": 0, "ldl": 0, "max_reg": 0}
        for _, op, args in ins:
            base = op.split(".")[0]
            if "GMMA" in base:
                form = (op + args).split()[0]    # IGMMA.64x64x32.U8.U8
                gmma[form] = gmma.get(form, 0) + 1
            row["mma_sync"] += base in ("IMMA", "HMMA")
            row["stl"] += base == "STL"
            row["ldl"] += base == "LDL"
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", args)]
            row["max_reg"] = max([row["max_reg"], *regs])
        out[name] = row
        if not any("U8" in op for op in gmma) or row["mma_sync"]:
            raise AssertionError(f"kernel 8's SASS ({name}): no unsigned "
                                 f"8-bit warpgroup MMA, or an mma.sync form: "
                                 f"{row}")
    if not out:
        raise AssertionError("kernel 8's SASS: no mxu_pass_kernel")
    return out


def check_mxu_kernel(torch, gen, compare) -> dict:
    """Kernel 8 against `pass_plain` (exact) in every form: the block form
    (int32 in and out, no twiddle) at sides 2 to 64 and ragged column
    counts, both directions; the first (int32 in, packed out), a middle
    (packed in and out) and the last (packed in, int32 out) pass of 2^20
    chains with sides 16, 32 and 64, both directions; then each middle
    pass timed over 2^20 elements beside its plain version, its floors and
    one `torch._int_mm` of its digit products."""
    from crypto3_zk_tpu_torch.fields import params as P
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX

    fs = P.BLS12_381_FR
    err = 0
    for log_m, b in MXU_BLOCKS:
        for inverse in (False, True):
            plan = MX.get_mxu_plan(fs, log_m, inverse)
            err = max(err, compare(
                "mxu_ntt", fs, lambda f, x: MX.block_ntt(f, plan, x),
                lambda f, x: MX.block_ntt_plain(f, plan, x),
                (rand_field(torch, fs, (1 << log_m, b), gen),)))
    passes = {}
    for s, sides in MXU_CHAINS.items():
        geoms = MX.chain_geoms(sides)
        for p in (0, 1, len(geoms) - 1):
            g = geoms[p]
            for inverse in (False, True):
                x = mxu_input(torch, fs, g, gen)
                got = MX.mxu_pass(fs, g, x, inverse)
                torch.cuda.synchronize()
                want = MX.pass_plain(fs, g, x, inverse)
                err = max(err, mxu_equal(
                    torch, fs, g, got, want,
                    f"pass {p} of chain {sides} (side {g.m}, in "
                    f"{'packed' if g.in_packed else 'int32'}, out "
                    f"{'packed' if g.out_packed else 'int32'}, twiddle "
                    f"{g.twiddle}, {'inverse' if inverse else 'forward'})"))
                del x, got, want
        g = geoms[1]
        sets = [mxu_input(torch, fs, g, gen) for _ in range(2)]
        ms = time_ms(torch, lambda i: MX.mxu_pass(fs, g, sets[i], False), 2,
                     5, queued=True)
        plain_ms = time_ms(torch, lambda i: MX.pass_plain(fs, g, sets[i],
                                                          False), 2, 1)
        del sets
        torch.cuda.empty_cache()
        bnd = mxu_pass_bound(fs, g)
        library = int_mm_ms(torch, g)
        chain_ms = []
        if s == 5:
            # every pass of the 2^20 chain: the first reads int32 digits,
            # the last writes them and has no twiddle
            for gp in geoms:
                sets = [mxu_input(torch, fs, gp, gen) for _ in range(2)]
                chain_ms.append(time_ms(
                    torch, lambda i: MX.mxu_pass(fs, gp, sets[i], False), 2,
                    5, queued=True))
                del sets
            log(f"  mxu_ntt passes of the 2^20 chain {sides}: "
                + ", ".join(f"{t:.4f}" for t in chain_ms) + " ms (bounds "
                + ", ".join(f"{mxu_pass_bound(fs, gp)['bound_ms']:.4f}"
                            for gp in geoms) + "; integer work "
                + ", ".join(f"{mxu_pass_bound(fs, gp)['int_ms']:.4f}"
                            for gp in geoms) + ")")
        useful = 2 * bnd["macs"] / (ms * 1e-3)
        issued = 2 * bnd["issued"] / (ms * 1e-3)
        passes[1 << s] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": library, **bnd,
                          "int8_share": useful / INT8_OPS_PER_S,
                          "issued_share": issued / INT8_OPS_PER_S,
                          "chain_pass_ms": chain_ms}
        log(f"  mxu_ntt middle pass of side {1 << s} over 2^20 elements: "
            f"{ms:.4f} ms, plain {plain_ms:.2f} ms; floors: products "
            f"{bnd['products_ms']:.4f} ms, bytes {bnd['bytes_ms']:.4f} ms, "
            f"integer work {bnd['int_ms']:.4f} ms ({bnd['twiddle_products']} "
            f"twiddle products); bound {bnd['bound_ms']:.4f}"
            f" ms by {bnd['bound_by']} ({100 * bnd['bound_ms'] / ms:.1f} %); "
            f"{useful / 1e12:.1f} T int8 ops/s of the needed products "
            f"({100 * useful / INT8_OPS_PER_S:.1f} % of the peak; issued "
            f"{100 * issued / INT8_OPS_PER_S:.1f} %); one torch._int_mm of "
            f"the same digit products {library:.4f} ms")
    ptxas = mxu_ptxas()
    log(f"  mxu_ntt ptxas: {ptxas}")
    sass = mxu_sass()
    for name, row in sass.items():
        log(f"  mxu_ntt SASS {name}: {row}")
    main = passes[32]
    return {"name": "mxu_ntt", "route": "cuda",
            "source": "crypto3_zk_tpu_torch/csrc/mxu_ntt.cu",
            "replaces": "crypto3_zk_tpu/ops/mxu_ntt.py:198",
            "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "int_bound_ms": main["int_ms"],
            "library_ms": main["library_ms"], "field": fs.name,
            "shape": "a middle pass of side 32 over 2^20 elements (packed "
                     "in and out, twiddle)",
            "pass_by_side": passes, "ptxas": ptxas, "sass": sass,
            "bound_note": "32^2 M 8-bit multiply-adds an element at 1,979 T "
                          "int8 ops/s, or 32 bytes an element in and out; "
                          "int_bound_ms: the epilogue's multiply-adds at the "
                          "measured rate"}


def ntt_floors(fs, log_n: int) -> dict:
    """Transform-level floors (ms): `ntt_mxu`'s, the sum of its passes'
    bounds (larger of products and bytes) under `plan_sides`; and
    `ntt_hopper`'s butterflies alone, N/2 log N Montgomery products at the
    measured multiply-add rate (two instructions a word product)."""
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    geoms = MX.chain_geoms(MX.plan_sides(log_n))
    mxu = sum(mxu_pass_bound(fs, g)["bound_ms"] for g in geoms)
    mxu_int = sum(mxu_pass_bound(fs, g)["int_ms"] for g in geoms)
    hopper = (1 << (log_n - 1)) * log_n * mont_ops(fs.nl) / IMAD["per_s"] \
        * 1e3
    return {"ntt_mxu": mxu, "ntt_mxu_int": mxu_int, "ntt_hopper": hopper,
            "sides": MX.plan_sides(log_n)}


def mxu_path(torch) -> tuple[dict, dict]:
    """`ntt_mxu` over bls12-381 Fr at 2^20, 2^24 and 2^26 forward, equal
    to `ntt_hopper` digit for digit (which is held against `ntt_plain`
    at 2^17 to 2^22 in the other phases), the inverse at 2^20 equal to
    `ntt_hopper`'s, and inverse of forward at 2^26 equal to the input. The
    references are computed outside the counted calls; a forward call must
    launch kernel 8 and nothing else, an inverse kernel 8 and kernel 1 (the
    1/N). Then both forms timed round-robin (device time, 3 repetitions
    each, with the device's peak memory in the call) beside their floors."""
    from crypto3_zk_tpu_torch.fields import params as P
    from crypto3_zk_tpu_torch.ops import hopper_field as HF
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX

    fs = P.BLS12_381_FR
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2012)
    counts = {k: 0 for k in launch_counts()}

    def counted(fn, forward):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        now = launch_counts()
        other = {k: v for k, v in now.items() if v and k != "mxu_ntt"}
        if forward and other:
            raise AssertionError(f"a forward ntt_mxu launched {other}")
        for k, v in now.items():
            counts[k] += v
        return out

    def equal(what, got, want):
        err = max_abs_err(torch, got, want)
        log(f"  {what}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"{what} differs")

    out = {"round_robin": {}, "floors": {}}
    for log_n in MXU_LOGS:
        x = rand_field(torch, fs, (1 << log_n,), gen)
        ref = HF.ntt_hopper(fs, x, False)
        got = counted(lambda: MX.ntt_mxu(fs, x, False), True)
        equal(f"ntt_mxu 2^{log_n} forward (sides "
              f"{MX.plan_sides(log_n)}) against ntt_hopper", got, ref)
        del ref
        if log_n == 20:
            ref = HF.ntt_hopper(fs, x, True)
            inv = counted(lambda: MX.ntt_mxu(fs, x, True), False)
            equal("ntt_mxu 2^20 inverse against ntt_hopper", inv, ref)
            del ref, inv
        if log_n == 26:
            back = counted(lambda: MX.ntt_mxu(fs, got, True), False)
            equal("ntt_mxu 2^26 inverse of forward against the input",
                  back, x)
            del back
        del got
        # round robin: hopper, mxu, mxu, hopper, hopper, mxu (device time
        # with the stream held, one call each; tables built before)
        times = {"ntt_hopper": [], "ntt_mxu": []}
        peaks = {"ntt_hopper": [], "ntt_mxu": []}
        forms = {"ntt_hopper": lambda i: HF.ntt_hopper(fs, x, False),
                 "ntt_mxu": lambda i: MX.ntt_mxu(fs, x, False)}
        order = ["ntt_hopper", "ntt_mxu", "ntt_mxu", "ntt_hopper"] * \
            ((MXU_REPS + 1) // 2)
        for name in order[:2 * MXU_REPS]:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            times[name].append(time_ms(torch, forms[name], 1, 1, queued=True))
            peaks[name].append((torch.cuda.max_memory_allocated() - base)
                               / 2**20)
        floors = ntt_floors(fs, log_n)
        out["round_robin"][f"2^{log_n}"] = {
            k: {"ms": times[k], "peak_extra_mib": peaks[k]} for k in times}
        out["floors"][f"2^{log_n}"] = floors
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        log(f"  2^{log_n} forward, round robin: " + "; ".join(
            f"{k} " + ", ".join(f"{t:.3f}" for t in times[k]) + " ms, peak "
            f"+{max(peaks[k]):.0f} MiB" for k in times)
            + f"; medians {med['ntt_mxu']:.3f} / {med['ntt_hopper']:.3f} ms "
            f"against floors {floors['ntt_mxu']:.3f} (integer work "
            f"{floors['ntt_mxu_int']:.3f}) / {floors['ntt_hopper']:.3f} ms")
        del x
        if log_n > 20:
            # the 2^24 and 2^26 twiddle tables hold 1 and 4 GiB a direction
            HF._four_step_twiddles.cache_clear()
            torch.cuda.empty_cache()
    if not counts["mxu_ntt"] or not counts["mont_mul"]:
        raise AssertionError("the ntt_mxu path never launched kernel 8 or "
                             "the inverse's kernel 1")
    log(f"  launches of the ntt_mxu path: "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts, out


def check_big_transforms(torch) -> dict:
    """`ntt_hopper` past the single four-step's 2^20: against `ntt_plain`
    at 2^21 and 2^22, forward and inverse; inverse of forward equals the
    input at 2^24 and 2^26, each direction timed (bls12-381 Fr)."""
    from crypto3_zk_tpu_torch.fields import params as P
    from crypto3_zk_tpu_torch.ops import hopper_field as HF

    fs = P.BLS12_381_FR
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2026)
    out = {}
    for log_n in (21, 22):
        x = rand_field(torch, fs, (1 << log_n,), gen)
        for inverse in (False, True):
            before = launch_counts()
            got = HF.ntt_hopper(fs, x, inverse)
            torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in launch_counts().items()
                        if v != before[k]}
            err = max_abs_err(torch, got, HF.ntt_plain(fs, x, inverse))
            log(f"  ntt_hopper {fs.name} 2^{log_n} "
                f"{'inverse' if inverse else 'forward'}: max_abs_err {err}, "
                f"launches {launches}")
            if err != 0:
                raise AssertionError(f"ntt_hopper disagrees with its plain "
                                     f"version at 2^{log_n}")
            out[f"2^{log_n}_{'inverse' if inverse else 'forward'}_launches"] \
                = launches
        del x, got
    for log_n in (24, 26):
        x = rand_field(torch, fs, (1 << log_n,), gen)
        ev = HF.ntt_hopper(fs, x, False)
        back = HF.ntt_hopper(fs, ev, True)
        torch.cuda.synchronize()
        err = max_abs_err(torch, back, x)
        del back
        fwd = time_ms(torch, lambda i: HF.ntt_hopper(fs, x, False), 1, 3)
        inv = time_ms(torch, lambda i: HF.ntt_hopper(fs, ev, True), 1, 3)
        log(f"  ntt_hopper {fs.name} 2^{log_n}: inverse of forward "
            f"max_abs_err {err}; forward {fwd:.3f} ms, inverse {inv:.3f} ms "
            f"(peak {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB)")
        if err != 0:
            raise AssertionError(f"ntt_hopper round trip fails at 2^{log_n}")
        out[f"2^{log_n}_forward_ms"], out[f"2^{log_n}_inverse_ms"] = fwd, inv
        del x, ev
        # the 2^26 twiddle tables hold 8 GiB: give them back
        HF._four_step_twiddles.cache_clear()
        torch.cuda.empty_cache()
    return out


def check_longest_transform(torch, n: int) -> None:
    """`ntt_hopper` against its plain version, forward and inverse, at the
    longest transform the Placeholder prove ran."""
    from crypto3_zk_tpu_torch.fields import params as P
    from crypto3_zk_tpu_torch.ops import hopper_field as HF

    fs = P.BLS12_381_FR
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2019)
    x = rand_field(torch, fs, (n,), gen)
    for inverse in (False, True):
        got = HF.ntt_hopper(fs, x, inverse)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, HF.ntt_plain(fs, x, inverse))
        log(f"  ntt_hopper {fs.name} 2^{n.bit_length() - 1} "
            f"{'inverse' if inverse else 'forward'}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"ntt_hopper disagrees with its plain "
                                 f"version at {n}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print ptxas' register and shared-memory report")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from crypto3_zk_tpu_torch import kernels as K

    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {card}")

    secs = K.build_all(verbose=args.verbose_build)
    log(f"build: {secs:.2f} s ({len(K.SOURCES)} sources, nvcc sm_90a)")
    rate = imad_rate(torch)
    log(f"32-bit multiply-adds with carry: {rate / 1e12:.3f} T/s measured "
        f"(the float32 rate the bounds use: {OPS_PER_S / 1e12:.0f} T/s)")
    streams = int_streams(torch)

    t0 = time.perf_counter()
    rows, transforms = check_kernels(torch)
    log(f"kernels: {time.perf_counter() - t0:.2f} s, launches so far "
        f"{launch_counts()}")

    extra = {"imad_per_s": rate, "int_streams": streams}
    if not args.kernels_only:
        t0 = time.perf_counter()
        extra["ntt_big"] = check_big_transforms(torch)
        log(f"ntt past 2^20: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        mxu_counts, extra["ntt_mxu"] = mxu_path(torch)
        log(f"ntt_mxu at 2^20, 2^24 and 2^26, equal to ntt_hopper, timed "
            f"round robin: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        field_counts = {"goldilocks": goldilocks_agreement(torch)}
        log(f"Goldilocks circuit_1 proof, card against CPU: equal, "
            f"verified: {time.perf_counter() - t0:.2f} s, launches "
            f"{field_counts['goldilocks']}")
        t0 = time.perf_counter()
        field_counts["mnt4_fr"] = mnt4_witness_map(torch)
        log(f"MNT4 Fr witness map, card against CPU: equal: "
            f"{time.perf_counter() - t0:.2f} s, launches "
            f"{field_counts['mnt4_fr']}")
        t0 = time.perf_counter()
        small_agreement(torch)
        log(f"small circuit, card against CPU: equal proofs: "
            f"{time.perf_counter() - t0:.2f} s")
        from crypto3_zk_tpu_torch.fields import curves as CV
        for curve in (CV.ALT_BN128, CV.BLS12_381):
            dt = msm_oracle_check(curve)
            log(f"msm 2^10 on {curve.name} against its oracle: equal: "
                f"{dt:.2f} s")
        paths = {"groth16_prove": main_path(torch), "mxu_path": mxu_counts}
        t0 = time.perf_counter()
        small_agreement_lpc(torch)
        log(f"small LPC proof, card against CPU: equal: "
            f"{time.perf_counter() - t0:.2f} s")
        paths["lpc_path"], paths["lpc_proof_eval"] = lpc_path(torch)
        t0 = time.perf_counter()
        small_agreement_placeholder(torch)
        log(f"small Placeholder proof, card against CPU: equal: "
            f"{time.perf_counter() - t0:.2f} s")
        extra["poseidon_device_ms"] = {}
        for rows_log in PLACEHOLDER_LOG2_ROWS:
            tag = "placeholder" if rows_log == 16 else f"placeholder{rows_log}"
            (paths[tag + "_path"], paths[tag + "_prove"], longest,
             extra["poseidon_device_ms"][f"2^{rows_log}"]) = \
                placeholder_path(torch, rows_log)
            check_longest_transform(torch, longest)
        t0 = time.perf_counter()
        msm_against_host(torch)
        log(f"msm against the host: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        small_agreement_placeholder_kzg(torch)
        log(f"small Placeholder-over-KZG proofs (v2, bdfg), card against "
            f"CPU: equal, verified: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        (paths["placeholder_kzg_path"], paths["placeholder_kzg_prove"],
         extra["placeholder_kzg"]) = placeholder_kzg_path(torch)
        log(f"placeholder over kzg: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        small_agreement_classic(torch)
        log(f"small PGHR13, GM17 and USCS proofs, card against CPU: equal, "
            f"verified: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        paths["classic_path"], extra["classic"] = classic_path(torch)
        log(f"classic provers: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        small_agreement_ceremony(torch)
        log(f"small ceremony (m = 8), card against CPU: equal, verified: "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        small_agreement_extensions(torch)
        log(f"small aggregate, encrypted-input, ADSNARK and PCD proofs, "
            f"card against CPU: equal, verified: "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        paths["ceremony_path"], extra["ceremony"] = ceremony_path(torch)
        log(f"ceremony path: {time.perf_counter() - t0:.2f} s")
        from crypto3_zk_tpu_torch.commitments import ipa as IPA
        for curve in (IPA.PALLAS, IPA.VESTA):
            dt = msm_oracle_check(curve)
            log(f"msm 2^10 on {curve.name} against its oracle: equal: "
                f"{dt:.2f} s")
        extra["pasta_msm_crossover_ms"] = pasta_msm_crossover(torch)
        t0 = time.perf_counter()
        small_agreement_pasta(torch)
        log(f"small IPA, kimchi SRS + Lagrange basis and Pickles proofs, "
            f"card against CPU: equal, verified: "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        paths["pasta_path"], extra["pasta"] = pasta_path(torch)
        log(f"pasta path: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        small_agreement_lpc_sha2(torch)
        log(f"small sha2 LPC proof, card against CPU: equal: "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        (paths["lpc_sha2_path"], paths["lpc_sha2_proof_eval"],
         extra["lpc_sha2"]) = lpc_sha2_path(torch)
        log(f"sha2 LPC path: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        paths["mesh_path"], extra["mesh"] = mesh_path(torch)
        log(f"mesh path: {time.perf_counter() - t0:.2f} s")
        whole = [k for k in paths
                 if k in ("groth16_prove", "lpc_path", "classic_path",
                          "ceremony_path", "pasta_path", "lpc_sha2_path",
                          "mesh_path", "mxu_path")
                 or k.endswith("_path") and k.startswith("placeholder")]
        for row in rows:
            name, _, field = row["name"].partition("[")
            if field:
                # another field's instance: its launches in that field's run
                row["launches"] = field_counts[field[:-1]][name]
                continue
            row["launches"] = sum(paths[k][name] for k in whole)
            for k, counts in paths.items():
                row["launches_" + k] = counts[name]
    log(json.dumps({"ntt_2p17_ms": transforms, **extra}))
    log(json.dumps({"kernels": rows}))
    log(f"total: {time.perf_counter() - t_all:.2f} s")
    log(card)
    if args.kernels_only:
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
