#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the CUDA kernels from `crypto3_zk_tpu_torch/csrc/`, measures the
card's 32-bit multiply-add rate (`csrc/rate.cu`), holds each kernel, and
each form of kernel 5, against its plain PyTorch version on the card (exact
equality: every value is an integer) for the 8- and 12-word fields and for
the Goldilocks (2 words, p fills its top word) and MNT4 Fr (19 digits,
R = 2^304) instances, then drives the port's main paths through the entry
points a user calls:

- `ntt_hopper` past the single four-step's 2^20: against `ntt_plain` at
  2^21 and 2^22, and inverse of forward at 2^24 and 2^26 (bls12-381 Fr);
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
- the Placeholder prover over bls12-381 Fr on tables of 2^16 and of 2^18
  rows (`arithmetization.circuits.placeholder_chain`: an add/mul chain over
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
  rejected.

It fails (non-zero exit, no result line) without a CUDA device, when a kernel
does not build, launch or agree, when a kernel of a path was never launched
by that path (the launch counts are set to 0 just before each path and read
just after), when a verifier's answer is wrong (a proof rejected, a wrong
public input or a changed evaluation accepted, prover and verifier
transcripts that disagree), or when a small proof made on the card differs
from the CPU plain path's.

Output: one line per phase with its seconds; then the times of one whole 2^17
transform, the transforms past 2^20, the multiply-add rate and kernel 5's
device ms in each Placeholder prove as a JSON object; then, on a line of its
own, a JSON object {"kernels": [...]} with every kernel's numbers
(`launches` is the sum over the whole paths: Groth16 prove, LPC path,
both Placeholder paths over LPC, the Placeholder-over-KZG path and the
classic path; `launches_<path>` its parts; a row named
`kernel[field]` is another field's instance, its launches those of that
field's run; `int_bound_ms` is the bound with the measured integer rate);
then the card's name and power limit; then the result line.

`--kernels-only` stops after the kernel checks, for a quick look at a kernel
edit: it drives no main path, so its `kernels` line carries no `launches`
and it prints no result line. With no arguments the run is the full one.
"""
from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
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


def int_bound_ms(bytes_moved: int, ops: int) -> float:
    """The bound with the measured integer rate in place of the float32
    one: the larger of the bytes' time and the multiply-add instructions'
    (`ops` counts two a word product, the instructions it issues)."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / IMAD["per_s"]) * 1e3


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
                plain_reps=2):
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
        log(f"  {name}: {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by}, integer-rate bound "
            f"{rows[-1]['int_bound_ms']:.4f} ms")
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
    return rows, transforms


LPC_LOG2_DEGREE = 16         # the LPC path's polynomials: degree < 2^16
LPC_EXPAND = 2               # its first domain D0 has 2^18 points, and its
                             # first Merkle trees 2^17 leaves (the fixture's
                             # expand factor, `tools/lpc_fixture.py`)
# states each form is timed at: both sides of `hopper_hash.SHARED_MAX`
POSEIDON_SIZES = (64, 1 << 12, 1 << 13, 1 << 14, 1 << 17)


def check_poseidon(torch, gen, compare, measure, rows, product_ms):
    """Kernel 5 against its plain version in each form (one thread a state,
    three threads a state, the tree's tail in one launch): both round
    orders, both word counts, every input form the Merkle layer uses; each
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
        log(f"  poseidon on {fs.name}: alpha {pp.alpha}, "
            f"{len(pp.round_constants)} rounds, partial "
            f"{pp.partial_rounds}, rc first {pp.rc_first}, "
            f"{HH.products_per_state(pp)} products a state")
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
    # the Merkle forms at the LPC path's own top shapes: the largest node
    # level (strided even and odd digests, no third element, element 0 out)
    # and a two-row leaf sponge (no state, two absorb planes, element 0 out)
    pp = PO.get_params(P.BLS12_381_FR)
    fs = pp.fs
    products = HH.products_per_state(pp)
    for form in ("lanes", "shared"):
        _, level, _, sponge = forms(form)
        err[form] = max(err[form], compare(
            f"poseidon({form}, level)", fs, level, level_plain,
            (rand_field(torch, fs, (top,), gen),)))
        err[form] = max(err[form], compare(
            f"poseidon({form}, absorb)", fs, sponge, sponge_plain,
            (rand_field(torch, fs, (top,), gen),
             rand_field(torch, fs, (top,), gen))))
    # each form timed at each size; the row's own numbers at the size where
    # the wrapper picks it (2^17 for one thread a state, as in earlier runs;
    # 2^12 for three threads a state)
    chain = {"lanes": products, "shared": len(pp.round_constants) * 6}
    form_rows = {}
    for form, name, n_row in (("lanes", "poseidon", top),
                              ("shared", "poseidon_shared", 1 << 12)):
        permute = forms(form)[0]
        row = measure(name, "crypto3_zk_tpu_torch/csrc/poseidon.cu",
                      "crypto3_zk_tpu/ops/poseidon.py:185", fs, permute,
                      permute_plain,
                      lambda: (rand_field(torch, fs, (3, n_row), gen),),
                      bytes_moved=6 * fs.nl * 4 * n_row,
                      ops=products * mont_ops(fs.nl) * n_row,
                      per_set_bytes=3 * fs.nl * 4 * n_row,
                      extra_err=err[form])
        form_rows[form] = row
        row["form"] = form
        row["products_in_sequence"] = chain[form]
        row["latency_bound_ms"] = chain[form] * product_ms
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
    lanes_row["products_per_state"] = products
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
                  ops=products * mont_ops(fs.nl) * (2 * HH.TREE_MAX - 1),
                  per_set_bytes=FLUSH_BYTES, extra_err=err["tree"],
                  plain_reps=1)
    row["form"] = "tree"
    row["products_in_sequence"] = levels * chain["shared"]
    row["latency_bound_ms"] = levels * chain["shared"] * product_ms
    log(f"  poseidon_tree: {levels} levels, latency bound "
        f"{row['latency_bound_ms']:.4f} ms")

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
    products = HH.products_per_state(pp)

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
            ops=products * mont_ops(fs.nl) * n_row,
            per_set_bytes=3 * fs.nl * 4 * n_row, extra_err=errs[form])
        row["form"] = form
    n2 = 2 * HH.TREE_MAX
    measure("poseidon_tree" + tag, "crypto3_zk_tpu_torch/csrc/poseidon.cu",
            "crypto3_zk_tpu/ops/poseidon.py:185", fs,
            lambda fs_, d: tuple(HH.poseidon_tree_hopper(pp, d)),
            lambda fs_, d: tuple(HH.poseidon_tree_plain(pp, d)),
            lambda: (rand_field(torch, fs, (n2,), gen),),
            bytes_moved=fs.nl * 4 * (n2 + 2 * HH.TREE_MAX - 1),
            ops=products * mont_ops(fs.nl) * (2 * HH.TREE_MAX - 1),
            per_set_bytes=FLUSH_BYTES, extra_err=errs["tree"])


def launch_counts() -> dict:
    from crypto3_zk_tpu_torch.ops import hopper_field as HF
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    from crypto3_zk_tpu_torch.ops import hopper_msm as HM
    return {**HF.LAUNCHES, **HM.LAUNCHES, **HH.LAUNCHES}


def reset_launch_counts() -> None:
    from crypto3_zk_tpu_torch.ops import hopper_field as HF
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    from crypto3_zk_tpu_torch.ops import hopper_msm as HM
    for counts in (HF.LAUNCHES, HF.LARGEST, HM.LAUNCHES, HM.ELEMENTS,
                   HH.LAUNCHES, HH.ELEMENTS):
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

PLACEHOLDER_LOG2_ROWS = (16, 18)   # the tables: 2^k rows, 2^k - 6 usable


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

    t0 = time.perf_counter()
    rows, transforms = check_kernels(torch)
    log(f"kernels: {time.perf_counter() - t0:.2f} s, launches so far "
        f"{launch_counts()}")

    extra = {"imad_per_s": rate}
    if not args.kernels_only:
        t0 = time.perf_counter()
        extra["ntt_big"] = check_big_transforms(torch)
        log(f"ntt past 2^20: {time.perf_counter() - t0:.2f} s")
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
        paths = {"groth16_prove": main_path(torch)}
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
        whole = [k for k in paths
                 if k in ("groth16_prove", "lpc_path", "classic_path")
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
