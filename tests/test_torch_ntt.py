"""The port's NTT (`crypto3_zk_tpu_torch.ops.ntt`, `ops.hopper_field`)
against the JAX package's, on the CPU, bit for bit (tolerance 0). Inputs are
made with numpy from a fixed seed and given to both."""
import numpy as np
import pytest
import torch

from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.ops import limbs as L
from crypto3_zk_tpu.ops import ntt as N
from crypto3_zk_tpu.ops import pallas_field as PF
from crypto3_zk_tpu_torch import convert as CONV
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import hopper_field as HF
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.ops import ntt as TN
from crypto3_zk_tpu_torch.poly.domain import get_domain

import torch_threads  # noqa: F401  one torch thread a worker

FS, TFS = P.ALT_BN128_FR, TP.ALT_BN128_FR


def _pair(n, seed, fs=FS, tfs=TFS, lead=()):
    rng = np.random.default_rng(seed)
    count = int(np.prod(lead, dtype=np.int64)) * n
    vals = [int.from_bytes(rng.bytes(40), "little") % fs.p
            for _ in range(count)]
    arr = np.asarray(L.encode(fs, vals)).reshape((fs.nl,) + lead + (n,))
    return vals, arr, CONV.limbs_from_numpy(tfs, arr, device="cpu")


def _same(ref, got):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy().astype(np.int64))


@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 8, 10])
def test_ntt_and_coset_transforms_match_reference(log_n):
    n = 1 << log_n
    _, x, tx = _pair(n, log_n)
    fwd = N.ntt(FS, x)
    _same(fwd, TN.ntt(TFS, tx))
    _same(N.ntt(FS, x, inverse=True), TN.ntt(TFS, tx, inverse=True))
    _same(x, TN.ntt(TFS, TN.ntt(TFS, tx), inverse=True))
    _same(N.ntt_raw(FS, x, inverse=True), TN.ntt_raw(TFS, tx, inverse=True))
    g = FS.generator
    _same(N.coset_ntt(FS, x, g), TN.coset_ntt(TFS, tx, g))
    _same(N.coset_intt(FS, x, g), TN.coset_intt(TFS, tx, g))
    # the four-step wrapper (its CPU route) computes the same transform
    _same(fwd, HF.ntt_hopper(TFS, tx))


def test_ntt_is_polynomial_evaluation():
    n = 16
    vals, _, tx = _pair(n, 77)
    p, w = FS.p, FS.root_of_unity(n)
    want = [sum(c * pow(w, i * j, p) for j, c in enumerate(vals)) % p
            for i in range(n)]
    assert TL.decode(TFS, TN.ntt(TFS, tx)) == want
    assert TL.decode(TFS, get_domain(TFS, n).fft(tx)) == want
    assert TL.decode(TFS, get_domain(TFS, n).ifft(
        TL.encode(TFS, want, "cpu"))) == vals


@pytest.mark.parametrize("log_n", [4, 6, 7, 9])
def test_transforms_are_evaluations_on_the_domain_and_its_coset(log_n):
    """The sizes the sweep above leaves out, held against Python ints
    instead of a compile of the reference: `ntt` evaluates the polynomial at
    w^i, `coset_ntt` at g w^i, and the inverses undo them."""
    n = 1 << log_n
    vals, _, tx = _pair(n, 50 + log_n)
    p, w, g = FS.p, FS.root_of_unity(n), FS.generator
    wp = [pow(w, i, p) for i in range(n)]
    want = [sum(c * wp[i * j % n] for j, c in enumerate(vals)) % p
            for i in range(n)]
    gp = [pow(g, j, p) for j in range(n)]
    shifted = [sum(c * gp[j] % p * wp[i * j % n] for j, c in enumerate(vals))
               % p for i in range(n)]
    fwd, cos = TN.ntt(TFS, tx), TN.coset_ntt(TFS, tx, g)
    assert TL.decode(TFS, fwd) == want
    assert TL.decode(TFS, cos) == shifted
    assert torch.equal(TN.ntt(TFS, fwd, inverse=True), tx)
    assert torch.equal(TN.coset_intt(TFS, cos, g), tx)
    assert torch.equal(HF.ntt_hopper(TFS, tx), fwd)


def test_batched_rows_match_reference():
    _, x, tx = _pair(32, 5, lead=(3,))
    _same(N.ntt(FS, x), TN.ntt(TFS, tx))
    _same(N.ntt(FS, x, inverse=True), TN.ntt(TFS, tx, inverse=True))
    _same(N.ntt_raw(FS, x), HF.ntt_rows_hopper(TFS, tx, False))


def test_second_scalar_field_bls12_381_fr():
    fs, tfs = P.BLS12_381_FR, TP.BLS12_381_FR
    _, x, tx = _pair(64, 9, fs, tfs)
    _same(N.ntt(fs, x), TN.ntt(tfs, tx))


def test_row_kernel_plain_version_matches_pallas_kernel():
    """Kernel 2's plain version against the TPU row kernel in interpret
    mode, at two rows of 2^2: compiling that kernel in interpret mode costs
    tens of seconds per butterfly stage on a cold cache (minutes at 2^6), so
    the longer sizes below are held against `ops.ntt` instead."""
    _, x, tx = _pair(4, 21, lead=(2,))
    ref = PF._ntt_rows_pallas(FS, x, False, interpret=True)
    _same(ref, HF.ntt_rows_plain(TFS, tx, False))
    _same(ref, HF.ntt_rows_hopper(TFS, tx, False))


@pytest.mark.parametrize("inverse", [False, True])
def test_row_kernel_plain_version_matches_reference_rows(inverse):
    _, x, tx = _pair(64, 22, lead=(3,))
    _same(N.ntt_raw(FS, x, inverse=inverse),
          HF.ntt_rows_plain(TFS, tx, inverse))


@pytest.mark.parametrize("log_n", [6, 11, 12])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_wrapper_matches_reference(log_n, inverse):
    """`ntt_hopper` at a direct size and at 2^11 and 2^12, the smallest sizes
    that take the four-step branch (C = 32, R = 64 and R = C = 64): two row
    passes over strided views, the twiddle table and 1/N as multipliers.
    Held against `crypto3_zk_tpu.ops.ntt.ntt`, which computes what
    `ntt_pallas` does: the Pallas kernel's interpret mode is too slow here at
    these lengths."""
    n = 1 << log_n
    _, x, tx = _pair(n, 30 + log_n)
    ref = N.ntt(FS, x, inverse=inverse)
    _same(ref, HF.ntt_hopper(TFS, tx, inverse))
    _same(ref, HF.ntt_plain(TFS, tx, inverse))
    if not inverse:
        _same(ref, HF.ntt_hopper_raw(TFS, tx, inverse))


def _views(seed, m=8, b=16):
    """A strided input (the columns of a (B, M) matrix as M rows of B), its
    contiguous copy, and a strided output view into a flat buffer."""
    _, _, base = _pair(m, seed, lead=(b,))                  # (NL, B, M)
    x = base.transpose(1, 2)                                # (NL, M, B)
    flat = torch.full((TFS.nl, m * b), -1, dtype=torch.int32)
    return x, x.contiguous(), flat, flat.reshape(TFS.nl, b, m).transpose(1, 2)


@pytest.mark.parametrize("kind", ["none", "table", "constant", "per_row",
                                  "per_element"])
@pytest.mark.parametrize("inverse", [False, True])
def test_rows_with_strides_and_multiplier_equal_the_unfused_steps(kind,
                                                                  inverse):
    """Strided input, strided output and each kind of multiplier through the
    plain row function and the wrapper: the same as transforming a
    contiguous copy, multiplying afterwards and copying into place."""
    x, xc, flat, view = _views(61)
    _, _, table = _pair(16, 62, lead=(8,))                  # (NL, 8, 16)
    mul = {"none": None, "table": table,
           "constant": TL.const_mont(TFS, 0xABCDEF, (1, 1), "cpu"),
           "per_row": table[:, :, :1], "per_element": table[:, :1, :]}[kind]
    want = HF.ntt_rows_plain(TFS, xc, inverse)
    if mul is not None:
        want = HF.mont_mul_plain(TFS, want, mul)
    for rows in (HF.ntt_rows_plain, HF.ntt_rows_hopper):
        assert torch.equal(rows(TFS, x, inverse, mul), want)
        flat.fill_(-1)
        assert rows(TFS, x, inverse, mul, view) is view
        assert torch.equal(view, want)
        assert torch.equal(flat.reshape(TFS.nl, 16, 8),
                           want.transpose(1, 2))


def test_rows_launch_is_what_the_kernel_is_given():
    """(rows, log B, log G, threads, shared-memory bytes, strides of x,
    multiplier view, strides of out), and the layouts that are refused."""
    nl = TFS.nl
    x = torch.zeros((nl, 256, 512), dtype=torch.int32)
    rows, log_b, log_g, threads, smem, xs, mul, outs = \
        HF._rows_launch(TFS, x, None, None)
    assert (rows, log_b, log_g, threads) == (256, 9, 1, 256)
    assert smem == 8 * (2 * 512 + 256) * 4
    assert list(xs) == [256 * 512, 512, 1] and mul is None and outs is None
    # the two passes of a 2^17 four-step (C = 256, R = 512): columns in,
    # then columns in and out
    flat = torch.zeros((nl, 1 << 17), dtype=torch.int32)
    cols = flat.reshape(nl, 512, 256).transpose(1, 2)       # (NL, 256, 512)
    table = torch.zeros((nl, 256, 512), dtype=torch.int32)
    rows, log_b, log_g, threads, smem, xs, mul, _ = \
        HF._rows_launch(TFS, cols, table, None)
    assert (rows, log_b, log_g, threads) == (256, 9, 1, 256)
    assert list(xs) == [1 << 17, 1, 256]
    assert mul.stride() == (1 << 17, 512, 1)
    out = torch.zeros((nl, 1 << 17), dtype=torch.int32)
    view = out.reshape(nl, 256, 512).transpose(1, 2)        # (NL, 512, 256)
    scale = HF._inverse_scale(TFS, 1 << 17, "cpu")
    assert scale is HF._inverse_scale(TFS, 1 << 17, "cpu")  # stays put
    rows, log_b, log_g, threads, _, xs, mul, outs = \
        HF._rows_launch(TFS, table.transpose(1, 2), scale, view)
    assert (rows, log_b, log_g, threads) == (512, 8, 2, 256)
    assert list(xs) == [1 << 17, 1, 512] and list(outs) == [1 << 17, 1, 512]
    assert mul.shape == (nl, 512, 256) and mul.stride()[1:] == (0, 0)
    # short rows are grouped while 128 blocks remain; few rows are not
    short = torch.zeros((nl, 4096, 2), dtype=torch.int32)
    assert HF._rows_launch(TFS, short, None, None)[2:4] == (5, 32)
    one = torch.zeros((nl, 1, 1024), dtype=torch.int32)
    assert HF._rows_launch(TFS, one, None, None)[2:4] == (0, 256)
    wide = torch.zeros((24, 4096, 2), dtype=torch.int32)
    assert HF._rows_launch(TP.BLS12_381_FQ, wide, None, None)[4] \
        == 12 * (64 + 1) * 4
    # refusals
    bad_x = [torch.zeros((nl, 4, 24), dtype=torch.int32),        # not 2^k
             torch.zeros((nl, 2, 2048), dtype=torch.int32),      # too long
             torch.zeros((nl, 4, 1), dtype=torch.int32),
             torch.zeros((nl, 0, 8), dtype=torch.int32)]
    for bad in bad_x:
        with pytest.raises(ValueError):
            HF._rows_launch(TFS, bad, None, None)
    for bad in (torch.zeros((nl, 4, 8), dtype=torch.int64),
                torch.zeros((nl, 32), dtype=torch.int32),
                torch.zeros((nl + 1, 4, 8), dtype=torch.int32)):
        with pytest.raises(TypeError):
            HF._rows_launch(TFS, bad, None, None)
    x = torch.zeros((nl, 4, 8), dtype=torch.int32)
    bad_out = [x,                                                # in place
               x.transpose(1, 2).transpose(1, 2)[:, :, :],       # same storage
               torch.zeros((nl, 4, 1), dtype=torch.int32).expand(nl, 4, 8),
               torch.zeros((nl, 8, 4), dtype=torch.int32)]
    for bad in bad_out:
        with pytest.raises(ValueError):
            HF._rows_launch(TFS, x, None, bad)
    for bad in (torch.zeros((nl, 2, 8), dtype=torch.int32),
                torch.zeros((nl, 8), dtype=torch.int32)):
        with pytest.raises(ValueError):
            HF._rows_launch(TFS, x, bad, None)


@pytest.mark.parametrize("log_b", [1, 2, 5, 9])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_words_are_the_plain_table_fused_and_bit_reversed(log_b,
                                                                  inverse):
    words = HF._twiddle_words(TFS, log_b, inverse, "cpu").numpy() \
        .view(np.uint32)
    plain = HF._twiddles_np(TFS, log_b, inverse).astype(np.uint32)
    assert words.shape == (TFS.nl // 2, max(1 << (log_b - 1), 1))
    slots = HF.bitrev_perm(log_b - 1)
    # slot m holds w^j with j = the bit reversal of m
    np.testing.assert_array_equal(words & 0xFFFF, plain[0::2][:, slots])
    np.testing.assert_array_equal(words >> 16, plain[1::2][:, slots])
    # stage t of a row of 2^log_b reads the slots below 2^(t-1): they hold
    # the powers w^(j * B / 2^t) that the stage needs
    for t in range(1, log_b + 1):
        js = sorted(int(slots[m]) for m in range(1 << (t - 1)))
        assert js == [j << (log_b - t) for j in range(1 << (t - 1))]


def test_kernels_refuse_a_modulus_that_fills_its_top_word():
    """The 8- and 12-word instances keep sums of two residues in NW words,
    so a modulus of 16 or 24 digits without a free top bit is refused; only
    the 2-word instance (Goldilocks) carries out of its top word."""
    from crypto3_zk_tpu_torch import kernels as K
    p = 2**256 - 2**32 - 977
    g = next(g for g in range(2, 50) if pow(g, (p - 1) // 2, p) == p - 1)
    full = TP.FieldSpec("full_256", p, g, 1)
    with pytest.raises(ValueError):
        K.field_consts(full)
    assert K.field_consts(TP.BLS12_381_FR)[0] == 8
    assert TP.GOLDILOCKS.p.bit_length() == 64
    nw, consts = K.field_consts(TP.GOLDILOCKS)
    assert nw == 2 and list(consts)[:2] == [1, 0xFFFFFFFF]


def test_four_step_twiddles_match_reference():
    n, r, c = 1 << 11, 1 << 5, 1 << 6
    for inverse in (False, True):
        _same(PF._four_step_twiddles_np(FS, n, r, c, inverse),
              HF._four_step_twiddles(TFS, n, r, c, inverse, "cpu"))
    _same(N.get_plan(FS, 6).tw_fwd,
          torch.from_numpy(TN.get_plan(TFS, 6).tw_fwd.astype(np.int32)))
    np.testing.assert_array_equal(N._bitrev_perm(7), TN._bitrev_perm(7))


def test_launch_geometry_reads_operands_in_place():
    """The strided views the elementwise kernel walks: no copy, and walking
    them in (d0, d1, d2) order gives the broadcast result."""
    _, _, a = _pair(6, 41, lead=(4,))              # (NL, 4, 6)
    cases = [
        (a, a.flip(1).contiguous()),                 # same shape, contiguous
        (a, TL.const_mont(TFS, 7, (1, 1), "cpu")),   # broadcast constant
        (a.transpose(1, 2), a.transpose(1, 2)),      # views
        (a[:, :, :1], a[:, :1, :]),                  # both broadcast
    ]
    for x, y in cases:
        bshape, shape3, xv, yv = HF._launch_geometry(TFS.nl, x, y)
        assert xv.data_ptr() == x.data_ptr() and yv.data_ptr() == y.data_ptr()
        assert xv.shape == yv.shape == (TFS.nl,) + shape3
        walked = HF.mont_mul_plain(TFS, xv.reshape(TFS.nl, -1),
                                   yv.reshape(TFS.nl, -1))
        want = HF.mont_mul_plain(TFS, x, y)
        assert tuple(want.shape[1:]) == bshape
        assert torch.equal(walked.reshape(want.shape), want)
