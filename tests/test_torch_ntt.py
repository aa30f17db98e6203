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


@pytest.mark.parametrize("log_n", [6, 11])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_wrapper_matches_reference(log_n, inverse):
    """`ntt_hopper` at the largest direct size's neighbourhood and at 2^11,
    the smallest size that takes the four-step branch. Held against
    `crypto3_zk_tpu.ops.ntt.ntt`, which computes what `ntt_pallas` does: the
    Pallas kernel's interpret mode is too slow here at these lengths."""
    n = 1 << log_n
    _, x, tx = _pair(n, 30 + log_n)
    _same(N.ntt(FS, x, inverse=inverse), HF.ntt_hopper(TFS, tx, inverse))


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
