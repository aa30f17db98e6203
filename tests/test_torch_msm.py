"""The port's MSM modules (`ops.hopper_msm`, `ops.msm_affine`, `ops.msm`,
`ops.curve`) on the CPU: the inversion kernels' plain versions against the
TPU kernels in interpret mode, and the MSM's output point against the JAX
package's host oracle. Everything is an integer: equality is exact."""
import random

import numpy as np
import pytest
import torch

from crypto3_zk_tpu.fields import curves as CV
from crypto3_zk_tpu.ops import curve as CRV
from crypto3_zk_tpu.ops import limbs as L
from crypto3_zk_tpu.ops import msm_affine as MA
from crypto3_zk_tpu.ops import pallas_msm as PM
from crypto3_zk_tpu.ops.msm import msm_host
from crypto3_zk_tpu_torch import convert as CONV
from crypto3_zk_tpu_torch.fields import curves as TCV
from crypto3_zk_tpu_torch.ops import curve as TCRV
from crypto3_zk_tpu_torch.ops import hopper_msm as HM
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.ops import msm as TM
from crypto3_zk_tpu_torch.ops import msm_affine as TMA

import torch_threads  # noqa: F401  one torch thread a worker

CURVE, TCURVE = CV.ALT_BN128, TCV.ALT_BN128


def _same(ref, got):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy().astype(np.int64))


def test_inversion_kernels_plain_versions_match_pallas_kernels():
    """Kernels 3 and 4 at C = 4, K = 8. The TPU kernels take x as
    (NL, C, K) and give f, g as (K, NL, C); the port's layout is (NL, K, C)
    throughout, so the comparison transposes."""
    fs, tfs = CURVE.fq, TCURVE.fq
    rng = np.random.default_rng(3)
    C, K = 4, 8
    vals = [int.from_bytes(rng.bytes(40), "little") % (fs.p - 1) + 1
            for _ in range(C * K)]
    xr = L.encode(fs, vals).reshape(fs.nl, C, K)
    f, g, tot = PM.inv_scans_pallas(fs, xr, L.ones_mont(fs, (1,)),
                                    interpret=True)
    out = PM.mul3_bcast_pallas(fs, f, g, tot, interpret=True)   # (NL, C, K)

    tx = CONV.limbs_from_numpy(tfs, np.asarray(xr), "cpu") \
        .transpose(1, 2).contiguous()                           # (NL, K, C)
    for scans in (HM.inv_scans_plain, HM.inv_scans_hopper):
        tf, tg, ttot = scans(tfs, tx)
        _same(np.transpose(np.asarray(f), (1, 0, 2)), tf)
        _same(np.transpose(np.asarray(g), (1, 0, 2)), tg)
        _same(tot, ttot)
    for mul3 in (HM.mul3_bcast_plain, HM.mul3_bcast_hopper):
        _same(np.transpose(np.asarray(out), (0, 2, 1)),
              mul3(tfs, tf, tg, ttot))


@pytest.mark.parametrize("size", [1, 64, 65, 200, 1024, 1025, 65537])
def test_chunked_batch_inverse(size):
    """Sizes on both sides of every level of the recursion: the tail alone
    (up to 1024), one level of scans above it (1025), two levels (65537 lanes
    leave 1025 chunk totals)."""
    tfs = TCURVE.fq
    rng = random.Random(size)
    vals = [rng.randrange(1, tfs.p) for _ in range(size)]
    vals[0] = tfs.p - 1
    before = dict(HM.LAUNCHES)
    inv = HM.batch_inverse_chunked(tfs, TL.encode(tfs, vals, "cpu"))
    assert TL.decode(tfs, inv) == [pow(v, -1, tfs.p) for v in vals]
    assert HM.LAUNCHES == before          # nothing is launched on the CPU


def test_chunked_batch_inverse_never_reaches_the_fermat_chain(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("limbs.inv was called")
    monkeypatch.setattr(TL, "inv", refuse)
    monkeypatch.setattr(TL, "mont_pow_const", refuse)
    tfs = TCURVE.fq
    vals = list(range(1, 1301))
    inv = HM.batch_inverse_chunked(tfs, TL.encode(tfs, vals, "cpu"))
    assert TL.decode(tfs, inv) == [pow(v, -1, tfs.p) for v in vals]
    empty = TL.zeros(tfs, (0,), "cpu")
    assert HM.batch_inverse_chunked(tfs, empty).shape == (tfs.nl, 0)


@pytest.mark.parametrize("size", [1, 8, 64, 65, 512, HM.INV_TAIL_MAX])
def test_inversion_tail_plain_version_matches_reference(size):
    """The tail's plain version (and the wrapper, which takes it on the CPU)
    against `pow(x, -1, p)` and against the JAX package's batched inversion,
    bit for bit."""
    fs, tfs = CURVE.fq, TCURVE.fq
    rng = np.random.default_rng(100 + size)
    vals = [int.from_bytes(rng.bytes(40), "little") % (fs.p - 1) + 1
            for _ in range(size)]
    vals[0] = fs.p - 1
    x = L.encode(fs, vals)
    ref = MA._batch_inverse_chunked(CRV.FqOps(fs), x, size)
    tx = CONV.limbs_from_numpy(tfs, np.asarray(x), "cpu")
    for invert in (HM.batch_inverse_small_plain,
                   HM.batch_inverse_small_hopper):
        got = invert(tfs, tx)
        _same(ref, got)
        assert TL.decode(tfs, got) == [pow(v, -1, fs.p) for v in vals]


def test_inversion_tail_on_a_twelve_word_field_and_its_refusals():
    tfs = TCV.BLS12_381.fq
    vals = [1, 2, tfs.p - 1, 0x1234567890ABCDEF, tfs.R_mod_p]
    got = HM.batch_inverse_small_hopper(tfs, TL.encode(tfs, vals, "cpu"))
    assert TL.decode(tfs, got) == [pow(v, -1, tfs.p) for v in vals]
    for bad in (0, HM.INV_TAIL_MAX + 1):
        with pytest.raises(ValueError):
            HM.batch_inverse_small_hopper(tfs, TL.zeros(tfs, (bad,), "cpu"))
    with pytest.raises(ValueError):
        HM.batch_inverse_small_hopper(tfs, TL.zeros(tfs, (2, 2), "cpu"))


@pytest.mark.parametrize("curve", [TCV.ALT_BN128, TCV.BLS12_381])
def test_tail_ladder_and_its_count_of_products(curve):
    """The kernel's ladder, replayed on Python ints: 4-bit windows of p - 2
    from the top over the table x^0..x^15 give x^-1, and the products it
    takes are what `tail_products_in_sequence` states for one element."""
    fs = curve.fq
    x = 0xC0FFEE % fs.p
    table, products = [1], 0
    for _ in range(15):
        table.append(table[-1] * x % fs.p)
        products += 1
    acc = None
    for digit in (int(d, 16) for d in f"{fs.p - 2:x}"):
        if acc is None:
            acc = table[digit]
            continue
        for _ in range(4):
            acc = acc * acc % fs.p
            products += 1
        if digit:
            acc = acc * table[digit] % fs.p
            products += 1
    assert acc == pow(x, -1, fs.p)
    assert HM.tail_products_in_sequence(fs, 1) == products
    assert HM.tail_products_in_sequence(fs, 512) == products + 2 * 9
    assert HM.tail_products_in_sequence(fs, 513) == products + 2 * 10


def test_scan_geometry_is_what_the_kernel_is_given():
    """(threads that share a chunk, blocks, shared-memory bytes)."""
    nl = TCURVE.fq.nl
    assert HM.scan_geometry(nl, 64, 1 << 15) == (8, 1024, 8 * 72 * 32 * 4)
    assert HM.scan_geometry(nl, 64, 1) == (8, 1, 8 * 72 * 32 * 4)
    assert HM.scan_geometry(nl, 64, 33) == (8, 2, 8 * 72 * 32 * 4)
    assert HM.scan_geometry(nl, 32, 7)[0] == 4
    assert HM.scan_geometry(nl, 17, 7)[0] == 2
    assert HM.scan_geometry(nl, 15, 7)[0] == 1
    assert HM.scan_geometry(nl, 1, 7) == (1, 1, 8 * 2 * 32 * 4)
    assert HM.scan_geometry(24, 64, 5) == (8, 1, 12 * 72 * 32 * 4)
    for k, c in ((0, 4), (4, 0), (300, 4)):
        with pytest.raises(ValueError):
            HM.scan_geometry(nl, k, c)


@pytest.mark.parametrize("k,c", [(1, 7), (2, 8), (64, 3), (17, 5)])
def test_scans_plain_version_against_python_ints(k, c):
    """The (NL, K, C) layout at ragged shapes: chunk c is the elements
    x[:, :, c], f and g are its exclusive prefix and suffix products."""
    tfs = TCURVE.fq
    rng = random.Random(k * 100 + c)
    vals = [[rng.randrange(1, tfs.p) for _ in range(c)] for _ in range(k)]
    x = TL.encode(tfs, [v for row in vals for v in row], "cpu") \
        .reshape(tfs.nl, k, c)
    f, g, tot = HM.inv_scans_hopper(tfs, x)
    for j in range(c):
        col = [vals[i][j] for i in range(k)]
        pre = [1]
        for v in col:
            pre.append(pre[-1] * v % tfs.p)
        suf = [1]
        for v in reversed(col):
            suf.append(suf[-1] * v % tfs.p)
        assert TL.decode(tfs, f[:, :, j]) == pre[:-1]
        assert TL.decode(tfs, g[:, :, j]) == suf[:-1][::-1]
        assert TL.decode(tfs, tot[:, j:j + 1]) == [pre[-1]]


def test_jacobian_formulas_match_host_curve():
    ops = TCRV.FqOps(TCURVE.fq, "cpu")
    g = CURVE.g1
    pts = [CV.g1_mul(CURVE, g, k) for k in (1, 2, 3, 5, 5, 7)]
    other = [CV.g1_mul(CURVE, g, k) for k in (4, 2, 9, 5, 0, 1)]
    other[4] = CV.g1_neg(CURVE, pts[4])

    def enc(ps):
        return (ops.encode([q[0] for q in ps]), ops.encode([q[1] for q in ps]),
                ops.ones((len(ps),)))

    got = TCRV.to_affine_host(ops, TCRV.jac_add(ops, enc(pts), enc(other)))
    assert got == [CV.g1_add(CURVE, a, b) for a, b in zip(pts, other)]
    got = TCRV.to_affine_host(ops, TCRV.jac_double(ops, enc(pts)))
    assert got == [CV.g1_add(CURVE, a, a) for a in pts]
    inf = TCRV.inf_point(ops, (len(pts),))
    assert TCRV.to_affine_host(ops, TCRV.jac_add(ops, inf, enc(pts))) == pts
    assert TCRV.to_affine_host(ops, TCRV.jac_neg(ops, enc(pts))) == \
        [CV.g1_neg(CURVE, a) for a in pts]


def _fixture(group, n, seed):
    rng = random.Random(seed)
    gen = CURVE.g1 if group == "g1" else CURVE.g2
    add = CV.g1_add if group == "g1" else CV.g2_add
    neg = CV.g1_neg if group == "g1" else CV.g2_neg
    pool, acc = [], None
    for _ in range(24):
        acc = add(CURVE, acc, gen)
        pool.append(acc)
    pts = [pool[rng.randrange(24)] for _ in range(n)]
    sc = [rng.randrange(CURVE.fr.p) for _ in range(n)]
    sc[:3] = [0, 1, CURVE.fr.p - 1]
    pts[5] = None                                    # an infinity base
    pts[8] = pts[7]                                  # a repeated point ...
    pts[9] = neg(CURVE, pts[7])                      # ... and its negation
    sc[7] = sc[8] = sc[9]                            # in the same buckets
    return pts, sc


def _oracle(pts, sc, group):
    live = [(q, s) for q, s in zip(pts, sc) if q is not None]
    return msm_host(CURVE, [q for q, _ in live], [s for _, s in live],
                    group=group)


@pytest.mark.parametrize("group,window_bits,n", [("g1", 4, 100),
                                                 ("g1", 7, 40),
                                                 ("g2", 5, 40)])
def test_msm_bases_run_matches_host_oracle(group, window_bits, n):
    pts, sc = _fixture(group, n, 0x51 + window_bits)
    bases = TMA.MSMBases(TCURVE, pts, group, window_bits=window_bits,
                         device="cpu")
    assert bases.run(sc) == _oracle(pts, sc, group)
    # a second run on the same bases: all-equal scalars put every base of a
    # window into one bucket, the deepest halving there is
    assert bases.run([12345] * n) == _oracle(pts, [12345] * n, group)


def test_msm_affine_one_shot_and_edge_sizes():
    pts, sc = _fixture("g1", 12, 3)
    bases = TMA.MSMBases(TCURVE, pts, "g1", window_bits=3, device="cpu")
    assert bases.run(sc[:10]) == _oracle(pts[:10], sc[:10], "g1")
    assert bases.run([0] * 12) is None
    assert TMA.msm_affine(TCURVE, [None, None], [5, 6], window_bits=3,
                          device="cpu") is None
    assert TMA.msm_affine(TCURVE, [CURVE.g1], [CURVE.fr.p - 1],
                          window_bits=8, device="cpu") \
        == CV.g1_neg(CURVE, CURVE.g1)


def test_msm_refuses_curves_with_nonzero_a():
    from crypto3_zk_tpu_torch.fields import mnt as TMNT
    with pytest.raises(ValueError):
        TMA.MSMBases(TMNT.MNT4, [TMNT.MNT4.g1], "g1", device="cpu")
    with pytest.raises(ValueError):
        TM.fixed_base_exp_batch(TMNT.MNT4, TMNT.MNT4.g1, [1, 2], device="cpu")


def test_signed_digits_and_pass_counts():
    """The signed window digits cut on the device recompose every scalar
    for window widths on and across digit edges, and the pass counts follow
    the largest bucket."""
    fr = TCURVE.fr
    sc = [0, 1, fr.p - 1, 31, 16, 48] + [random.Random(4).randrange(fr.p)
                                         for _ in range(20)]

    def signed(xs, c):
        w = TMA.n_windows(fr.bits, c)
        return TMA._signed_digits_dev(TMA._window_digits_dev(
            TL.from_numpy(TL.pack_ints(fr, xs), "cpu"), c, w), c), w

    for c in (3, 5, 13, 16):
        sd, w = signed(sc, c)
        assert int(sd.abs().max()) <= 1 << (c - 1)
        assert [sum(int(sd[j, i]) << (c * j) for j in range(w))
                for i in range(len(sc))] == sc
    c = 5
    eq, w = signed([12345] * 64, c)
    assert TMA._pass_maxima_dev(eq, 1, w, c).tolist() == [64]   # 6 passes
    one, w = signed([7], c)
    assert TMA._pass_maxima_dev(one, 1, w, c).tolist() == [1]   # none
    zero = torch.zeros((w, 32), dtype=torch.int32)
    assert TMA._pass_maxima_dev(zero, 1, w, c).tolist() == [0]
    # the default width, 16 bits, reads the digits off the limbs directly
    np.testing.assert_array_equal(
        TM._digits_host(fr, sc, 16, fr.nl), TL.pack_ints(fr, sc))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_exp_batch_matches_host_multiples(group):
    gen = CURVE.g1 if group == "g1" else CURVE.g2
    mul = CV.g1_mul if group == "g1" else CV.g2_mul
    ks = [0, 1, 2, CURVE.fr.p - 1, 0xDEADBEEFCAFE, CURVE.fr.p + 5]
    got = TM.fixed_base_exp_batch(TCURVE, gen, ks, c=4, group=group,
                                  device="cpu")
    assert got == [mul(CURVE, gen, k % CURVE.fr.p) for k in ks]
    assert got[0] is None


def test_msm_host_matches_reference():
    pts, sc = _fixture("g1", 12, 9)
    live = [(q, s) for q, s in zip(pts, sc) if q is not None]
    assert TM.msm_host(TCURVE, [q for q, _ in live], [s for _, s in live]) \
        == _oracle(pts, sc, "g1")
