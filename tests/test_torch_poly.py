"""The port's polynomials (`poly/polynomial.py`) and the field helpers under
them (`prefix_product_exclusive`, `sum_reduce`, batched `ntt`,
`batch_inverse`, `powers_of`, `calculate_domain_set`) against the JAX package
and Python-integer evaluation. Same inputs from a seed, exact equality."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.ops import limbs as L
from crypto3_zk_tpu.ops import ntt as N
from crypto3_zk_tpu.poly import polynomial as RP
from crypto3_zk_tpu_torch import convert as C
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import hopper_field as HF
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.ops import ntt as TN
from crypto3_zk_tpu_torch.poly import domain as TD
from crypto3_zk_tpu_torch.poly import polynomial as TPoly

import torch_threads  # noqa: F401  one torch thread a worker

FS, TFS = P.BLS12_381_FR, TP.BLS12_381_FR
p = FS.p


def _coeffs(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(p) for _ in range(n)]


def _both(coeffs):
    ref = RP.Poly.from_ints(FS, coeffs)
    return ref, C.poly_from_reference(TFS, np.asarray(ref.c), "cpu")


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def _same(t: torch.Tensor, a) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(a).astype(np.int32))


def test_poly_arithmetic_and_evaluate():
    ca, cb = _coeffs(12, 1), _coeffs(7, 2)
    (ra, ta), (rb, tb) = _both(ca), _both(cb)
    _same((ta + tb).c, (ra + rb).c)
    _same((ta - tb).c, (ra - rb).c)
    _same((-ta).c, (-ra).c)
    _same((ta * tb).c, (ra * rb).c)
    _same(ta.scale(5).c, ra.scale(5).c)
    x = 0x1234567
    assert ta.evaluate(x) == ra.evaluate(x) == _horner(ca, x)
    assert ta.evaluate_many([0, 1, p - 1]) == [_horner(ca, v)
                                               for v in (0, 1, p - 1)]
    assert ta.degree() == 11 and ta.n == 12
    assert TPoly.Poly.zero(TFS, "cpu").degree() == -1
    assert TPoly.Poly.from_ints(TFS, [], "cpu").to_ints() == [0]
    prod = (ta * tb).to_ints()
    assert _horner(prod, x) == _horner(ca, x) * _horner(cb, x) % p


@pytest.mark.parametrize("in_domain", [False, True])
def test_divide_by_linear_both_branches(in_domain):
    ca = _coeffs(13, 3)
    ra, ta = _both(ca)
    z = TFS.root_of_unity(16) if in_domain else 0xABCDEF
    tq, rq = ta.divide_by_linear(z), ra.divide_by_linear(z)
    _same(tq.c, rq.c)
    # q * (x - z) + f(z) == f at a fresh point
    x = 0x77777
    assert (_horner(tq.to_ints(), x) * (x - z) + _horner(ca, z)) % p == \
        _horner(ca, x)


def test_poly_dfs_against_the_reference():
    ca, cb = _coeffs(16, 4), _coeffs(12, 5)
    (ra, ta), (rb, tb) = _both(ca), _both(cb)
    rfa, rfb = RP.PolyDFS.from_poly(ra), RP.PolyDFS.from_poly(rb)
    fa, fb = TPoly.PolyDFS.from_poly(ta), TPoly.PolyDFS.from_poly(tb)
    _same(fa.v, rfa.v)
    assert (fb.n, fb.deg) == (rfb.n, rfb.deg) == (16, 12)
    for got, want in (((fa + fb), (rfa + rfb)), ((fa - fb), (rfa - rfb)),
                      ((fa * fb), (rfa * rfb)), (-fa, -rfa),
                      (fa.scale(9), rfa.scale(9)),
                      (fa.resize(64), rfa.resize(64)),
                      (fb.resize(32), rfb.resize(32)),
                      (fa.shift(3), rfa.shift(3)),
                      (fa.resize(64).shift(-1, 16),
                       rfa.resize(64).shift(-1, 16))):
        _same(got.v, want.v)
        assert got.deg == want.deg
    _same(fa.coefficients().c, rfa.coefficients().c)
    assert fa.coefficients().to_ints() == ca
    k = TL.encode(TFS, [77], "cpu")
    _same(fa.scale_arr(k).v, rfa.scale_arr(L.encode(FS, [77])).v)
    x = 0x31337
    assert fa.evaluate(x) == rfa.evaluate(x) == _horner(ca, x)
    # shift: g(x) = f(x * w^rotation)
    w = TFS.root_of_unity(16)
    assert fa.shift(3).evaluate(x) == _horner(ca, x * pow(w, 3, p) % p)
    # carried over by `convert`
    carried = C.poly_dfs_from_reference(TFS, np.asarray(rfb.v), rfb.deg,
                                        "cpu")
    _same(carried.v, fb.v)
    assert carried.deg == 12
    assert TPoly.PolyDFS.constant(TFS, 5, 8, "cpu").to_ints() == [5] * 8
    assert TPoly.PolyDFS.from_evals_ints(TFS, [1, 2, 3, 4], "cpu").deg == 4


def test_polynomial_sum_and_product():
    cs = [_coeffs(4, 10 + i) for i in range(3)]
    refs = [RP.PolyDFS.from_poly(RP.Poly.from_ints(FS, c)) for c in cs]
    ours = [C.poly_dfs_from_reference(TFS, np.asarray(r.v), r.deg, "cpu")
            for r in refs]
    _same(TPoly.polynomial_sum(ours).v, RP.polynomial_sum(refs).v)
    got, want = TPoly.polynomial_product(ours), RP.polynomial_product(refs)
    _same(got.v, want.v)
    assert got.deg == want.deg == 10
    x = 0x5555
    assert got.evaluate(x) == \
        _horner(cs[0], x) * _horner(cs[1], x) * _horner(cs[2], x) % p


def test_prefix_product_exclusive_and_sum_reduce():
    vals = _coeffs(11, 20)
    ref = L.encode(FS, vals)
    x = C.limbs_from_numpy(TFS, np.asarray(ref), "cpu")
    _same(TL.prefix_product_exclusive(TFS, x, axis=1),
          L.prefix_product_exclusive(FS, ref, axis=1))
    acc, want = 1, []
    for v in vals:
        want.append(acc)
        acc = acc * v % p
    assert TL.decode(TFS, TL.prefix_product_exclusive(TFS, x)) == want
    _same(TN.sum_reduce(TFS, x, axis=1), N.sum_reduce(FS, ref, axis=1))
    assert TL.decode(TFS, TN.sum_reduce(TFS, x)[:, None]) == [sum(vals) % p]
    x2 = x[:, :10].reshape(TFS.nl, 2, 5)
    got = TN.sum_reduce(TFS, x2, axis=-1)                 # odd length: padded
    assert TL.decode(TFS, got) == [sum(vals[:5]) % p, sum(vals[5:10]) % p]
    _same(got, N.sum_reduce(FS, ref[:, :10].reshape(FS.nl, 2, 5), axis=-1))


def test_powers_of_equals_the_host_chain():
    for n in (1, 2, 5, 16, 37):
        got = TL.powers(TFS, 0xC0FFEE, n, "cpu")
        assert got.shape == (TFS.nl, n)
        _same(got, TL.powers_np(TFS, 0xC0FFEE, n))


@pytest.mark.parametrize("inverse", [False, True])
def test_batched_ntt_above_the_row_length(inverse):
    """(NL, 3, 2^11): every line equals the unbatched transform, which is
    the four-step split through the row transform on both devices."""
    n = 1 << 11
    x = TL.encode(TFS, _coeffs(3 * n, 30), "cpu").reshape(TFS.nl, 3, n)
    got = TN.ntt(TFS, x, inverse)
    assert got.shape == x.shape
    for i in range(3):
        assert torch.equal(got[:, i], TN.ntt(TFS, x[:, i].contiguous(),
                                             inverse))
        assert torch.equal(got[:, i], HF.ntt_plain(TFS, x[:, i], inverse))
    raw = TN.ntt_raw(TFS, x, inverse)
    assert torch.equal(raw[:, 1], HF.ntt_rows_plain(TFS, x[:, 1], inverse))
    ref = N.ntt(FS, jnp.asarray(x[:, 2].numpy().astype(np.uint32)), inverse)
    _same(got[:, 2], ref)


def test_batch_inverse_maps_zero_to_zero():
    vals = _coeffs(40, 40)
    vals[0] = vals[17] = vals[39] = 0
    vals[5] = 1
    ref = L.encode(FS, vals).reshape(FS.nl, 4, 10)
    x = C.limbs_from_numpy(TFS, np.asarray(ref), "cpu")
    for axis in (1, 2):
        got = TL.batch_inverse(TFS, x, axis=axis)
        _same(got, L.batch_inverse(FS, ref, axis=axis))
        assert TL.decode(TFS, got) == [pow(v, -1, p) if v else 0
                                       for v in vals]


def test_calculate_domain_set():
    ds = TD.calculate_domain_set(TFS, 6, 4)
    assert [d.n for d in ds] == [64, 32, 16, 8]
    assert all(ds[i + 1].omega == pow(ds[i].omega, 2, p) for i in range(3))
