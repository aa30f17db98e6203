"""The port's Poseidon (`crypto3_zk_tpu_torch.ops.poseidon`, `.nil_poseidon`,
kernel 5's plain version in `.hopper_hash`) against the JAX package and the
scalar permutation on Python integers. Same inputs from a seed, exact
equality: every value is an integer."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.ops import limbs as L
from crypto3_zk_tpu.ops import nil_poseidon as NPO
from crypto3_zk_tpu.ops import poseidon as PO
from crypto3_zk_tpu_torch.convert import limbs_from_numpy
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import hopper_hash as HH
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.ops import nil_poseidon as TNPO
from crypto3_zk_tpu_torch.ops import poseidon as TPO

import torch_threads  # noqa: F401  one torch thread a worker

N = 4   # lanes; one shape per flavour keeps the JAX side to one compile


def _pair(flavour):
    """(reference module, its params, port module, its params)."""
    if flavour == "nil":
        return (NPO, NPO.get_params(P.PALLAS_FQ),
                TNPO, TNPO.get_params(TP.PALLAS_FQ))
    return (PO, PO.get_params(P.BLS12_381_FR),
            TPO, TPO.get_params(TP.BLS12_381_FR))


def _states(p, seed):
    rng = random.Random(seed)
    cols = [[rng.randrange(p) for _ in range(N)] for _ in range(3)]
    cols[0][0], cols[1][0], cols[2][0] = 0, 1, p - 1      # the edge values
    cols[0][1], cols[1][1], cols[2][1] = p - 1, p - 1, 0
    return cols


@pytest.mark.parametrize("name", ["BLS12_381_FR", "ALT_BN128_FR", "PALLAS_FQ"])
def test_parameters_equal_the_reference(name):
    ref = PO.get_params(getattr(P, name))
    got = TPO.get_params(getattr(TP, name))
    assert got.round_constants == ref.round_constants
    assert got.mds == ref.mds
    assert (got.alpha, got.t, got.r_f, got.r_p) == \
        (ref.alpha, ref.t, ref.r_f, ref.r_p)
    np.testing.assert_array_equal(got.rc_dev, ref.rc_dev)
    np.testing.assert_array_equal(got.mds_dev, ref.mds_dev)
    assert got.partial_rounds == (ref.r_f // 2, ref.r_f // 2 + ref.r_p)


def test_nil_parameters_equal_the_reference():
    ref = NPO.get_params(P.PALLAS_FQ)
    got = TNPO.get_params(TP.PALLAS_FQ)
    assert [list(r) for r in got.round_constants] == \
        [list(r) for r in ref.round_constants]
    assert [list(r) for r in got.mds] == [list(r) for r in ref.mds]
    assert got.alpha == ref.alpha == 7
    np.testing.assert_array_equal(got.rc_dev, ref.rc_dev)
    np.testing.assert_array_equal(got.mds_dev, ref.mds_dev)
    with pytest.raises(ValueError):
        TNPO.NilPoseidonParams(TP.BLS12_381_FR)


@pytest.mark.parametrize("flavour", ["original", "nil"])
def test_permute_batch_equals_the_reference_and_the_host(flavour):
    ref_mod, ref_pp, mod, pp = _pair(flavour)
    fs = pp.fs
    cols = _states(fs.p, 11)
    ref_state = jnp.stack([L.encode(ref_pp.fs, c) for c in cols], axis=1)
    state = limbs_from_numpy(fs, np.asarray(ref_state), "cpu")
    assert state.shape == (fs.nl, 3, N)                    # (NL, t, n)
    got = mod.permute_batch(pp, state)
    want = np.asarray(ref_mod.permute_batch(ref_pp, ref_state))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    out = [TL.decode(fs, got[:, i]) for i in range(3)]
    for lane in range(N):
        assert [o[lane] for o in out] == mod.permute_host(
            pp, [c[lane] for c in cols])
        assert mod.permute_host(pp, [c[lane] for c in cols]) == \
            ref_mod.permute_host(ref_pp, [c[lane] for c in cols])


@pytest.mark.parametrize("flavour", ["original", "nil"])
def test_hash2_batch_equals_the_reference_and_the_host(flavour):
    ref_mod, ref_pp, mod, pp = _pair(flavour)
    fs = pp.fs
    a, b, _ = _states(fs.p, 12)
    ra, rb = L.encode(ref_pp.fs, a), L.encode(ref_pp.fs, b)
    got = mod.hash2_batch(pp, limbs_from_numpy(fs, np.asarray(ra), "cpu"),
                          limbs_from_numpy(fs, np.asarray(rb), "cpu"))
    want = np.asarray(ref_mod.hash2_batch(ref_pp, ra, rb))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert TL.decode(fs, got) == [mod.hash2_host(pp, x, y)
                                  for x, y in zip(a, b)]


@pytest.mark.parametrize("alpha_field", ["BLS12_381_FR", "PALLAS_FQ",
                                         "BLS12_381_FQ", "GOLDILOCKS"])
def test_plain_version_runs_every_alpha_and_word_count(alpha_field):
    """The S-box exponent is the smallest of 5, 7, 11, 13, 17 coprime to
    p - 1; the plain version raises by its bits, as the kernel does."""
    fs = getattr(TP, alpha_field)
    pp = TPO.get_params(fs)
    assert pp.alpha == next(a for a in (5, 7, 11, 13, 17)
                            if np.gcd(a, (fs.p - 1) % a) == 1)
    cols = _states(fs.p, 13)
    state = torch.stack([TL.encode(fs, c, "cpu") for c in cols], dim=1)
    got = TPO.permute_batch(pp, state)
    out = [TL.decode(fs, got[:, i]) for i in range(3)]
    for lane in range(N):
        assert [o[lane] for o in out] == TPO.permute_host(
            pp, [c[lane] for c in cols])


def test_wrapper_forms_and_refusals():
    pp = TPO.get_params(TP.BLS12_381_FR)
    fs = pp.fs
    cols = _states(fs.p, 14)
    s = [TL.encode(fs, c, "cpu") for c in cols]
    extra = TL.encode(fs, _states(fs.p, 15)[0], "cpu")
    # absorb planes are added to elements 0 and 1 before the permutation
    got = HH.poseidon_permute_hopper(pp, (s[0], None, s[2]), (extra, s[1]))
    want = TPO.permute_batch(pp, torch.stack(
        [TL.add(fs, s[0], extra), s[1], s[2]], dim=1))
    assert torch.equal(got, want)
    # strided planes and the element-0-only output
    level = torch.stack([s[0], s[1]], dim=2).reshape(fs.nl, 2 * N)
    assert torch.equal(
        HH.poseidon_permute_hopper(pp, (level[:, 0::2], level[:, 1::2], None),
                                   lane0_only=True),
        TPO.hash2_batch(pp, s[0], s[1]))
    assert HH.products_per_state(pp) == 828
    assert HH.products_per_state(TNPO.get_params(TP.PALLAS_FQ)) == 55 * 21
    launches = dict(HH.LAUNCHES)
    with pytest.raises(ValueError):
        HH.poseidon_permute_hopper(pp, (None, None, None))
    with pytest.raises(ValueError):
        HH.poseidon_permute_hopper(pp, (s[0], s[1][:, :2], None))
    with pytest.raises(TypeError):
        HH.poseidon_permute_hopper(pp, (s[0].to(torch.int64), None, None))
    assert HH.LAUNCHES == launches          # the CPU never counts a launch
