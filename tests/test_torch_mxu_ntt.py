"""The port's digit-plane NTT (`crypto3_zk_tpu_torch.ops.mxu_ntt`) against
the JAX package's `ops/mxu_ntt.py`, on the CPU, exact (tolerance 0: every
value is an integer). Inputs are made with numpy from fixed seeds and given
to both. The JAX transforms run at the sizes `tests/test_ntt_poly.py` runs
them (n = 256, and n = 2^12 with `log_block=1`), so the compile cache
serves both files; the block-level cases reuse the block shapes those
transforms compile. The kernel itself runs on the CPU through its host
build in `tests/test_torch_host_kernels.py`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.ops import limbs as L
from crypto3_zk_tpu.ops import mxu_ntt as RMX
from crypto3_zk_tpu_torch import convert as CONV
from crypto3_zk_tpu_torch import kernels as K
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import hopper_field as HF
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
from crypto3_zk_tpu_torch.ops import ntt as TN

import torch_threads  # noqa: F401  one torch thread a worker

FS, TFS = P.BLS12_381_FR, TP.BLS12_381_FR


def _pair(shape, seed):
    """Montgomery digits of random elements of the field, the first three
    0, 1 and p - 1, as the reference's array and the port's tensor."""
    rng = np.random.default_rng(seed)
    count = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(40), "little") % FS.p
            for _ in range(count)]
    vals[:3] = [0, 1, FS.p - 1][:count]
    arr = np.asarray(L.encode(FS, vals)).reshape((FS.nl,) + tuple(shape))
    return vals, arr, CONV.limbs_from_numpy(TFS, arr, device="cpu")


def _same(ref, got):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy().astype(np.int64))


@pytest.mark.parametrize("log_m", [2, 3, 4, 5])
@pytest.mark.parametrize("inverse", [False, True])
def test_plan_digits_equal_the_reference(log_m, inverse):
    want = RMX.MXUNttPlan(FS, log_m, inverse)
    got = MX.MXUNttPlan(TFS, log_m, inverse)
    assert (got.nd, got.m, got.rounds) == (want.nd, want.m, want.rounds)
    np.testing.assert_array_equal(got.w_digits, want.w_digits)
    # the table is W' = w^(kj) 2^(16 (NL+1)) mod p in base-128 digits
    omega = TFS.root_of_unity(1 << log_m)
    if inverse:
        omega = pow(omega, -1, TFS.p)
    k, j = 1, (1 << log_m) - 1
    value = pow(omega, k * j, TFS.p) * pow(2, 16 * (TFS.nl + 1), TFS.p) \
        % TFS.p
    assert got.w_digits[:, k, j].tolist() == MX._digitize_int(value, got.nd)
    assert MX.get_mxu_plan(TFS, log_m, inverse) is \
        MX.get_mxu_plan(TFS, log_m, inverse)


def test_decomposition_equals_the_reference():
    _, arr, x = _pair((4, 9), 11)
    want = jax.jit(functools.partial(RMX._decompose_digits, FS))(
        jnp.asarray(arr))
    got = MX._decompose_digits(TFS, x)
    assert got.dtype == torch.int8 and got.shape == (MX._n_digits(TFS), 4, 9)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _planes(arr, log_m):
    """The plane sums of one block product, (2 ND - 1, M, B) int64, from
    the reference's digits and table."""
    plan = RMX.get_mxu_plan(FS, log_m, False)
    xd = np.asarray(jax.jit(functools.partial(RMX._decompose_digits, FS))(
        jnp.asarray(arr))).astype(np.int64)
    w = plan.w_digits.astype(np.int64)
    nd = plan.nd
    out = np.zeros((2 * nd - 1,) + arr.shape[1:], dtype=np.int64)
    for a in range(nd):
        out[a:a + nd] += np.einsum("kj,djb->dkb", w[a], xd)
    return out, plan.m * 127 ** 2 * nd


def test_wide_reduction_equals_the_reference_and_python_ints():
    _, arr, _ = _pair((4, 9), 12)
    planes, bound = _planes(arr, 2)
    want = jax.jit(functools.partial(RMX._mont_reduce_wide, FS),
                   static_argnums=1)(jnp.asarray(planes.astype(np.int32)),
                                     bound)
    got = MX._mont_reduce_wide(TFS, torch.from_numpy(planes), bound)
    _same(want, got)
    # the value sum_s P_s 2^(7 s), times 2^-(16 (NL+1)), reduced
    scale = pow(2, -16 * (TFS.nl + 1), TFS.p)
    flat = planes.reshape(planes.shape[0], -1)
    vals = [sum(int(flat[s, i]) << (7 * s) for s in range(flat.shape[0]))
            * scale % TFS.p for i in range(flat.shape[1])]
    assert TL.unpack_ints(TFS, got) == vals


@pytest.mark.parametrize("log_m,b", [(5, 128), (6, 64)])
def test_block_pass_equals_the_reference(log_m, b):
    """The block shapes of the n = 2^12, `log_block=1` transform."""
    _, arr, x = _pair((1 << log_m, b), 13 + log_m)
    plan = RMX.get_mxu_plan(FS, log_m, False)
    want = RMX._block_ntt(FS, plan, jnp.asarray(arr), plan.w_digits_dev())
    _same(want, MX.block_ntt(TFS, MX.get_mxu_plan(TFS, log_m, False), x))


@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_twiddle_tables_agree(inverse):
    """The table `ntt_mxu` takes, `hopper_field`'s doubling build with its
    sides swapped, is the reference's (NL, R, C) table, entry
    [k2, cc] = w_N^(cc k2)."""
    for n, r, c in ((1 << 10, 64, 16), (1 << 8, 4, 64)):
        dev = HF._four_step_twiddles(TFS, n, c, r, inverse, "cpu")
        assert dev.shape == (TFS.nl, r, c)
        _same(RMX._four_step_twiddles(FS, n, r, c, inverse), dev)


def test_ntt_mxu_equals_the_reference():
    _, arr, x = _pair((256,), 21)
    fwd = MX.ntt_mxu(TFS, x)
    _same(RMX.ntt_mxu(FS, jnp.asarray(arr)), fwd)
    back = MX.ntt_mxu(TFS, fwd, inverse=True)
    _same(RMX.ntt_mxu(FS, RMX.ntt_mxu(FS, jnp.asarray(arr)), inverse=True),
          back)
    _same(arr, back)


def test_ntt_mxu_recursive_four_step_equals_the_reference():
    """`log_block=1` makes the first factor 2^11, above the 2^10 block cap,
    so the size-R side is itself a four-step (the path above 2^20 at toy
    size)."""
    _, arr, x = _pair((1 << 12,), 22)
    got = MX.ntt_mxu(TFS, x, log_block=1)
    _same(RMX.ntt_mxu(FS, jnp.asarray(arr), log_block=1), got)
    _same(TN.ntt(TFS, x), got)


def test_ntt_mxu_equals_the_port_ntt_and_round_trips():
    """n = 2^11 under the default split: blocks of 32 and 64."""
    _, _, x = _pair((1 << 11,), 23)
    fwd = MX.ntt_mxu(TFS, x)
    assert torch.equal(fwd, TN.ntt(TFS, x))
    assert torch.equal(MX.ntt_mxu(TFS, fwd, inverse=True), x)
    assert torch.equal(MX.ntt_mxu(TFS, x, inverse=True),
                       TN.ntt(TFS, x, inverse=True))


def test_block_launch_geometry_and_refusals():
    plan = MX.get_mxu_plan(TFS, 5, False)
    x = torch.zeros((TFS.nl, 32, 100), dtype=torch.int32)
    assert MX.block_launch(TFS, plan, x) == (32, 100)
    with pytest.raises(ValueError):                   # no kernel instance
        MX.block_launch(TP.GOLDILOCKS, MX.get_mxu_plan(TP.GOLDILOCKS, 5,
                                                       False),
                        torch.zeros((4, 32, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        MX.block_launch(TFS, plan, x.to(torch.int64))
    with pytest.raises(ValueError):                   # the plan's M is 32
        MX.block_launch(TFS, plan, torch.zeros((TFS.nl, 64, 8),
                                               dtype=torch.int32))
    with pytest.raises(ValueError):
        MX.block_launch(TFS, plan, x.transpose(1, 2).contiguous()
                        .transpose(1, 2))


class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def is_cuda(self):
        return True


def test_a_cuda_tensor_takes_the_kernel_or_raises(monkeypatch):
    """A tensor on the card goes to the kernel, never to the plain version:
    where the kernel cannot be built (no `nvcc` here) the call raises, and
    a field without an instance is refused first."""
    _, _, x = _pair((1 << 8,), 24)
    card = x.as_subclass(_OnTheCard)
    monkeypatch.setattr(MX, "block_ntt_plain", None)   # no way back to it
    before = dict(MX.LAUNCHES)
    calls = []

    def entry(name):
        calls.append(name)
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(K, "entry", entry)
    with pytest.raises(RuntimeError, match="nvcc"):
        MX.ntt_mxu(TFS, card)
    assert calls == ["zk_mxu_block"] and MX.LAUNCHES == before
    gl = torch.zeros((4, 1 << 8), dtype=torch.int32).as_subclass(_OnTheCard)
    with pytest.raises(ValueError):
        MX.ntt_mxu(TP.GOLDILOCKS, gl)
    assert calls == ["zk_mxu_block"]
