"""The port's digit-plane NTT (`crypto3_zk_tpu_torch.ops.mxu_ntt`) against
the JAX package's `ops/mxu_ntt.py`, on the CPU, exact (tolerance 0: every
value is an integer). Inputs are made with numpy from fixed seeds and given
to both. The JAX transforms run at the sizes `tests/test_ntt_poly.py` runs
them (n = 256, and n = 2^12 with `log_block=1`), so the compile cache
serves both files; the block-level cases reuse the block shapes those
transforms compile. The kernel itself runs on the CPU through its host
build in `tests/test_torch_host_kernels.py`."""
import dataclasses
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


@pytest.mark.parametrize("log_n", [6, 7, 8, 9, 10, 11, 12])
def test_ntt_mxu_chain_equals_the_reference(log_n):
    """`ntt_mxu` under the port's split (`plan_sides`: one pass up to 2^6,
    2^4 x 2^3 at 2^7, then mixes of sides 16, 32 and 64) against the JAX
    package's `ntt_mxu` (its own split), forward and inverse, exact."""
    _, arr, x = _pair((1 << log_n,), 40 + log_n)
    sides = MX.plan_sides(log_n)
    assert sum(sides) == log_n and all(1 <= s <= 6 for s in sides)
    fwd = MX.ntt_mxu(TFS, x)
    ref = RMX.ntt_mxu(FS, jnp.asarray(arr))
    _same(ref, fwd)
    _same(RMX.ntt_mxu(FS, ref, inverse=True),
          MX.ntt_mxu(TFS, fwd, inverse=True))


def test_plan_sides_and_log_block():
    """Passes of side 32, a remainder of one bit taken by one pass of 64
    and one of 2 to 4 bits by passes of 16; `log_block` keeps its JAX
    meaning, the side of the top split's block (the last factor)."""
    assert MX.plan_sides(20) == [5, 5, 5, 5]
    assert MX.plan_sides(21) == [6, 5, 5, 5]
    assert MX.plan_sides(22) == [5, 5, 4, 4, 4]
    assert MX.plan_sides(23) == [5, 5, 5, 4, 4]
    assert MX.plan_sides(24) == [5, 5, 5, 5, 4]
    assert MX.plan_sides(26) == [6, 5, 5, 5, 5]
    for log_n in range(8, 31):
        sides = MX.plan_sides(log_n)
        assert sum(sides) == log_n and set(sides) <= {4, 5, 6}
        assert sides.count(6) <= 1 and sides.count(4) <= 3
    assert MX.plan_sides(12, log_block=1) == MX.plan_sides(11) + [1]
    assert MX.plan_sides(6) == [6] and MX.plan_sides(7) == [4, 3]
    geoms = MX.chain_geoms([5, 5, 5, 5])
    assert [(g.m, g.c, g.b) for g in geoms] == [
        (32, 1 << 15, 1), (32, 1 << 10, 32), (32, 32, 1 << 10),
        (32, 1, 1 << 15)]
    assert [(g.in_packed, g.out_packed, g.twiddle) for g in geoms] == [
        (False, True, True), (True, True, True), (True, True, True),
        (True, False, False)]
    # the J lanes of a pass are the next pass's transform index, its K
    # lanes the outputs of the pass before
    assert [(g.lsj, g.lsk) for g in geoms] == [(10, 0), (10, 0), (10, 5),
                                               (0, 10)]


def test_smoke_counts_the_twiddle_work_each_pass_runs(monkeypatch):
    """`chip_smoke.py`'s floors of a pass count the twiddle as the kernel
    runs it: at 2^20 the first and middle passes of side 32 (n = 2^20 and
    2^15 <= 2^TW_ONE_MAX_LOG) read one table of n entries and do one 8-word
    Montgomery product (9 x 8 + 64 + 64 word products, 400 instructions an
    element), the last none (144); lowering `TW_ONE_MAX_LOG` gives them two
    tables and two products (656)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as CS
    first, middle, _, last = MX.chain_geoms([5, 5, 5, 5])
    n = 1 << 20
    table = MX.get_mxu_plan(TFS, 5, False).table_u8.size
    want = {id(first): (1, 400, 96 * n + 32 * 2 ** 20),
            id(middle): (1, 400, 64 * n + 32 * 2 ** 15),
            id(last): (0, 144, 32 * n + 64 * n)}
    for g in (first, middle, last):
        c = CS.mxu_pass_counts(TFS, g)
        products, imad, byt = want[id(g)]
        log_n = (g.m * g.c).bit_length() - 1
        assert MX.twiddle_split(log_n) == log_n
        assert (c["twiddle_products"], c["imad"], c["bytes"]) == (
            products, imad * n, byt + table)
    monkeypatch.setattr(MX, "TW_ONE_MAX_LOG", 8)
    assert MX.twiddle_split(20) == 10 and MX.twiddle_split(15) == 8
    c = CS.mxu_pass_counts(TFS, middle)
    assert (c["twiddle_products"], c["imad"], c["bytes"]) == (
        2, 656 * n, 64 * n + 32 * (2 ** 8 + 2 ** 7) + table)
    c = CS.mxu_pass_counts(TFS, first)
    assert (c["twiddle_products"], c["imad"], c["bytes"]) == (
        2, 656 * n, 96 * n + 32 * 2 * 2 ** 10 + table)


@pytest.mark.parametrize("m,v,lanes", [(16, 64, (2, 0)), (32, 100, (2, 0)),
                                       (64, 256, (4, 0)), (32, 1024, (0, 6)),
                                       (16, 4096, (8, 3))])
def test_packed_digits_unpack_to_the_input(m, v, lanes):
    """`pack_plain` then `unpack_plain` gives back the input; each
    element's 32 bytes are its digits, little-endian, spread over the 32
    digit slabs of its tile."""
    _, _, x = _pair((m, v), 50 + m + v)
    buf = MX.pack_plain(TFS, x, *lanes)
    assert buf.dtype == torch.uint8
    assert buf.numel() == -(-v // 64) * MX.packed_tile_bytes(m)
    assert torch.equal(MX.unpack_plain(TFS, buf, m, v, *lanes), x)
    # element (j = 1, vector 2): its tile and row, then digit 3's slab
    ki = 2 if m >= 32 else 1
    tile, row = MX.tile_row(2, *lanes)
    at = tile * MX.packed_tile_bytes(m) + 3 * ki * 1024 + row * 16 + 1
    assert int(buf[at]) == (int(x[1, 1, 2]) >> 8) & 0xFF
    vv = torch.arange(v)
    t, r = MX.tile_row(vv, *lanes)
    assert torch.equal(MX.tile_base(t, *lanes) + (r >> 2 << lanes[0])
                       + ((r & 3) << lanes[1]), vv)


@pytest.mark.parametrize("log_m", [2, 5, 6])
def test_u8_table_is_the_scaled_matrix(log_m):
    """`table_u8` holds W''[k, j] = w^(kj) 2^288 mod p as 32 bytes under
    each (output group, k-step, digit) core matrix, zero outside M and in
    the PAD digits each side."""
    plan = MX.get_mxu_plan(TFS, log_m, False)
    t = plan.table_u8
    m = plan.m
    tm = max(m, 16)
    assert t.shape == (tm // 8, max(1, tm // 32), 32 + 2 * MX.PAD, 2, 8, 16)
    omega = TFS.root_of_unity(m)
    scale = pow(2, 288, TFS.p)
    for k, j in ((0, 0), (1, m - 1), (m - 1, m // 2)):
        kg, kl, jh, ki, jb = k // 8, k % 8, j // 32, (j % 32) // 16, j % 16
        digits = t[kg, jh, MX.PAD:MX.PAD + 32, ki, kl, jb]
        want = pow(omega, k * j, TFS.p) * scale % TFS.p
        assert int.from_bytes(bytes(digits.tolist()), "little") == want
    assert not t[:, :, :MX.PAD].any() and not t[:, :, MX.PAD + 32:].any()
    # (k, j) -> the 32 digits; zero past M on either axis
    full = t.transpose(0, 4, 1, 3, 5, 2).reshape(tm, -1, 32 + 2 * MX.PAD)
    assert not full[m:].any() and not full[:, m:].any()
    assert full[:m, :m].any()


def test_pass_plain_refusals():
    """`mxu_pass` refuses what the kernel does not take, on any device."""
    _, _, x = _pair((16 * 64,), 60)
    g = MX.PassGeom(m=16, c=64, b=1, out_packed=True, twiddle=True, m2=16)
    assert MX.mxu_pass(TFS, g, x, False).dtype == torch.uint8
    with pytest.raises(ValueError):                   # side 48
        MX.mxu_pass(TFS, dataclasses.replace(g, m=48), x, False)
    with pytest.raises(ValueError):                   # packed at side 8
        MX.mxu_pass(TFS, dataclasses.replace(g, m2=8), x, False)
    with pytest.raises(ValueError):                   # lanes outside 64
        MX.mxu_pass(TFS, dataclasses.replace(g, lsj=8), x, False)
    with pytest.raises(TypeError):                    # packed input wanted
        MX.mxu_pass(TFS, dataclasses.replace(g, in_packed=True), x, False)
    with pytest.raises(TypeError):
        MX.mxu_pass(TFS, g, x.to(torch.int64), False)
    with pytest.raises(ValueError):                   # no instance
        MX.mxu_pass(TP.GOLDILOCKS, g, torch.zeros((4, 1024),
                                                  dtype=torch.int32), False)


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
    monkeypatch.setattr(MX, "pass_plain", None)
    before = dict(MX.LAUNCHES)
    calls = []

    def entry(name):
        calls.append(name)
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(K, "entry", entry)
    with pytest.raises(RuntimeError, match="nvcc"):
        MX.ntt_mxu(TFS, card)
    assert calls == ["zk_mxu_pass"] and MX.LAUNCHES == before
    gl = torch.zeros((4, 1 << 8), dtype=torch.int32).as_subclass(_OnTheCard)
    with pytest.raises(ValueError):
        MX.ntt_mxu(TP.GOLDILOCKS, gl)
    assert calls == ["zk_mxu_pass"]
