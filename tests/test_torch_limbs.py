"""The port's limb arithmetic (`crypto3_zk_tpu_torch.ops.limbs`) against the
JAX package's, on the CPU, bit for bit (tolerance 0: every value is an
integer). Inputs are made with numpy from a fixed seed and given to both."""
import numpy as np
import pytest
import torch

from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.ops import limbs as L
from crypto3_zk_tpu.ops import pallas_field as PF
from crypto3_zk_tpu_torch import convert as CONV
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import hopper_field as HF
from crypto3_zk_tpu_torch.ops import limbs as TL

import torch_threads  # noqa: F401  one torch thread a worker

FIELDS = ["ALT_BN128_FR", "ALT_BN128_FQ", "BLS12_381_FQ"]


def _values(p, n, seed):
    rng = np.random.default_rng(seed)
    nbytes = (p.bit_length() + 7) // 8 + 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def _pair(name, n, seed):
    """The same Montgomery limb array as a JAX array and as a port tensor."""
    fs, tfs = getattr(P, name), getattr(TP, name)
    arr = np.asarray(L.encode(fs, _values(fs.p, n, seed)))
    return fs, tfs, arr, CONV.limbs_from_numpy(tfs, arr, device="cpu")


def _same(ref, got):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy().astype(np.int64))


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_reference(name, op):
    fs, tfs, a, ta = _pair(name, 64, 1)
    _, _, b, tb = _pair(name, 64, 2)
    b, tb = b[:, ::-1].copy(), tb.flip(1)      # edges meet random values too
    for x, y, tx, ty in ((a, b, ta, tb), (a, a, ta, ta), (b, a, tb, ta)):
        _same(getattr(L, op)(fs, x, y), getattr(TL, op)(tfs, tx, ty))


@pytest.mark.parametrize("name", FIELDS)
def test_unary_ops_match_reference(name):
    fs, tfs, a, ta = _pair(name, 32, 3)
    _same(L.mont_sqr(fs, a), TL.mont_sqr(tfs, ta))
    _same(L.neg(fs, a), TL.neg(tfs, ta))
    _same(L.double(fs, a), TL.double(tfs, ta))
    _same(L.to_mont(fs, a), TL.to_mont(tfs, ta))
    _same(L.from_mont(fs, a), TL.from_mont(tfs, ta))
    assert TL.decode(tfs, ta) == L.decode(fs, a)
    _same(L.encode(fs, [5, 7]), TL.encode(tfs, [5, 7], "cpu"))
    _same(L.const_mont(fs, 9, (3,)),
          TL.const_mont(tfs, 9, (3,), "cpu").contiguous())
    _same(L.powers(fs, 3, 8), TL.powers(tfs, 3, 8, "cpu"))
    np.testing.assert_array_equal(np.asarray(L.is_zero(fs, a)),
                                  TL.is_zero(tfs, ta).numpy())


@pytest.mark.parametrize("name", FIELDS)
def test_inverse_matches_reference(name):
    fs, tfs, a, ta = _pair(name, 8, 4)
    got = TL.inv(tfs, ta)
    _same(L.inv(fs, a), got)
    p = fs.p
    assert TL.decode(tfs, got) == [pow(v, -1, p) if v else 0
                                   for v in L.decode(fs, a)]


@pytest.mark.parametrize("name", FIELDS)
def test_batch_inverse_matches_reference(name):
    fs, tfs, a, ta = _pair(name, 24, 5)
    a3, t3 = a.reshape(fs.nl, 3, 8), ta.reshape(fs.nl, 3, 8)
    _same(L.batch_inverse(fs, a3, axis=-1), TL.batch_inverse(tfs, t3, axis=-1))
    _same(L.batch_inverse(fs, a3, axis=1), TL.batch_inverse(tfs, t3, axis=1))


@pytest.mark.parametrize("name", ["ALT_BN128_FQ", "BLS12_381_FQ"])
def test_mont_mul_plain_matches_pallas_kernel(name):
    """Kernel 1's plain version against the TPU kernel in interpret mode at
    N = 256. The 24-digit field is held against `limbs.mont_mul` instead,
    which computes the same product: compiling the Pallas kernel for it in
    interpret mode takes minutes on a cold cache."""
    fs, tfs, a, ta = _pair(name, 256, 6)
    _, _, b, tb = _pair(name, 256, 7)
    b, tb = b[:, ::-1].copy(), tb.flip(1)
    if fs.nl == 16:
        ref = PF.mont_mul_pallas(fs, a, b, interpret=True)
    else:
        ref = L.mont_mul(fs, a, b)
    _same(ref, HF.mont_mul_plain(tfs, ta, tb))
    _same(ref, HF.mont_mul_hopper(tfs, ta, tb))


@pytest.mark.parametrize("name", ["ALT_BN128_FR", "BLS12_381_FQ",
                                  "PALLAS_FQ", "GOLDILOCKS"])
def test_plain_forms_agree_with_each_other_and_python_ints(name,
                                                           monkeypatch):
    """The plain versions' two forms (whole-tensor for few lanes,
    digit-serial for many) give the same digits, and the values Python ints
    give; the MDS-style matrix product equals its products and adds."""
    tfs = getattr(TP, name)
    p = tfs.p
    a, b = _values(p, 40, 9), _values(p, 40, 10)[::-1]
    ta, tb = TL.encode(tfs, a, "cpu"), TL.encode(tfs, b, "cpu")
    forms = []
    for few_lanes in (HF._FEW_LANES, 0):
        monkeypatch.setattr(HF, "_FEW_LANES", few_lanes)
        forms.append([HF.mont_mul_plain(tfs, ta, tb),
                      HF.add_plain(tfs, ta, tb), HF.sub_plain(tfs, ta, tb)])
    for few, many in zip(*forms):
        assert torch.equal(few, many)
    assert [TL.decode(tfs, x) for x in forms[0]] == [
        [x * y % p for x, y in zip(a, b)], [(x + y) % p for x, y in zip(a, b)],
        [(x - y) % p for x, y in zip(a, b)]]
    m = _values(p, 9, 11)
    digits = TL.encode(tfs, m, "cpu").numpy().astype(np.int64)
    table = torch.from_numpy(HF.matvec_table(digits.reshape(tfs.nl, 3, 3)))
    x = ta[:, :39].reshape(tfs.nl, 3, 13)
    got = HF.mont_matvec_plain(tfs, table, x)
    xs = [a[j * 13:(j + 1) * 13] for j in range(3)]
    assert [TL.decode(tfs, got[:, i]) for i in range(3)] == [
        [sum(m[3 * i + j] * xs[j][k] for j in range(3)) % p
         for k in range(13)] for i in range(3)]


def test_time_plain_times_both_forms_on_the_same_digits():
    """`tools/time_plain.py`, whose readings set `_FEW_LANES`, runs every
    form on either side of the bound, finds their digits equal, and leaves
    the bound as it was."""
    from crypto3_zk_tpu_torch.tools import time_plain
    bound = HF._FEW_LANES
    rows = time_plain.time_forms(torch.device("cpu"), [2, 10], 1)
    assert [(r["op"], r["log_lanes"]) for r in rows] == [
        (op, log) for log in (2, 10)
        for op in ("mont_mul", "add", "sub", "mds")]
    assert all(v > 0 for r in rows for k, v in r.items() if k.endswith("ms"))
    assert HF._FEW_LANES == bound

def test_mont_mul_broadcasts_like_reference():
    fs, tfs, a, ta = _pair("ALT_BN128_FR", 12, 8)
    c = L.const_mont(fs, 12345, (1, 1))
    tc = TL.const_mont(tfs, 12345, (1, 1), "cpu")
    _same(L.mont_mul(fs, a.reshape(fs.nl, 3, 4), c),
          TL.mont_mul(tfs, ta.reshape(fs.nl, 3, 4), tc))


def test_odd_digit_count_is_refused_by_the_kernels():
    """An odd digit count has a kernel instance only at 19 digits (the
    MNT4/MNT6 scalar fields, R = 2^304, 10 words with a half top word);
    any other odd count is still refused."""
    from crypto3_zk_tpu_torch import kernels as K
    for fs in (TP.MNT4_FR, TP.MNT6_FR):
        nw, consts = K.field_consts(fs)
        assert (fs.nl, nw) == (19, 10)
        assert [consts[j] for j in range(2 * nw)] == [
            (v >> (32 * j)) & 0xFFFFFFFF
            for v in (fs.p, fs.R_mod_p) for j in range(nw)]
        assert consts[2 * nw] * fs.p % (1 << 32) == (1 << 32) - 1
        assert fs.R == 1 << 304
    p = (1 << 270) - 1
    while not all(pow(a, p - 1, p) == 1 for a in (2, 3, 5, 7)):
        p -= 2
    g = next(g for g in range(2, 50) if pow(g, (p - 1) // 2, p) == p - 1)
    seventeen = TP.FieldSpec("odd_17", p, g, 1)
    assert seventeen.nl == 17
    with pytest.raises(ValueError):
        K.field_consts(seventeen)
    # the fused words of 19 digits: the top word has one digit
    d = np.arange(19 * 2, dtype=np.int64).reshape(19, 2) % (1 << 16)
    w = K.fuse_words(d)
    assert w.shape == (10, 2)
    np.testing.assert_array_equal(w[9], d[18])
    np.testing.assert_array_equal(w[0], d[0] | (d[1] << 16))


def test_default_device_is_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        assert TL.zeros(TP.ALT_BN128_FR, (2,)).is_cuda
    else:
        with pytest.raises(RuntimeError):
            TL.zeros(TP.ALT_BN128_FR, (2,))
