"""The CUDA kernels' own sources, compiled for the CPU
(`crypto3_zk_tpu_torch.tools.host_kernels`) and held against their plain
PyTorch versions and Python integers, bit for bit. This runs the code of
`csrc/*.cu` itself (indexing, strides, shared memory, barriers, the carry
chains of `field.cuh` through their host definitions), which the wrappers
never do on the CPU. Skipped where there is no `g++`."""
import random

import numpy as np
import pytest
import torch

from crypto3_zk_tpu_torch import kernels as K
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import hopper_field as HF
from crypto3_zk_tpu_torch.ops import hopper_msm as HM
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.tools import host_kernels

import torch_threads  # noqa: F401  one torch thread a worker

FQ, FR, BLS = TP.ALT_BN128_FQ, TP.ALT_BN128_FR, TP.BLS12_381_FQ
GL, MNT4 = TP.GOLDILOCKS, TP.MNT4_FR     # 2 words, p fills its top word;
                                         # 19 digits, R = 2^304


@pytest.fixture(scope="module")
def entry():
    if host_kernels.compiler() is None:
        pytest.skip("no g++ to compile the kernels for the CPU")
    return host_kernels.entry


def _rand(fs, shape, seed, nonzero=False):
    rng = random.Random(seed)
    n = int(np.prod(shape))
    vals = [rng.randrange(1 if nonzero else 0, fs.p) for _ in range(n)]
    if n >= 3:
        vals[:3] = [1 if nonzero else 0, fs.R_mod_p, fs.p - 1]
    return TL.encode(fs, vals, "cpu").reshape((fs.nl,) + tuple(shape))


def _filled(shape):
    return torch.full(shape, -7, dtype=torch.int32)


@pytest.mark.parametrize("fs", [FQ, TP.BLS12_381_FR, BLS, GL, MNT4],
                         ids=lambda fs: fs.name)
def test_field_arithmetic_against_python_ints(entry, fs):
    rng = random.Random(5)
    edge = [0, 1, fs.p - 1, fs.p - 2, fs.R_mod_p, (1 << 32) - 1, 1 << 32,
            fs.p >> 1, (fs.p >> 1) + 1, (1 << 63) % fs.p]
    av = edge + [rng.randrange(fs.p) for _ in range(64)]
    bv = [rng.randrange(fs.p) for _ in range(64)] + edge
    a = torch.from_numpy(TL.pack_ints(fs, av).astype(np.int32))
    b = torch.from_numpy(TL.pack_ints(fs, bv).astype(np.int32))
    nw, consts = K.field_consts(fs)
    _, shape3, avw, bvw = HF._launch_geometry(fs.nl, a, b)
    for name, ref in (("zk_mont_mul", lambda x, y: x * y * fs.Rinv % fs.p),
                      ("zk_add", lambda x, y: (x + y) % fs.p),
                      ("zk_sub", lambda x, y: (x - y) % fs.p)):
        out = _filled(a.shape)
        assert entry(name)(nw, consts, avw.data_ptr(), bvw.data_ptr(),
                           out.data_ptr(), *shape3, HF._kernel_strides(avw),
                           HF._kernel_strides(bvw), None) == 0
        assert TL.unpack_ints(fs, out) == [ref(x, y) for x, y in zip(av, bv)]


def _scans(entry, fs, x):
    nl, k, c = x.shape
    share, _, _ = HM.scan_geometry(nl, k, c)
    nw, consts = K.field_consts(fs)
    f, g, tot = _filled(x.shape), _filled(x.shape), _filled((nl, c))
    assert entry("zk_inv_scans")(nw, consts, x.data_ptr(), f.data_ptr(),
                                 g.data_ptr(), tot.data_ptr(), k, c, share,
                                 None) == 0
    return f, g, tot


@pytest.mark.parametrize("k,c", [(64, 33), (64, 1), (1, 7), (2, 8), (17, 40)])
@pytest.mark.parametrize("fs", [FQ, BLS, GL, MNT4], ids=lambda fs: fs.name)
def test_scan_kernel_matches_its_plain_version(entry, fs, k, c):
    x = _rand(fs, (k, c), 100 * k + c, nonzero=True)
    for got, want in zip(_scans(entry, fs, x), HM.inv_scans_plain(fs, x)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("size", [1, 2, 3, 63, 512, HM.INV_TAIL_MAX])
@pytest.mark.parametrize("fs", [FQ, BLS, GL, MNT4], ids=lambda fs: fs.name)
def test_tail_kernel_inverts(entry, fs, size):
    x = _rand(fs, (size,), size, nonzero=True)
    nw, consts = K.field_consts(fs)
    out = _filled(x.shape)
    assert entry("zk_inv_tail")(nw, consts, x.data_ptr(), out.data_ptr(),
                                size, None) == 0
    assert TL.decode(fs, out) == [pow(v, -1, fs.p) for v in TL.decode(fs, x)]
    for bad in (0, HM.INV_TAIL_MAX + 1):
        assert entry("zk_inv_tail")(nw, consts, x.data_ptr(),
                                    out.data_ptr(), bad, None) != 0


@pytest.mark.parametrize("fs", [FQ, GL, MNT4], ids=lambda fs: fs.name)
def test_mul3_kernel_matches_its_plain_version(entry, fs):
    a, b = _rand(fs, (8, 5), 1), _rand(fs, (8, 5), 2)
    c = _rand(fs, (5,), 3)
    nw, consts = K.field_consts(fs)
    out = _filled(a.shape)
    assert entry("zk_mul3")(nw, consts, a.data_ptr(), b.data_ptr(),
                            c.data_ptr(), out.data_ptr(), 8, 5, None) == 0
    assert torch.equal(out, HM.mul3_bcast_plain(fs, a, b, c))


def _rows(entry, fs, x, inverse, mul=None, out=None):
    (m_rows, log_b, log_g, threads, _, xs, mul_view, out_strides) = \
        HF._rows_launch(fs, x, mul, out)
    nw, consts = K.field_consts(fs)
    tww = HF._twiddle_words(fs, log_b, inverse, "cpu")
    if out is None:
        out = _filled(x.shape)
        out_strides = HF._row_strides(out)
    assert entry("zk_ntt_rows")(
        nw, consts, x.data_ptr(), xs, tww.data_ptr(),
        None if mul_view is None else mul_view.data_ptr(),
        None if mul_view is None else HF._row_strides(mul_view),
        out.data_ptr(), out_strides, m_rows, log_b, log_g, threads,
        None) == 0
    return out


@pytest.mark.parametrize("log_b", range(1, 11))
def test_row_kernel_matches_its_plain_version(entry, log_b):
    for m_rows, inverse in ((1, False), (3, True)):
        x = _rand(FR, (m_rows, 1 << log_b), 7 * log_b + m_rows)
        assert torch.equal(_rows(entry, FR, x, inverse),
                           HF.ntt_rows_plain(FR, x, inverse))


@pytest.mark.parametrize("fs", [GL, MNT4], ids=lambda fs: fs.name)
def test_row_kernel_two_and_nineteen_digit_instances(entry, fs):
    for log_b, m_rows, inverse in ((1, 3, False), (5, 3, True),
                                   (10, 1, False)):
        x = _rand(fs, (m_rows, 1 << log_b), 3 * log_b + m_rows)
        assert torch.equal(_rows(entry, fs, x, inverse),
                           HF.ntt_rows_plain(fs, x, inverse))


def test_row_kernel_many_rows_a_block_and_twelve_words(entry, monkeypatch):
    x = _rand(BLS, (300, 2), 5)
    assert HF._rows_launch(BLS, x, None, None)[2] == 1
    assert torch.equal(_rows(entry, BLS, x, False),
                       HF.ntt_rows_plain(BLS, x, False))
    monkeypatch.setattr(HF, "_ROWS_MIN_BLOCKS", 1)
    for m_rows, b in ((37, 16), (5, 512)):
        x = _rand(FR, (m_rows, b), m_rows)
        assert HF._rows_launch(FR, x, None, None)[2] >= 2
        assert torch.equal(_rows(entry, FR, x, True),
                           HF.ntt_rows_plain(FR, x, True))


@pytest.mark.parametrize("kind", ["none", "table", "constant", "per_row",
                                  "per_element"])
def test_row_kernel_strides_and_multipliers(entry, monkeypatch, kind):
    monkeypatch.setattr(HF, "_ROWS_MIN_BLOCKS", 4)        # 4 rows a block
    x = _rand(FR, (16, 16), 11).transpose(1, 2)           # columns as rows
    table = _rand(FR, (16, 16), 12)
    mul = {"none": None, "table": table, "constant": _rand(FR, (1, 1), 13),
           "per_row": table[:, :, :1], "per_element": table[:, :1, :]}[kind]
    want = HF.ntt_rows_plain(FR, x, True, mul)
    assert torch.equal(_rows(entry, FR, x, True, mul), want)
    flat = _filled((FR.nl, 256))
    view = flat.reshape(FR.nl, 16, 16).transpose(1, 2)
    _rows(entry, FR, x, True, mul, view)
    assert torch.equal(view, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_through_the_row_kernel(entry, inverse):
    x = _rand(FR, (1 << 11,), 21)
    got = HF.ntt_hopper(
        FR, x, inverse,
        rows=lambda fs, v, inv, mul=None, out=None:
            _rows(entry, fs, v, inv, mul, out))
    assert torch.equal(got, HF.ntt_plain(FR, x, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_recurses_through_the_kernels(entry, monkeypatch, inverse):
    """With the row limit lowered to 2^2, a 2^7 transform splits 2^2 * 2^5,
    its second side (4 lines of 2^5) 2^2 * 2^3, and that one's second side
    (16 lines of 2^3) 2^2 * 2^1: the batched four-step of interleaved lines
    recurses twice, kernel 1 multiplying by each level's twiddles and
    moving the lines; held against Python integers."""
    monkeypatch.setattr(HF, "_MAX_ROW_LOG", 2)
    vals = [random.Random(31).randrange(FR.p) for _ in range(1 << 7)]
    w = FR.root_of_unity(1 << 7)
    if inverse:
        w = pow(w, -1, FR.p)
    want = [sum(v * pow(w, i * k, FR.p) for i, v in enumerate(vals)) % FR.p
            for k in range(1 << 7)]
    if inverse:
        want = [x * pow(1 << 7, -1, FR.p) % FR.p for x in want]
    products = []

    def mul(fs, a, b):
        products.append(a.shape)
        nw, consts = K.field_consts(fs)
        bshape, shape3, av, bv = HF._launch_geometry(fs.nl, a, b)
        out = _filled((fs.nl,) + bshape)
        assert entry("zk_mont_mul")(nw, consts, av.data_ptr(), bv.data_ptr(),
                                    out.data_ptr(), *shape3,
                                    HF._kernel_strides(av),
                                    HF._kernel_strides(bv), None) == 0
        return out

    got = HF.ntt_hopper(
        FR, TL.encode(FR, vals, "cpu"), inverse,
        rows=lambda fs, v, inv, mul=None, out=None:
            _rows(entry, fs, v, inv, mul, out), mul=mul)
    assert TL.decode(FR, got) == want
    # one twiddle launch for each split of more than one line; the top
    # split's twiddle rides in its first row launch
    assert len(products) == 2


def _poseidon(entry, pp, ins, adds=(None, None), lane0_only=False, form=0):
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    fs = pp.fs
    n, _ = HH._lanes(fs, ins, adds)
    nw, consts = K.field_consts(fs)
    ptrs, strides = HH.plane_args(ins, adds)
    out = _filled((fs.nl, n) if lane0_only else (fs.nl, 3, n))
    assert entry("zk_poseidon_permute")(
        nw, consts, ptrs, strides, HH._schedule(pp, lane0_only),
        HH._const_words(pp, "cpu").data_ptr(), out.data_ptr(), n, form,
        None) == 0
    return out


def _poseidon_params(flavour):
    from crypto3_zk_tpu_torch.ops import nil_poseidon as NPO
    from crypto3_zk_tpu_torch.ops import poseidon as PO
    if flavour == "nil":
        return NPO.get_params(TP.PALLAS_FQ)
    return PO.get_params({"original": TP.BLS12_381_FR, "original12": BLS,
                          "goldilocks": GL, "mnt4": MNT4}[flavour])


@pytest.mark.parametrize("flavour", ["original", "nil", "original12",
                                     "goldilocks", "mnt4"])
def test_poseidon_kernel_matches_its_plain_version(entry, flavour):
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    pp = _poseidon_params(flavour)
    fs = pp.fs
    for n in (1, 33):
        state = _rand(fs, (3, n), 40 + n)
        ins = (state[:, 0], state[:, 1], state[:, 2])
        got = _poseidon(entry, pp, ins)
        assert torch.equal(got, HH.poseidon_permute_plain(pp, ins))
    # against the scalar permutation on Python integers
    mod = __import__(type(pp).__module__, fromlist=["permute_host"])
    cols = [TL.decode(fs, got[:, i]) for i in range(3)]
    vals = [TL.decode(fs, state[:, i]) for i in range(3)]
    for lane in (0, 1, 2, 32):
        assert [c[lane] for c in cols] == mod.permute_host(
            pp, [v[lane] for v in vals])


@pytest.mark.parametrize("flavour", ["original", "nil"])
def test_poseidon_kernel_merkle_forms(entry, flavour):
    """Strided planes (a level's even and odd digests), the zero capacity
    element, the sponge's absorb planes and the element-0-only output."""
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    pp = _poseidon_params(flavour)
    fs = pp.fs
    level = _rand(fs, (70,), 7)
    ins = (level[:, 0::2], level[:, 1::2], None)
    got = _poseidon(entry, pp, ins, lane0_only=True)
    assert torch.equal(got, HH.poseidon_permute_plain(pp, ins,
                                                      lane0_only=True))
    state = _rand(fs, (3, 35), 8)
    ins = (state[:, 0], state[:, 1], state[:, 2])
    rows = _rand(fs, (2, 35), 9)
    for adds in ((rows[:, 0], rows[:, 1]), (rows[:, 0], None)):
        for lane0_only in (False, True):
            got = _poseidon(entry, pp, ins, adds, lane0_only)
            assert torch.equal(got, HH.poseidon_permute_plain(
                pp, ins, adds, lane0_only))
    nw, consts = K.field_consts(fs)
    ptrs, strides = HH.plane_args(ins, (None, None))
    bad = HH._schedule(pp, False)
    bad[5] = 2
    assert entry("zk_poseidon_permute")(
        nw, consts, ptrs, strides, bad, HH._const_words(pp, "cpu").data_ptr(),
        got.data_ptr(), 35, 0, None) != 0
    assert entry("zk_poseidon_permute")(
        nw, consts, ptrs, strides, HH._schedule(pp, False),
        HH._const_words(pp, "cpu").data_ptr(), got.data_ptr(), 35, 2,
        None) != 0


@pytest.mark.parametrize("flavour", ["original", "nil", "goldilocks"])
def test_poseidon_shared_form_matches_its_plain_version(entry, flavour):
    """Three threads a state: lane counts that fill a warp's ten states,
    that leave part of one (odd and even), a whole state given, a level's
    strided even and odd digests, and the sponge's absorb planes."""
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    pp = _poseidon_params(flavour)
    fs = pp.fs
    state = _rand(fs, (3, 44), 60)
    want = HH.poseidon_permute_plain(pp, (state[:, 0], state[:, 1],
                                          state[:, 2]))
    for n in (1, 10, 33, 44):     # lanes are independent: a prefix each
        part = state[:, :, :n]
        ins = (part[:, 0], part[:, 1], part[:, 2])
        assert torch.equal(_poseidon(entry, pp, ins, form=1),
                           want[:, :, :n])
    level = _rand(fs, (82,), 17)
    ins = (level[:, 0::2], level[:, 1::2], None)
    assert torch.equal(_poseidon(entry, pp, ins, lane0_only=True, form=1),
                       HH.poseidon_permute_plain(pp, ins, lane0_only=True))
    rows = _rand(fs, (2, 41), 19)
    for adds in ((rows[:, 0], rows[:, 1]), (rows[:, 0], None)):
        got = _poseidon(entry, pp, (None, None, None), adds, True, form=1)
        assert torch.equal(got, HH.poseidon_permute_plain(
            pp, (None, None, None), adds, True))


def _poseidon_tree(entry, pp, digests):
    import ctypes
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    fs = pp.fs
    s = HH._tree_states(fs, digests)
    nw, consts = K.field_consts(fs)
    levels = [_filled((fs.nl, s >> lvl)) for lvl in range(s.bit_length())]
    ptrs, strides = HH.plane_args((digests[:, 0::2], digests[:, 1::2], None),
                                  (None, None))
    outs = (ctypes.c_void_p * len(levels))(*[t.data_ptr() for t in levels])
    assert entry("zk_poseidon_tree")(
        nw, consts, ptrs, strides, HH._schedule(pp, True),
        HH._const_words(pp, "cpu").data_ptr(), outs, s, len(levels),
        None) == 0
    return levels


def test_poseidon_tree_form_from_512_leaves_to_the_root(entry):
    """A tree of 2^9 leaf digests as `merkle._device_levels` builds it on
    the card: the levels of more than `TREE_MAX` states by the shared form,
    one launch each, and the rest in one launch of the tree form; every
    level plane equals the plain permutation's, down to the root."""
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    pp = _poseidon_params("original")
    fs = pp.fs
    got = [_rand(fs, (1 << 9,), 23)]
    while got[-1].shape[1] > 2 * HH.TREE_MAX:
        cur = got[-1]
        got.append(_poseidon(entry, pp, (cur[:, 0::2], cur[:, 1::2], None),
                             lane0_only=True, form=1))
    assert len(got) > 1
    got += _poseidon_tree(entry, pp, got[-1])
    cur, want = got[0], []
    while cur.shape[1] > 1:
        cur = HH.poseidon_permute_plain(pp, (cur[:, 0::2], cur[:, 1::2],
                                             None), lane0_only=True)
        want.append(cur)
    assert len(got) - 1 == len(want) == 9
    for g, w in zip(got[1:], want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("flavour", ["nil", "mnt4"])
def test_poseidon_tree_form_small_trees(entry, flavour):
    """The tree form on 2 and 8 digests, and what it refuses."""
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    pp = _poseidon_params(flavour)
    fs = pp.fs
    for n2 in (2, 8):
        digests = _rand(fs, (n2,), n2)
        got = _poseidon_tree(entry, pp, digests)
        want = HH.poseidon_tree_plain(pp, digests)
        assert len(got) == len(want) == n2.bit_length() - 1
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for bad in (3, 12, 4 * HH.TREE_MAX):
        with pytest.raises(ValueError):
            HH._tree_states(fs, _rand(fs, (bad,), bad))
