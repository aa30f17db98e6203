"""The CUDA kernels' own sources, compiled for the CPU
(`crypto3_zk_tpu_torch.tools.host_kernels`) and held against their plain
PyTorch versions and Python integers, bit for bit. This runs the code of
`csrc/*.cu` itself (indexing, strides, shared memory, barriers, the carry
chains of `field.cuh` through their host definitions), which the wrappers
never do on the CPU. Skipped where there is no `g++`."""
import ctypes
import random
import types

import numpy as np
import pytest
import torch

from crypto3_zk_tpu_torch import kernels as K
from crypto3_zk_tpu_torch.fields import curves as TCV
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import hopper_curve as HC
from crypto3_zk_tpu_torch.ops import hopper_field as HF
from crypto3_zk_tpu_torch.ops import hopper_msm as HM
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.ops import points as TPT
from crypto3_zk_tpu_torch.tools import host_kernels
from crypto3_zk_tpu_torch.tools import scalar_mul_shapes as SMS

import torch_threads  # noqa: F401  one torch thread a worker

FQ, FR, BLS = TP.ALT_BN128_FQ, TP.ALT_BN128_FR, TP.BLS12_381_FQ
GL, MNT4 = TP.GOLDILOCKS, TP.MNT4_FR     # 2 words, p fills its top word;
                                         # 19 digits, R = 2^304
MNT6 = TP.MNT6_FR                        # 19 digits, Poseidon's x^11


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
    # the table every form reads, as the wrapper passes it (sparse partial
    # rounds in the original flavour, the dense one in the nil flavour)
    assert entry("zk_poseidon_permute")(
        nw, consts, ptrs, strides, HH._schedule(pp, lane0_only),
        HH._table_words(pp, "cpu").data_ptr(), out.data_ptr(), n, form,
        None) == 0
    return out


def _poseidon_params(flavour):
    from crypto3_zk_tpu_torch.ops import nil_poseidon as NPO
    from crypto3_zk_tpu_torch.ops import poseidon as PO
    if flavour == "nil":
        return NPO.get_params(TP.PALLAS_FQ)
    return PO.get_params({"original": TP.BLS12_381_FR, "original12": BLS,
                          "goldilocks": GL, "mnt4": MNT4,
                          "mnt6": MNT6}[flavour])


@pytest.mark.parametrize("flavour", ["original", "nil", "original12",
                                     "goldilocks", "mnt4", "mnt6"])
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


@pytest.mark.parametrize("flavour", ["original", "nil", "original12",
                                     "goldilocks", "mnt4", "mnt6"])
def test_poseidon_lanes_form_edge_states(entry, flavour):
    """One thread a state on edge states (every element p - 1, every
    element 0, p - 1 beside 0) and on lane counts that end inside a block
    of 128 states (129 and 200), against the plain version and the scalar
    permutation; and the schedules the form has no instance for are
    refused."""
    from crypto3_zk_tpu_torch.ops import hopper_hash as HH
    pp = _poseidon_params(flavour)
    fs = pp.fs
    # the rule `lanes_counts` reckons reductions by is the one `field.cuh`'s
    # `mont_dot3` compiles: one reduction a row but where p fills its top
    # word (`FieldShape::full_top`, 2 words) or R splits a word (`half_top`,
    # 10 words)
    assert HH.row_reduced_once(fs) == (K.words(fs.nl) not in (2, 10))
    n = 200
    state = _rand(fs, (3, n), 90)
    edges = {0: [fs.p - 1] * 3, 1: [0, 0, 0], 128: [fs.p - 1, 0, fs.p - 1],
             n - 1: [fs.p - 1] * 3}
    for lane, vals in edges.items():
        for i, v in enumerate(vals):
            state[:, i, lane] = TL.encode(fs, [v], "cpu")[:, 0]
    want = HH.poseidon_permute_plain(pp, (state[:, 0], state[:, 1],
                                          state[:, 2]))
    for m in (129, n):            # lanes are independent: a prefix each
        part = state[:, :, :m]
        got = _poseidon(entry, pp, (part[:, 0], part[:, 1], part[:, 2]))
        assert torch.equal(got, want[:, :, :m])
    mod = __import__(type(pp).__module__, fromlist=["permute_host"])
    for lane, vals in edges.items():
        assert [TL.decode(fs, want[:, i, lane:lane + 1])[0]
                for i in range(3)] == mod.permute_host(pp, vals)
    nw, consts = K.field_consts(fs)
    ptrs, strides = HH.plane_args((state[:, 0], state[:, 1], state[:, 2]),
                                  (None, None))
    table = HH._table_words(pp, "cpu").data_ptr()
    rounds = len(pp.round_constants)
    # sched[1], [2], [3] = p_begin, p_end, alpha. Original flavour: no full
    # round before the partial ones, none after them, an alpha without an
    # instance; nil flavour: a partial round, another alpha than 7
    for at, value in ((1, 0), (2, rounds), (3, 13)) if pp.rc_first else \
            ((2, 1), (3, 5)):
        bad = HH._schedule(pp, False)
        bad[at] = value
        assert entry("zk_poseidon_permute")(
            nw, consts, ptrs, strides, bad, table, want.data_ptr(), n, 0,
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
        HH._table_words(pp, "cpu").data_ptr(), outs, s, len(levels),
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


def _scalar_mul_case(curve, group):
    """Points and scalars that reach every branch of kernel 6 at its window
    w: 0, 1, r - 1, random scalars, a point at infinity (lane 4), and
    `scalar_mul_shapes.edge_scalars`, each checked here for the digits that
    take it there: a zero digit in the middle (no addition at that step), a
    zero top digit (acc starts at infinity, the first addition takes the
    table's entry), a top digit that is the carry alone, a window of all
    ones (digit -1: Y negated, a carry into the window above), r + 2d and
    r, whose last additions meet acc = T[d] (the doubling case) and acc =
    -T[d] (infinity), d the last digit, and 2^bits - 1 (zero digits but the
    lowest and the top)."""
    rng = random.Random(66)
    mul = TCV.g1_mul if group == "g1" else TCV.g2_mul
    gen = curve.g1 if group == "g1" else curve.g2
    r, nbits = curve.fr.p, curve.fr.bits
    w = HC.WINDOW[group]
    edges = SMS.edge_scalars(r, nbits, w, rng)
    ks = [0, 1, r - 1, rng.randrange(r), 5, rng.randrange(r)] \
        + list(edges.values())
    pts = [mul(curve, gen, rng.randrange(1, r)) for _ in ks]
    pts[4] = None
    digits = torch.tensor([[(k >> (16 * j)) & 0xFFFF for k in ks]
                           for j in range(HC.SCALAR_DIGITS)],
                          dtype=torch.int32)
    d = HC.signed_digits(digits, nbits, w)
    lane = dict(zip(edges, range(6, len(ks))))
    mid = d.shape[0] // 2
    assert d[mid, lane["zero digit in the middle"]] == 0
    assert d[-1, lane["zero top digit"]] == 0
    assert d[-1, lane["top digit from the carry"]] == 1
    assert d[mid, lane["window of all ones"]] == -1
    for name, acc_over_d in (("last addition meets acc = T[d]", 1),
                             ("last addition meets acc = -T[d]", -1)):
        k, last = ks[lane[name]], int(d[0, lane[name]])
        assert last != 0 and (k - last - acc_over_d * last) % r == 0
    assert (d[1:-1, lane["all ones"]] == 0).all()
    return pts, ks, digits, mul


@pytest.mark.parametrize("curve,group", [
    (TCV.ALT_BN128, "g1"), (TCV.ALT_BN128, "g2"),
    (TCV.BLS12_381, "g1"), (TCV.BLS12_381, "g2")],
    ids=["alt_bn128-g1", "alt_bn128-g2", "bls12_381-g1", "bls12_381-g2"])
def test_scalar_mul_kernel_matches_its_plain_version(entry, curve, group):
    """Kernel 6's source against Python integers (affine) and, for G1,
    digit for digit against its plain version (Jacobian); then one
    broadcast scalar. G2 is held against Python integers only in this test
    (its plain version takes tens of seconds on a CPU); `chip_smoke.py`
    holds G1 and G2 of both curves against the plain version on the
    card. The compiled window is the one the plain version takes."""
    pts, ks, digits, mul = _scalar_mul_case(curve, group)
    assert SMS.shape(entry(HC.entry_name(group) + "_shape"),
                     curve.fq.nl // 2)["window"] \
        == HC.WINDOW[group]
    vec = TPT.PointVector(curve, group, host=pts)
    P = vec.jacobian("cpu")
    got = HC.run_entry(entry(HC.entry_name(group)), curve, P, digits, group,
                       None)
    want = [None if pt is None else mul(curve, pt, k)
            for pt, k in zip(pts, ks)]
    assert TPT.PointVector.from_jacobian(curve, group, got).host() == want
    if group == "g1":
        flat = HC._flat(got, group)
        for a, b in zip(flat, HC._flat(HC.scalar_mul_batch_plain(
                curve, P, digits, group), group)):
            assert torch.equal(a, b)
    one = digits[:, 3:4].contiguous()
    got = HC.run_entry(entry(HC.entry_name(group)), curve, P, one, group, None)
    assert TPT.PointVector.from_jacobian(curve, group, got).host() == [
        None if pt is None else mul(curve, pt, ks[3]) for pt in pts]


@pytest.mark.parametrize("kind", ["0", "1", "r-1", "r", "r+2", "2^bits-1",
                                  "random"])
def test_signed_digits_rebuild_the_scalar(kind):
    """The recoding of kernel 6 and its plain version: for windows of 2 to
    6 bits over alt_bn128's and bls12-381's scalar bits, nbits // w + 1
    digits in [-2^(w-1), 2^(w-1)], the top one not negative, that rebuild
    k as sum d_i 2^(w i)."""
    for curve in (TCV.ALT_BN128, TCV.BLS12_381):
        r, nbits = curve.fr.p, curve.fr.bits
        k = {"0": 0, "1": 1, "r-1": r - 1, "r": r, "r+2": r + 2,
             "2^bits-1": (1 << nbits) - 1,
             "random": random.Random(nbits).randrange(1 << nbits)}[kind]
        digits = torch.tensor([[(k >> (16 * j)) & 0xFFFF]
                               for j in range(HC.SCALAR_DIGITS)],
                              dtype=torch.int32)
        for w in range(2, 7):
            d = HC.signed_digits(digits, nbits, w)[:, 0].tolist()
            assert len(d) == nbits // w + 1
            assert all(-(1 << (w - 1)) <= x <= 1 << (w - 1) for x in d)
            assert d[-1] >= 0
            assert sum(x << (w * i) for i, x in enumerate(d)) == k


def test_scalar_mul_refuses_other_curves_first():
    from crypto3_zk_tpu_torch.fields import mnt as TMNT
    with pytest.raises(ValueError):
        HC.check_curve(TMNT.MNT4)
    with pytest.raises(ValueError):
        HC.scalar_mul_batch_hopper(TMNT.MNT4, None, None)


@pytest.mark.parametrize("length", [0, 55, 64, 256])
def test_sha256_kernel_block_form_matches_its_plain_version(entry, length):
    """Kernel 7's block form: padded messages of 1 to 5 blocks (256 bytes
    is a leaf of 8 bls12-381 Fr values), 200 messages (two blocks of
    threads, the second ragged), against its plain version and hashlib."""
    import hashlib

    from crypto3_zk_tpu_torch.ops import sha256 as SH
    rng = random.Random(length)
    msgs = [bytes(rng.randrange(256) for _ in range(length))
            for _ in range(200)]
    raw = torch.tensor([list(m) for m in msgs], dtype=torch.int64) \
        .reshape(200, length)
    words = SH.pad_messages(raw)
    assert words.shape == (16 * SH.padded_blocks(length), 200)
    out = _filled((8, 200))
    assert entry("zk_sha256_blocks")(words.data_ptr(), 200,
                                     words.shape[0] // 16, None,
                                     out.data_ptr(), None) == 0
    assert torch.equal(out, SH.sha256_blocks_plain(words))
    assert SH.digests_to_bytes(out) == [hashlib.sha256(m).digest()
                                        for m in msgs]


def test_sha256_kernel_node_form_matches_its_plain_version(entry):
    """Kernel 7's node form on a level of 2 x 130 digests read in place,
    and the refusal of an empty batch."""
    import hashlib

    from crypto3_zk_tpu_torch.ops import sha256 as SH
    digests = [hashlib.sha256(bytes([i % 256, i // 256])).digest()
               for i in range(260)]
    level = SH.bytes_to_digests(digests, "cpu")
    out = _filled((8, 130))
    kw = ctypes.addressof(SH._padding_arg(64))
    assert entry("zk_sha256_nodes")(level.data_ptr(), 130, kw,
                                    out.data_ptr(), None) == 0
    assert torch.equal(out, SH.sha256_nodes_plain(level))
    assert SH.digests_to_bytes(out) == [
        hashlib.sha256(digests[2 * i] + digests[2 * i + 1]).digest()
        for i in range(130)]
    assert entry("zk_sha256_nodes")(level.data_ptr(), 0, kw, out.data_ptr(),
                                    None) != 0
    assert entry("zk_sha256_nodes")(level.data_ptr(), 130, None,
                                    out.data_ptr(), None) != 0


def _sha256_messages(n, length, seed):
    rng = random.Random(seed)
    return [bytes(rng.randrange(256) for _ in range(length))
            for _ in range(n)]


@pytest.mark.parametrize("n", [1, 127, 129])
@pytest.mark.parametrize("length", [55, 56, 64, 119, 120, 256])
def test_sha256_kernel_block_form_padding_block(entry, length, n):
    """The block form on lengths with the bit length in the last data block
    (55, 119), in a block of its own after data (56, 120) and in a block of
    pure padding (64, 256), for one ragged and two blocks of threads: every
    block read and run through the schedule, and (64, 256) the last block
    left unread, its rounds from `padding_schedule`."""
    import hashlib

    from crypto3_zk_tpu_torch.ops import sha256 as SH
    msgs = _sha256_messages(n, length, 1000 * length + n)
    raw = torch.tensor([list(m) for m in msgs], dtype=torch.int64)
    words = SH.pad_messages(raw.reshape(n, length))
    want = SH.sha256_blocks_plain(words)
    assert SH.digests_to_bytes(want) == [hashlib.sha256(m).digest()
                                         for m in msgs]
    runs = [(words.shape[0] // 16, None)]
    if length % 64 == 0:
        runs.append((words.shape[0] // 16 - 1,
                     ctypes.addressof(SH._padding_arg(length))))
    for nblocks, kw in runs:
        out = _filled((8, n))
        assert entry("zk_sha256_blocks")(words.data_ptr(), n, nblocks, kw,
                                         out.data_ptr(), None) == 0
        assert torch.equal(out, want)


@pytest.mark.parametrize("m", [1, 127, 129])
def test_sha256_kernel_node_form_ragged(entry, m):
    from crypto3_zk_tpu_torch.ops import sha256 as SH
    rng = np.random.default_rng(m)
    level = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (8, 2 * m),
                                          dtype=np.int64)).to(torch.int32)
    out = _filled((8, m))
    assert entry("zk_sha256_nodes")(level.data_ptr(), m,
                                    ctypes.addressof(SH._padding_arg(64)),
                                    out.data_ptr(), None) == 0
    assert torch.equal(out, SH.sha256_nodes_plain(level))


def _leaf_rows(fs, k, n, seed):
    """(values [k][n], (k, NL, n) Montgomery rows), values from numpy with
    0 and p - 1 in the first leaf."""
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(fs.bits // 8 + 8), "little") % fs.p
             for _ in range(n)] for _ in range(k)]
    vals[0][0] = 0
    vals[-1][0] = fs.p - 1
    return vals, torch.stack([TL.encode(fs, v, "cpu") for v in vals])


def _leaf_kernel(entry, fs, rows, layout):
    """Kernel 7's leaf form on the canonical digits of `rows`, laid out
    (NL, k, n) as the wrapper gives them, or (k, NL, n)."""
    from crypto3_zk_tpu_torch.ops import sha256 as SH
    k, nl, n = rows.shape
    half = SH.leaf_half(fs)
    digits = TL.from_mont(fs, rows.permute(1, 0, 2)).contiguous()
    if layout == "k_nl_n":
        digits = digits.permute(1, 0, 2).contiguous()
        sd, se = n, nl * n
    else:
        sd, se = k * n, n
    length = 2 * half * k
    kw = ctypes.addressof(SH._padding_arg(length)) if length % 64 == 0 \
        else None
    out = _filled((8, n))
    assert entry("zk_sha256_field_rows")(digits.data_ptr(), n, k, half, sd,
                                         se, kw, out.data_ptr(), None) == 0
    return out


# (field, elements a leaf): every instance at 1, 2 and 8 elements, and the
# two leaves whose bit length takes a block of its own
_LEAF_CASES = [(fs, k) for fs in (TP.BLS12_381_FR, GL, MNT4, BLS)
               for k in (1, 2, 8)] + [(GL, 7), (MNT4, 5)]


@pytest.mark.parametrize("n", [1, 127, 129])
@pytest.mark.parametrize("fs,k", _LEAF_CASES,
                         ids=[f"{fs.name}-{k}" for fs, k in _LEAF_CASES])
def test_sha256_kernel_leaf_form_matches_its_plain_version(entry, fs, k, n):
    """The leaf form on every instance (8, 32, 38 and 48 bytes an element:
    words straddle MNT4 Fr's elements), k elements a leaf, against its
    plain version and `hashlib` of `field_to_bytes`. A message that fills
    its last block ends in a block of pure padding (32 bytes: one
    bls12-381 Fr value); 7 Goldilocks and 5 MNT4 Fr values (56 and 190
    bytes) leave 56 and 62 bytes in their last data block, so that the
    0x80 byte ends that block and the bit length takes a block of its
    own."""
    import hashlib

    from crypto3_zk_tpu_torch.ops import sha256 as SH
    from crypto3_zk_tpu_torch.transcript.fiat_shamir import field_to_bytes
    vals, rows = _leaf_rows(fs, k, n, 97 * k + n)
    want = SH.sha256_field_rows_plain(fs, rows)
    assert torch.equal(SH.sha256_field_rows_hopper(fs, rows), want)
    for layout in ("nl_k_n", "k_nl_n") if n == 129 else ("nl_k_n",):
        assert torch.equal(_leaf_kernel(entry, fs, rows, layout), want)
    got = SH.digests_to_bytes(want)
    for i in (0, n - 1):
        msg = b"".join(field_to_bytes(fs, vals[e][i]) for e in range(k))
        assert got[i] == hashlib.sha256(msg).digest()


def test_sha256_kernel_leaf_form_refuses_what_it_does_not_take(entry):
    from crypto3_zk_tpu_torch.ops import sha256 as SH
    fs = TP.BLS12_381_FR
    _, rows = _leaf_rows(fs, 2, 4, 3)
    digits = TL.from_mont(fs, rows.permute(1, 0, 2)).contiguous()
    out = _filled((8, 4))
    kw = ctypes.addressof(SH._padding_arg(64))
    ok = dict(n=4, k=2, half=16, sd=8, se=4, kw=kw)

    def run(**change):
        a = {**ok, **change}
        return entry("zk_sha256_field_rows")(
            digits.data_ptr(), a["n"], a["k"], a["half"], a["sd"], a["se"],
            a["kw"], out.data_ptr(), None)

    assert run() == 0
    assert torch.equal(out, SH.sha256_field_rows_plain(fs, rows))
    for change in ({"half": 12}, {"kw": None}, {"n": 0}, {"k": 0},
                   {"sd": 0}, {"se": 1 << 31}):
        assert run(**change) != 0
    for bits in (56, 320):           # 7 bytes an element; 40, no instance
        with pytest.raises(ValueError):
            SH.leaf_half(types.SimpleNamespace(name=f"{bits}-bit", bits=bits))


@pytest.mark.parametrize("mode", range(11))
def test_int_rate_streams_run(entry, mode):
    """The rate loops of `csrc/rate.cu` run on the CPU (what they compute is
    a checksum; their speed means something on the card only), and an
    unknown mode is refused."""
    out = _filled((2 * 32,))
    assert entry("zk_int_rate")(mode, out.data_ptr(), 2, 32, 3,
                                0x9E3779B1 - (1 << 32), None) == 0
    assert (out != -7).any()
    assert entry("zk_int_rate")(11, out.data_ptr(), 2, 32, 3, 3, None) != 0


@pytest.mark.parametrize("log_m,b", [(1, 5), (2, 3), (4, 33), (5, 8),
                                     (5, 40), (6, 7), (3, 64)])
@pytest.mark.parametrize("inverse", [False, True])
def test_mxu_block_kernel_matches_its_plain_version(entry, log_m, b,
                                                    inverse):
    """Kernel 8 (`csrc/mxu_ntt.cu`) in its block form, int32 in and out
    and no twiddle: the int32 digits cut into the tile by the producer
    warpgroup, the 8-bit digit products by the host definition of the
    `wgmma` tile product through the kernel's descriptors, the plane merge,
    the nine word rounds and the stores, against `block_ntt_plain`: sides
    below 16 (the side-16 table with zero rows and columns), one and two
    k-steps (side 64), column counts that do not fill a tile of 64 and
    tiles walked by a persistent block, edges 0, 1 and p - 1."""
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    fs = TP.BLS12_381_FR
    plan = MX.get_mxu_plan(fs, log_m, inverse)
    x = _rand(fs, (1 << log_m, b), 31 * log_m + b)
    assert MX.block_launch(fs, plan, x) == (1 << log_m, b)
    g = MX.PassGeom(m=1 << log_m, c=1, b=b)
    out, args = MX.pass_launch(fs, g, x.reshape(fs.nl, -1), inverse, 4)
    out.fill_(-7)
    assert entry("zk_mxu_pass")(*args, None) == 0
    assert torch.equal(out.reshape(x.shape), MX.block_ntt_plain(fs, plan, x))


@pytest.mark.parametrize("sides,inverse", [
    ([4, 4, 4], False), ([4, 4, 4], True), ([5, 5], False),
    ([4, 6, 4], True), ([6, 5, 1], False), ([5, 4, 3], True)])
def test_mxu_pass_kernel_chain_matches_its_plain_version(entry, sides,
                                                         inverse):
    """Every pass of a transform's chain, kernel 8 against `pass_plain`:
    int32 in and packed out with the twiddle (the first pass), packed in
    and out (a middle one), packed in and int32 out without it (the last),
    the tile lanes of the packed layout, partial tiles (2^10: 32 vectors a
    pass), an int32 hand-over to a side below 16, sides 16, 32 and 64; the
    chain's output is the transform. Packed outputs are compared through
    `unpack_plain` (rows past the vectors of a partial tile are never
    written), and byte for byte where the tiles are full."""
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    from crypto3_zk_tpu_torch.ops import ntt as TN
    fs = TP.BLS12_381_FR
    n = 1 << sum(sides)
    x = _rand(fs, (n,), 7 * n + len(sides))
    y = x
    geoms = MX.chain_geoms(sides)
    for g in geoms:
        out, args = MX.pass_launch(fs, g, y, inverse, 4)
        assert entry("zk_mxu_pass")(*args, None) == 0
        want = MX.pass_plain(fs, g, y, inverse)
        if g.out_packed:
            m2, c2, b2 = g.next_view()
            assert torch.equal(
                MX.unpack_plain(fs, out, m2, c2 * b2, g.lsj2, g.lsk2),
                MX.unpack_plain(fs, want, m2, c2 * b2, g.lsj2, g.lsk2))
            if c2 * b2 % MX.ROWS == 0:
                assert torch.equal(out, want)
        else:
            assert torch.equal(out, want)
        y = out
    assert [g.twiddle for g in geoms] == [True] * (len(sides) - 1) + [False]
    scale = TL.const_mont(fs, pow(n, -1, fs.p), (1,), "cpu")
    want = TN.ntt(fs, x, inverse=inverse)
    assert torch.equal(TL.mont_mul(fs, y, scale) if inverse else y, want)


@pytest.mark.parametrize("sides,one_max", [([4, 4, 4], 4), ([4, 4, 4], 8),
                                           ([5, 4, 4], 6), ([4, 5, 4], 4)])
def test_mxu_pass_kernel_two_twiddle_tables_give_the_same_digits(
        entry, monkeypatch, sides, one_max):
    """Above 2^TW_ONE_MAX_LOG points a pass's twiddle is the product of two
    small tables, lo[e mod 2^h] hi[e >> h]; lowered here, so that the
    kernel's second product runs at test sizes, in the first and middle
    passes, against `pass_plain`."""
    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    fs = TP.BLS12_381_FR
    monkeypatch.setattr(MX, "TW_ONE_MAX_LOG", one_max)
    y = _rand(fs, (1 << sum(sides),), 99 + one_max)
    two = 0
    for g in MX.chain_geoms(sides):
        out, args = MX.pass_launch(fs, g, y, False, 3)
        one = args[2][MX.GEOM_FIELDS.index("tw_one")]
        two += g.twiddle and not one
        assert one == int(g.twiddle and
                          (g.m * g.c).bit_length() - 1 <= one_max)
        assert entry("zk_mxu_pass")(*args, None) == 0
        want = MX.pass_plain(fs, g, y, False)
        assert torch.equal(out, want)
        y = want
    assert two >= 1


def test_mxu_pass_kernel_refuses_what_it_does_not_take(entry):
    """The kernel has the 16-digit instance only; the entry refuses a
    digit count, no columns, a side that is no power of two or above 64,
    packed digits at a side below 16, a next side that does not divide the
    vectors' slow part, a tile count that disagrees, tile lanes outside
    the vectors, and a side-64 grid that is no multiple of 4; nothing is
    written then."""
    import ctypes

    from crypto3_zk_tpu_torch.ops import mxu_ntt as MX
    fs = TP.BLS12_381_FR
    gl_nw, gl_consts = K.field_consts(GL)
    g = MX.PassGeom(m=16, c=64, b=1, lsj=2, lsk=0, out_packed=True,
                    twiddle=True, m2=16)
    x = _rand(fs, (16 * 64,), 3)
    out, args = MX.pass_launch(fs, g, x, False, 2)
    fn = entry("zk_mxu_pass")
    geom = list(args[2])
    out.fill_(7)

    def refused(**change):
        vals = dict(zip(MX.GEOM_FIELDS, geom))
        vals.update(change)
        arr = (ctypes.c_longlong * len(geom))(*[vals[k] for k in
                                                MX.GEOM_FIELDS])
        return fn(args[0], args[1], arr, *args[3:], None) != 0

    assert fn(gl_nw, gl_consts, args[2], *args[3:], None) != 0
    assert refused(c=0, tiles=0)
    assert refused(m=48)
    assert refused(m=128)
    assert refused(m=8, in_packed=1)
    assert refused(m2=8)
    assert refused(m2=128)
    assert refused(tiles=17)
    assert refused(lsj=12)
    assert refused(m=64, blocks=3)
    assert refused(staged=2)                          # int32 runs, packed out
    assert refused(staged=1, m=8, m2=16)
    assert torch.equal(out, torch.full_like(out, 7))
    assert fn(*args, None) == 0
