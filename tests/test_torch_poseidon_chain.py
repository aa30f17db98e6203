"""Kernel 5's shared and tree forms (three threads a state), whose sparse
partial rounds fold the mix constant into the S-box's last product and
whose full rounds raise each element whole: the kernel's source compiled
for the CPU
(`crypto3_zk_tpu_torch.tools.host_kernels`) against the plain version for
all six compiled instances, on edge states and on every Merkle input form;
a Python-int model of the folded rounds on the table the kernel reads
against the JAX package's permutation; the chain and the counts the bounds
are reckoned from. Exact equality: every value is an integer."""
import random

import pytest
import torch

from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.ops import nil_poseidon as NPO
from crypto3_zk_tpu.ops import poseidon as PO
from crypto3_zk_tpu_torch import kernels as K
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import hopper_hash as HH
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.ops import nil_poseidon as TNPO
from crypto3_zk_tpu_torch.ops import poseidon as TPO
from test_torch_host_kernels import (_poseidon, _poseidon_params,
                                     _poseidon_tree, _rand)

import torch_threads  # noqa: F401  one torch thread a worker

# the six (words, alpha, flavour) instances the kernel compiles
FLAVOURS = ["original", "nil", "original12", "goldilocks", "mnt4", "mnt6"]


@pytest.fixture(scope="module")
def entry():
    from crypto3_zk_tpu_torch.tools import host_kernels
    if host_kernels.compiler() is None:
        pytest.skip("no g++ to compile the kernels for the CPU")
    return host_kernels.entry


def _table_ints(pp):
    """The table every form reads (`_table_words`), Montgomery words ->
    values."""
    fs = pp.fs
    w = HH._table_words(pp, "cpu").numpy().astype("int64") & 0xFFFFFFFF
    return [sum(int(x) << (32 * j) for j, x in enumerate(row)) * fs.Rinv
            % fs.p for row in w]


def _steps(pp):
    """The permutation as the shared form runs it, one entry a round:
    ("full", rc, M) (original flavour: add rc, S-box, mix by M; M the
    pre-sparse matrix in the last full round before the partial ones),
    ("partial", (k, m00, w1, w2, v1, v2)), or ("nil", rc, M) (S-box, mix,
    add rc), each read off the table the kernel stages."""
    t = _table_ints(pp)
    rounds = len(pp.round_constants)
    if not pp.rc_first:
        mds = t[3 * rounds:3 * rounds + 9]
        return [("nil", t[3 * r:3 * r + 3], mds) for r in range(rounds)]
    lo, hi = pp.partial_rounds
    full = rounds - (hi - lo)
    mds, pre = t[3 * full:3 * full + 9], t[3 * full + 9:3 * full + 18]
    steps = []
    for f in range(full):
        steps.append(("full", t[3 * f:3 * f + 3], pre if f == lo - 1
                      else mds))
        if f == lo - 1:
            steps += [("partial", t[3 * full + 18 + 6 * q:
                                    3 * full + 24 + 6 * q])
                      for q in range(hi - lo)]
    return steps


def _full_model(pp, x, m):
    """A full round's S-box and mix thread by thread, as the kernel runs
    it: each element raised whole, then row e = sum_i x_i^alpha M[e][i]."""
    p = pp.fs.p
    xa = [pow(xi, pp.alpha, p) for xi in x]
    return [sum(xa[i] * m[3 * e + i] for i in range(3)) % p
            for e in range(3)]


def _partial_model(pp, s, q):
    """A sparse partial round thread by thread: every thread raises
    y = s0 + k; thread e's dot is y^(2^K) (c_e y^REST) + W1_e s1 + W2_e s2,
    c = (m00, v1, v2), (W1, W2) = (w1, w2), (1, 0), (0, 1)."""
    p = pp.fs.p
    kk, m00, w1, w2, v1, v2 = q
    k, rest = HH.sbox_split(pp.alpha)
    y = (s[0] + kk) % p
    top = pow(y, 1 << k, p)
    out = []
    for c, (a1, a2) in zip((m00, v1, v2), ((w1, w2), (1, 0), (0, 1))):
        a = c * pow(y, rest, p) % p
        out.append((top * a + a1 * s[1] + a2 * s[2]) % p)
    return out


def _model_step(pp, step, s):
    """One round of `_steps` on Python integers, as the kernel runs it."""
    p = pp.fs.p
    if step[0] == "full":
        return _full_model(pp, [(a + b) % p for a, b in zip(s, step[1])],
                           step[2])
    if step[0] == "partial":
        return _partial_model(pp, s, step[1])
    return [(a + b) % p for a, b in zip(_full_model(pp, s, step[2]),
                                        step[1])]


def _permute_shared_model(pp, state):
    s = [v % pp.fs.p for v in state]
    for step in _steps(pp):
        s = _model_step(pp, step, s)
    return s


def _states(p, seed, n=3):
    rng = random.Random(seed)
    return [[0, 0, 0], [1, 1, 1], [p - 1] * 3, [0, 1, p - 1]] + \
        [[rng.randrange(p) for _ in range(3)] for _ in range(n)]


@pytest.mark.parametrize("name", ["BLS12_381_FR", "BLS12_381_FQ",
                                  "ALT_BN128_FR", "ALT_BN128_FQ",
                                  "GOLDILOCKS", "MNT4_FR", "MNT6_FR",
                                  "PALLAS_FQ", "PALLAS_FR", "VESTA_FQ",
                                  "VESTA_FR", "nil PALLAS_FQ"])
def test_folded_rounds_on_the_kernel_table_equal_the_reference(name):
    """The shared form's rounds (sparse partial rounds with the mix folded
    into the S-box's last product, full rounds on elements raised whole),
    evaluated thread by thread on Python integers from the table the
    kernel reads, are the JAX package's permutation for every parameter set
    of both flavours."""
    if name.startswith("nil"):
        ref = NPO.get_params(P.PALLAS_FQ)
        pp = TNPO.get_params(TP.PALLAS_FQ)
        host = NPO.permute_host
    else:
        ref = PO.get_params(getattr(P, name))
        pp = TPO.get_params(getattr(TP, name))
        host = PO.permute_host
    for state in _states(pp.fs.p, 31):
        assert _permute_shared_model(pp, state) == host(ref, state)


def test_shared_chain_and_counts():
    """Products in sequence (a dot as one product) and what the form issues
    a state."""
    pp = TPO.get_params(TP.BLS12_381_FR)
    npp = TNPO.get_params(TP.PALLAS_FQ)
    # a partial round 3 deep, a full round raised whole 4 (x^2, x^4, x^5,
    # the dot): one deeper than folded, two products fewer a thread
    assert HH.shared_chain(pp) == 57 * 3 + 8 * 4 == 203
    assert HH.shared_chain(npp) == 55 * 4 == 220
    mnt6 = TPO.get_params(TP.MNT6_FR)
    lo, hi = mnt6.partial_rounds
    assert HH.shared_chain(mnt6) == \
        (hi - lo) * 4 + (len(mnt6.round_constants) - (hi - lo)) * 5
    # bls12-381 Fr, a state (3 threads): 65 rounds of 6 products and 4
    # reductions a thread
    assert HH.shared_counts(pp) == {
        "products": 1170, "reductions": 780,
        "instructions": 1170 * 128 + 780 * 144, "chain": 203,
        "textbook_chain": 390}
    # the nil set, x^7: x^2, x^3, x^4, x^7 and a dot a thread
    nil = HH.shared_counts(npp)
    assert (nil["products"], nil["reductions"]) == (55 * 3 * 7,
                                                    55 * 3 * 5)
    # the 2-word instance reduces every product of a dot
    gl = HH.shared_counts(TPO.get_params(TP.GOLDILOCKS))
    assert gl["products"] == gl["reductions"]
    assert HH.sbox_split(5) == (2, 1) and HH.sbox_split(7) == (2, 3) \
        and HH.sbox_split(11) == (3, 3)
    with pytest.raises(ValueError):
        HH.sbox_split(13)


def _sqrt(v, p):
    """A square root of v mod p (Tonelli-Shanks), or None."""
    v %= p
    if v == 0:
        return 0
    if pow(v, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % p, i + 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def _root_2k(v, k, p):
    """x with x^(2^k) = v mod p, or None: k square roots, each of both
    signs tried."""
    if k == 0:
        return v % p
    r = _sqrt(v, p)
    if r is None:
        return None
    for c in (r, p - r):
        x = _root_2k(c, k - 1, p)
        if x is not None:
            return x
    return None


def _top_power_at_max(pp, whole=False):
    """x whose x^(2^K) (x^alpha with `whole`, a full round's left operand)
    is stored in Montgomery form as the largest residue that has such a
    root (p - 1, else p - 2, ...): the dot's left operand at its largest."""
    fs = pp.fs
    if whole:
        return pow((fs.p - 1) * fs.Rinv, pow(pp.alpha, -1, fs.p - 1), fs.p)
    k, _ = HH.sbox_split(pp.alpha)
    for j in range(256):
        x = _root_2k((fs.p - 1 - j) * fs.Rinv, k, fs.p)
        if x is not None:
            return x
    raise AssertionError("no residue near p - 1 has a 2^K-th root")


def _invert(pp, steps, s):
    """The state before `steps` that they take to s (every round map is a
    bijection: x^alpha has the inverse exponent mod p - 1)."""
    p = pp.fs.p
    root = pow(pp.alpha, -1, p - 1)

    def solve(m, v):                  # M^-1 v, M 3x3 row-major
        det = (m[0] * (m[4] * m[8] - m[5] * m[7])
               - m[1] * (m[3] * m[8] - m[5] * m[6])
               + m[2] * (m[3] * m[7] - m[4] * m[6])) % p
        out = []
        for c in range(3):
            mc = list(m)
            for r in range(3):
                mc[3 * r + c] = v[r]
            d = (mc[0] * (mc[4] * mc[8] - mc[5] * mc[7])
                 - mc[1] * (mc[3] * mc[8] - mc[5] * mc[6])
                 + mc[2] * (mc[3] * mc[7] - mc[4] * mc[6])) % p
            out.append(d * pow(det, -1, p) % p)
        return out

    for step in reversed(steps):
        if step[0] == "full":
            x = [pow(v, root, p) for v in solve(step[2], s)]
            s = [(a - b) % p for a, b in zip(x, step[1])]
        elif step[0] == "partial":
            kk, m00, w1, w2, v1, v2 = step[1]
            big = (s[0] - w1 * s[1] - w2 * s[2]) * pow(
                m00 - w1 * v1 - w2 * v2, -1, p) % p
            s1, s2 = (s[1] - v1 * big) % p, (s[2] - v2 * big) % p
            s = [(pow(big, root, p) - kk) % p, s1, s2]
        else:
            s = [pow(v, root, p) for v in
                 solve(step[2], [(a - b) % p for a, b in zip(s, step[1])])]
    return s


def _edge_states(pp):
    """Input states that reach, at a chosen round, the dot operands at their
    largest as far as the fixed constants leave them free: before full
    round 0, before the first partial round and before the first full round
    after them (original flavour) or before the last round (nil): a full
    round's left operands x_i^alpha, a partial round's y^(2^K), at the
    largest Montgomery word value that has such a root, s1 and s2 at p - 1
    in Montgomery form. With them the plain edges 0, 1, p - 1."""
    fs, p = pp.fs, pp.fs.p
    steps = _steps(pp)
    top = _top_power_at_max(pp)
    full = _top_power_at_max(pp, whole=True)
    m1 = (p - 1) * fs.Rinv % p            # p - 1 in Montgomery form
    targets = []                          # (rounds before, the mid-state)
    if pp.rc_first:
        first = next(i for i, st in enumerate(steps) if st[0] == "partial")
        after = max(i for i, st in enumerate(steps) if st[0] == "partial") + 1
        for at in (0, after):
            targets.append((at, [(full - c) % p for c in steps[at][1]]))
        targets.append((first, [(top - steps[first][1][0]) % p, m1, m1]))
    else:
        targets += [(0, [full] * 3), (len(steps) - 1, [full] * 3)]
    states = [_invert(pp, steps[:at], mid) for at, mid in targets]
    for (at, mid), st in zip(targets, states):
        s = st
        for step in steps[:at]:           # the forward model reaches mid
            s = _model_step(pp, step, s)
        assert s == mid
    edges = [[0, 0, 0], [1, 1, 1], [p - 1] * 3, [p - 1, 0, 1], [m1] * 3]
    return edges + states


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_shared_form_edge_states(entry, flavour):
    """Three threads a state on 0, 1, p - 1 and on states built backwards
    from rounds whose dots meet their largest operands, against the plain
    version and the scalar permutation; in the same launch as random
    states, so that edge states share warps with others."""
    pp = _poseidon_params(flavour)
    fs = pp.fs
    rows = _edge_states(pp)
    state = _rand(fs, (3, 23), 3)
    for lane, vals in enumerate(rows):
        for i, v in enumerate(vals):
            state[:, i, 2 * lane] = TL.encode(fs, [v], "cpu")[:, 0]
    ins = (state[:, 0], state[:, 1], state[:, 2])
    got = _poseidon(entry, pp, ins, form=1)
    assert torch.equal(got, HH.poseidon_permute_plain(pp, ins))
    mod = __import__(type(pp).__module__, fromlist=["permute_host"])
    for lane, vals in enumerate(rows):
        assert [TL.decode(fs, got[:, i, 2 * lane:2 * lane + 1])[0]
                for i in range(3)] == mod.permute_host(pp, vals)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_shared_form_merkle_inputs(entry, flavour):
    """Three threads a state in every instance on the Merkle layer's input
    forms: whole states over 1, 10, 33 and 44 lanes (part of a warp's ten
    states, a block's forty and past it), a level's strided even and odd
    digests with the zero capacity element and element 0 out, the sponge's
    absorb planes on a state (both, the first alone; whole state or element
    0 out) and on the zero state."""
    pp = _poseidon_params(flavour)
    fs = pp.fs
    state = _rand(fs, (3, 44), 60)
    want = HH.poseidon_permute_plain(pp, (state[:, 0], state[:, 1],
                                          state[:, 2]))
    for n in (1, 10, 33, 44):
        part = state[:, :, :n]
        assert torch.equal(_poseidon(entry, pp, (part[:, 0], part[:, 1],
                                                 part[:, 2]), form=1),
                           want[:, :, :n])
    level = _rand(fs, (82,), 17)
    ins = (level[:, 0::2], level[:, 1::2], None)
    assert torch.equal(_poseidon(entry, pp, ins, lane0_only=True, form=1),
                       HH.poseidon_permute_plain(pp, ins, lane0_only=True))
    state = _rand(fs, (3, 35), 8)
    ins = (state[:, 0], state[:, 1], state[:, 2])
    rows = _rand(fs, (2, 35), 9)
    for adds in ((rows[:, 0], rows[:, 1]), (rows[:, 0], None)):
        for lane0_only in (False, True):
            assert torch.equal(
                _poseidon(entry, pp, ins, adds, lane0_only, form=1),
                HH.poseidon_permute_plain(pp, ins, adds, lane0_only))
        assert torch.equal(
            _poseidon(entry, pp, (None, None, None), adds, True, form=1),
            HH.poseidon_permute_plain(pp, (None, None, None), adds, True))


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_tree_form_every_instance(entry, flavour):
    """The tree form in every instance on 2, 8 and 2 * TREE_MAX digests
    (the largest first level, every warp of the block in it), with edge
    digests among them, level by level against the plain version."""
    pp = _poseidon_params(flavour)
    fs = pp.fs
    for n2 in (2, 8, 2 * HH.TREE_MAX):
        digests = _rand(fs, (n2,), 70 + n2)
        got = _poseidon_tree(entry, pp, digests)
        want = HH.poseidon_tree_plain(pp, digests)
        assert len(got) == len(want) == n2.bit_length() - 1
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("form", ["shared", "tree"])
def test_shared_and_tree_forms_refuse_other_schedules(entry, form):
    """A schedule outside the six compiled instances, or one the sparse
    schedule cannot take, is refused by both forms (nothing is written)."""
    import ctypes
    pp = _poseidon_params("original")
    npp = _poseidon_params("nil")
    fs = pp.fs
    nw, consts = K.field_consts(fs)
    digests = _rand(fs, (8,), 5)
    ins = (digests[:, 0::2], digests[:, 1::2], None)
    ptrs, strides = HH.plane_args(ins, (None, None))
    rounds = len(pp.round_constants)
    bad = []
    # alpha 7 with the sparse schedule over 8 words, alpha 13; no full round
    # before the partial ones, none after them; the nil flavour with a
    # partial round
    for params, at, value in ((pp, 3, 7), (pp, 3, 13), (pp, 1, 0),
                              (pp, 2, rounds), (npp, 2, 1)):
        sched = HH._schedule(params, True)
        sched[at] = value
        bad.append((params, sched))
    for params, sched in bad:
        table = HH._table_words(params, "cpu").data_ptr()
        out = torch.full((fs.nl, 4), -7, dtype=torch.int32)
        if form == "shared":
            code = entry("zk_poseidon_permute")(
                nw, consts, ptrs, strides, sched, table, out.data_ptr(), 4,
                1, None)
        else:
            levels = [torch.full((fs.nl, 4 >> lvl), -7, dtype=torch.int32)
                      for lvl in range(3)]
            outs = (ctypes.c_void_p * 3)(*[t.data_ptr() for t in levels])
            code = entry("zk_poseidon_tree")(
                nw, consts, ptrs, strides, sched, table, outs, 4, 3, None)
            out = levels[0]
        assert code != 0
        assert (out == -7).all()
