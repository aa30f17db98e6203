"""CUDA kernel for the Poseidon permutation of a batch of states.

Kernel 5: the width-3 permutation of n independent states in ONE launch. It
has no Pallas counterpart: the JAX package composes the permutation from
elementwise field ops (`ops/poseidon.py::permute_batch`,
`ops/nil_poseidon.py::permute_batch`) and leaves the fusion to its compiler;
composed from `limbs.mont_mul` calls here it would be some 1,200 launches a
permutation. Source: `csrc/poseidon.cu`, which says what bounds each form.
A state moves 6*NL*4 bytes for hundreds of Montgomery products: the
operations bound it, and on small levels their latency.

- `poseidon_permute_hopper(pp, ins, adds, lane0_only)` picks one of two
  forms by the number of states n: up to `SHARED_MAX`, three threads a
  state (`form="shared"`: 4 products in sequence a full round at x^5 and
  3 a partial one, `shared_chain`; small levels are bound by that latency
  and one warp's multiply-adds); above, one thread a state
  (`form="lanes"`: the fewest instructions, large levels are bound by the
  integer rate). A caller may name the form.
- `poseidon_tree_hopper(pp, digests)`: a Merkle tree's last levels, from at
  most `TREE_MAX` states down to the root, in ONE launch of one block (the
  shared form with a barrier between levels); every level's digests come
  back as their own plane.

One entry serves both flavours. The parameter object `pp` carries the
schedule: `round_constants` (rounds x 3 ints), `mds` (3 x 3 ints),
`alpha`, `partial_rounds` (the half-open range of rounds whose S-box touches
element 0 only) and `rc_first` (True: add rc -> S-box -> MDS, the original
Poseidon; False: S-box -> MDS -> add rc, the nil flavour). Every form
reads it as one table (`_table_words`): in the original flavour the same
permutation with sparse partial rounds (`sparse_schedule`, built here in
Python integers and cached per parameter set: 600 products a state instead
of 828 for bls12-381 Fr in the lanes form), in the nil flavour the dense
table; a row of a mix is reduced once where `row_reduced_once`.
`lanes_counts` and `shared_counts` count what each form issues and the
floor of the permutation, `shared_chain` the shared form's products in
sequence.

State layout: (NL, 3, n), limb axis first, lanes innermost. The three
elements are given as separate (NL, n) planes with any strides, so a state
(`state[:, i]`), a Merkle level's even and odd digests (`cur[:, 0::2]`,
`cur[:, 1::2]`) and a leaf row are all read in place; `None` is the zero
element. `adds`, where given, are added to elements 0 and 1 before the
permutation (the sponge's absorb). `lane0_only` returns element 0 alone,
(NL, n), else the whole state.

The wrappers run the plain version only when every tensor lies on the CPU;
given a CUDA tensor they launch a kernel or raise. `LAUNCHES` counts
launches of each form, `ELEMENTS` the states they ran on.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels as K
from . import limbs as L
from .hopper_field import (add_plain, matvec_table, mont_matvec_plain,
                           mont_mul_plain)

LAUNCHES = {"poseidon": 0, "poseidon_shared": 0, "poseidon_tree": 0}
ELEMENTS = {"poseidon": 0, "poseidon_shared": 0, "poseidon_tree": 0}

# states up to which `poseidon_permute_hopper` takes three threads a state:
# where that form beats the lanes form (`tools/poseidon_times.py` and
# `chip_smoke.py` time both from 64 to 2^17 states). On an H100 (700 W),
# shared against lanes in one run, round robin: 0.1421 / 0.2194 ms at 64
# states, 0.1427 / 0.2200 at 2^12, 0.1997 / 0.2210 at 2^13 (two warps on
# some sub-partitions), 0.3933 / 0.2219 at 2^14.
SHARED_MAX = 1 << 13
# states at the first level the tree form takes: on the same card, with the
# full rounds then folded at x^5, the tree from 32 states (4 warps) 0.9002
# ms and a shared launch on 64 0.1502, against the tree from 64 (7 warps)
# 1.1197 (`csrc/poseidon.cu`)
TREE_MAX = 32
_FORMS = {"lanes": (0, "poseidon"), "shared": (1, "poseidon_shared")}


def products_per_state(pp) -> int:
    """Montgomery products the textbook schedule does on a state: the
    S-boxes (by square-and-multiply on alpha's bits) and nine for every MDS
    mix."""
    sbox = pp.alpha.bit_length() - 1 + bin(pp.alpha).count("1") - 1
    rounds = len(pp.round_constants)
    lo, hi = pp.partial_rounds
    return (3 * (rounds - (hi - lo)) + (hi - lo)) * sbox + 9 * rounds


def row_reduced_once(fs) -> bool:
    """Whether a row of three products is reduced once (`csrc/field.cuh::
    mont_dot3`): where R = 2^(16 NL) is a whole number of 32-bit words (NL
    even) and p < R/2, so that the row's sum reduces below 2.5p. Elsewhere
    (R splits a word, or p fills its top word) each product is reduced.
    `FieldShape`'s `half_top` and `full_top` encode the same rule by the
    word count of the fields the kernels are built for."""
    return fs.nl % 2 == 0 and 2 * fs.p < 1 << (16 * fs.nl)


def lanes_counts(pp) -> dict:
    """What a state's permutation costs, in 32-bit multiply-add
    instructions by the count `chip_smoke.py::mont_ops` uses (a word
    product two, a reduction 2 NW^2 + 2 NW; a general product with its
    reduction 2 NW (2 NW + 1), 272 at NW = 8):

    - `instructions`: what the lanes form issues. Original flavour: full
      rounds with three S-boxes and three dense rows, partial rounds with
      one S-box, one row of three and two single products (the sparse
      matrix); the nil flavour dense. Squarings are general products; a
      row of three is reduced once where `row_reduced_once`, else each
      product is.
    - `floor_instructions`: what the function needs at least, the bound of
      every form: the same schedule with a squaring at NW (NW + 1) (its
      NW (NW + 1) / 2 word products) and one reduction a row in every
      field.
    - `textbook_instructions`: the textbook schedule (`products_per_state`,
      every product reduced)."""
    nw = K.words(pp.fs.nl)
    squares = pp.alpha.bit_length() - 1
    sbox = squares + bin(pp.alpha).count("1") - 1
    lo, hi = pp.partial_rounds
    partial = hi - lo
    full = len(pp.round_constants) - partial
    products = full * (3 * sbox + 9) + partial * (sbox + 5)
    squarings = (3 * full + partial) * squares
    rows = full * (3 * sbox + 3) + partial * (sbox + 3)
    reductions = rows if row_reduced_once(pp.fs) else products
    reduce = 2 * nw * nw + 2 * nw
    return {"products": products, "squarings": squarings,
            "reductions": reductions,
            "instructions": products * 2 * nw * nw + reductions * reduce,
            "floor_instructions": (products - squarings) * 2 * nw * nw
            + squarings * nw * (nw + 1) + rows * reduce,
            "textbook_products": products_per_state(pp),
            "textbook_instructions": products_per_state(pp)
            * 2 * nw * (2 * nw + 1)}


def sbox_split(alpha: int) -> tuple[int, int]:
    """(K, REST) with alpha = 2^K + REST, REST 1 or 3 (`csrc/poseidon.cu::
    SboxSplit`): x^5 = x^4 x, x^7 = x^4 x^3, x^11 = x^8 x^3. The shared
    forms' partial rounds fold a mix constant m into the last factor,
    m x^alpha = x^(2^K) (m x^REST)."""
    k = alpha.bit_length() - 1
    rest = alpha - (1 << k)
    if rest not in (1, 3):
        raise ValueError(f"poseidon: alpha {alpha} is not 2^K + 1 or 2^K + 3")
    return k, rest


def shared_chain(pp) -> int:
    """Montgomery products in sequence in a permutation by the shared and
    tree forms (three threads a state), the dot (`mont_dot3`) counted as
    one product's latency, so a lower bound: a partial round is K
    squarings and one dot, the mix constant folded into the S-box's last
    product; a full round raises its element whole, K + 1 products in
    sequence (x^3 beside the squarings where alpha = 2^K + 3), then the dot
    (`csrc/poseidon.cu::full_round_shared`). 203 for bls12-381 Fr (57 x 3 +
    8 x 4), 220 for the nil Pallas Fq set (55 full rounds x 4). The textbook
    schedule with three threads a state was 6 a round (`textbook_chain`)."""
    k, _ = sbox_split(pp.alpha)
    lo, hi = pp.partial_rounds
    full = len(pp.round_constants) - (hi - lo)
    return (hi - lo) * (k + 1) + full * (k + 2)


def shared_counts(pp) -> dict:
    """What the shared form issues a state, its three threads together, by
    the count of `lanes_counts`: in every round a thread does K + 1
    products before its dot (K + 2 where REST = 3): a full round's raise
    its element whole, a partial round's square y K times and form its
    coefficient times y^REST. A dot is three products and one reduction
    where `row_reduced_once`, else three of each. Also `chain`
    (`shared_chain`) and `textbook_chain` (6 products a round, the textbook
    schedule with three threads a state)."""
    nw = K.words(pp.fs.nl)
    k, rest = sbox_split(pp.alpha)
    rounds = len(pp.round_constants)
    before_dot = k + 1 + (rest == 3)
    dot_reductions = 1 if row_reduced_once(pp.fs) else 3
    products = 3 * rounds * (before_dot + 3)
    reductions = 3 * rounds * (before_dot + dot_reductions)
    return {"products": products, "reductions": reductions,
            "instructions": products * 2 * nw * nw
            + reductions * (2 * nw * nw + 2 * nw),
            "chain": shared_chain(pp),
            "textbook_chain": rounds * 6}


def _mat(a, b, p):
    return [[sum(a[i][k] * b[k][j] for k in range(len(b))) % p
             for j in range(len(b[0]))] for i in range(len(a))]


@functools.lru_cache(maxsize=None)
def sparse_schedule(pp):
    """The original flavour's permutation with sparse partial rounds
    (Grassi et al., the Poseidon paper, eprint 2019/458, Appendix B), in
    Python integers, equal to it on every input. Returns (full_rc, mds,
    pre, partial):

    - full_rc: the rc vector of each full round in order, the first full
      round after the partial ones carrying the constants the partial
      rounds pushed forward;
    - mds: the matrix of every full round but the last before the partial
      ones, which takes `pre` (the dense pre-sparse matrix);
    - partial: for each partial round (k, m00, w1, w2, v1, v2): add k to
      element 0, raise element 0 to alpha, then
      s0' = m00 s0 + w1 s1 + w2 s2, s1' = s1 + v1 s0, s2' = s2 + v2 s0.

    Derivation. Going back from the last partial round, the round's matrix
    N (M at first) factors as N = M'' M' with M' = diag(1, N11), which
    leaves element 0 alone and so commutes with a partial S-box, and M''
    sparse: m00 = N00, (w1, w2) = N[0][1:] N11^-1, (v1, v2) = N[1:][0]. M'
    moves into the round before, whose matrix becomes M' M; the last full
    round before the partial ones keeps it as `pre`, and each partial
    round's rc vector is carried through its M'. Then each partial round
    keeps element 0 of its constants and hands the rest, through its sparse
    matrix, on to the next round's, and the last one to the next full
    round."""
    p = pp.fs.p
    lo, hi = pp.partial_rounds
    rounds = len(pp.round_constants)
    if pp.t != 3 or not pp.rc_first or lo < 1 or (hi > lo and hi >= rounds):
        raise ValueError("sparse_schedule: the original flavour, width 3, "
                         "with full rounds before and after the partial "
                         "ones")
    mds = [[c % p for c in row] for row in pp.mds]
    rc = [[c % p for c in r] for r in pp.round_constants]
    blocks, rows = [None] * (hi - lo), [None] * (hi - lo)
    nxt = [[1, 0], [0, 1]]
    for r in reversed(range(lo, hi)):
        n = _mat([[1, 0, 0], [0] + nxt[0], [0] + nxt[1]], mds, p)
        n11 = [n[1][1:], n[2][1:]]
        det = (n11[0][0] * n11[1][1] - n11[0][1] * n11[1][0]) % p
        if det == 0:
            raise ValueError("sparse_schedule: a singular 2x2 block")
        di = pow(det, -1, p)
        inv = [[n11[1][1] * di % p, -n11[0][1] * di % p],
               [-n11[1][0] * di % p, n11[0][0] * di % p]]
        w = _mat([n[0][1:]], inv, p)[0]
        rows[r - lo] = (n[0][0], w[0], w[1], n[1][0], n[2][0])
        blocks[r - lo] = nxt = n11
    pre = _mat([[1, 0, 0], [0] + nxt[0], [0] + nxt[1]], mds, p)
    carry, partial = [0, 0, 0], []
    for r in range(lo, hi):
        a, c = blocks[r - lo], rc[r]
        v = [(c[0] + carry[0]) % p,
             (a[0][0] * c[1] + a[0][1] * c[2] + carry[1]) % p,
             (a[1][0] * c[1] + a[1][1] * c[2] + carry[2]) % p]
        m00, w1, w2, v1, v2 = rows[r - lo]
        partial.append((v[0], m00, w1, w2, v1, v2))
        carry = [(w1 * v[1] + w2 * v[2]) % p, v[1], v[2]]
    full_rc = [tuple(rc[r]) for r in range(lo)]
    full_rc += [tuple((c + d) % p for c, d in zip(rc[r], carry))
                if r == hi else tuple(rc[r]) for r in range(hi, rounds)]
    return (tuple(full_rc), tuple(map(tuple, mds)), tuple(map(tuple, pre)),
            tuple(partial))


@functools.lru_cache(maxsize=None)
def _const_digits_np(pp) -> np.ndarray:
    """(NL, rounds*3 + 9) digit planes, Montgomery form: the round constants
    rc[r][i] at r*3 + i, then the matrix M[i][j] at rounds*3 + i*3 + j."""
    fs = pp.fs
    flat = [c for rc in pp.round_constants for c in rc]
    flat += [c for row in pp.mds for c in row]
    return L.pack_ints(fs, [c % fs.p * fs.R % fs.p for c in flat])


@functools.lru_cache(maxsize=None)
def _const_digits(pp, device: str) -> torch.Tensor:
    return L.from_numpy(_const_digits_np(pp), device)


@functools.lru_cache(maxsize=None)
def _mds_table(pp, device: str) -> torch.Tensor:
    """The MDS matrix (Montgomery form) as `mont_matvec_plain` takes it."""
    rounds = len(pp.round_constants)
    digits = _const_digits_np(pp)[:, rounds * 3:].reshape(pp.fs.nl, 3, 3)
    return torch.from_numpy(matvec_table(digits.astype(np.int64))) \
        .to(device)


@functools.lru_cache(maxsize=None)
def _const_words(pp, device: str) -> torch.Tensor:
    """The dense table, the nil flavour's: (rounds*3 + 9, NW) int32, digit
    pairs fused to 32-bit words."""
    words = K.fuse_words(_const_digits_np(pp)).T
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)) \
        .to(device)


@functools.lru_cache(maxsize=None)
def _table_words(pp, device: str) -> torch.Tensor:
    """The table every form of kernel 5 stages in shared memory. Nil
    flavour: `_const_words`. Original
    flavour, `sparse_schedule`'s: the full rounds' rc vectors (3 a round),
    the matrix, the pre-sparse matrix (9 each), then (k, m00, w1, w2, v1,
    v2) for each partial round; (R_F*3 + 18 + R_P*6, NW) int32, 384 rows
    (12 KB at NW = 8) for 8 full and 57 partial rounds."""
    if not pp.rc_first:
        return _const_words(pp, device)
    full_rc, mds, pre, partial = sparse_schedule(pp)
    flat = [c for rc in full_rc for c in rc]
    flat += [c for row in mds for c in row] + [c for row in pre for c in row]
    flat += [c for row in partial for c in row]
    fs = pp.fs
    digits = L.pack_ints(fs, [c % fs.p * fs.R % fs.p for c in flat])
    words = np.ascontiguousarray(K.fuse_words(digits).T).view(np.int32)
    return torch.from_numpy(words).to(device)


def _schedule(pp, lane0_only: bool):
    lo, hi = pp.partial_rounds
    return (ctypes.c_int * 6)(len(pp.round_constants), lo, hi, pp.alpha,
                              1 if pp.rc_first else 0, 1 if lane0_only else 3)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _sbox_plain(fs, x: torch.Tensor, alpha: int) -> torch.Tensor:
    acc = x
    for bit in bin(alpha)[3:]:
        acc = mont_mul_plain(fs, acc, acc)
        if bit == "1":
            acc = mont_mul_plain(fs, acc, x)
    return acc


def poseidon_permute_plain(pp, ins, adds=(None, None),
                           lane0_only: bool = False) -> torch.Tensor:
    """The permutation composed from plain modular adds and Montgomery
    products round by round, as the reference composes it (the MDS mix's
    nine products and six adds as `mont_matvec_plain`, the same residues)."""
    fs = pp.fs
    n, device = _lanes(fs, ins, adds)
    zero = torch.zeros((fs.nl, n), dtype=torch.int32, device=device)
    elems = [zero if t is None else t for t in ins]
    for j, extra in enumerate(adds):
        if extra is not None:
            elems[j] = add_plain(fs, elems[j], extra)
    state = torch.stack(elems, dim=1)                       # (NL, 3, n)
    consts = _const_digits(pp, str(device))
    rounds = len(pp.round_constants)
    mds = _mds_table(pp, str(device))
    lo, hi = pp.partial_rounds
    for r in range(rounds):
        rc = consts[:, r * 3:r * 3 + 3, None]               # (NL, 3, 1)
        if pp.rc_first:
            state = add_plain(fs, state, rc)
        if lo <= r < hi:
            state = torch.cat([_sbox_plain(fs, state[:, 0:1], pp.alpha),
                               state[:, 1:]], dim=1)
        else:
            state = _sbox_plain(fs, state, pp.alpha)
        # out[i] = sum_j M[i][j] * state[j]: the nine products and the adds
        # as one product against M's digits and one reduction per output
        state = mont_matvec_plain(fs, mds, state)
        if not pp.rc_first:
            state = add_plain(fs, state, rc)
    return state[:, 0].contiguous() if lane0_only else state


# ---------------------------------------------------------------------------
# kernel 5
# ---------------------------------------------------------------------------

def _lanes(fs, ins, adds):
    """Number of lanes and device of the planes given; refuses what the
    kernel does not take. Pure shape work, the same on any device."""
    if len(ins) != 3 or len(adds) != 2:
        raise ValueError("poseidon: three state planes and two absorb "
                         "planes (None where absent)")
    planes = [t for t in (*ins, *adds) if t is not None]
    if not planes:
        raise ValueError("poseidon: no input plane")
    first = planes[0]
    for t in planes:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != fs.nl:
            raise TypeError("poseidon: planes are (NL, n) int32 digits")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError("poseidon: planes differ in shape or device")
    if first.shape[1] < 1:
        raise ValueError("poseidon: no lanes")
    return first.shape[1], first.device


def plane_args(ins, adds):
    """The five plane pointers {in0, in1, in2, add0, add1} (null where
    absent) and their {lane, limb} strides in int32s, as the kernel takes
    them."""
    planes = (*ins, *adds)
    ptrs = (ctypes.c_void_p * 5)(*[None if t is None else t.data_ptr()
                                   for t in planes])
    strides = (ctypes.c_longlong * 10)()
    for i, t in enumerate(planes):
        if t is not None:
            strides[2 * i], strides[2 * i + 1] = t.stride(1), t.stride(0)
    return ptrs, strides


def poseidon_permute_hopper(pp, ins, adds=(None, None),
                            lane0_only: bool = False,
                            form: str | None = None) -> torch.Tensor:
    """Kernel 5. ins: three (NL, n) planes, the state's elements (None = 0);
    adds: two planes added to elements 0 and 1 first (None = nothing).
    Returns the permuted state (NL, 3, n), or its element 0 (NL, n).
    `form` ("lanes" or "shared") names the kernel form; by default the
    shared one up to `SHARED_MAX` states, else the lanes one."""
    fs = pp.fs
    n, device = _lanes(fs, ins, adds)
    if form is None:
        form = "shared" if n <= SHARED_MAX else "lanes"
    code_form, name = _FORMS[form]
    if device.type != "cuda":
        return poseidon_permute_plain(pp, ins, adds, lane0_only)
    nw, fconsts = K.field_consts(fs)
    ptrs, strides = plane_args(ins, adds)
    out = torch.empty((fs.nl, n) if lane0_only else (fs.nl, 3, n),
                      dtype=torch.int32, device=device)
    code = K.entry("zk_poseidon_permute")(
        nw, fconsts, ptrs, strides, _schedule(pp, lane0_only),
        _table_words(pp, str(device)).data_ptr(), out.data_ptr(), n, code_form,
        K.stream_ptr())
    K.check(code, "zk_poseidon_permute")
    LAUNCHES[name] += 1
    ELEMENTS[name] += n
    return out


def _tree_states(fs, digests: torch.Tensor) -> int:
    """States at the tree form's first level; refuses what it does not
    take. Pure shape work, the same on any device."""
    if digests.dtype != torch.int32 or digests.dim() != 2 \
            or digests.shape[0] != fs.nl:
        raise TypeError("poseidon_tree: digests are (NL, 2S) int32 digits")
    s = digests.shape[1] // 2
    if s < 1 or 2 * s != digests.shape[1] or s & (s - 1) or s > TREE_MAX:
        raise ValueError(f"poseidon_tree: {digests.shape[1]} digests; the "
                         f"tree form takes 2S, S a power of two up to "
                         f"{TREE_MAX}")
    return s


def poseidon_tree_plain(pp, digests: torch.Tensor) -> list[torch.Tensor]:
    """The levels one plain permutation at a time."""
    _tree_states(pp.fs, digests)
    levels, cur = [], digests
    while cur.shape[1] > 1:
        cur = poseidon_permute_plain(pp, (cur[:, 0::2], cur[:, 1::2], None),
                                     lane0_only=True)
        levels.append(cur)
    return levels


def poseidon_tree_hopper(pp, digests: torch.Tensor) -> list[torch.Tensor]:
    """Kernel 5, tree form. digests: (NL, 2S) one Merkle level, S a power
    of two up to `TREE_MAX`. Returns the digest planes of every level above
    it, (NL, S) first and (NL, 1), the root, last, all from one launch."""
    fs = pp.fs
    s = _tree_states(fs, digests)
    if not digests.is_cuda:
        return poseidon_tree_plain(pp, digests)
    nw, fconsts = K.field_consts(fs)
    levels = [torch.empty((fs.nl, s >> lvl), dtype=torch.int32,
                          device=digests.device)
              for lvl in range(s.bit_length())]
    ptrs, strides = plane_args((digests[:, 0::2], digests[:, 1::2], None),
                               (None, None))
    outs = (ctypes.c_void_p * len(levels))(*[t.data_ptr() for t in levels])
    code = K.entry("zk_poseidon_tree")(
        nw, fconsts, ptrs, strides, _schedule(pp, True),
        _table_words(pp, str(digests.device)).data_ptr(), outs, s,
        len(levels), K.stream_ptr())
    K.check(code, "zk_poseidon_tree")
    LAUNCHES["poseidon_tree"] += 1
    ELEMENTS["poseidon_tree"] += 2 * s - 1
    return levels
