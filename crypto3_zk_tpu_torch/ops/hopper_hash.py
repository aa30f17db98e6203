"""CUDA kernel for the Poseidon permutation of a batch of states.

Kernel 5: the width-3 permutation of n independent states in ONE launch. It
has no Pallas counterpart: the JAX package composes the permutation from
elementwise field ops (`ops/poseidon.py::permute_batch`,
`ops/nil_poseidon.py::permute_batch`) and leaves the fusion to its compiler;
composed from `limbs.mont_mul` calls here it would be some 1,200 launches a
permutation. Source: `csrc/poseidon.cu`, which says what bounds each form.
A state moves 6*NL*4 bytes for about 830 Montgomery products: the
operations bound it, and on small levels their latency.

- `poseidon_permute_hopper(pp, ins, adds, lane0_only)` picks one of two
  forms by the number of states n: up to `SHARED_MAX`, three threads a
  state (`form="shared"`, 390 products in sequence instead of 828: small
  levels are bound by that latency); above, one thread a state
  (`form="lanes"`, the fewest products: large levels are bound by the
  rate). A caller may name the form.
- `poseidon_tree_hopper(pp, digests)`: a Merkle tree's last levels, from at
  most `TREE_MAX` states down to the root, in ONE launch of one block (the
  shared form with a barrier between levels); every level's digests come
  back as their own plane.

One entry serves both flavours. The parameter object `pp` carries the
schedule as data: `round_constants` (rounds x 3 ints), `mds` (3 x 3 ints),
`alpha`, `partial_rounds` (the half-open range of rounds whose S-box touches
element 0 only) and `rc_first` (True: add rc -> S-box -> MDS, the original
Poseidon; False: S-box -> MDS -> add rc, the nil flavour).

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
# where that form's shorter chain beats the one-thread form's fewer products
# (`chip_smoke.py` times both forms from 64 to 2^17 states; on an H100,
# shared against one thread: 0.189 / 0.376 ms up to 2^12, 0.262 / 0.380 at
# 2^13, 0.507 / 0.380 at 2^14, 2.970 / 2.263 at 2^17)
SHARED_MAX = 1 << 13
TREE_MAX = 64             # states at the first level the tree form takes
_FORMS = {"lanes": (0, "poseidon"), "shared": (1, "poseidon_shared")}


def products_per_state(pp) -> int:
    """Montgomery products one permutation does on a state: the S-boxes
    (by square-and-multiply on alpha's bits) and nine for every MDS mix."""
    sbox = pp.alpha.bit_length() - 1 + bin(pp.alpha).count("1") - 1
    rounds = len(pp.round_constants)
    lo, hi = pp.partial_rounds
    return (3 * (rounds - (hi - lo)) + (hi - lo)) * sbox + 9 * rounds


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
    """The table the kernel stages in shared memory: (rounds*3 + 9, NW)
    int32, digit pairs fused to 32-bit words."""
    words = K.fuse_words(_const_digits_np(pp)).T
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)) \
        .to(device)


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
        _const_words(pp, str(device)).data_ptr(), out.data_ptr(), n,
        code_form, K.stream_ptr())
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
        _const_words(pp, str(digests.device)).data_ptr(), outs, s,
        len(levels), K.stream_ptr())
    K.check(code, "zk_poseidon_tree")
    LAUNCHES["poseidon_tree"] += 1
    ELEMENTS["poseidon_tree"] += 2 * s - 1
    return levels
