"""Batched-affine Pippenger MSM.

Counterpart of `ops/msm_affine.py` of the JAX package; the contract is the
output point. The algorithm is the reference's:

- scalars are recoded into SIGNED c-bit digits (negative digits negate the
  point), halving the bucket count;
- all windows of a group flatten into one lane array keyed
  (window << c) | bucket and sort once on the device;
- bucket sums form by HALVING PASSES: each pass pairs, inside every bucket,
  the lanes of even rank with their right neighbours and adds them with the
  affine formula, all slope denominators sharing ONE batched inversion;
- the weighted bucket merge sum_b b*B_b is split b - 1 = LO*hi + lo, so the
  big grid reduces with Jacobian tree reductions and only two small
  weighted ladders remain.

What differs from the reference, and why:

- the sort is `torch.sort(stable=True)` on the int32 keys; the reference's
  bitonic network exists because its target has no fast sort;
- shapes are dynamic here, so dead lanes are dropped after the sort and
  after every pass (`_compact`, an `index_select`), each pass runs at the
  true live width, and no lane count is padded to a compile shape;
- the pass count k* is a Python int and the pass loop a Python loop;
- the batched inversion always goes through kernels 3 and 4 of
  `ops/hopper_msm.py`, recursively on the chunk totals until at most
  `hopper_msm.INV_TAIL_MAX` values are left, which kernel 3's tail inverts
  in one launch; G2 denominators are
  reduced to their Fq norms first, so the same Fq kernels invert them;
- the window width is a constructor argument (default 16 bits);
- the scalars' signed window digits and each group's pass count are cut on
  the device (`run_limbs`), whether the scalars come as host ints (`run`)
  or as a tensor already there (a KZG commitment's coefficients).

Works for G1 (FqOps) and G2 (Fq2Ops) on a = 0 curves (bls12-381,
alt_bn128). Curves with a != 0 are refused.
"""
from __future__ import annotations

import numpy as np
import torch

from . import curve as CRV
from . import hopper_msm as HM
from . import limbs as L
from ..utils.profiling import span

_DEAD = 0x7FFFFFFF      # sorts after every live (window, bucket) key
_LANES_CAP = 1 << 22    # max flattened (windows x points) lanes per group


# ---------------------------------------------------------------------------
# small tree helpers (coords are tensors for Fq, tuples of tensors for Fq2)
# ---------------------------------------------------------------------------

def _tmap(f, *xs):
    if isinstance(xs[0], tuple):
        return tuple(_tmap(f, *parts) for parts in zip(*xs))
    return f(*xs)


def _take(x, idx):
    return _tmap(lambda a: a.index_select(-1, idx), x)


def _roll_left(x):
    return _tmap(lambda a: torch.roll(a, -1, dims=-1), x)


def _shape_of(t):
    if isinstance(t, tuple):
        return _shape_of(t[0])
    return tuple(t.shape[1:])


# ---------------------------------------------------------------------------
# batched inversion (`hopper_msm.batch_inverse_chunked`: kernels 3 and 4)
# ---------------------------------------------------------------------------

def _inv_batch(ops, den):
    """Batched inverse of nonzero slope denominators, generic over Fq/Fq2.
    An Fq2 value a + b*u (u^2 = -1) inverts through its norm a^2 + b^2 in
    Fq: (a - b*u) / norm."""
    if isinstance(ops, CRV.Fq2Ops):
        a, b = den
        fs = ops.fs
        norm = L.add(fs, L.mont_mul(fs, a, a), L.mont_mul(fs, b, b))
        ninv = HM.batch_inverse_chunked(fs, norm)
        return (L.mont_mul(fs, a, ninv),
                L.mont_mul(fs, L.neg(fs, b), ninv))
    return HM.batch_inverse_chunked(ops.fs, den)


# ---------------------------------------------------------------------------
# affine pair combine (shared-inversion add, branch-free edge handling)
# ---------------------------------------------------------------------------

def _pair_denominator(ops, A, B):
    """Denominator of the affine chord/tangent slope for A+B, with 1
    selected into lanes whose inverse is unused (infinity operands,
    P + (-P) cancellations). Returns (den, aux) for `_pair_combine`."""
    ax, ay, ainf = A
    bx, by, binf = B
    dx = ops.sub(bx, ax)
    dy = ops.sub(by, ay)
    x_eq = ops.is_zero(dx)
    y_eq = ops.is_zero(dy)
    dbl = x_eq & y_eq
    vanish = x_eq & ~y_eq
    den = ops.select(dbl, ops.dbl(ay), dx)
    unused = ainf | binf | vanish
    den = ops.select(unused, ops.ones(_shape_of(ax)), den)
    return den, (dy, dbl, vanish)


def _pair_combine(ops, A, B, inv_den, aux):
    """A + B given the batched inverse of the slope denominator.
    4 muls/lane (a = 0 curves: tangent numerator 3x^2)."""
    ax, ay, ainf = A
    bx, by, binf = B
    dy, dbl, vanish = aux
    x2 = ops.sqr(ax)
    num = ops.select(dbl, ops.add(ops.dbl(x2), x2), dy)
    lam = ops.mul(num, inv_den)
    x3 = ops.sub(ops.sub(ops.sqr(lam), ax), bx)
    y3 = ops.sub(ops.mul(lam, ops.sub(ax, x3)), ay)
    both = ainf & binf
    live_pair = ~ainf & ~binf
    rx = ops.select(ainf, bx, ops.select(binf | vanish, ax, x3))
    ry = ops.select(ainf, by, ops.select(binf | vanish, ay, y3))
    rinf = both | (vanish & live_pair)
    return (rx, ry, rinf)


# ---------------------------------------------------------------------------
# ranks, halving pass, compaction
# ---------------------------------------------------------------------------

def _ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Position of every lane inside its run of equal keys: its index less
    the index of its key's first lane, by a binary search of the sorted
    keys (a running maximum of the run heads took a sixth of a KZG prove's
    device time)."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=sorted_keys.device)
    return idx - torch.searchsorted(sorted_keys, sorted_keys)


def _halving_pass(ops, x, y, keys):
    """One halving pass over bucket-sorted lanes: inside every bucket the
    lane of even rank (the leader) takes in its right neighbour with the
    shared-inversion affine add. Returns (x, y, alive): leaders hold the
    sums, consumed partners and cancelled pairs (P + -P) are no longer
    alive. A bucket of m lanes holds at most ceil(m/2) afterwards."""
    size = keys.shape[0]
    dead = keys == _DEAD
    rank = _ranks(keys)
    pkeys = torch.roll(keys, -1)
    pkeys[size - 1] = _DEAD                     # the last lane has no partner
    leader = (keys == pkeys) & ~dead & ((rank & 1) == 0)

    A = (x, y, dead)
    B = (_roll_left(x), _roll_left(y), ~leader)  # non-leaders add infinity
    den, aux = _pair_denominator(ops, A, B)
    inv_den = _inv_batch(ops, den)
    rx, ry, rinf = _pair_combine(ops, A, B, inv_den, aux)

    new_x = ops.select(leader, rx, x)
    new_y = ops.select(leader, ry, y)
    consumed = torch.roll(leader, 1)
    consumed[0] = False
    alive = ~(consumed | torch.where(leader, rinf, dead))
    return new_x, new_y, alive


def _compact(x, y, keys, alive):
    """Keep the alive lanes, in order. Bucket runs stay contiguous."""
    idx = torch.nonzero(alive).squeeze(1)
    return _take(x, idx), _take(y, idx), keys.index_select(0, idx)


# ---------------------------------------------------------------------------
# digit recode and pass counts (host, numpy)
# ---------------------------------------------------------------------------

def n_windows(bits: int, c: int) -> int:
    """Windows of c bits covering a `bits`-bit scalar so that the top
    window, which stays unsigned and absorbs the last carry, holds at most
    2^(c-1)."""
    w = -(-bits // c)
    if bits - (w - 1) * c > c - 1:
        w += 1
    return w


def window_digits_np(limbs: np.ndarray, c: int, windows: int) -> np.ndarray:
    """(NL, N) 16-bit scalar digits -> (windows, N) int32 unsigned c-bit
    digits (little-endian windows)."""
    nl, n = limbs.shape
    if c == 16:
        out = np.zeros((windows, n), np.int32)
        out[:min(nl, windows)] = limbs[:windows]
        return out
    assert c < 31
    raw = np.ascontiguousarray(limbs.astype("<u2").T)            # (N, NL)
    bits = np.unpackbits(raw.view(np.uint8), axis=1, bitorder="little")
    need = windows * c
    if bits.shape[1] < need:
        bits = np.pad(bits, ((0, 0), (0, need - bits.shape[1])))
    bits = bits[:, :need].reshape(n, windows, c).astype(np.int32)
    return np.ascontiguousarray((bits << np.arange(c, dtype=np.int32))
                                .sum(axis=2, dtype=np.int32).T)


def _window_digits_dev(limbs: torch.Tensor, c: int,
                       windows: int) -> torch.Tensor:
    """`window_digits_np` on the device: (NL, N) 16-bit digits -> (windows,
    N) int32 unsigned c-bit digits. A window of at most 16 bits spans at
    most two digits."""
    nl, n = limbs.shape
    x = torch.cat([limbs.to(torch.int64),
                   torch.zeros((2, n), dtype=torch.int64,
                               device=limbs.device)])
    mask = (1 << c) - 1
    rows = []
    for w in range(windows):
        j, s = divmod(w * c, 16)
        if j >= nl:
            rows.append(torch.zeros_like(x[0]))
        else:
            rows.append(((x[j] | (x[j + 1] << 16)) >> s) & mask)
    return torch.stack(rows).to(torch.int32)


def _signed_digits_dev(digits: torch.Tensor, c: int) -> torch.Tensor:
    """Signed digits in [-2^(c-1), 2^(c-1)] from (windows, N) unsigned
    c-bit digits, the carry rippling upward window by window; the top
    window keeps its (small) unsigned value so no carry escapes."""
    out = digits.clone()
    half, full = 1 << (c - 1), 1 << c
    for w in range(out.shape[0] - 1):
        hot = (out[w] >= half).to(out.dtype)
        out[w] -= hot * full
        out[w + 1] += hot
    return out


def _pass_maxima_dev(sdig: torch.Tensor, g_cnt: int, wg: int,
                     c: int) -> torch.Tensor:
    """Each group's largest bucket multiplicity over its (window, |digit|)
    keys, on the device: the group needs ceil(log2) of it halving passes."""
    _, n = sdig.shape
    bucket = sdig.abs().to(torch.int64).reshape(g_cnt, wg, n)
    wloc = torch.arange(g_cnt * wg, dtype=torch.int64,
                        device=sdig.device).reshape(g_cnt, wg, 1)
    span = wg << c
    key = torch.where(bucket != 0, (wloc << c) | bucket, g_cnt * span)
    bc = torch.bincount(key.reshape(-1), minlength=g_cnt * span + 1)
    return bc[:g_cnt * span].reshape(g_cnt, span).amax(dim=1)


def _window_grouping(w: int, n: int) -> tuple[int, int]:
    """(n_groups, windows_per_group): flatten as many windows as fit the
    lane cap; wg always divides w."""
    wg = max(1, min(w, _LANES_CAP // max(n, 1)))
    while w % wg:
        wg -= 1
    return w // wg, wg


# ---------------------------------------------------------------------------
# bucket-grid merge: sum_b b*B_b with b-1 = LO*hi + lo
# ---------------------------------------------------------------------------

def _slice_axis(P, axis: int, lo: int, hi: int):
    return tuple(_tmap(lambda a: a.narrow(axis, lo, hi - lo), c) for c in P)


def _jac_reduce_axis(ops, P, axis_len: int, axis: int):
    """Sum a Jacobian point array along NEGATIVE `axis` (a power-of-two
    length) by halving: each level adds the upper half onto the lower one.
    Returns the array with that axis removed."""
    assert axis < 0 and axis_len & (axis_len - 1) == 0
    while axis_len > 1:
        half = axis_len // 2
        P = CRV.jac_add(ops, _slice_axis(P, axis, 0, half),
                        _slice_axis(P, axis, half, axis_len))
        axis_len = half
    return tuple(_tmap(lambda a: a.squeeze(axis), c) for c in P)


def _jac_weighted_sum(ops, P, weights, nbits: int):
    """sum_i w_i * P_i along the LAST axis (static int `weights`): per-lane
    double-and-add ladder (nbits steps of one jac_double and one jac_add)
    followed by one `_jac_reduce_axis`."""
    x, y, z = P
    n = len(weights)
    shape = _shape_of(x)
    wb = torch.as_tensor(np.asarray(weights, np.int32), device=ops.device)
    acc = CRV.inf_point(ops, shape)
    zero = ops.zeros(shape)
    for b in range(nbits):
        acc = CRV.jac_double(ops, acc)
        bit = (((wb >> (nbits - 1 - b)) & 1) == 1).expand(shape)
        acc = CRV.jac_add(ops, acc, (x, y, ops.select(bit, z, zero)))
    n2 = 1 << (n - 1).bit_length() if n > 1 else 1
    assert n2 == n
    return _jac_reduce_axis(ops, acc, n, -1)


def _grid_merge(ops, G, grid_hi: int, grid_lo: int):
    """(wg, HI, LO) affine grid + inf flags -> per-window Jacobian total
    sum_b b*B_b, where slot (hi, lo) holds bucket b = LO*hi + lo + 1:

        sum_b b*B_b = LO * sum_hi hi*C_hi + sum_lo (lo+1)*D_lo

    with C_hi = sum_lo B[hi, .] and D_lo = sum_hi B[., lo] the grid
    marginals (Jacobian tree reductions over the full grid); the weighted
    sums then run on the small marginals as ladders."""
    gx, gy, ginf = G
    shape = _shape_of(gx)
    z = ops.select(ginf, ops.zeros(shape), ops.ones(shape))
    P = (gx, gy, z)
    C = _jac_reduce_axis(ops, P, grid_lo, -1)                # (wg, HI)
    D = _jac_reduce_axis(ops, P, grid_hi, -2)                # (wg, LO)
    SD = _jac_weighted_sum(ops, D, np.arange(1, grid_lo + 1),
                           grid_lo.bit_length())
    if grid_hi == 1:                                         # hi = 0 only
        return SD
    SC = _jac_weighted_sum(ops, C, np.arange(grid_hi),
                           (grid_hi - 1).bit_length())       # sum hi*C_hi
    for _ in range(grid_lo.bit_length() - 1):                # x LO
        SC = CRV.jac_double(ops, SC)
    return CRV.jac_add(ops, SC, SD)                          # (NL, wg)


# ---------------------------------------------------------------------------
# one group of windows
# ---------------------------------------------------------------------------

def _msm_group(ops, coords, sw: torch.Tensor, k_star: int, c: int):
    """coords: (X, Y, Yneg) affine Montgomery digit planes, batch n.
    sw: (wg, n) int32 signed digits of the group's windows. Returns the
    per-window Jacobian totals, coords of shape (NL, wg)."""
    X, Y, Yneg = coords
    wg, n = sw.shape
    size0 = wg * n
    dev = sw.device
    wgrid = 1 << (c - 1)                       # slots per window: bucket - 1
    grid_lo = 1 << (c // 2)
    grid_hi = wgrid // grid_lo

    bucket = sw.abs()
    wloc = torch.arange(wg, dtype=torch.int32, device=dev)[:, None]
    key = torch.where(bucket == 0, _DEAD, (wloc << c) | bucket) \
        .reshape(size0)
    keys, perm = torch.sort(key, stable=True)
    n_live = int((keys != _DEAD).sum().item())  # zero digits sort last
    keys = keys[:n_live]
    perm = perm[:n_live]
    pid = perm % n                              # point index
    neg = (sw.reshape(size0) < 0).index_select(0, perm)
    YY = _tmap(lambda a, b: torch.cat([a, b], dim=-1), Y, Yneg)
    x = _take(X, pid)
    y = _take(YY, pid + n * neg.to(pid.dtype))
    del key, perm, pid, neg, YY, bucket         # sort temporaries

    for _ in range(k_star):
        if keys.shape[0] == 0:
            break
        x, y, alive = _halving_pass(ops, x, y, keys)
        x, y, keys = _compact(x, y, keys, alive)

    # dense (window, hi, lo) grid scatter: every bucket's total now sits on
    # its one live lane; bucket b of window w -> slot w*wgrid + (b-1). No
    # slot is written twice, which the rank check below confirms.
    if keys.shape[0] and int(_ranks(keys).max().item()) != 0:
        raise RuntimeError("MSM halving passes left a bucket unreduced")
    tgt = ((keys >> c) * wgrid + ((keys & ((1 << c) - 1)) - 1)).to(torch.int64)

    def scatter(src):
        grid = torch.zeros(src.shape[:-1] + (wg * wgrid,), dtype=src.dtype,
                           device=dev)
        grid.index_copy_(-1, tgt, src)
        return grid.reshape(src.shape[:-1] + (wg, grid_hi, grid_lo))

    gx = _tmap(scatter, x)
    gy = _tmap(scatter, y)
    ginf = torch.ones(wg * wgrid, dtype=torch.bool, device=dev)
    ginf[tgt] = False
    ginf = ginf.reshape(wg, grid_hi, grid_lo)
    return _grid_merge(ops, (gx, gy, ginf), grid_hi, grid_lo)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------

def _check_bases(curve, window_bits: int) -> None:
    if getattr(curve, "a", 0) != 0:
        raise ValueError(f"{curve.name}: the device MSM's point "
                         f"formulas hold for a = 0 curves only")
    if not 2 <= window_bits <= 16:
        raise ValueError("window_bits must lie in [2, 16]")


class MSMBases:
    """Device-resident encoded bases, reusable across MSMs (Groth16 proving
    keys issue many MSMs over the same query vectors; a KZG commitment key
    serves every commitment of a proof).

    `window_bits`: the Pippenger window width c (signed digits, 2^(c-1)
    buckets per window). `device`: where the bases live and the MSM runs;
    the default is the card. An MSM of m scalars runs over the first m
    bases only."""

    def __init__(self, curve, points_affine, group: str = "g1",
                 window_bits: int = 16, device=None):
        _check_bases(curve, window_bits)
        ops = CRV.FqOps(curve.fq, device) if group == "g1" \
            else CRV.Fq2Ops(curve.fq, device)
        # infinity bases (e.g. [0]G entries of a Groth16 A_query) carry no
        # contribution: their coordinates are zeros that are never read,
        # and their scalars are forced to zero at run() time; zero digits
        # never become lanes.
        zero = 0 if group == "g1" else (0, 0)
        self._setup(curve, group, window_bits,
                    ops.encode([zero if pt is None else pt[0]
                                for pt in points_affine]),
                    ops.encode([zero if pt is None else pt[1]
                                for pt in points_affine]),
                    torch.tensor([pt is None for pt in points_affine],
                                 dtype=torch.bool, device=ops.device))

    @classmethod
    def from_affine(cls, curve, x, y, inf, group: str = "g1",
                    window_bits: int = 16) -> "MSMBases":
        """Bases that lie on a device already, as Montgomery affine
        coordinates (G2: (c0, c1) pairs) and an infinity mask; no host
        round trip. The coordinates of infinity bases are never read."""
        out = cls.__new__(cls)
        out._setup(curve, group, window_bits, x, y, inf)
        return out

    def _setup(self, curve, group, window_bits, x, y, inf):
        _check_bases(curve, window_bits)
        self.curve, self.group, self.c = curve, group, window_bits
        xs = x if group == "g1" else x[0]
        self.n = xs.shape[-1]
        self.ops = CRV.FqOps(curve.fq, xs.device) if group == "g1" \
            else CRV.Fq2Ops(curve.fq, xs.device)
        self.device = self.ops.device
        self._inf_pos = torch.nonzero(inf).reshape(-1).cpu().numpy()
        self.X, self.Y = x, y
        self.Yneg = self.ops.neg(y)

    def run(self, scalars: list[int]):
        """sum_i scalars[i] * bases[i] as a host affine point (None =
        infinity), for at most as many scalars as bases (`run_limbs` of
        their digits)."""
        if not scalars:
            return None
        return self.run_limbs(
            L.encode_canonical(self.curve.fr, scalars, self.device))

    def run_limbs(self, limbs: torch.Tensor):
        """The MSM of scalars that lie on the bases' device as canonical
        (not Montgomery) 16-bit digits (NL, m), over the first m bases: the
        signed window digits are cut on the device, and the one transfer is
        each group's largest bucket multiplicity (all 0 only for scalars
        that are all 0)."""
        totals = self.window_totals(limbs)
        if totals is None:
            return None
        return _combine_windows(self.curve, self.ops, totals, self.group,
                                self.c)

    @property
    def windows(self) -> int:
        """The number of signed c-bit windows of a scalar."""
        return n_windows(self.curve.fr.bits, self.c)

    def window_totals(self, limbs: torch.Tensor, lo: int = 0,
                      hi: int | None = None):
        """The per-window Jacobian totals T_w = sum_b b*B_b of windows
        [lo, hi) (default all), coords of shape (NL, hi - lo), of the MSM
        of `run_limbs`; sum_w 2^(c*w) * T_w over every window is the MSM.
        The signed digits are cut over all windows (a carry crosses
        windows), then only [lo, hi) run. None when every digit of the
        range is 0 (its totals are all the identity)."""
        m = limbs.shape[-1]
        assert m <= self.n and limbs.device.type == self.device.type
        windows = self.windows
        hi = windows if hi is None else hi
        assert 0 <= lo < hi <= windows
        if m == 0:
            return None
        inf = self._inf_pos[self._inf_pos < m]
        if inf.size:
            limbs = limbs.clone()
            limbs[:, torch.from_numpy(inf).to(self.device)] = 0
        with span("zk.msm.digits"):
            sdig = _signed_digits_dev(
                _window_digits_dev(limbs, self.c, windows), self.c)[lo:hi]
            g_cnt, wg = _window_grouping(hi - lo, m)
            maxima = _pass_maxima_dev(sdig, g_cnt, wg, self.c).tolist()
        if not any(maxima):
            return None
        # halving passes a group needs: after k* passes every bucket holds
        # at most one live lane, so the grid scatter writes no slot twice
        k_stars = [(mx - 1).bit_length() if mx > 1 else 0 for mx in maxima]
        coords = tuple(_tmap(lambda a: a[..., :m], t)
                       for t in (self.X, self.Y, self.Yneg))
        totals = []
        for g in range(g_cnt):
            with span("zk.msm.group"):
                totals.append(_msm_group(self.ops, coords,
                                         sdig[g * wg:(g + 1) * wg],
                                         k_stars[g], self.c))
        return tuple(_tmap(lambda *a: torch.cat(a, dim=-1), *cs)
                     for cs in zip(*totals))


def _combine_windows(curve, ops, totals, group: str, c: int):
    """totals: per-window Jacobian coords of shape (NL, W); host Horner
    combine sum_w 2^(c*w) * T_w."""
    from ..fields import curves as CV
    with span("zk.msm.to_affine"):
        pts = CRV.to_affine_host(ops, totals)
    host_add = CV.g1_add if group == "g1" else CV.g2_add
    host_mul = CV.g1_mul if group == "g1" else CV.g2_mul
    acc = None
    with span("zk.msm.combine"):
        for w in reversed(range(len(pts))):
            if acc is not None:
                acc = host_mul(curve, acc, 1 << c)
            acc = host_add(curve, acc, pts[w])
    return acc


def msm_affine(curve, points_affine, scalars: list[int], group: str = "g1",
               window_bits: int = 16, device=None):
    """One-shot MSM over host affine points. For repeated MSMs over the same
    bases build an `MSMBases` once and call `.run`."""
    return MSMBases(curve, points_affine, group, window_bits, device) \
        .run(scalars)
