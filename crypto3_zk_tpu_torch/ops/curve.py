"""Batched elliptic-curve point arithmetic on device (Jacobian coordinates).

Counterpart of `ops/curve.py` of the JAX package, the replacement for the
scalar group math behind `algebra::multiexp` (driven from
`prover.hpp (gg):108-139`): points are structure-of-limb-plane tensors, an
element of G1 is three (NL, *batch) coordinate tensors, an element of G2
three pairs of them (Fq2 as a (c0, c1) tuple). All formulas are branch-free:
doubling/infinity edge cases are resolved with lane-wise selects. The ops
veneers carry the device their constants are made on.

Formulas (a = 0 curves): dbl-2009-l and add-2007-bl.
"""
from __future__ import annotations

from ..fields.params import FieldSpec
from . import limbs as L


class FqOps:
    """Vectorized base-field ops (thin veneer over limbs)."""

    def __init__(self, fs: FieldSpec, device=None):
        self.fs = fs
        self.device = L.resolve_device(device)

    def add(self, a, b):
        return L.add(self.fs, a, b)

    def sub(self, a, b):
        return L.sub(self.fs, a, b)

    def mul(self, a, b):
        return L.mont_mul(self.fs, a, b)

    def sqr(self, a):
        return L.mont_sqr(self.fs, a)

    def neg(self, a):
        return L.neg(self.fs, a)

    def dbl(self, a):
        return L.add(self.fs, a, a)

    def is_zero(self, a):
        return L.is_zero(self.fs, a)

    def zeros(self, shape):
        return L.zeros(self.fs, shape, self.device)

    def ones(self, shape):
        return L.ones_mont(self.fs, shape, self.device)

    def select(self, mask, a, b):
        return L.select(mask, a, b)

    def encode(self, xs):
        return L.encode(self.fs, xs, self.device)

    def decode(self, arr):
        return L.decode(self.fs, arr)

    def inv_batch(self, a):
        return L.batch_inverse(self.fs, a, axis=1)


class Fq2Ops:
    """Vectorized Fq2 ops; elements are (c0, c1) tuples of limb arrays.
    Non-residue beta = -1 (both supported curves)."""

    def __init__(self, fs: FieldSpec, device=None):
        self.fs = fs
        self.base = FqOps(fs, device)
        self.device = self.base.device

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def mul(self, a, b):
        t0 = self.base.mul(a[0], b[0])
        t1 = self.base.mul(a[1], b[1])
        t2 = self.base.mul(self.base.add(a[0], a[1]),
                           self.base.add(b[0], b[1]))
        return (self.base.sub(t0, t1),
                self.base.sub(self.base.sub(t2, t0), t1))

    def sqr(self, a):
        # (a0+a1)(a0-a1), 2 a0 a1
        t = self.base.mul(a[0], a[1])
        return (self.base.mul(self.base.add(a[0], a[1]),
                              self.base.sub(a[0], a[1])),
                self.base.dbl(t))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def dbl(self, a):
        return (self.base.dbl(a[0]), self.base.dbl(a[1]))

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def zeros(self, shape):
        return (self.base.zeros(shape), self.base.zeros(shape))

    def ones(self, shape):
        return (self.base.ones(shape), self.base.zeros(shape))

    def select(self, mask, a, b):
        return (self.base.select(mask, a[0], b[0]),
                self.base.select(mask, a[1], b[1]))

    def encode(self, xs):
        """xs: list of (c0, c1) int tuples."""
        return (self.base.encode([x[0] for x in xs]),
                self.base.encode([x[1] for x in xs]))

    def decode(self, arr):
        c0 = self.base.decode(arr[0])
        c1 = self.base.decode(arr[1])
        return list(zip(c0, c1))


# ---------------------------------------------------------------------------
# Jacobian point ops (points = (X, Y, Z) of field elements)
# ---------------------------------------------------------------------------

def inf_point(ops, shape):
    """(1, 1, 0) — Z = 0 marks infinity."""
    return (ops.ones(shape), ops.ones(shape), ops.zeros(shape))


def point_select(ops, mask, a, b):
    return tuple(ops.select(mask, ca, cb) for ca, cb in zip(a, b))


def jac_double(ops, P):
    """dbl-2009-l (a=0): 4 sqr + 3 mul."""
    X, Y, Z = P
    A = ops.sqr(X)
    B = ops.sqr(Y)
    C = ops.sqr(B)
    t = ops.sqr(ops.add(X, B))
    D = ops.dbl(ops.sub(ops.sub(t, A), C))
    E = ops.add(ops.dbl(A), A)
    F = ops.sqr(E)
    X3 = ops.sub(F, ops.dbl(D))
    eight_c = ops.dbl(ops.dbl(ops.dbl(C)))
    Y3 = ops.sub(ops.mul(E, ops.sub(D, X3)), eight_c)
    Z3 = ops.dbl(ops.mul(Y, Z))
    return (X3, Y3, Z3)


def jac_add(ops, P1, P2):
    """add-2007-bl with branch-free edge handling (infinity / equal /
    inverse operands)."""
    X1, Y1, Z1 = P1
    X2, Y2, Z2 = P2
    Z1Z1 = ops.sqr(Z1)
    Z2Z2 = ops.sqr(Z2)
    U1 = ops.mul(X1, Z2Z2)
    U2 = ops.mul(X2, Z1Z1)
    S1 = ops.mul(ops.mul(Y1, Z2), Z2Z2)
    S2 = ops.mul(ops.mul(Y2, Z1), Z1Z1)
    H = ops.sub(U2, U1)
    rr = ops.dbl(ops.sub(S2, S1))
    I = ops.sqr(ops.dbl(H))
    J = ops.mul(H, I)
    V = ops.mul(U1, I)
    X3 = ops.sub(ops.sub(ops.sqr(rr), J), ops.dbl(V))
    Y3 = ops.sub(ops.mul(rr, ops.sub(V, X3)),
                 ops.dbl(ops.mul(S1, J)))
    Z3 = ops.mul(ops.mul(Z1, Z2), ops.dbl(H))
    added = (X3, Y3, Z3)

    h_zero = ops.is_zero(H)
    r_zero = ops.is_zero(rr)
    z1_zero = ops.is_zero(Z1)
    z2_zero = ops.is_zero(Z2)

    doubled = jac_double(ops, P1)
    shape = _batch_shape(ops, X1)
    inf = inf_point(ops, shape)

    out = point_select(ops, h_zero & r_zero, doubled, added)
    out = point_select(ops, h_zero & ~r_zero, inf, out)
    out = point_select(ops, z2_zero, P1, out)
    out = point_select(ops, z1_zero, P2, out)
    return out


def _batch_shape(ops, coord):
    if isinstance(coord, tuple):
        return coord[0].shape[1:]
    return coord.shape[1:]


def jac_neg(ops, P):
    return (P[0], ops.neg(P[1]), P[2])


def to_affine_host(ops, P):
    """Decode a batch of Jacobian points to host affine tuples (None = inf)."""
    X, Y, Z = P
    xs = ops.decode(X)
    ys = ops.decode(Y)
    zs = ops.decode(Z)
    p = ops.fs.p if isinstance(ops, FqOps) else ops.base.fs.p
    out = []
    for x, y, z in zip(xs, ys, zs):
        if isinstance(ops, Fq2Ops):
            if z == (0, 0):
                out.append(None)
                continue
            from ..fields import tower as T
            zi = T.fq2_inv(p, z)
            zi2 = T.fq2_sqr(p, zi)
            zi3 = T.fq2_mul(p, zi2, zi)
            out.append((T.fq2_mul(p, x, zi2), T.fq2_mul(p, y, zi3)))
        else:
            if z == 0:
                out.append(None)
                continue
            zi = pow(z, -1, p)
            out.append((x * zi * zi % p, y * zi * zi * zi % p))
    return out
