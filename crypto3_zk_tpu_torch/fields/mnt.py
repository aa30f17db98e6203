"""MNT4-298 / MNT6-298 pairing cycle (the PCD recursion substrate).

The reference's recursive PCD (`systems/pcd/r1cs_pcd/`, SURVEY.md §2.6)
composes proofs over the MNT4/MNT6 cycle: MNT4's scalar field is MNT6's
base field and vice versa, so a verifier for one curve arithmetizes
natively over the other. This module provides the cycle's L0: the two
curves, generic GF(p^k) extension towers (k = 4, 6), group ops, and Tate
pairings with denominator elimination (both embedding degrees are even).

All parameters are SELF-VERIFIED at import/test time rather than trusted:
p and r are 298-bit primes, r | p^4 - 1 (resp. p^6 - 1) with no smaller
embedding degree, and the curves have prime order r (a random point times
r is infinity — an overwhelming-probability certificate). The G2 basis is
DERIVED, not pasted: a deterministic point of E(F_{p^k}) is cofactor-
multiplied into E[r] \\ G1 (the trace/Frobenius order count gives the
cofactor), so no unverifiable generator constants enter the codebase.

Host-side scalar math: pairings are verifier-side and latency-insensitive
(same placement choice as `fields/curves.py` for BLS/BN — SURVEY.md §2.0
pairings row).
"""
from __future__ import annotations

import dataclasses
import functools

# --- cycle parameters (prime order, a/b verified by r*P = inf) ---
MNT4_P = 475922286169261325753349249653048451545124879242694725395555128576210262817955800483758081
MNT4_R = 475922286169261325753349249653048451545124878552823515553267735739164647307408490559963137
MNT4_A = 2
MNT4_B = 423894536526684178289416011533888240029318103673896002803341544124054745019340795360841685

MNT6_P = MNT4_R
MNT6_R = MNT4_P
MNT6_A = 11
MNT6_B = 106700080510851735677967319632585352256454251201367587890185989362936000262606668469523074


# ---------------------------------------------------------------------------
# generic GF(p^k) as F_p[x] / (x^k - c)
# ---------------------------------------------------------------------------

class ExtField:
    """F_p[x]/(x^k - c) with c found by irreducibility search."""

    def __init__(self, p: int, k: int):
        self.p = p
        self.k = k
        c = 2
        while not self._binomial_irreducible(c):
            c += 1
        self.c = c

    def _binomial_irreducible(self, c: int) -> bool:
        """x^k - c irreducible over F_p: x^(p^k) = x mod f and
        gcd(x^(p^(k/l)) - x, f) = 1 for primes l | k."""
        p, k = self.p, self.k
        f = [(-c) % p] + [0] * (k - 1) + [1]

        def pm(a, b):
            res = [0] * (len(a) + len(b) - 1)
            for i, ai in enumerate(a):
                if ai:
                    for j, bj in enumerate(b):
                        res[i + j] = (res[i + j] + ai * bj) % p
            # reduce by x^k = c
            while len(res) > k:
                top = res.pop()
                res[len(res) - k] = (res[len(res) - k] + top * c) % p
            return res

        def xpow(e):
            result = [1]
            base = [0, 1]
            while e:
                if e & 1:
                    result = pm(result, base)
                base = pm(base, base)
                e >>= 1
            return result

        def trim0(x):
            x = list(x)
            while len(x) > 1 and x[-1] == 0:
                x.pop()
            return x

        if trim0(xpow(p ** k)) != [0, 1]:
            return False
        ls = {l for l in (2, 3, 5, 7) if k % l == 0}
        for l in ls:
            g = xpow(p ** (k // l))
            g = [(a - b) % p for a, b in
                 zip(g + [0] * 2, [0, 1] + [0] * len(g))][:max(len(g), 2)]
            if all(v == 0 for v in g):
                return False
            # gcd(g, f) must be 1: since f = x^k - c would only share a
            # factor if g = 0 mod an irreducible factor; cheap check: g
            # invertible mod f
            if self._poly_inv_or_none(g, f) is None:
                return False
        return True

    def _poly_inv_or_none(self, a, f):
        p = self.p

        def pdivmod(num, den):
            num = list(num)
            q = [0] * max(1, len(num) - len(den) + 1)
            dinv = pow(den[-1], -1, p)
            for i in range(len(num) - len(den), -1, -1):
                coef = num[i + len(den) - 1] * dinv % p
                q[i] = coef
                if coef:
                    for j, dj in enumerate(den):
                        num[i + j] = (num[i + j] - coef * dj) % p
            while len(num) > 1 and num[-1] == 0:
                num.pop()
            return q, num

        def trim(x):
            x = list(x)
            while len(x) > 1 and x[-1] == 0:
                x.pop()
            return x

        r0, r1 = trim(f), trim(a)
        s0, s1 = [0], [1]
        while r1 != [0]:
            q, rem = pdivmod(r0, r1)
            r0, r1 = r1, trim(rem)
            # s0 - q*s1
            qs = [0] * (len(q) + len(s1) - 1)
            for i, qi in enumerate(q):
                if qi:
                    for j, sj in enumerate(s1):
                        qs[i + j] = (qs[i + j] + qi * sj) % p
            ns = [( (s0[i] if i < len(s0) else 0) - (qs[i] if i < len(qs) else 0)) % p
                  for i in range(max(len(s0), len(qs)))]
            s0, s1 = s1, trim(ns)
        if len(r0) != 1 or r0[0] == 0:
            return None
        inv = pow(r0[0], -1, p)
        return [v * inv % p for v in s0]

    # --- element ops (tuples of length k) ---
    def zero(self):
        return (0,) * self.k

    def one(self):
        return (1,) + (0,) * (self.k - 1)

    def embed(self, v: int):
        return (v % self.p,) + (0,) * (self.k - 1)

    def add(self, a, b):
        return tuple((x + y) % self.p for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple((x - y) % self.p for x, y in zip(a, b))

    def neg(self, a):
        return tuple((-x) % self.p for x in a)

    def mul(self, a, b):
        p, k, c = self.p, self.k, self.c
        res = [0] * (2 * k - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    res[i + j] += ai * bj
        out = list(res[:k])
        for i in range(k, 2 * k - 1):
            out[i - k] += res[i] * c
        return tuple(v % p for v in out)

    def sqr(self, a):
        return self.mul(a, a)

    def smul(self, a, s: int):
        s %= self.p
        return tuple(x * s % self.p for x in a)

    def inv(self, a):
        f = [(-self.c) % self.p] + [0] * (self.k - 1) + [1]
        r = self._poly_inv_or_none(list(a), f)
        if r is None:
            raise ZeroDivisionError("not invertible")
        r = r[: self.k] + [0] * (self.k - len(r))
        return tuple(v % self.p for v in r)

    def pow(self, a, e: int):
        result = self.one()
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            base = self.sqr(base)
            e >>= 1
        return result

    def is_zero(self, a) -> bool:
        return all(v == 0 for v in a)


# ---------------------------------------------------------------------------
# curve / pairing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MNTCurve:
    name: str
    p: int
    r: int
    a: int
    b: int
    k: int                     # embedding degree

    @functools.cached_property
    def ext(self) -> ExtField:
        return ExtField(self.p, self.k)

    @functools.cached_property
    def g1(self) -> tuple[int, int]:
        """Deterministic generator: smallest x giving a curve point (prime
        order r, so every point generates)."""
        p = self.p
        x = 1
        while True:
            rhs = (x * x * x + self.a * x + self.b) % p
            if rhs == 0 or pow(rhs, (p - 1) // 2, p) == 1:
                y = _sqrt_mod(rhs, p)
                return (x, min(y, p - y))
            x += 1

    @functools.cached_property
    def order_ext(self) -> int:
        """|E(F_{p^k})| from the Frobenius trace recurrence
        (t_1 = p + 1 - r; t_{2m} = t_m^2 - 2 p^m)."""
        t1 = self.p + 1 - self.r
        # Lucas-style recurrence: t_n with t_0 = 2, t_1 = t1, s.t.
        # t_{n+1} = t1 * t_n - p * t_{n-1}
        tn_1, tn = 2, t1
        for _ in range(self.k - 1):
            tn_1, tn = tn, t1 * tn - self.p * tn_1
        return self.p ** self.k + 1 - tn

    @functools.cached_property
    def g2(self):
        """Deterministic order-r point of E(F_{p^k}) independent of G1:
        cofactor-multiply a derived point by |E(F_{p^k})| / r^2."""
        F = self.ext
        assert self.order_ext % (self.r * self.r) == 0, \
            "full r-torsion must live in the embedding field"
        cof = self.order_ext // (self.r * self.r)
        seed = 1
        while True:
            # x = (seed, 1, 0, ...): genuinely in the extension
            x = (seed % self.p, 1) + (0,) * (self.k - 2)
            rhs = F.add(F.mul(F.sqr(x), x),
                        F.add(F.smul(x, self.a), F.embed(self.b)))
            y = _ext_sqrt(F, rhs)
            if y is not None:
                q = ext_mul_scalar(self, (x, y), cof)
                if q is not None:
                    qr = ext_mul_scalar(self, q, self.r)
                    if qr is None:
                        return q
            seed += 1


def _sqrt_mod(v: int, p: int) -> int:
    """Standalone Tonelli-Shanks (no FieldSpec needed)."""
    if v == 0:
        return 0
    assert pow(v, (p - 1) // 2, p) == 1
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def _ext_sqrt(F: ExtField, v):
    """Square root in GF(p^k) via exponentiation when p^k = 3 mod 4, else
    Tonelli-Shanks over the extension (generic, slow path)."""
    if F.is_zero(v):
        return F.zero()
    n = F.p ** F.k
    if pow_is_qr(F, v, n) is False:
        return None
    if n % 4 == 3:
        cand = F.pow(v, (n + 1) // 4)
        return cand if F.mul(cand, cand) == v else None
    # Tonelli-Shanks in the extension group
    q, s = n - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue
    z = (2, 1) + (0,) * (F.k - 2)
    while F.pow(z, (n - 1) // 2) == F.one():
        z = (z[0] + 1,) + z[1:]
    m, c = s, F.pow(z, q)
    t, r = F.pow(v, q), F.pow(v, (q + 1) // 2)
    while t != F.one():
        i, tt = 0, t
        while tt != F.one():
            tt = F.sqr(tt)
            i += 1
            if i == m:
                return None
        b = c
        for _ in range(m - i - 1):
            b = F.sqr(b)
        m, c = i, F.sqr(b)
        t, r = F.mul(t, F.sqr(b)), F.mul(r, b)
    return r


def pow_is_qr(F: ExtField, v, n: int) -> bool:
    return F.pow(v, (n - 1) // 2) == F.one()


# --- E(F_{p^k}) affine ops (None = infinity) ---

def ext_add(curve: MNTCurve, P, Q):
    F = curve.ext
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if F.is_zero(F.add(y1, y2)):
            return None
        num = F.add(F.smul(F.sqr(x1), 3), F.embed(curve.a))
        den = F.smul(y1, 2)
    else:
        num = F.sub(y2, y1)
        den = F.sub(x2, x1)
    lam = F.mul(num, F.inv(den))
    x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def ext_mul_scalar(curve: MNTCurve, P, k: int):
    R = None
    while k:
        if k & 1:
            R = ext_add(curve, R, P)
        P = ext_add(curve, P, P)
        k >>= 1
    return R


def g1_to_ext(curve: MNTCurve, P):
    if P is None:
        return None
    F = curve.ext
    return (F.embed(P[0]), F.embed(P[1]))


def g1_add(curve: MNTCurve, P, Q):
    p = curve.p
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + curve.a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return (x3, (lam * (x1 - x3) - y1) % p)


def g1_mul(curve: MNTCurve, P, k: int):
    R = None
    while k:
        if k & 1:
            R = g1_add(curve, R, P)
        P = g1_add(curve, P, P)
        k >>= 1
    return R


# --- Tate pairing with denominator elimination (k even) ---

def tate_pairing(curve: MNTCurve, P, Q):
    """e(P, Q) for P in G1 (F_p coords), Q in E(F_{p^k})[r]. Textbook
    Miller loop over the bits of r with numerator/denominator accumulated
    separately (one extension inversion total — Q is a GENERAL embedding-
    field point here, so the subfield denominator-elimination shortcut of
    `fields/curves.py` does not apply), then the full (p^k - 1)/r power."""
    F = curve.ext
    if P is None or Q is None:
        return F.one()
    p = curve.p
    xq, yq = Q

    def line(T, U):
        """(numerator, denominator) update for the chord/tangent at T,U
        evaluated at Q: l_{T,U}(Q) and the vertical v_{T+U}(Q)."""
        x1, y1 = T
        x2, y2 = U
        if x1 == x2 and (y1 + y2) % p == 0:
            return F.sub(xq, F.embed(x1)), F.one()   # vertical chord
        if T == U:
            lam = (3 * x1 * x1 + curve.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        l = F.sub(F.sub(yq, F.embed(y1)),
                  F.smul(F.sub(xq, F.embed(x1)), lam))
        S = g1_add(curve, T, U)
        v = F.one() if S is None else F.sub(xq, F.embed(S[0]))
        return l, v

    fn, fd = F.one(), F.one()
    T = (P[0], P[1])
    for bit in bin(curve.r)[3:]:
        l, v = line(T, T)
        fn = F.mul(F.sqr(fn), l)
        fd = F.mul(F.sqr(fd), v)
        T = g1_add(curve, T, T)
        if bit == "1":
            l, v = line(T, (P[0], P[1]))
            fn = F.mul(fn, l)
            fd = F.mul(fd, v)
            T = g1_add(curve, T, P)
    f = F.mul(fn, F.inv(fd))
    return F.pow(f, (p ** curve.k - 1) // curve.r)


MNT4 = MNTCurve("mnt4_298", MNT4_P, MNT4_R, MNT4_A, MNT4_B, 4)
MNT6 = MNTCurve("mnt6_298", MNT6_P, MNT6_R, MNT6_A, MNT6_B, 6)


# ---------------------------------------------------------------------------
# CurveSpec-compatible surface (duck-typed for models/groth16 et al.)
# ---------------------------------------------------------------------------

def _curve_fields(curve: MNTCurve):
    from . import params as P
    if curve.name.startswith("mnt4"):
        return P.MNT4_FR, P.MNT6_FR      # fr = r-side, fq = p-side
    return P.MNT6_FR, P.MNT4_FR


def curve_fr(curve: MNTCurve):
    return _curve_fields(curve)[0]


def curve_fq(curve: MNTCurve):
    return _curve_fields(curve)[1]


# bind as properties so vk.curve.fr works exactly like CurveSpec
MNTCurve.fr = property(lambda self: curve_fr(self))
MNTCurve.fq = property(lambda self: curve_fq(self))


def g1_neg(curve: MNTCurve, P):
    if P is None:
        return None
    return (P[0], (-P[1]) % curve.p)


def g2_add(curve: MNTCurve, P, Q):
    return ext_add(curve, P, Q)


def g2_neg(curve: MNTCurve, Q):
    if Q is None:
        return None
    return (Q[0], curve.ext.neg(Q[1]))


def g2_mul(curve: MNTCurve, Q, k: int):
    return ext_mul_scalar(curve, Q, k)


def pairing(curve: MNTCurve, P, Q):
    return tate_pairing(curve, P, Q)


def multi_pairing(curve: MNTCurve, pairs):
    """prod e(P_i, Q_i). No shared-final-exponentiation shortcut (host,
    verifier-side; the BLS/BN path in `fields/curves.py` has the optimized
    variant)."""
    F = curve.ext
    out = F.one()
    for P, Q in pairs:
        out = F.mul(out, tate_pairing(curve, P, Q))
    return out
