"""Elliptic curve specs, host-side group arithmetic, and pairings.

Role split per SURVEY.md §2.0: host scalar group ops + Miller loop / final
exponentiation serve verifiers and key generation
(`verifier.hpp (gg):168-183`, `kzg.hpp:195-206`); the batched device point
kernels live in `ops/curve.py` / `ops/msm.py`.

Pairing: Tate pairing with denominator elimination, computed uniformly for
both curves — the Miller loop runs over the r-bits with P in G1(Fq), lines
evaluated at the untwisted Q in Fq12 (untwist: D-twist (x w^2, y w^3),
M-twist (x w^-2, y w^-3)). Correctness is checked by bilinearity tests, not
speed: verification is host-side and latency-insensitive here.
"""
from __future__ import annotations

import dataclasses
import functools

from . import params as FP
from . import tower as T


def _is_mnt(c) -> bool:
    """Duck dispatch: the MNT4/MNT6 PCD cycle (`fields/mnt.py`) plugs into
    the same g1/g2/pairing entry points the SNARK models call."""
    from . import mnt as _m
    return isinstance(c, _m.MNTCurve)


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    name: str
    fq: FP.FieldSpec
    fr: FP.FieldSpec
    b: int                       # E: y^2 = x^3 + b
    g1: tuple[int, int]
    xi: tuple[int, int]          # Fq6 non-residue in Fq2
    twist: str                   # "M" or "D"
    b2: tuple[tuple[int, int], tuple[int, int]] | None  # unused; from b/xi
    g2: tuple[tuple[int, int], tuple[int, int]]
    cofactor_g1: int = 1
    # optimal-ate parameters: loop count |t| (0 = fall back to Tate),
    # whether the curve parameter is negative (BLS12-381: z < 0 => conjugate
    # the Miller value), and whether the BN two-Frobenius tail steps apply
    ate_loop: int = 0
    ate_is_negative: bool = False
    ate_bn_tail: bool = False
    # BLS12 production implementations (crypto3-algebra, bellperson, blst)
    # use the Hayashida-et-al. hard part, whose exponent is 3*(p^4-p^2+1)/r
    # — the canonical reduced value CUBED (gcd(3, r) = 1, still a perfect
    # pairing). Pinned by the bellperson ipp2 vectors in test_conformance.
    final_exp_factor: int = 1

    @functools.cached_property
    def final_exp(self) -> int:
        p = self.fq.p
        return self.final_exp_factor * ((p ** 12 - 1) // self.fr.p)

    def __hash__(self):
        return hash(self.name)


BLS12_381 = CurveSpec(
    name="bls12_381",
    fq=FP.BLS12_381_FQ,
    fr=FP.BLS12_381_FR,
    b=4,
    g1=(
        0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    ),
    xi=(1, 1),        # 1 + u
    twist="M",
    ate_loop=0xD201000000010000,     # |z|, z = -0xd201000000010000
    ate_is_negative=True,
    final_exp_factor=3,
    b2=None,
    g2=(
        (
            0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
            0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
        ),
        (
            0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
            0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
        ),
    ),
    cofactor_g1=0x396C8C005555E1568C00AAAB0000AAAB,
)

ALT_BN128 = CurveSpec(
    name="alt_bn128",
    fq=FP.ALT_BN128_FQ,
    fr=FP.ALT_BN128_FR,
    b=3,
    g1=(1, 2),
    xi=(9, 1),        # 9 + u
    twist="D",
    ate_loop=6 * 4965661367192848881 + 2,    # 6z + 2, z > 0
    ate_bn_tail=True,
    b2=None,
    g2=(
        (
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        (
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    ),
)

CURVES = {c.name: c for c in (BLS12_381, ALT_BN128)}


# ---------------------------------------------------------------------------
# host G1 (affine with infinity = None)
# ---------------------------------------------------------------------------

def g1_is_on_curve(c: CurveSpec, pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    p = c.fq.p
    return (y * y - x * x * x - c.b) % p == 0


def _jac_double_a0(p: int, X: int, Y: int, Z: int):
    """2 * (X : Y : Z) in Jacobian coordinates on a = 0 curves
    (dbl-2009-l); Z = 0 stays infinity."""
    A = X * X % p
    B = Y * Y % p
    C = B * B % p
    D = 2 * ((X + B) * (X + B) - A - C) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    return X3, (E * (D - X3) - 8 * C) % p, 2 * Y * Z % p


def _ladder_g1(p: int, a, k: int):
    """k * a on a short Weierstrass curve with a = 0 over F_p, k >= 0 not
    reduced: left-to-right double-and-add with a Jacobian accumulator and
    the affine point as the addend (mixed addition), one inversion at the
    end. The same point as the affine ladder, without an inversion a
    step."""
    if a is None or k == 0:
        return None
    x, y = a
    X, Y, Z = x, y, 1
    for bit in bin(k)[3:]:
        X, Y, Z = _jac_double_a0(p, X, Y, Z)
        if bit != "1":
            continue
        if Z == 0:
            X, Y, Z = x, y, 1
            continue
        Z1Z1 = Z * Z % p
        H = (x * Z1Z1 - X) % p
        r = (y * Z * Z1Z1 - Y) % p
        if H == 0:
            if r == 0:                       # the accumulator is a itself
                X, Y, Z = _jac_double_a0(p, X, Y, Z)
            else:                            # a + (-a)
                X, Y, Z = 1, 1, 0
            continue
        HH = H * H % p
        HHH = H * HH % p
        V = X * HH % p
        X3 = (r * r - HHH - 2 * V) % p
        X, Y, Z = X3, (r * (V - X3) - Y * HHH) % p, Z * H % p
    if Z == 0:
        return None
    zi = pow(Z, -1, p)
    zi2 = zi * zi % p
    return (X * zi2 % p, Y * zi2 * zi % p)


def _mul_raw_g1(c: CurveSpec, a, k: int):
    """Scalar mul WITHOUT reducing k mod r (g1_mul reduces, which would make
    the r*P subgroup test vacuous)."""
    if _is_mnt(c):
        out = None
        add = a
        while k:
            if k & 1:
                out = g1_add(c, out, add)
            add = g1_add(c, add, add)
            k >>= 1
        return out
    return _ladder_g1(c.fq.p, a, k)


def _ladder_g2(p: int, a, k: int):
    """`_ladder_g1` over Fq2 (the a = 0 twist; neither formula reads b)."""
    if a is None or k == 0:
        return None
    add, sub, mul, sqr = T.fq2_add, T.fq2_sub, T.fq2_mul, T.fq2_sqr
    zero = T.FQ2_ZERO

    def double(X, Y, Z):
        A = sqr(p, X)
        B = sqr(p, Y)
        C = sqr(p, B)
        XB = add(p, X, B)
        D = T.fq2_scalar(p, sub(p, sub(p, sqr(p, XB), A), C), 2)
        E = T.fq2_scalar(p, A, 3)
        X3 = sub(p, sqr(p, E), T.fq2_scalar(p, D, 2))
        Y3 = sub(p, mul(p, E, sub(p, D, X3)), T.fq2_scalar(p, C, 8))
        return X3, Y3, T.fq2_scalar(p, mul(p, Y, Z), 2)

    x, y = a
    one = (1, 0)
    X, Y, Z = x, y, one
    for bit in bin(k)[3:]:
        X, Y, Z = double(X, Y, Z)
        if bit != "1":
            continue
        if Z == zero:
            X, Y, Z = x, y, one
            continue
        Z1Z1 = sqr(p, Z)
        H = sub(p, mul(p, x, Z1Z1), X)
        r = sub(p, mul(p, y, mul(p, Z, Z1Z1)), Y)
        if H == zero:
            if r == zero:
                X, Y, Z = double(X, Y, Z)
            else:
                X, Y, Z = one, one, zero
            continue
        HH = sqr(p, H)
        HHH = mul(p, H, HH)
        V = mul(p, X, HH)
        X3 = sub(p, sub(p, sqr(p, r), HHH), T.fq2_scalar(p, V, 2))
        X, Y, Z = X3, sub(p, mul(p, r, sub(p, V, X3)), mul(p, Y, HHH)), \
            mul(p, Z, H)
    if Z == zero:
        return None
    zi = T.fq2_inv(p, Z)
    zi2 = sqr(p, zi)
    return (mul(p, X, zi2), mul(p, Y, mul(p, zi2, zi)))


def _mul_raw_g2(c: CurveSpec, a, k: int):
    if _is_mnt(c):
        out = None
        add = a
        while k:
            if k & 1:
                out = g2_add(c, out, add)
            add = g2_add(c, add, add)
            k >>= 1
        return out
    return _ladder_g2(c.fq.p, a, k)


def g1_on_curve(c, pt) -> bool:
    """Curve-equation check only (cheap); accepts MNT curves too."""
    if pt is None:
        return True
    if _is_mnt(c):
        # MNT4/6-298 G1 has prime order: y^2 = x^3 + a x + b over F_p.
        x, y = pt
        return (y * y - (x * x * x + c.a * x + c.b)) % c.p == 0
    return g1_is_on_curve(c, pt)


def g2_on_curve(c, pt) -> bool:
    if pt is None:
        return True
    if _is_mnt(c):
        x, y = pt
        F = c.ext
        rhs = F.add(F.mul(F.sqr(x), x),
                    F.add(F.smul(x, c.a), F.embed(c.b)))
        return F.sqr(y) == rhs
    return g2_is_on_curve(c, pt)


def sqrt_fq(c: CurveSpec, a: int):
    """Square root in Fq (p = 3 mod 4 for bls12-381 and alt_bn128), or None
    if a is a non-residue. Used by compressed-point deserialization."""
    p = c.fq.p
    assert p % 4 == 3
    a %= p
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a else None


def sqrt_fq2(c: CurveSpec, a):
    """Square root in Fq2 = Fq[u]/(u^2+1) via the norm map, or None."""
    p = c.fq.p
    a0, a1 = a[0] % p, a[1] % p
    if a1 == 0:
        r = sqrt_fq(c, a0)
        if r is not None:
            return (r, 0)
        r = sqrt_fq(c, (-a0) % p)        # a0 = -(r^2) => sqrt = r*u
        return None if r is None else (0, r)
    alpha = sqrt_fq(c, (a0 * a0 + a1 * a1) % p)   # sqrt of the norm
    if alpha is None:
        return None
    inv2 = pow(2, -1, p)
    x0 = sqrt_fq(c, (a0 + alpha) * inv2 % p)
    if x0 is None or x0 == 0:
        x0 = sqrt_fq(c, (a0 - alpha) % p * inv2 % p)
    if x0 is None or x0 == 0:
        return None
    x1 = a1 * pow(2 * x0, -1, p) % p
    cand = (x0, x1)
    sq = ((x0 * x0 - x1 * x1) % p, 2 * x0 * x1 % p)
    return cand if sq == (a0, a1) else None


def g2_y_from_x(c: CurveSpec, x):
    """y with y^2 = x^3 + b2 on the sextic twist, or None. b2 = b*xi for
    M-twists (bls12-381) and b/xi for D-twists (alt_bn128)."""
    p = c.fq.p
    from . import tower as _T
    x3 = _T.fq2_mul(p, _T.fq2_sqr(p, x), x)
    if c.twist == "M":
        b2 = _T.fq2_scalar(p, c.xi, c.b)
    else:
        b2 = _T.fq2_scalar(p, _T.fq2_inv(p, c.xi), c.b)
    rhs = _T.fq2_add(p, x3, b2)
    return sqrt_fq2(c, rhs)


def g1_well_formed(c, pt) -> bool:
    """On-curve + prime-order-subgroup membership for attacker-supplied G1
    elements — the reference verifier's `proof.is_well_formed()` gate
    (r1cs_gg_ppzksnark/verifier.hpp:164). Infinity is well-formed."""
    if pt is None:
        return True
    if not g1_on_curve(c, pt):
        return False
    if _is_mnt(c) or c.cofactor_g1 == 1:
        return True  # prime-order group: on-curve implies membership
    return _mul_raw_g1(c, pt, c.fr.p) is None


def g2_well_formed(c, pt) -> bool:
    """On-twist + subgroup membership for attacker-supplied G2 elements
    (invalid-curve attack gate). Infinity is well-formed."""
    if pt is None:
        return True
    if not g2_on_curve(c, pt):
        return False
    if _is_mnt(c):
        from . import mnt as _m
        return _m.ext_mul_scalar(c, pt, c.r) is None
    return _mul_raw_g2(c, pt, c.fr.p) is None


def g1_add(c: CurveSpec, a, b):
    if _is_mnt(c):
        from . import mnt as _m
        return _m.g1_add(c, a, b)
    p = c.fq.p
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def g1_neg(c: CurveSpec, a):
    if _is_mnt(c):
        from . import mnt as _m
        return _m.g1_neg(c, a)
    if a is None:
        return None
    return (a[0], (-a[1]) % c.fq.p)


def g1_mul(c: CurveSpec, a, k: int):
    if _is_mnt(c):
        from . import mnt as _m
        return _m.g1_mul(c, a, k)
    return _ladder_g1(c.fq.p, a, k % c.fr.p)


# ---------------------------------------------------------------------------
# host G2 (affine over Fq2, infinity = None)
# ---------------------------------------------------------------------------

def _b2(c: CurveSpec):
    p = c.fq.p
    bb = (c.b % p, 0)
    if c.twist == "M":
        return T.fq2_mul(p, bb, c.xi)
    return T.fq2_mul(p, bb, T.fq2_inv(p, c.xi))


def g2_is_on_curve(c: CurveSpec, pt) -> bool:
    if pt is None:
        return True
    p = c.fq.p
    x, y = pt
    lhs = T.fq2_sqr(p, y)
    rhs = T.fq2_add(p, T.fq2_mul(p, T.fq2_sqr(p, x), x), _b2(c))
    return lhs == rhs


def g2_add(c: CurveSpec, a, b):
    if _is_mnt(c):
        from . import mnt as _m
        return _m.g2_add(c, a, b)
    p = c.fq.p
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if T.fq2_add(p, y1, y2) == T.FQ2_ZERO:
            return None
        num = T.fq2_scalar(p, T.fq2_sqr(p, x1), 3)
        den = T.fq2_scalar(p, y1, 2)
        lam = T.fq2_mul(p, num, T.fq2_inv(p, den))
    else:
        lam = T.fq2_mul(p, T.fq2_sub(p, y2, y1),
                        T.fq2_inv(p, T.fq2_sub(p, x2, x1)))
    x3 = T.fq2_sub(p, T.fq2_sub(p, T.fq2_sqr(p, lam), x1), x2)
    y3 = T.fq2_sub(p, T.fq2_mul(p, lam, T.fq2_sub(p, x1, x3)), y1)
    return (x3, y3)


def g2_neg(c: CurveSpec, a):
    if _is_mnt(c):
        from . import mnt as _m
        return _m.g2_neg(c, a)
    if a is None:
        return None
    return (a[0], T.fq2_neg(c.fq.p, a[1]))


def g2_mul(c: CurveSpec, a, k: int):
    if _is_mnt(c):
        from . import mnt as _m
        return _m.g2_mul(c, a, k)
    return _ladder_g2(c.fq.p, a, k % c.fr.p)


# ---------------------------------------------------------------------------
# pairing (Tate, denominator elimination)
# ---------------------------------------------------------------------------

def _fq12_embed_fq(c: CurveSpec, a: int):
    return (((a % c.fq.p, 0), T.FQ2_ZERO, T.FQ2_ZERO),
            T.FQ6_ZERO)


def _fq12_embed_fq2(c: CurveSpec, a):
    return ((a, T.FQ2_ZERO, T.FQ2_ZERO), T.FQ6_ZERO)


_W = (T.FQ6_ZERO, T.FQ6_ONE)  # w


@functools.lru_cache(maxsize=None)
def _untwist_factors(c: CurveSpec):
    p, xi = c.fq.p, c.xi
    w2 = T.fq12_mul(p, xi, _W, _W)
    w3 = T.fq12_mul(p, xi, w2, _W)
    if c.twist == "D":
        return w2, w3
    return T.fq12_inv(p, xi, w2), T.fq12_inv(p, xi, w3)


def untwist(c: CurveSpec, q):
    """psi: E'(Fq2) -> E(Fq12)."""
    fx, fy = _untwist_factors(c)
    p, xi = c.fq.p, c.xi
    xs = T.fq12_mul(p, xi, _fq12_embed_fq2(c, q[0]), fx)
    ys = T.fq12_mul(p, xi, _fq12_embed_fq2(c, q[1]), fy)
    return xs, ys


def _fq12_eq(a, b):
    return a == b


def _ate_step(c: CurveSpec, T1, T2, Pt):
    """Full chord/tangent line l_{T1,T2} evaluated at Pt, plus T1 + T2 —
    all in affine E(Fq12) coordinates, slope computed once. Full line
    functions (verticals included) so the Miller value conforms bit-for-bit
    with bellperson/py_ecc (no denominator elimination)."""
    p, xi = c.fq.p, c.xi
    x1, y1 = T1
    x2, y2 = T2
    xt, yt = Pt
    if not _fq12_eq(x1, x2):
        m = T.fq12_mul(p, xi, _fq12_sub(p, y2, y1),
                       T.fq12_inv(p, xi, _fq12_sub(p, x2, x1)))
    elif _fq12_eq(y1, y2):
        x1sq = T.fq12_sqr(p, xi, x1)
        num = _fq12_add(p, _fq12_add(p, x1sq, x1sq), x1sq)
        m = T.fq12_mul(p, xi, num,
                       T.fq12_inv(p, xi, _fq12_add(p, y1, y1)))
    else:
        # vertical: l = xt - x1, T1 + T2 = infinity (never reached for
        # subgroup points within the ate loop; kept for completeness)
        return _fq12_sub(p, xt, x1), None
    line = _fq12_sub(p, T.fq12_mul(p, xi, m, _fq12_sub(p, xt, x1)),
                     _fq12_sub(p, yt, y1))
    x3 = _fq12_sub(p, _fq12_sub(p, T.fq12_sqr(p, xi, m), x1), x2)
    y3 = _fq12_sub(p, T.fq12_mul(p, xi, m, _fq12_sub(p, x1, x3)), y1)
    return line, (x3, y3)


def _fq12_frob_point(c: CurveSpec, Q):
    """(x^p, y^p) on E(Fq12) via Frobenius (fq12_pow by p; host-side)."""
    p, xi = c.fq.p, c.xi
    return (T.fq12_pow(p, xi, Q[0], p), T.fq12_pow(p, xi, Q[1], p))


def _ate_miller_loop(c: CurveSpec, p_g1, q_g2):
    """Optimal-ate Miller loop f_{t,psi(Q)}(P): the loop runs over the
    (short) curve parameter with T = psi(Q) in E(Fq12), lines evaluated at
    P. BLS12-381: t = |z|, conjugate at the end (z < 0). BN254: t = 6z+2
    plus the two Frobenius tail steps. Conforms to the value pinned by the
    reference's bellperson vectors
    (`r1cs_gg_ppzksnark_aggregation_conformity.cpp:214-292`)."""
    p, xi = c.fq.p, c.xi
    if p_g1 is None or q_g2 is None:
        return T.FQ12_ONE
    Pt = (_fq12_embed_fq(c, p_g1[0]), _fq12_embed_fq(c, p_g1[1]))
    Qx, Qy = untwist(c, q_g2)
    Qt = (Qx, Qy)
    f = T.FQ12_ONE
    Tpt = Qt
    for bit in bin(c.ate_loop)[3:]:
        line, Tpt = _ate_step(c, Tpt, Tpt, Pt)
        f = T.fq12_mul(p, xi, T.fq12_sqr(p, xi, f), line)
        if bit == "1":
            line, Tpt = _ate_step(c, Tpt, Qt, Pt)
            f = T.fq12_mul(p, xi, f, line)
    if c.ate_bn_tail:
        Q1 = _fq12_frob_point(c, Qt)
        Q2 = _fq12_frob_point(c, Q1)
        nQ2 = (Q2[0], (T.fq6_neg(p, Q2[1][0]), T.fq6_neg(p, Q2[1][1])))
        line, Tpt = _ate_step(c, Tpt, Q1, Pt)
        f = T.fq12_mul(p, xi, f, line)
        line, Tpt = _ate_step(c, Tpt, nQ2, Pt)
        f = T.fq12_mul(p, xi, f, line)
    if c.ate_is_negative:
        f = T.fq12_conj(p, f)
    return f


def miller_loop(c: CurveSpec, p_g1, q_g2):
    """Optimal-ate Miller value when the curve carries ate parameters
    (BLS12-381, alt_bn128 — the externally-conformant pairing), else the
    Tate loop below. Product-then-final-exp composition is preserved for
    both (ipp2 multiplies Miller values before one final exponentiation)."""
    if c.ate_loop:
        return _ate_miller_loop(c, p_g1, q_g2)
    return _tate_miller_loop(c, p_g1, q_g2)


def _tate_miller_loop(c: CurveSpec, p_g1, q_g2):
    """f_{r,P}(psi(Q)) — verticals skipped (killed by the final exp)."""
    p, xi = c.fq.p, c.xi
    if p_g1 is None or q_g2 is None:
        return T.FQ12_ONE
    xs, ys = untwist(c, q_g2)
    f = T.FQ12_ONE
    tx, ty = p_g1
    px, py = p_g1
    r = c.fr.p
    bits = bin(r)[3:]  # skip leading 1
    for bit in bits:
        # doubling step: slope at T
        lam = (3 * tx * tx) * pow(2 * ty, -1, p) % p
        # l(S) = yS - yT - lam*(xS - xT)
        line = _line_eval(c, xs, ys, tx, ty, lam)
        f = T.fq12_mul(p, xi, T.fq12_sqr(p, xi, f), line)
        # T = 2T
        x3 = (lam * lam - 2 * tx) % p
        y3 = (lam * (tx - x3) - ty) % p
        tx, ty = x3, y3
        if bit == "1":
            if tx == px and (ty + py) % p == 0:
                # vertical line: contributes an Fq6 factor, killed later
                tx, ty = None, None  # T becomes infinity
            elif tx == px and ty == py:
                lam = (3 * tx * tx) * pow(2 * ty, -1, p) % p
                f = T.fq12_mul(p, xi, f, _line_eval(c, xs, ys, tx, ty, lam))
                x3 = (lam * lam - 2 * tx) % p
                y3 = (lam * (tx - x3) - ty) % p
                tx, ty = x3, y3
            else:
                lam = (py - ty) * pow(px - tx, -1, p) % p
                f = T.fq12_mul(p, xi, f, _line_eval(c, xs, ys, tx, ty, lam))
                x3 = (lam * lam - tx - px) % p
                y3 = (lam * (tx - x3) - ty) % p
                tx, ty = x3, y3
        if tx is None:
            break
    return f


def _line_eval(c: CurveSpec, xs, ys, tx: int, ty: int, lam: int):
    """yS - yT - lam*(xS - xT) in Fq12."""
    p, xi = c.fq.p, c.xi
    t1 = T.fq12_mul(p, xi, _fq12_embed_fq(c, lam), xs)
    out = ys
    out = _fq12_sub(p, out, t1)
    const = (lam * tx - ty) % p
    out = _fq12_add(p, out, _fq12_embed_fq(c, const))
    return out


def _fq12_add(p, a, b):
    return (T.fq6_add(p, a[0], b[0]), T.fq6_add(p, a[1], b[1]))


def _fq12_sub(p, a, b):
    return (T.fq6_sub(p, a[0], b[0]), T.fq6_sub(p, a[1], b[1]))


def final_exponentiation(c: CurveSpec, f):
    return T.fq12_pow(c.fq.p, c.xi, f, c.final_exp)


def pairing(c: CurveSpec, p_g1, q_g2):
    if _is_mnt(c):
        from . import mnt as _m
        return _m.pairing(c, p_g1, q_g2)
    return final_exponentiation(c, miller_loop(c, p_g1, q_g2))


def gt_one(c: CurveSpec):
    """GT identity element (for `== one` pairing-product checks)."""
    if _is_mnt(c):
        return c.ext.one()
    return T.FQ12_ONE


def multi_pairing(c: CurveSpec, pairs) -> tuple:
    if _is_mnt(c):
        from . import mnt as _m
        return _m.multi_pairing(c, pairs)
    """prod e(P_i, Q_i) with one shared final exponentiation."""
    p, xi = c.fq.p, c.xi
    f = T.FQ12_ONE
    for (pp, qq) in pairs:
        f = T.fq12_mul(p, xi, f, miller_loop(c, pp, qq))
    return final_exponentiation(c, f)
