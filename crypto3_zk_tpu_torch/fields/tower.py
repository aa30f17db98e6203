"""Extension field towers Fq2 / Fq6 / Fq12 (host python ints).

TPU-native split of the reference's algebra layer (SURVEY.md §2.0): pairing
towers run HOST-side — they serve only verifiers and key generation
(`verifier.hpp (gg):168-183`, `kzg.hpp:195-206`), which are scalar and
latency-insensitive — while the bulk G1/G2 group math runs on device
(`ops/curve.py`).

Tower (standard for BLS12-381 / alt_bn128):
    Fq2  = Fq [u] / (u^2 - beta)        beta = -1
    Fq6  = Fq2[v] / (v^3 - xi)          xi curve-specific (1+u / 9+u)
    Fq12 = Fq6 [w] / (w^2 - v)

Elements: Fq2 = (c0, c1) ints; Fq6 = 3-tuple of Fq2; Fq12 = 2-tuple of Fq6.
All functions take the prime modulus p and xi where needed.
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# Fq2 (beta = -1): (a0 + a1 u)
# ---------------------------------------------------------------------------

def fq2_add(p, a, b):
    return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)


def fq2_sub(p, a, b):
    return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)


def fq2_neg(p, a):
    return ((-a[0]) % p, (-a[1]) % p)


def fq2_mul(p, a, b):
    # (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    t0 = a[0] * b[0] % p
    t1 = a[1] * b[1] % p
    return ((t0 - t1) % p, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % p)


def fq2_sqr(p, a):
    # (a0+a1)(a0-a1) + 2 a0 a1 u
    t = a[0] * a[1] % p
    return ((a[0] + a[1]) * (a[0] - a[1]) % p, 2 * t % p)


def fq2_scalar(p, a, k: int):
    return (a[0] * k % p, a[1] * k % p)


def fq2_conj(p, a):
    return (a[0], (-a[1]) % p)


def fq2_inv(p, a):
    # 1 / (a0 + a1 u) = conj / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % p
    ninv = pow(norm, -1, p)
    return (a[0] * ninv % p, (-a[1]) * ninv % p)


def fq2_pow(p, a, e: int):
    out = (1, 0)
    base = a
    while e:
        if e & 1:
            out = fq2_mul(p, out, base)
        base = fq2_sqr(p, base)
        e >>= 1
    return out


FQ2_ONE = (1, 0)
FQ2_ZERO = (0, 0)


# ---------------------------------------------------------------------------
# Fq6 over Fq2 with v^3 = xi
# ---------------------------------------------------------------------------

def _mul_xi(p, xi, a):
    return fq2_mul(p, xi, a)


def fq6_add(p, a, b):
    return tuple(fq2_add(p, x, y) for x, y in zip(a, b))


def fq6_sub(p, a, b):
    return tuple(fq2_sub(p, x, y) for x, y in zip(a, b))


def fq6_neg(p, a):
    return tuple(fq2_neg(p, x) for x in a)


def fq6_mul(p, xi, a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(p, a0, b0)
    t1 = fq2_mul(p, a1, b1)
    t2 = fq2_mul(p, a2, b2)
    c0 = fq2_add(p, t0, _mul_xi(p, xi, fq2_sub(
        p, fq2_mul(p, fq2_add(p, a1, a2), fq2_add(p, b1, b2)),
        fq2_add(p, t1, t2))))
    c1 = fq2_add(p, fq2_sub(
        p, fq2_mul(p, fq2_add(p, a0, a1), fq2_add(p, b0, b1)),
        fq2_add(p, t0, t1)), _mul_xi(p, xi, t2))
    c2 = fq2_add(p, fq2_sub(
        p, fq2_mul(p, fq2_add(p, a0, a2), fq2_add(p, b0, b2)),
        fq2_add(p, t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(p, xi, a):
    return fq6_mul(p, xi, a, a)


def fq6_scalar2(p, a, k2):
    """Multiply by an Fq2 scalar."""
    return tuple(fq2_mul(p, x, k2) for x in a)


def fq6_mul_v(p, xi, a):
    """a * v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
    return (_mul_xi(p, xi, a[2]), a[0], a[1])


def fq6_inv(p, xi, a):
    a0, a1, a2 = a
    t0 = fq2_sqr(p, a0)
    t1 = fq2_sqr(p, a1)
    t2 = fq2_sqr(p, a2)
    t3 = fq2_mul(p, a0, a1)
    t4 = fq2_mul(p, a0, a2)
    t5 = fq2_mul(p, a1, a2)
    c0 = fq2_sub(p, t0, _mul_xi(p, xi, t5))
    c1 = fq2_sub(p, _mul_xi(p, xi, t2), t3)
    c2 = fq2_sub(p, t1, t4)
    t6 = fq2_add(p, fq2_mul(p, a0, c0),
                 _mul_xi(p, xi, fq2_add(p, fq2_mul(p, a2, c1),
                                        fq2_mul(p, a1, c2))))
    t6i = fq2_inv(p, t6)
    return (fq2_mul(p, c0, t6i), fq2_mul(p, c1, t6i), fq2_mul(p, c2, t6i))


FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)
FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)


# ---------------------------------------------------------------------------
# Fq12 over Fq6 with w^2 = v
# ---------------------------------------------------------------------------

def fq12_mul(p, xi, a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(p, xi, a0, b0)
    t1 = fq6_mul(p, xi, a1, b1)
    c0 = fq6_add(p, t0, fq6_mul_v(p, xi, t1))
    c1 = fq6_sub(p, fq6_mul(p, xi, fq6_add(p, a0, a1), fq6_add(p, b0, b1)),
                 fq6_add(p, t0, t1))
    return (c0, c1)


def fq12_sqr(p, xi, a):
    return fq12_mul(p, xi, a, a)


def fq12_inv(p, xi, a):
    a0, a1 = a
    t = fq6_sub(p, fq6_sqr(p, xi, a0),
                fq6_mul_v(p, xi, fq6_sqr(p, xi, a1)))
    ti = fq6_inv(p, xi, t)
    return (fq6_mul(p, xi, a0, ti), fq6_neg(p, fq6_mul(p, xi, a1, ti)))


def fq12_conj(p, a):
    """Conjugate over Fq6 (the p^6-Frobenius): (a0, -a1)."""
    return (a[0], fq6_neg(p, a[1]))


def fq12_pow(p, xi, a, e: int):
    if e < 0:
        return fq12_pow(p, xi, fq12_inv(p, xi, a), -e)
    out = FQ12_ONE
    base = a
    while e:
        if e & 1:
            out = fq12_mul(p, xi, out, base)
        base = fq12_sqr(p, xi, base)
        e >>= 1
    return out


FQ12_ONE = (FQ6_ONE, FQ6_ZERO)
