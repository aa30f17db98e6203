"""alt_bn128 (BN254) for the reference: its fields, G1 and G2 in affine
coordinates (infinity is None), and scalar multiplication by the generators.

Plain Python integers, written from the curve's published constants
(EIP-196 / EIP-197): y^2 = x^3 + 3 over Fq, and the D-type twist
y^2 = x^3 + 3 / (9 + u) over Fq2 = Fq[u] / (u^2 + 1). Points are tuples as
the port's proofs hold them: G1 (x, y), G2 ((x0, x1), (y0, y1)).
"""
from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
R_GENERATOR = 5          # the smallest multiplicative generator of Fr
R_TWO_ADICITY = 28

G1 = (1, 2)
G2 = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
       11559732032986387107991004021392285783925812861821192530917403151452391805634),
      (8495653923123431417604973247489272438418190587263600148770280649306958101930,
       4082367875863433681332203403145435568316851327593401208105741076214120093531))


def root_of_unity(n: int) -> int:
    """The primitive n-th root of unity of Fr (n a power of two) that the
    evaluation domains use: the generator raised to (r - 1) / 2^28, then
    to 2^28 / n."""
    g = pow(R_GENERATOR, (R - 1) >> R_TWO_ADICITY, R)
    return pow(g, (1 << R_TWO_ADICITY) // n, R)


# --- Fq2 -----------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def f2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
    return (a[0] * d % Q, (-a[1]) * d % Q)


# --- Jacobian arithmetic over a field given by its operations ---------------

class _Ops:
    def __init__(self, add, sub, mul, inv, zero, one):
        self.add, self.sub, self.mul, self.inv = add, sub, mul, inv
        self.zero, self.one = zero, one


_FQ = _Ops(lambda a, b: (a + b) % Q, lambda a, b: (a - b) % Q,
           lambda a, b: a * b % Q, lambda a: pow(a, -1, Q), 0, 1)
_FQ2 = _Ops(f2_add, f2_sub, f2_mul, f2_inv, (0, 0), (1, 0))


def _double(F, P):
    X, Y, Z = P
    if Z == F.zero:
        return P
    A = F.mul(X, X)
    B = F.mul(Y, Y)
    C = F.mul(B, B)
    t = F.add(X, B)
    D = F.sub(F.sub(F.mul(t, t), A), C)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    Fv = F.mul(E, E)
    X3 = F.sub(Fv, F.add(D, D))
    C8 = F.add(C, C)
    C8 = F.add(C8, C8)
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    Z3 = F.mul(Y, Z)
    return (X3, Y3, F.add(Z3, Z3))


def _add_affine(F, P, a):
    """P (Jacobian) + a (affine, not infinity)."""
    X1, Y1, Z1 = P
    if Z1 == F.zero:
        return (a[0], a[1], F.one)
    Z1Z1 = F.mul(Z1, Z1)
    U2 = F.mul(a[0], Z1Z1)
    S2 = F.mul(F.mul(a[1], Z1), Z1Z1)
    H = F.sub(U2, X1)
    rr = F.sub(S2, Y1)
    if H == F.zero:
        if rr == F.zero:
            return _double(F, P)
        return (F.one, F.one, F.zero)
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V = F.mul(X1, HH)
    X3 = F.sub(F.sub(F.mul(rr, rr), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.mul(Y1, HHH))
    Z3 = F.mul(Z1, H)
    return (X3, Y3, Z3)


def _to_affine(F, P):
    X, Y, Z = P
    if Z == F.zero:
        return None
    zi = F.inv(Z)
    zi2 = F.mul(zi, zi)
    return (F.mul(X, zi2), F.mul(Y, F.mul(zi, zi2)))


def _mul(F, a, k: int):
    k %= R
    if a is None or k == 0:
        return None
    P = (F.one, F.one, F.zero)
    for bit in bin(k)[2:]:
        P = _double(F, P)
        if bit == "1":
            P = _add_affine(F, P, a)
    return _to_affine(F, P)


def g1_mul(a, k: int):
    """k * a in G1, affine (None for infinity)."""
    return _mul(_FQ, a, k)


def g2_mul(a, k: int):
    """k * a in G2, affine over Fq2 (None for infinity)."""
    return _mul(_FQ2, a, k)
