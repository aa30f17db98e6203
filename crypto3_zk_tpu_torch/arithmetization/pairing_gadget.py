"""In-circuit pairing-product verification gadgets over the MNT4/6 cycle.

Counterpart of `arithmetization/pairing_gadget.py` of the JAX package (host
only), without three of its faults: `groth16_verify_gadget` also constrains
B's extension coordinates to the curve (`ext_on_curve`; the reference
constrains only A and C), it refuses a primary-input count that differs
from the verification key's instead of dropping the extra inputs, and the
k = 6 final exponentiation stays a refusal.

The reference composes proofs recursively by verifying a Groth16 proof
INSIDE an R1CS circuit over the matching cycle field
(`r1cs_mp_ppzkpcd/r1cs_mp_ppzkpcd.hpp:78-714`); the pairing gadgets it
consumes live in the sibling crypto3-blueprint repo. This module builds
that capability fresh on top of `fields/mnt.py`:

- an R1CS `Builder` that allocates witness variables and emits
  `arithmetization/r1cs.py` constraints while tracking a satisfying
  assignment (gadget style: the host computes every intermediate value,
  the constraints pin it);
- F_{p^k} = F_p[x]/(x^k - c) arithmetic gadgets: one extension multiply
  costs 2k-1 rank-1 constraints via evaluation-point interpolation (the
  product polynomial of degree 2k-2 is pinned at 2k-1 points, and the
  binomial reduction x^k = c is linear);
- a Tate Miller-loop gadget mirroring `fields/mnt.py::tate_pairing`:
  the loop walks bits of r with the T-chain in G1 (plain F_p variables,
  4 constraints per doubling), evaluating lines at an extension-field
  point Q — exactly the Groth16 verification shape, where the G1 side
  (A, acc, C) varies per proof and the G2 side (B, gamma, delta) only
  appears as evaluation points;
- `pairing_product_check`: constrains prod_i e(P_i, Q_i)^{s_i} * K = 1
  (K a constant GT factor, e.g. e(alpha, beta)^{-1} from a Groth16 vk),
  with the final exponentiation split (p^2-1)(p^2+1)/r so the p^2-power
  is a free diagonal Frobenius and only the ~298-bit hard part is a
  double-and-add ladder.

Exceptional cases: for P of prime order r the T-chain never reaches
infinity mid-loop (T = mP with 0 < m < r), and the only exceptional line
is the statically-known FINAL addition (T = -P, vertical chord) when r
is odd — handled per-iteration at build time, no in-circuit branching.
"""
from __future__ import annotations

import dataclasses

from ..fields import mnt as MNT
from . import r1cs as R


def _lc_scale(a: R.LinearCombination, s: int, p: int) -> R.LinearCombination:
    return R.LinearCombination([(i, c * s % p) for i, c in a.terms])


def _lc_add(*lcs: R.LinearCombination) -> R.LinearCombination:
    acc: dict[int, int] = {}
    for a in lcs:
        for i, c in a.terms:
            acc[i] = acc.get(i, 0) + c
    return R.LinearCombination([(i, c) for i, c in acc.items() if c])


def _lc_const(v: int) -> R.LinearCombination:
    return R.lc((0, v)) if v else R.LinearCombination([])


class Builder:
    """Gadget-style R1CS builder: every `aux` allocation records the
    host-computed value, so the constraint system and a satisfying
    assignment emerge together. Variable 0 is the constant ONE."""

    def __init__(self, p: int):
        self.p = p
        self.values: list[int] = [1]
        self.constraints: list[tuple] = []

    def aux(self, value: int) -> R.LinearCombination:
        self.values.append(value % self.p)
        return R.lc((len(self.values) - 1, 1))

    def val(self, a: R.LinearCombination) -> int:
        return sum(c * self.values[i] for i, c in a.terms) % self.p

    def constrain(self, a, b, c):
        self.constraints.append((a, b, c))

    def mul(self, a: R.LinearCombination,
            b: R.LinearCombination) -> R.LinearCombination:
        out = self.aux(self.val(a) * self.val(b))
        self.constrain(a, b, out)
        return out

    def assert_eq(self, a: R.LinearCombination, b: R.LinearCombination):
        self.constrain(_lc_add(a, _lc_scale(b, -1, self.p)),
                       R.lc((0, 1)), _lc_const(0))

    def to_r1cs(self) -> tuple[R.R1CSConstraintSystem, list[int]]:
        """All variables auxiliary (the PCD composition layer decides the
        primary split); returns (system, aux_assignment)."""
        cs = R.R1CSConstraintSystem(primary_input_size=0,
                                    auxiliary_input_size=len(self.values) - 1)
        for a, b, c in self.constraints:
            cs.add_constraint(a, b, c)
        return cs, self.values[1:]

    def is_satisfied(self) -> bool:
        p = self.p
        for a, b, c in self.constraints:
            if self.val(a) * self.val(b) % p != self.val(c):
                return False
        return True


# ---------------------------------------------------------------------------
# extension-field gadgets (elements = tuples of k LinearCombinations)
# ---------------------------------------------------------------------------

def ext_const(F: MNT.ExtField, v) -> tuple:
    return tuple(_lc_const(x) for x in v)


def ext_var(bld: Builder, v) -> tuple:
    return tuple(bld.aux(x) for x in v)


def ext_val(bld: Builder, F: MNT.ExtField, a) -> tuple:
    return tuple(bld.val(x) for x in a)


def ext_add(F: MNT.ExtField, a, b):
    return tuple(_lc_add(x, y) for x, y in zip(a, b))


def ext_sub(F: MNT.ExtField, a, b):
    p = F.p
    return tuple(_lc_add(x, _lc_scale(y, -1, p)) for x, y in zip(a, b))


def ext_smul_lc(bld: Builder, F: MNT.ExtField, a, s: R.LinearCombination):
    """a (ext of LCs) times a SCALAR LC: k rank-1 constraints."""
    return tuple(bld.mul(x, s) for x in a)


def ext_mul(bld: Builder, F: MNT.ExtField, a, b):
    """c = a*b in F_p[x]/(x^k - c): allocate the 2k-1 unreduced product
    coefficients t and pin them by evaluating the polynomial identity
    A(e)*B(e) = T(e) at e = 0..2k-2 (char(F_p) >> 2k, so the Vandermonde
    is invertible and degree-(2k-2) T is uniquely determined). The
    binomial reduction c_i = t_i + c*t_{i+k} is linear — no extra vars."""
    p, k, cc = F.p, F.k, F.c
    av = ext_val(bld, F, a)
    bv = ext_val(bld, F, b)
    t = [0] * (2 * k - 1)
    for i, ai in enumerate(av):
        if ai:
            for j, bj in enumerate(bv):
                t[i + j] = (t[i + j] + ai * bj) % p
    tl = [bld.aux(x) for x in t]
    for e in range(2 * k - 1):
        pw = [pow(e, m, p) for m in range(2 * k - 1)]
        A = _lc_add(*[_lc_scale(a[i], pw[i], p) for i in range(k)])
        B = _lc_add(*[_lc_scale(b[j], pw[j], p) for j in range(k)])
        T = _lc_add(*[_lc_scale(tl[m], pw[m], p) for m in range(2 * k - 1)])
        bld.constrain(A, B, T)
    out = []
    for i in range(k):
        if i + k < 2 * k - 1:
            out.append(_lc_add(tl[i], _lc_scale(tl[i + k], cc, p)))
        else:
            out.append(tl[i])
    return tuple(out)


def ext_sqr(bld: Builder, F: MNT.ExtField, a):
    return ext_mul(bld, F, a, a)


def ext_inv(bld: Builder, F: MNT.ExtField, a):
    """Witness the inverse, constrain a * a_inv = 1."""
    inv = ext_var(bld, F.inv(ext_val(bld, F, a)))
    prod = ext_mul(bld, F, a, inv)
    one = F.one()
    for i in range(F.k):
        bld.assert_eq(prod[i], _lc_const(one[i]))
    return inv


def ext_assert_eq(bld: Builder, F: MNT.ExtField, a, b):
    for x, y in zip(a, b):
        bld.assert_eq(x, y)


def ext_frobenius2(F: MNT.ExtField, a):
    """z -> z^(p^2): x^(p^2) = c^((p^2-1)/k') * x with p^2 ≡ 1 (mod k) for
    the even k of the MNT towers — a DIAGONAL linear map, zero
    constraints."""
    p, k, cc = F.p, F.k, F.c
    assert (p * p - 1) % k == 0
    out = []
    for i in range(k):
        coef = pow(cc, i * ((p * p - 1) // k) % (p - 1), p)
        out.append(_lc_scale(a[i], coef, p))
    return tuple(out)


# ---------------------------------------------------------------------------
# Tate Miller loop gadget (mirrors fields/mnt.py::tate_pairing)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class G1Var:
    x: R.LinearCombination
    y: R.LinearCombination


def g1_var(bld: Builder, P) -> G1Var:
    return G1Var(bld.aux(P[0]), bld.aux(P[1]))


def g1_on_curve(bld: Builder, curve: MNT.MNTCurve, P: G1Var):
    """y^2 = x^3 + a*x + b (affine, finite)."""
    p = curve.p
    x2 = bld.mul(P.x, P.x)
    x3ax = bld.mul(_lc_add(x2, _lc_const(curve.a)), P.x)
    bld.constrain(P.y, P.y, _lc_add(x3ax, _lc_const(curve.b)))


def ext_on_curve(bld: Builder, curve: MNT.MNTCurve, Q):
    """y^2 = x^3 + a*x + b for an affine point Q = (x, y) of E(F_{p^k})
    whose coordinates are ext LC tuples: three extension products and k
    equalities."""
    F = curve.ext
    p = curve.p
    xq, yq = Q
    x3 = ext_mul(bld, F, ext_sqr(bld, F, xq), xq)
    rhs = tuple(_lc_add(x3[i], _lc_scale(xq[i], curve.a, p),
                        _lc_const(curve.b) if i == 0 else _lc_const(0))
                for i in range(F.k))
    ext_assert_eq(bld, F, ext_sqr(bld, F, yq), rhs)


def _dbl_step(bld: Builder, curve: MNT.MNTCurve, T: G1Var):
    """T <- 2T with witnessed slope: 4 constraints."""
    p = curve.p
    xv, yv = bld.val(T.x), bld.val(T.y)
    lam_v = (3 * xv * xv + curve.a) * pow(2 * yv, -1, p) % p
    x3_v = (lam_v * lam_v - 2 * xv) % p
    y3_v = (lam_v * (xv - x3_v) - yv) % p
    lam = bld.aux(lam_v)
    x3 = bld.aux(x3_v)
    y3 = bld.aux(y3_v)
    x2 = bld.mul(T.x, T.x)                          # x^2
    bld.constrain(lam, _lc_scale(T.y, 2, p),
                  _lc_add(_lc_scale(x2, 3, p), _lc_const(curve.a)))
    bld.constrain(lam, lam, _lc_add(x3, _lc_scale(T.x, 2, p)))
    bld.constrain(lam, _lc_add(T.x, _lc_scale(x3, -1, p)),
                  _lc_add(y3, T.y))
    return G1Var(x3, y3), lam


def _add_step(bld: Builder, curve: MNT.MNTCurve, T: G1Var, P: G1Var):
    """T <- T + P (distinct, finite): 3 constraints."""
    p = curve.p
    x1, y1 = bld.val(T.x), bld.val(T.y)
    x2, y2 = bld.val(P.x), bld.val(P.y)
    lam_v = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3_v = (lam_v * lam_v - x1 - x2) % p
    y3_v = (lam_v * (x1 - x3_v) - y1) % p
    lam = bld.aux(lam_v)
    x3 = bld.aux(x3_v)
    y3 = bld.aux(y3_v)
    bld.constrain(lam, _lc_add(P.x, _lc_scale(T.x, -1, p)),
                  _lc_add(P.y, _lc_scale(T.y, -1, p)))
    bld.constrain(lam, lam, _lc_add(x3, T.x, P.x))
    bld.constrain(lam, _lc_add(T.x, _lc_scale(x3, -1, p)),
                  _lc_add(y3, T.y))
    return G1Var(x3, y3), lam


def _line_eval(bld: Builder, F: MNT.ExtField, T: G1Var,
               lam: R.LinearCombination, xq, yq):
    """l = (yq - y1) - lam*(xq - x1) evaluated at the ext point (xq, yq),
    with (x1, y1) the step's STARTING point: k rank-1 constraints."""
    p = F.p
    one0 = [_lc_scale(T.x, -1, p) if i == 0 else _lc_const(0)
            for i in range(F.k)]
    dx = tuple(_lc_add(xq[i], one0[i]) for i in range(F.k))
    m = ext_smul_lc(bld, F, dx, lam)
    out = []
    for i in range(F.k):
        base = yq[i] if i != 0 else _lc_add(yq[0], _lc_scale(T.y, -1, p))
        out.append(_lc_add(base, _lc_scale(m[i], -1, p)))
    return tuple(out)


def tate_miller(bld: Builder, curve: MNT.MNTCurve, P: G1Var, Q):
    """Miller loop of the Tate pairing e(P, Q): returns (fn, fd) ext-LC
    accumulators (numerator/denominator, final exponentiation NOT
    applied). Q is a tuple (xq, yq) of ext elements (LC tuples). P must
    have prime order r (the T-chain then stays finite until the final
    addition, which is the statically-handled vertical chord)."""
    F = curve.ext
    p = curve.p
    xq, yq = Q
    fn = ext_const(F, F.one())
    fd = ext_const(F, F.one())
    T = P
    bits = bin(curve.r)[3:]
    for i, bit in enumerate(bits):
        last = i == len(bits) - 1
        T0 = T
        T, lam = _dbl_step(bld, curve, T0)
        l = _line_eval(bld, F, T0, lam, xq, yq)
        v = tuple(_lc_add(xq[j], _lc_scale(T.x, -1, p)) if j == 0 else xq[j]
                  for j in range(F.k))
        fn = ext_mul(bld, F, ext_sqr(bld, F, fn), l)
        fd = ext_mul(bld, F, ext_sqr(bld, F, fd), v)
        if bit == "1":
            if last:
                # T = (r-1)P = -P: vertical chord l = xq - x(T), v = 1;
                # T + P = infinity (loop ends, nothing more to track)
                bld.assert_eq(T.x, P.x)          # pins the chain endpoint
                l = tuple(_lc_add(xq[j], _lc_scale(T.x, -1, p))
                          if j == 0 else xq[j] for j in range(F.k))
                fn = ext_mul(bld, F, fn, l)
            else:
                T0 = T
                T, lam = _add_step(bld, curve, T0, P)
                l = _line_eval(bld, F, T0, lam, xq, yq)
                v = tuple(_lc_add(xq[j], _lc_scale(T.x, -1, p))
                          if j == 0 else xq[j] for j in range(F.k))
                fn = ext_mul(bld, F, fn, l)
                fd = ext_mul(bld, F, fd, v)
    return fn, fd


def _final_exp_hard(bld: Builder, curve: MNT.MNTCurve, w):
    """w^((p^2+1)/r) by double-and-add over the ~|r|-bit static exponent."""
    F = curve.ext
    e = (curve.p ** 2 + 1) // curve.r if curve.k == 4 else \
        (curve.p ** 2 - curve.p + 1) // curve.r
    acc = None
    for bit in bin(e)[2:]:
        if acc is not None:
            acc = ext_sqr(bld, F, acc)
            if bit == "1":
                acc = ext_mul(bld, F, acc, w)
        else:
            acc = w                              # leading bit
    return acc


def final_exponentiation(bld: Builder, curve: MNT.MNTCurve, f):
    """f^((p^k - 1)/r) with the free p^2-Frobenius easy part.
    k=4: (p^4-1)/r = (p^2-1) * (p^2+1)/r.
    k=6: (p^6-1)/r = (p^3-1)(p+1) * (p^2-p+1)/r — the k=6 easy part needs
    odd-power Frobenius (non-diagonal over a sextic binomial only when
    p ≢ 1 mod 6); current gadget supports MNT4 (k=4), which is the curve
    whose proofs the MNT6 side must verify in-circuit."""
    F = curve.ext
    if curve.k != 4:
        raise NotImplementedError("final_exponentiation gadget: k=4 only "
                                  "(MNT4 proofs verified inside MNT6 R1CS)")
    fro = ext_frobenius2(F, f)
    w = ext_mul(bld, F, fro, ext_inv(bld, F, f))     # f^(p^2-1)
    return _final_exp_hard(bld, curve, w)


def pairing_product_check(bld: Builder, curve: MNT.MNTCurve, pairs,
                          const_factor=None):
    """Constrain  prod_i e(P_i, Q_i)^{s_i} * K == 1  (s_i in {+1, -1},
    K an optional constant GT element). Shares ONE final exponentiation
    across the product (the Groth16 check
    e(A,B) e(alpha,beta)^-1 e(acc,gamma)^-1 e(C,delta)^-1 = 1 maps to
    pairs [(A,B,+1),(acc,gamma,-1),(C,delta,-1)] with
    K = e(alpha,beta)^-1 from the verification key)."""
    F = curve.ext
    num = ext_const(F, F.one())
    den = ext_const(F, F.one())
    for P, Q, sign in pairs:
        fn, fd = tate_miller(bld, curve, P, Q)
        if sign > 0:
            num = ext_mul(bld, F, num, fn)
            den = ext_mul(bld, F, den, fd)
        else:
            num = ext_mul(bld, F, num, fd)
            den = ext_mul(bld, F, den, fn)
    f = ext_mul(bld, F, num, ext_inv(bld, F, den))
    out = final_exponentiation(bld, curve, f)
    if const_factor is not None:
        out = ext_mul(bld, F, out, ext_const(F, const_factor))
    ext_assert_eq(bld, F, out, ext_const(F, F.one()))
    return out


# ---------------------------------------------------------------------------
# fixed-base scalar multiplication + the complete Groth16 verifier gadget
# ---------------------------------------------------------------------------

def bit_decompose(bld: Builder, x: R.LinearCombination, nbits: int):
    """Allocate boolean bits with Σ b_j 2^j == x (booleanity constraint per
    bit + one packing constraint). nbits covers the scalar field order;
    the honest witness is the canonical decomposition (value < r < p, so
    no wrap — the 2^nbits < 2p alias is excluded for in-range witnesses,
    the same contract as the reference's blueprint packing gadgets)."""
    p = bld.p
    xv = bld.val(x)
    bits = []
    for j in range(nbits):
        b = bld.aux((xv >> j) & 1)
        bld.constrain(b, _lc_add(b, _lc_const(p - 1)), _lc_const(0))
        bits.append(b)
    packed = _lc_add(*[_lc_scale(b, 1 << j, p) for j, b in enumerate(bits)])
    bld.assert_eq(packed, x)
    return bits


def g1_add_const(bld: Builder, curve: MNT.MNTCurve, A: G1Var, P):
    """A + P for a CONSTANT finite point P (incomplete: assumes
    A.x != P.x, which holds on the honest fixed-base ladder for scalars
    below the group order): 3 constraints."""
    p = curve.p
    x1, y1 = bld.val(A.x), bld.val(A.y)
    lam_v = (P[1] - y1) * pow(P[0] - x1, -1, p) % p
    x3_v = (lam_v * lam_v - x1 - P[0]) % p
    y3_v = (lam_v * (x1 - x3_v) - y1) % p
    lam, x3, y3 = bld.aux(lam_v), bld.aux(x3_v), bld.aux(y3_v)
    bld.constrain(lam, _lc_add(_lc_const(P[0]), _lc_scale(A.x, -1, p)),
                  _lc_add(_lc_const(P[1]), _lc_scale(A.y, -1, p)))
    bld.constrain(lam, lam, _lc_add(x3, A.x, _lc_const(P[0])))
    bld.constrain(lam, _lc_add(A.x, _lc_scale(x3, -1, p)),
                  _lc_add(y3, A.y))
    return G1Var(x3, y3)


def g1_cond_select(bld: Builder, b: R.LinearCombination, T: G1Var,
                   A: G1Var) -> G1Var:
    """b ? T : A for boolean b: 2 constraints."""
    p = bld.p
    dx = bld.mul(b, _lc_add(T.x, _lc_scale(A.x, -1, p)))
    dy = bld.mul(b, _lc_add(T.y, _lc_scale(A.y, -1, p)))
    return G1Var(_lc_add(A.x, dx), _lc_add(A.y, dy))


def g1_fixed_base_mul_acc(bld: Builder, curve: MNT.MNTCurve, acc: G1Var,
                          base, bits):
    """acc + x*base for a CONSTANT base and bit-decomposed x: per bit j,
    conditionally add the precomputed 2^j*base (host table; incomplete
    additions — sound for honest in-range witnesses, the blueprint
    fixed-base gadgets carry the same caveat)."""
    T = acc
    mult = base
    for b in bits:
        added = g1_add_const(bld, curve, T, mult)
        T = g1_cond_select(bld, b, added, T)
        mult = MNT.g1_add(curve, mult, mult)
    return T


def groth16_verify_gadget(bld: Builder, curve: MNT.MNTCurve, vk,
                          primary_lcs, proof_A: G1Var, proof_B,
                          proof_C: G1Var, nbits: int | None = None):
    """The COMPLETE in-circuit Groth16 verifier over the MNT4/6 cycle
    (`verifier.hpp (gg):138-187` as an R1CS over the OTHER cycle field):
    public-input accumulation with fixed-base ladders over the vk's
    gamma_ABC points, then the 3-pairing product check with
    e(alpha, beta)^-1 embedded as a constant. `primary_lcs` are circuit
    variables carrying the verified statement (in recursive PCD these are
    the outer circuit's own inputs); there must be one per input of the
    verification key. Proof points enter as variables and are constrained
    to their curves: A and C to E(F_p), B to E(F_{p^k}) (`ext_on_curve`);
    subgroup membership is not constrained in-circuit."""
    F = curve.ext
    nbits = nbits or curve.r.bit_length()
    if len(primary_lcs) != len(vk.gamma_ABC_g1) - 1:
        raise ValueError(f"{len(primary_lcs)} primary inputs for a key of "
                         f"{len(vk.gamma_ABC_g1) - 1}")
    g1_on_curve(bld, curve, proof_A)
    g1_on_curve(bld, curve, proof_C)
    ext_on_curve(bld, curve, proof_B)
    acc = G1Var(_lc_const(vk.gamma_ABC_g1[0][0]),
                _lc_const(vk.gamma_ABC_g1[0][1]))
    for x_lc, base in zip(primary_lcs, vk.gamma_ABC_g1[1:]):
        bits = bit_decompose(bld, x_lc, nbits)
        acc = g1_fixed_base_mul_acc(bld, curve, acc, base, bits)
    gamma = (ext_const(F, vk.gamma_g2[0]), ext_const(F, vk.gamma_g2[1]))
    delta = (ext_const(F, vk.delta_g2[0]), ext_const(F, vk.delta_g2[1]))
    k_const = F.inv(vk.alpha_g1_beta_g2)
    return pairing_product_check(
        bld, curve,
        [(proof_A, proof_B, +1), (acc, gamma, -1), (proof_C, delta, -1)],
        const_factor=k_const)
