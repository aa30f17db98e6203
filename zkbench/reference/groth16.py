"""The Groth16 proof a prover must return, from the trapdoor.

Groth16 over a QAP (libsnark's `r1cs_to_qap` and `r1cs_gg_ppzksnark`, as
crypto3-zk has them): with the trapdoor (t, alpha, beta, gamma, delta), the
assignment a (a_0 = 1) and the blinding (r, s) of a proof,

    A = (alpha + sum_i a_i A_i(t) + r delta) G1
    B = (beta + sum_i a_i B_i(t) + s delta) G2
    C = ((sum_{i > inputs} a_i (beta A_i(t) + alpha B_i(t) + C_i(t))
          + h(t) Z(t)) / delta + s e_A + r e_B - r s delta) G1

where e_A, e_B are the scalars of A and B, and h(t) Z(t) = A(t) B(t) - C(t)
for a satisfying assignment. The QAP's domain has room for the constraints
and one input-consistency row per input (the constant included), and A_i
carries L_{m + i}(t) for every input i. So each proof point is one scalar
multiplication of a generator by a scalar worked out in Fr: no key, no MSM.
"""
from __future__ import annotations

from . import bn254


def lagrange_all(t: int, n: int) -> list[int]:
    """L_j(t) for j < n over the domain of n-th roots of unity, t outside
    it: Z(t) w^j / (n (t - w^j)), inverted as a batch."""
    p = bn254.R
    w = bn254.root_of_unity(n)
    z = (pow(t, n, p) - 1) % p
    if z == 0:
        raise ValueError("t lies in the evaluation domain")
    pows = [1] * n
    for j in range(1, n):
        pows[j] = pows[j - 1] * w % p
    dens = [(t - x) % p for x in pows]
    prefix = [1] * (n + 1)
    for j in range(n):
        prefix[j + 1] = prefix[j] * dens[j] % p
    inv = pow(prefix[n], -1, p)
    scale = z * pow(n, -1, p) % p
    out = [0] * n
    for j in range(n - 1, -1, -1):
        out[j] = inv * prefix[j] % p * pows[j] % p * scale % p
        inv = inv * dens[j] % p
    return out


class Groth16Reference:
    """The expected proof points of one constraint system under one
    trapdoor. `cs` is built with `zkbench.reference.r1cs`; the generator's
    A/B swap rule is applied to it here, as the program's generator does to
    its own copy."""

    def __init__(self, cs, trapdoor: dict):
        p = bn254.R
        cs.swap_AB_if_beneficial()
        self.cs = cs
        self.tr = {k: v % p for k, v in trapdoor.items()}
        m, ni = cs.num_constraints, cs.num_inputs
        need = m + ni + 1
        n = 1 << (need - 1).bit_length()
        self.u = lagrange_all(self.tr["t"], n)
        # A_i(t), B_i(t), C_i(t) of the inputs (the constant one included)
        self.inputs = [[0, 0, 0] for _ in range(ni + 1)]
        for i in range(ni + 1):
            self.inputs[i][0] = self.u[m + i]
        for j, cst in enumerate(cs.constraints):
            for k, lc in enumerate((cst.a, cst.b, cst.c)):
                for idx, coeff in lc.terms:
                    if idx <= ni:
                        row = self.inputs[idx]
                        row[k] = (row[k] + self.u[j] * coeff) % p

    def scalars(self, primary: list[int], aux: list[int], r: int,
                s: int) -> tuple[int, int, int]:
        """(e_A, e_B, e_C): the discrete logarithms of the three points."""
        p = bn254.R
        cs, u, tr = self.cs, self.u, self.tr
        full = [1] + [v % p for v in primary] + [v % p for v in aux]
        if not cs.is_satisfied(p, primary, aux):
            raise ValueError("the assignment does not satisfy the system")
        m, ni = cs.num_constraints, cs.num_inputs
        at = bt = ct = 0
        for j, cst in enumerate(cs.constraints):
            uj = u[j]
            at += cst.a.evaluate(p, full) * uj
            bt += cst.b.evaluate(p, full) * uj
            ct += cst.c.evaluate(p, full) * uj
        for i in range(ni + 1):
            at += full[i] * u[m + i]
        at, bt, ct = at % p, bt % p, ct % p
        a_pub = sum(full[i] * self.inputs[i][0] for i in range(ni + 1)) % p
        b_pub = sum(full[i] * self.inputs[i][1] for i in range(ni + 1)) % p
        c_pub = sum(full[i] * self.inputs[i][2] for i in range(ni + 1)) % p
        alpha, beta, delta = tr["alpha"], tr["beta"], tr["delta"]
        e_a = (alpha + at + r * delta) % p
        e_b = (beta + bt + s * delta) % p
        private = (beta * (at - a_pub) + alpha * (bt - b_pub) + (ct - c_pub)
                   + at * bt - ct) % p
        e_c = (private * pow(delta, -1, p) + s * e_a + r * e_b
               - r * s % p * delta) % p
        return e_a, e_b, e_c

    def proof(self, primary: list[int], aux: list[int], r: int, s: int):
        """(A, B, C) as affine points."""
        e_a, e_b, e_c = self.scalars(primary, aux, r, s)
        return (bn254.g1_mul(bn254.G1, e_a), bn254.g2_mul(bn254.G2, e_b),
                bn254.g1_mul(bn254.G1, e_c))
