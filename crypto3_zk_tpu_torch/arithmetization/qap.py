"""R1CS -> QAP reduction.

`snark/reductions/r1cs_to_qap.hpp`:
- instance_map_with_evaluation (`:138-187`): host scalars (keygen-time).
- witness_map (`:219-325`, "the 7 FFTs"): the NTT pipeline runs on DEVICE —
  iNTT(aA), iNTT(aB), iNTT(aC), coset-NTT(x3), pointwise aA*aB - aC, divide
  by the (constant-on-coset) vanishing polynomial, coset-iNTT — exactly the
  reference's algorithm with `multiply_by_coset` folded into the coset
  transforms.

- instance_map_lagrange (`r1cs_to_qap.hpp::instance_map`): the sparse
  Lagrange-basis QAP a powers-of-tau consumer needs.

Counterpart of `arithmetization/qap.py` of the JAX package; `witness_map`
takes the device explicitly (default: the card).
"""
from __future__ import annotations

import dataclasses

from ..fields.params import FieldSpec
from ..ops import limbs as L
from ..ops import ntt as N
from ..poly.domain import Domain, get_domain
from .r1cs import R1CSConstraintSystem


def qap_domain(fs: FieldSpec, cs: R1CSConstraintSystem) -> Domain:
    need = cs.num_constraints + cs.num_inputs + 1
    n = 1 << (need - 1).bit_length()
    return get_domain(fs, n)


@dataclasses.dataclass
class QAPInstanceEvaluation:
    domain: Domain
    num_variables: int
    degree: int
    num_inputs: int
    t: int
    At: list[int]
    Bt: list[int]
    Ct: list[int]
    Ht: list[int]
    Zt: int


def instance_map_with_evaluation(fs: FieldSpec, cs: R1CSConstraintSystem,
                                 t: int) -> QAPInstanceEvaluation:
    p = fs.p
    domain = qap_domain(fs, cs)
    nv = cs.num_variables
    At = [0] * (nv + 1)
    Bt = [0] * (nv + 1)
    Ct = [0] * (nv + 1)
    Zt = domain.evaluate_vanishing(t)
    u = domain.evaluate_all_lagrange(t)
    for i in range(cs.num_inputs + 1):
        At[i] = u[cs.num_constraints + i]
    for i, cst in enumerate(cs.constraints):
        for idx, coeff in cst.a.terms:
            At[idx] = (At[idx] + u[i] * coeff) % p
        for idx, coeff in cst.b.terms:
            Bt[idx] = (Bt[idx] + u[i] * coeff) % p
        for idx, coeff in cst.c.terms:
            Ct[idx] = (Ct[idx] + u[i] * coeff) % p
    Ht = [pow(t, i, p) for i in range(domain.n + 1)]
    return QAPInstanceEvaluation(domain, nv, domain.n, cs.num_inputs, t,
                                 At, Bt, Ct, Ht, Zt)


@dataclasses.dataclass
class QAPInstanceLagrange:
    """Sparse Lagrange-basis QAP (`r1cs_to_qap.hpp::instance_map`): per
    variable, the list of (lagrange_index, coefficient) pairs; the CRS is
    assembled from [L_j(tau)]*G without knowing tau
    (`crs_operations.hpp:23-113`)."""
    domain: Domain
    num_variables: int
    degree: int
    num_inputs: int
    A: list[list[tuple[int, int]]]
    B: list[list[tuple[int, int]]]
    C: list[list[tuple[int, int]]]


def instance_map_lagrange(fs: FieldSpec,
                          cs: R1CSConstraintSystem) -> QAPInstanceLagrange:
    p = fs.p
    domain = qap_domain(fs, cs)
    nv = cs.num_variables
    A = [[] for _ in range(nv + 1)]
    B = [[] for _ in range(nv + 1)]
    C = [[] for _ in range(nv + 1)]
    for i in range(cs.num_inputs + 1):
        A[i].append((cs.num_constraints + i, 1))
    for i, cst in enumerate(cs.constraints):
        for idx, coeff in cst.a.terms:
            A[idx].append((i, coeff % p))
        for idx, coeff in cst.b.terms:
            B[idx].append((i, coeff % p))
        for idx, coeff in cst.c.terms:
            C[idx].append((i, coeff % p))
    return QAPInstanceLagrange(domain, nv, domain.n, cs.num_inputs, A, B, C)


@dataclasses.dataclass
class QAPWitness:
    num_variables: int
    degree: int
    num_inputs: int
    coefficients_for_ABCs: list[int]   # full variable assignment (no ONE)
    coefficients_for_H: list[int]


def witness_map(fs: FieldSpec, cs: R1CSConstraintSystem,
                primary: list[int], aux: list[int],
                d1: int = 0, d2: int = 0, d3: int = 0,
                device=None) -> QAPWitness:
    p = fs.p
    device = L.resolve_device(device)
    assert cs.is_satisfied(p, primary, aux)
    domain = qap_domain(fs, cs)
    n = domain.n
    full = list(primary) + list(aux)
    full_one = [1] + full

    aA = [0] * n
    aB = [0] * n
    aC = [0] * n
    for i in range(cs.num_inputs + 1):
        aA[i + cs.num_constraints] = full_one[i]
    for i, cst in enumerate(cs.constraints):
        aA[i] = (aA[i] + cst.a.evaluate(p, full_one)) % p
        aB[i] = (aB[i] + cst.b.evaluate(p, full_one)) % p
        aC[i] = cst.c.evaluate(p, full_one)

    # device NTT pipeline
    g = fs.generator
    dA = domain.ifft(L.encode(fs, aA, device))
    dB = domain.ifft(L.encode(fs, aB, device))
    dC = domain.ifft(L.encode(fs, aC, device))

    # (d2*A + d1*B - d3) + d1*d2*Z contribution (host, degree-n poly)
    coeffs_H = [0] * (n + 1)
    if d1 or d2 or d3:
        hA = L.decode(fs, dA)
        hB = L.decode(fs, dB)
        for i in range(n):
            coeffs_H[i] = (d2 * hA[i] + d1 * hB[i]) % p
        coeffs_H[0] = (coeffs_H[0] - d3) % p
        # add d1*d2*Z, Z = x^n - 1
        coeffs_H[0] = (coeffs_H[0] - d1 * d2) % p
        coeffs_H[n] = (coeffs_H[n] + d1 * d2) % p

    eA = N.coset_ntt(fs, dA, g)
    eB = N.coset_ntt(fs, dB, g)
    eC = N.coset_ntt(fs, dC, g)
    H_ev = L.sub(fs, L.mont_mul(fs, eA, eB), eC)
    # divide_by_z_on_coset: Z(g w^i) = g^n - 1 (constant)
    zinv = pow((pow(g, n, p) - 1) % p, -1, p)
    H_ev = L.mont_mul(fs, H_ev, L.const_mont(fs, zinv, (1,), device))
    H = N.coset_intt(fs, H_ev, g)
    hH = L.decode(fs, H)
    for i in range(n):
        coeffs_H[i] = (coeffs_H[i] + hH[i]) % p

    return QAPWitness(cs.num_variables, n, cs.num_inputs, full, coeffs_H)
