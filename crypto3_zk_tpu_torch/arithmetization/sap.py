"""R1CS -> SAP reduction (square arithmetic programs, for GM17).

Counterpart of `arithmetization/sap.py` of the JAX package
(`snark/reductions/r1cs_to_sap.hpp`): each R1CS constraint a*b=c becomes two
square constraints (a+b)^2 = 4c + x' and (a-b)^2 = x' with one extra
variable per constraint, plus 2 constraints + 1 extra variable per public
input for input consistency. Witness map = "A^2 - C over the coset": two
iNTTs, two coset NTTs and a coset iNTT through `ops/ntt.py` (kernels 1 and
2 on the card), on `device` (default: the card).
"""
from __future__ import annotations

import dataclasses

from ..fields.params import FieldSpec
from ..ops import limbs as L
from ..ops import ntt as N
from ..poly.domain import Domain, get_domain
from .r1cs import R1CSConstraintSystem


def sap_domain(fs: FieldSpec, cs: R1CSConstraintSystem) -> Domain:
    need = 2 * cs.num_constraints + 2 * cs.num_inputs + 1
    n = 1 << (need - 1).bit_length()
    return get_domain(fs, n)


@dataclasses.dataclass
class SAPInstanceEvaluation:
    domain: Domain
    num_variables: int
    degree: int
    num_inputs: int
    t: int
    At: list[int]
    Ct: list[int]
    Ht: list[int]
    Zt: int


def instance_map_with_evaluation(fs: FieldSpec, cs: R1CSConstraintSystem,
                                 t: int) -> SAPInstanceEvaluation:
    """`r1cs_to_sap.hpp:205-285`."""
    p = fs.p
    domain = sap_domain(fs, cs)
    nv = cs.num_variables + cs.num_constraints + cs.num_inputs
    At = [0] * (nv + 1)
    Ct = [0] * (nv + 1)
    Zt = domain.evaluate_vanishing(t)
    u = domain.evaluate_all_lagrange(t)
    extra_var_offset = cs.num_variables + 1
    for i, cst in enumerate(cs.constraints):
        for idx, coeff in cst.a.terms:
            At[idx] = (At[idx] + u[2 * i] * coeff + u[2 * i + 1] * coeff) % p
        for idx, coeff in cst.b.terms:
            At[idx] = (At[idx] + u[2 * i] * coeff - u[2 * i + 1] * coeff) % p
        for idx, coeff in cst.c.terms:
            Ct[idx] = (Ct[idx] + 4 * u[2 * i] * coeff) % p
        Ct[extra_var_offset + i] = (Ct[extra_var_offset + i]
                                    + u[2 * i] + u[2 * i + 1]) % p
    eco = 2 * cs.num_constraints
    evo2 = cs.num_variables + cs.num_constraints
    At[0] = (At[0] + u[eco]) % p
    Ct[0] = (Ct[0] + u[eco]) % p
    for i in range(1, cs.num_inputs + 1):
        At[i] = (At[i] + u[eco + 2 * i - 1]) % p
        At[0] = (At[0] + u[eco + 2 * i - 1]) % p
        Ct[i] = (Ct[i] + 4 * u[eco + 2 * i - 1]) % p
        Ct[evo2 + i] = (Ct[evo2 + i] + u[eco + 2 * i - 1]) % p
        At[i] = (At[i] + u[eco + 2 * i]) % p
        At[0] = (At[0] - u[eco + 2 * i]) % p
        Ct[evo2 + i] = (Ct[evo2 + i] + u[eco + 2 * i]) % p
    Ht = [pow(t, i, p) for i in range(domain.n + 1)]
    return SAPInstanceEvaluation(domain, nv, domain.n, cs.num_inputs, t,
                                 At, Ct, Ht, Zt)


@dataclasses.dataclass
class SAPWitness:
    num_variables: int
    degree: int
    num_inputs: int
    d1: int
    d2: int
    coefficients_for_ACs: list[int]
    coefficients_for_H: list[int]


def witness_map(fs: FieldSpec, cs: R1CSConstraintSystem,
                primary: list[int], aux: list[int],
                d1: int = 0, d2: int = 0, device=None) -> SAPWitness:
    """`r1cs_to_sap.hpp:314-470` with the NTT pipeline on `device`."""
    p = fs.p
    device = L.resolve_device(device)
    assert cs.is_satisfied(p, primary, aux)
    domain = sap_domain(fs, cs)
    n = domain.n
    full = list(primary) + list(aux)
    full_one = [1] + full
    # extra vars: (a-b)^2 per constraint, then (x_i - 1)^2 per input
    for cst in cs.constraints:
        v = (cst.a.evaluate(p, full_one) - cst.b.evaluate(p, full_one)) % p
        full.append(v * v % p)
        full_one.append(full[-1])
    for i in range(1, cs.num_inputs + 1):
        v = (full_one[i] - 1) % p
        full.append(v * v % p)
        full_one.append(full[-1])

    aA = [0] * n
    aC = [0] * n
    extra_var_offset = cs.num_variables + 1
    for i, cst in enumerate(cs.constraints):
        av = cst.a.evaluate(p, full_one)
        bv = cst.b.evaluate(p, full_one)
        cv = cst.c.evaluate(p, full_one)
        aA[2 * i] = (av + bv) % p
        aA[2 * i + 1] = (av - bv) % p
        aC[2 * i] = (4 * cv + full_one[extra_var_offset + i]) % p
        aC[2 * i + 1] = full_one[extra_var_offset + i]
    eco = 2 * cs.num_constraints
    evo2 = cs.num_variables + cs.num_constraints
    aA[eco] = 1
    aC[eco] = 1
    for i in range(1, cs.num_inputs + 1):
        aA[eco + 2 * i - 1] = (full_one[i] + 1) % p
        aA[eco + 2 * i] = (full_one[i] - 1) % p
        aC[eco + 2 * i - 1] = (4 * full_one[i] + full_one[evo2 + i]) % p
        aC[eco + 2 * i] = full_one[evo2 + i]

    g = fs.generator
    dA = domain.ifft(L.encode(fs, aA, device))
    coeffs_H = [0] * (n + 1)
    if d1 or d2:
        hA = L.decode(fs, dA)
        for i in range(n):
            coeffs_H[i] = 2 * d1 * hA[i] % p
        coeffs_H[0] = (coeffs_H[0] - d2 - d1 * d1) % p
        coeffs_H[n] = (coeffs_H[n] + d1 * d1) % p
    eA = N.coset_ntt(fs, dA, g)
    H_ev = L.mont_mul(fs, eA, eA)
    dC = domain.ifft(L.encode(fs, aC, device))
    eC = N.coset_ntt(fs, dC, g)
    H_ev = L.sub(fs, H_ev, eC)
    zinv = pow((pow(g, n, p) - 1) % p, -1, p)
    H_ev = L.mont_mul(fs, H_ev, L.const_mont(fs, zinv, (1,), device))
    H = N.coset_intt(fs, H_ev, g)
    hH = L.decode(fs, H)
    for i in range(n):
        coeffs_H[i] = (coeffs_H[i] + hH[i]) % p

    return SAPWitness(cs.num_variables + cs.num_constraints + cs.num_inputs,
                      n, cs.num_inputs, d1, d2, full, coeffs_H)
