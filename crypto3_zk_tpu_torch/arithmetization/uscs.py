"""USCS (unitary-square constraint systems) + SSP (square span programs).

Counterpart of `arithmetization/uscs.py` of the JAX package
(`constraint_satisfaction_problems/uscs.hpp` + `arithmetic_programs/ssp.hpp`
+ `reductions/uscs_to_ssp.hpp`): each constraint is one linear combination
whose value must be +-1; SSP asks (V(z))^2 - 1 divisible by Z(z). The
witness map's transforms go through `ops/ntt.py` (kernels 1 and 2 on the
card), on `device` (default: the card).
"""
from __future__ import annotations

import dataclasses

from ..fields.params import FieldSpec
from ..ops import limbs as L
from ..ops import ntt as N
from ..poly.domain import Domain, get_domain
from .r1cs import LinearCombination


@dataclasses.dataclass
class USCSConstraintSystem:
    primary_input_size: int
    auxiliary_input_size: int
    constraints: list[LinearCombination] = dataclasses.field(default_factory=list)

    @property
    def num_inputs(self):
        return self.primary_input_size

    @property
    def num_variables(self):
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_constraints(self):
        return len(self.constraints)

    def add_constraint(self, lc: LinearCombination):
        self.constraints.append(lc)

    def is_satisfied(self, p: int, primary, aux) -> bool:
        full = [1] + list(primary) + list(aux)
        for lc in self.constraints:
            v = lc.evaluate(p, full)
            if v != 1 and v != p - 1:
                return False
        return True


def uscs_domain(fs: FieldSpec, cs: USCSConstraintSystem) -> Domain:
    n = max(cs.num_constraints, 1)
    return get_domain(fs, 1 << (n - 1).bit_length())


@dataclasses.dataclass
class SSPInstanceEvaluation:
    domain: Domain
    num_variables: int
    degree: int
    num_inputs: int
    t: int
    Vt: list[int]
    Ht: list[int]
    Zt: int


def instance_map_with_evaluation(fs: FieldSpec, cs: USCSConstraintSystem,
                                 t: int) -> SSPInstanceEvaluation:
    """`uscs_to_ssp.hpp:110-145`."""
    p = fs.p
    domain = uscs_domain(fs, cs)
    Vt = [0] * (cs.num_variables + 1)
    Zt = domain.evaluate_vanishing(t)
    u = domain.evaluate_all_lagrange(t)
    for i, lc in enumerate(cs.constraints):
        for idx, coeff in lc.terms:
            Vt[idx] = (Vt[idx] + u[i] * coeff) % p
    for i in range(cs.num_constraints, domain.n):
        Vt[0] = (Vt[0] + u[i]) % p       # dummy constraint 1^2 = 1
    Ht = [pow(t, i, p) for i in range(domain.n + 1)]
    return SSPInstanceEvaluation(domain, cs.num_variables, domain.n,
                                 cs.num_inputs, t, Vt, Ht, Zt)


@dataclasses.dataclass
class SSPWitness:
    num_variables: int
    degree: int
    num_inputs: int
    d: int
    coefficients_for_Vs: list[int]
    coefficients_for_H: list[int]


def witness_map(fs: FieldSpec, cs: USCSConstraintSystem,
                primary: list[int], aux: list[int],
                d: int = 0, device=None) -> SSPWitness:
    """`uscs_to_ssp.hpp:147-230`: H = (V^2 - 1)/Z on the coset, the
    transforms on `device`."""
    p = fs.p
    device = L.resolve_device(device)
    assert cs.is_satisfied(p, primary, aux)
    domain = uscs_domain(fs, cs)
    n = domain.n
    full = list(primary) + list(aux)
    full_one = [1] + full

    aV = [0] * n
    for i, lc in enumerate(cs.constraints):
        aV[i] = lc.evaluate(p, full_one)
    for i in range(cs.num_constraints, n):
        aV[i] = 1

    g = fs.generator
    dV = domain.ifft(L.encode(fs, aV, device))
    coeffs_H = [0] * (n + 1)
    if d:
        hV = L.decode(fs, dV)
        for i in range(n):
            coeffs_H[i] = 2 * d * hV[i] % p
        coeffs_H[0] = (coeffs_H[0] - d * d) % p
        coeffs_H[n] = (coeffs_H[n] + d * d) % p
    eV = N.coset_ntt(fs, dV, g)
    H_ev = L.sub(fs, L.mont_mul(fs, eV, eV), L.ones_mont(fs, (n,), device))
    zinv = pow((pow(g, n, p) - 1) % p, -1, p)
    H_ev = L.mont_mul(fs, H_ev, L.const_mont(fs, zinv, (1,), device))
    H = N.coset_intt(fs, H_ev, g)
    hH = L.decode(fs, H)
    for i in range(n):
        coeffs_H[i] = (coeffs_H[i] + hH[i]) % p
    return SSPWitness(cs.num_variables, n, cs.num_inputs, d, full, coeffs_H)
