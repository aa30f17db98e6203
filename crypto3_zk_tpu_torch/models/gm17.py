"""GM17 (r1cs_se_ppzksnark) — simulation-extractable SNARK over SAP.

Counterpart of `models/gm17.py` of the JAX package
(`systems/ppzksnark/r1cs_se_ppzksnark/{generator,prover,verifier}.hpp`):
- generator (`generator.hpp:80-230`): SAP at toxic t; queries
  A (gamma A_i G), B (A_i H_gamma), C_1 (gamma(gamma C_i + (a+b)A_i) G),
  C_2 (2 gamma^2 Z A_i G), G_gamma2_Z_t (gamma^2 Z t^i G), verifier_query;
- prover (`prover.hpp:70-160`): SAP witness map + 5 MSMs (one in G2);
- verifier (`verifier.hpp:120-180`), on the host:
  e(A + G_alpha, B + H_beta) == e(G_alpha, H_beta) e(G_psi, H_gamma) e(C, H)
  and e(A, H_gamma) == e(G_gamma, B).

`generate` and `prove` run on `device` (default: the card), as PGHR13's do;
the same draws from the caller's `random.Random` give the same keys and
proofs as the reference.
"""
from __future__ import annotations

import dataclasses
import random

from ..arithmetization import sap as SAP
from ..arithmetization.r1cs import R1CSConstraintSystem
from ..fields import curves as CV
from ..fields import tower as T
from ..ops import limbs as L
from .groth16 import _msm_skip_inf, bases_cache, generator_batch


@dataclasses.dataclass
class ProvingKey:
    curve: CV.CurveSpec
    constraint_system: R1CSConstraintSystem
    A_query: list       # G1, len nv+1
    B_query: list       # G2, len nv+1
    C_query_1: list     # G1, len nv - num_inputs
    C_query_2: list     # G1, len nv+1
    G_gamma_Z: tuple
    H_gamma_Z: tuple
    G_ab_gamma_Z: tuple
    G_gamma2_Z2: tuple
    G_gamma2_Z_t: list  # G1, len degree+1


@dataclasses.dataclass
class VerificationKey:
    curve: CV.CurveSpec
    H: tuple
    G_alpha: tuple
    H_beta: tuple
    G_gamma: tuple
    H_gamma: tuple
    query: list


@dataclasses.dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


@dataclasses.dataclass
class Proof:
    A: tuple
    B: tuple  # G2
    C: tuple


def generate(curve: CV.CurveSpec, cs: R1CSConstraintSystem,
             rng: random.Random | None = None, device=None) -> Keypair:
    device = L.resolve_device(device)
    rng = rng if rng is not None else random.SystemRandom()
    fs = curve.fr
    p = fs.p
    while True:
        t = rng.randrange(1, p)
        inst = SAP.instance_map_with_evaluation(fs, cs, t)
        if inst.Zt != 0:
            break
    alpha = rng.randrange(1, p)
    beta = rng.randrange(1, p)
    gamma = rng.randrange(1, p)
    At, Ct, Zt = inst.At, inst.Ct, inst.Zt

    def e1s(ks):
        return generator_batch(curve, [k % p for k in ks], "g1", device)

    def e2s(ks):
        return generator_batch(curve, [k % p for k in ks], "g2", device)

    verifier_query = e1s([gamma * Ct[i] + (alpha + beta) * At[i]
                          for i in range(inst.num_inputs + 1)])
    A_query = e1s([gamma * a for a in At])
    B_query = e2s([gamma * a for a in At])
    G_gamma_Z, G_ab_gamma_Z, G_gamma2_Z2 = e1s(
        [gamma * Zt, (alpha + beta) * gamma * Zt, gamma * gamma * Zt * Zt])
    H_gamma_Z, = e2s([gamma * Zt])
    g2zt = gamma * gamma % p * Zt % p
    powers, acc = [], g2zt
    for _ in range(inst.degree + 1):
        powers.append(acc)
        acc = acc * t % p
    G_gamma2_Z_t = e1s(powers)
    C_query_1 = e1s([gamma * (gamma * Ct[i] + (alpha + beta) * At[i])
                     for i in range(inst.num_inputs + 1,
                                    inst.num_variables + 1)])
    dgz = 2 * gamma * gamma % p * Zt % p
    C_query_2 = e1s([dgz * a for a in At])

    pk = ProvingKey(curve, cs, A_query, B_query, C_query_1, C_query_2,
                    G_gamma_Z, H_gamma_Z, G_ab_gamma_Z, G_gamma2_Z2,
                    G_gamma2_Z_t)
    G_alpha, G_gamma = e1s([alpha, gamma])
    H_beta, H_gamma = e2s([beta, gamma])
    vk = VerificationKey(curve, curve.g2, G_alpha, H_beta, G_gamma, H_gamma,
                         verifier_query)
    return Keypair(pk, vk)


def prove(pk: ProvingKey, primary: list[int], aux: list[int],
          rng: random.Random | None = None,
          zk: tuple[int, int, int] | None = None, device=None) -> Proof:
    device = L.resolve_device(device)
    curve = pk.curve
    fs = curve.fr
    p = fs.p
    rng = rng if rng is not None else random.SystemRandom()
    d1, d2, r = zk if zk is not None else (
        rng.randrange(p), rng.randrange(p), rng.randrange(p))
    wit = SAP.witness_map(fs, pk.constraint_system, primary, aux, d1, d2,
                          device=device)
    acs = wit.coefficients_for_ACs
    cache = bases_cache(pk, device)

    def msm(name, bases, scalars, group="g1"):
        return _msm_skip_inf(curve, bases, scalars, group=group,
                             bases_cache=cache, cache_key=name,
                             device=device)

    def g1m(pt, k):
        return CV.g1_mul(curve, pt, k % p)

    def g1a(a, b):
        return CV.g1_add(curve, a, b)

    A = g1a(g1a(g1m(pk.G_gamma_Z, r), pk.A_query[0]),
            g1a(g1m(pk.G_gamma_Z, d1), msm("A", pk.A_query[1:], acs)))
    B = CV.g2_add(curve,
                  CV.g2_add(curve, CV.g2_mul(curve, pk.H_gamma_Z, r % p),
                            pk.B_query[0]),
                  CV.g2_add(curve, CV.g2_mul(curve, pk.H_gamma_Z, d1 % p),
                            msm("B", pk.B_query[1:], acs, group="g2")))
    C = msm("C1", pk.C_query_1, acs[wit.num_inputs:])
    C = g1a(C, g1m(pk.G_gamma2_Z2, r * r % p))
    C = g1a(C, g1m(pk.G_ab_gamma_Z, (r + d1) % p))
    C = g1a(C, g1m(pk.C_query_2[0], r))
    C = g1a(C, g1m(pk.G_gamma2_Z2, 2 * r * d1 % p))
    C = g1a(C, g1m(msm("C2", pk.C_query_2[1:], acs), r))
    C = g1a(C, g1m(pk.G_gamma2_Z_t[0], d2))
    C = g1a(C, msm("Z", pk.G_gamma2_Z_t, wit.coefficients_for_H))
    return Proof(A=A, B=B, C=C)


def verify(vk: VerificationKey, primary: list[int], proof: Proof) -> bool:
    """`verifier.hpp:120-180`, on the host."""
    curve = vk.curve
    assert len(vk.query) == len(primary) + 1
    if not (CV.g1_well_formed(curve, proof.A)
            and CV.g2_well_formed(curve, proof.B)
            and CV.g1_well_formed(curve, proof.C)):
        return False
    G_psi = vk.query[0]
    for i, x in enumerate(primary):
        G_psi = CV.g1_add(curve, G_psi, CV.g1_mul(curve, vk.query[i + 1], x))

    # test 1: e(A + G_alpha, B + H_beta) == e(G_alpha, H_beta)
    #         * e(G_psi, H_gamma) * e(C, H)
    lhs = CV.multi_pairing(curve, [
        (CV.g1_add(curve, proof.A, vk.G_alpha),
         CV.g2_add(curve, proof.B, vk.H_beta)),
        (CV.g1_neg(curve, vk.G_alpha), vk.H_beta),
        (CV.g1_neg(curve, G_psi), vk.H_gamma),
        (CV.g1_neg(curve, proof.C), vk.H),
    ])
    if lhs != T.FQ12_ONE:
        return False
    # test 2: e(A, H_gamma) == e(G_gamma, B)
    lhs2 = CV.multi_pairing(curve, [
        (proof.A, vk.H_gamma),
        (CV.g1_neg(curve, vk.G_gamma), proof.B),
    ])
    return lhs2 == T.FQ12_ONE
