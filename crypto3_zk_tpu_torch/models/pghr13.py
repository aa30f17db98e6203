"""PGHR13 / BCTV14a (r1cs_ppzksnark) — the classic 8-element SNARK.

Counterpart of `models/pghr13.py` of the JAX package
(`systems/ppzksnark/r1cs_ppzksnark/{generator,prover,verifier}.hpp`): proof =
(g_A, g_B, g_C knowledge commitments, g_H, g_K); the verifier checks the
three knowledge-commitment pairings, the QAP divisibility pairing and the
same-coefficient K check. Knowledge commitments are (g, h) pairs
(`knowledge_commitment.hpp:50`); g_B's g lives in G2.

`generate` and `prove` run on `device` (default: the card): the key's
query vectors by the fixed-base batch, the witness map's transforms and
the MSMs (G1 and, for B, G2) by the batched-affine MSM over bases encoded
once per key. Randomness is drawn from the caller's `random.Random` in the
reference's order, so the same draws give the same keys and proofs.
"""
from __future__ import annotations

import dataclasses
import random

from ..arithmetization import qap as QAP
from ..arithmetization.r1cs import R1CSConstraintSystem
from ..commitments.knowledge_commitment import KC, kc_multiexp
from ..fields import curves as CV
from ..fields import tower as T
from ..ops import limbs as L
from .groth16 import _msm_skip_inf, bases_cache, generator_batch


@dataclasses.dataclass
class ProvingKey:
    curve: CV.CurveSpec
    constraint_system: R1CSConstraintSystem
    A_query: list[KC]    # (G1, G1), len nv+2 (last = Zt slot)
    B_query: list[KC]    # (G2, G1)
    C_query: list[KC]    # (G1, G1)
    H_query: list        # G1, len degree+1
    K_query: list        # G1, len nv+4


@dataclasses.dataclass
class VerificationKey:
    curve: CV.CurveSpec
    alphaA_g2: tuple
    alphaB_g1: tuple
    alphaC_g2: tuple
    gamma_g2: tuple
    gamma_beta_g1: tuple
    gamma_beta_g2: tuple
    rC_Z_g2: tuple
    encoded_IC_query: list   # G1, len num_inputs+1


@dataclasses.dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


@dataclasses.dataclass
class Proof:
    g_A: KC
    g_B: KC
    g_C: KC
    g_H: tuple
    g_K: tuple


def generate(curve: CV.CurveSpec, cs: R1CSConstraintSystem,
             rng: random.Random | None = None, device=None) -> Keypair:
    """`r1cs_ppzksnark_generator` (generator.hpp:95-230)."""
    device = L.resolve_device(device)
    rng = rng if rng is not None else random.SystemRandom()
    fs = curve.fr
    p = fs.p
    cs.swap_AB_if_beneficial()
    t = rng.randrange(1, p)
    qap = QAP.instance_map_with_evaluation(fs, cs, t)
    At = list(qap.At) + [qap.Zt]
    Bt = list(qap.Bt) + [qap.Zt]
    Ct = list(qap.Ct) + [qap.Zt]
    Ht = qap.Ht
    alphaA, alphaB, alphaC, rA, rB, beta, gamma = (
        rng.randrange(1, p) for _ in range(7))
    rC = rA * rB % p

    Kt = [beta * (rA * At[i] + rB * Bt[i] + rC * Ct[i]) % p
          for i in range(qap.num_variables + 1)]
    Kt += [beta * rA * qap.Zt % p, beta * rB * qap.Zt % p,
           beta * rC * qap.Zt % p]

    IC_coefficients = At[: qap.num_inputs + 1]
    for i in range(qap.num_inputs + 1):
        At[i] = 0

    def e1s(ks):
        return generator_batch(curve, [k % p for k in ks], "g1", device)

    def e2s(ks):
        return generator_batch(curve, [k % p for k in ks], "g2", device)

    def kcs(gs, hs):
        return [KC(g, h) for g, h in zip(gs, hs)]

    A_query = kcs(e1s([rA * a for a in At]),
                  e1s([rA * alphaA % p * a for a in At]))
    B_query = kcs(e2s([rB * b for b in Bt]),
                  e1s([rB * alphaB % p * b for b in Bt]))
    C_query = kcs(e1s([rC * c for c in Ct]),
                  e1s([rC * alphaC % p * c for c in Ct]))
    H_query = e1s(Ht)
    K_query = e1s(Kt)

    vk = VerificationKey(
        curve, *e2s([alphaA]), *e1s([alphaB]), *e2s([alphaC]),
        *e2s([gamma]), *e1s([gamma * beta]), *e2s([gamma * beta]),
        *e2s([rC * qap.Zt]), e1s([rA * ic % p for ic in IC_coefficients]))
    pk = ProvingKey(curve, cs, A_query, B_query, C_query, H_query, K_query)
    return Keypair(pk, vk)


def _kc_add(curve, a: KC, b: KC, g2_main=False):
    if g2_main:
        return KC(CV.g2_add(curve, a.g, b.g), CV.g1_add(curve, a.h, b.h))
    return KC(CV.g1_add(curve, a.g, b.g), CV.g1_add(curve, a.h, b.h))


def _kc_mul(curve, a: KC, k, g2_main=False):
    if g2_main:
        return KC(CV.g2_mul(curve, a.g, k), CV.g1_mul(curve, a.h, k))
    return KC(CV.g1_mul(curve, a.g, k), CV.g1_mul(curve, a.h, k))


def prove(pk: ProvingKey, primary: list[int], aux: list[int],
          rng: random.Random | None = None,
          zk: tuple[int, int, int] | None = None, device=None) -> Proof:
    """`r1cs_ppzksnark_prover` (prover.hpp:73-132)."""
    device = L.resolve_device(device)
    curve = pk.curve
    fs = curve.fr
    p = fs.p
    rng = rng if rng is not None else random.SystemRandom()
    d1, d2, d3 = zk if zk is not None else (
        rng.randrange(p), rng.randrange(p), rng.randrange(p))
    wit = QAP.witness_map(fs, pk.constraint_system, primary, aux, d1, d2, d3,
                          device=device)
    nv = wit.num_variables
    coeffs = wit.coefficients_for_ABCs
    cache = bases_cache(pk, device)

    def msm(name, bases, scalars, group="g1"):
        return _msm_skip_inf(curve, bases, scalars, group=group,
                             bases_cache=cache, cache_key=name,
                             device=device)

    def kc_msm(name, query, g2_main=False):
        parts = iter((name + ".g", name + ".h"))     # g's MSM, then h's
        return KC(*kc_multiexp(
            curve, query, coeffs, g2_main=g2_main,
            msm_skip_inf=lambda c, b, s, group="g1", **_: msm(
                next(parts), b, s, group)))

    g_A = _kc_add(curve, pk.A_query[0], _kc_mul(curve, pk.A_query[nv + 1], d1))
    g_B = _kc_add(curve, pk.B_query[0],
                  _kc_mul(curve, pk.B_query[nv + 1], d2, True), True)
    g_C = _kc_add(curve, pk.C_query[0], _kc_mul(curve, pk.C_query[nv + 1], d3))

    g_A = _kc_add(curve, g_A, kc_msm("A", pk.A_query[1:nv + 1]))
    g_B = _kc_add(curve, g_B, kc_msm("B", pk.B_query[1:nv + 1], True), True)
    g_C = _kc_add(curve, g_C, kc_msm("C", pk.C_query[1:nv + 1]))

    g_H = msm("H", pk.H_query[: wit.degree + 1],
              wit.coefficients_for_H[: wit.degree + 1])
    g_K = pk.K_query[0]
    g_K = CV.g1_add(curve, g_K, CV.g1_mul(curve, pk.K_query[nv + 1], d1))
    g_K = CV.g1_add(curve, g_K, CV.g1_mul(curve, pk.K_query[nv + 2], d2))
    g_K = CV.g1_add(curve, g_K, CV.g1_mul(curve, pk.K_query[nv + 3], d3))
    g_K = CV.g1_add(curve, g_K, msm("K", pk.K_query[1:nv + 1], coeffs))
    return Proof(g_A, g_B, g_C, g_H, g_K)


def verify(vk: VerificationKey, primary: list[int], proof: Proof) -> bool:
    """`r1cs_ppzksnark_verifier_weak_input_consistency`
    (verifier.hpp:120-200), on the host."""
    curve = vk.curve
    # proof.is_well_formed() gate: g_B's knowledge commitment lives in
    # (G2, G1); every other element in G1.
    if not (CV.g1_well_formed(curve, proof.g_A.g)
            and CV.g1_well_formed(curve, proof.g_A.h)
            and CV.g2_well_formed(curve, proof.g_B.g)
            and CV.g1_well_formed(curve, proof.g_B.h)
            and CV.g1_well_formed(curve, proof.g_C.g)
            and CV.g1_well_formed(curve, proof.g_C.h)
            and CV.g1_well_formed(curve, proof.g_H)
            and CV.g1_well_formed(curve, proof.g_K)):
        return False
    acc = vk.encoded_IC_query[0]
    for i, x in enumerate(primary):
        acc = CV.g1_add(curve, acc,
                        CV.g1_mul(curve, vk.encoded_IC_query[i + 1], x))

    one = T.FQ12_ONE
    mp = CV.multi_pairing

    def neg1(a):
        return CV.g1_neg(curve, a)

    # knowledge commitment checks
    if mp(curve, [(proof.g_A.g, vk.alphaA_g2),
                  (neg1(proof.g_A.h), curve.g2)]) != one:
        return False
    if mp(curve, [(vk.alphaB_g1, proof.g_B.g),
                  (neg1(proof.g_B.h), curve.g2)]) != one:
        return False
    if mp(curve, [(proof.g_C.g, vk.alphaC_g2),
                  (neg1(proof.g_C.h), curve.g2)]) != one:
        return False
    # QAP divisibility
    a_acc = CV.g1_add(curve, proof.g_A.g, acc)
    if mp(curve, [(a_acc, proof.g_B.g),
                  (neg1(proof.g_H), vk.rC_Z_g2),
                  (neg1(proof.g_C.g), curve.g2)]) != one:
        return False
    # same-coefficient check
    a_acc_c = CV.g1_add(curve, a_acc, proof.g_C.g)
    if mp(curve, [(proof.g_K, vk.gamma_g2),
                  (neg1(a_acc_c), vk.gamma_beta_g2),
                  (neg1(vk.gamma_beta_g1), proof.g_B.g)]) != one:
        return False
    return True
