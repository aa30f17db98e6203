"""USCS ppzkSNARK (`systems/ppzksnark/uscs_ppzksnark/`).

Counterpart of `models/uscs_ppzksnark.py` of the JAX package: generator
(`generator.hpp:95-200`), prover (`prover.hpp:69-114`), verifier
(`verifier.hpp:120-185`, on the host): proof = (V_g1, alpha_V_g1, H_g1,
V_g2), checked by
  e(V_g1+acc, G2) == e(G1, V_g2)
  e(V_g1+acc, V_g2) == e(H, Z_g2) * e(G1, G2)
  e(V_g1, alpha_tilde_g2) == e(alpha_V_g1, tilde_g2)

`generate` and `prove` run on `device` (default: the card), as PGHR13's do;
the same draws from the caller's `random.Random` give the same keys and
proofs as the reference.
"""
from __future__ import annotations

import dataclasses
import random

from ..arithmetization import uscs as USCS
from ..fields import curves as CV
from ..fields import tower as T
from ..ops import limbs as L
from .groth16 import _msm_skip_inf, bases_cache, generator_batch


@dataclasses.dataclass
class ProvingKey:
    curve: CV.CurveSpec
    constraint_system: USCS.USCSConstraintSystem
    V_g1_query: list        # len nv - ninputs + 1 (last = Zt slot)
    alpha_V_g1_query: list
    H_g1_query: list        # len degree + 1
    V_g2_query: list        # len nv + 2 (all Vt + Zt slot)


@dataclasses.dataclass
class VerificationKey:
    curve: CV.CurveSpec
    tilde_g2: tuple
    alpha_tilde_g2: tuple
    Z_g2: tuple
    encoded_IC_query: list  # len ninputs + 1


@dataclasses.dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


@dataclasses.dataclass
class Proof:
    V_g1: tuple
    alpha_V_g1: tuple
    H_g1: tuple
    V_g2: tuple


def generate(curve: CV.CurveSpec, cs: USCS.USCSConstraintSystem,
             rng: random.Random | None = None, device=None) -> Keypair:
    device = L.resolve_device(device)
    rng = rng if rng is not None else random.SystemRandom()
    fs = curve.fr
    p = fs.p
    t = rng.randrange(1, p)
    inst = USCS.instance_map_with_evaluation(fs, cs, t)
    Vt_table = list(inst.Vt) + [inst.Zt]
    Xt_table = inst.Vt[: inst.num_inputs + 1]
    Vt_minus_Xt = inst.Vt[inst.num_inputs + 1:] + [inst.Zt]
    alpha = rng.randrange(1, p)
    tilde = rng.randrange(1, p)

    def e1s(ks):
        return generator_batch(curve, [k % p for k in ks], "g1", device)

    def e2s(ks):
        return generator_batch(curve, [k % p for k in ks], "g2", device)

    pk = ProvingKey(curve, cs, e1s(Vt_minus_Xt),
                    e1s([alpha * v for v in Vt_minus_Xt]), e1s(inst.Ht),
                    e2s(Vt_table))
    vk = VerificationKey(curve, *e2s([tilde, alpha * tilde, inst.Zt]),
                         e1s(Xt_table))
    return Keypair(pk, vk)


def prove(pk: ProvingKey, primary: list[int], aux: list[int],
          rng: random.Random | None = None,
          zk_d: int | None = None, device=None) -> Proof:
    device = L.resolve_device(device)
    curve = pk.curve
    fs = curve.fr
    p = fs.p
    rng = rng if rng is not None else random.SystemRandom()
    d = zk_d if zk_d is not None else rng.randrange(p)
    wit = USCS.witness_map(fs, pk.constraint_system, primary, aux, d,
                           device=device)
    nv, ninp = wit.num_variables, wit.num_inputs
    ws = wit.coefficients_for_Vs
    cache = bases_cache(pk, device)

    def msm(name, bases, scalars, group="g1"):
        return _msm_skip_inf(curve, bases, scalars, group=group,
                             bases_cache=cache, cache_key=name,
                             device=device)

    def add1(a, b):
        return CV.g1_add(curve, a, b)

    V_g1 = CV.g1_mul(curve, pk.V_g1_query[-1], d)
    V_g1 = add1(V_g1, msm("V", pk.V_g1_query[: nv - ninp], ws[ninp:nv]))
    alpha_V_g1 = CV.g1_mul(curve, pk.alpha_V_g1_query[-1], d)
    alpha_V_g1 = add1(alpha_V_g1, msm("alpha_V",
                                      pk.alpha_V_g1_query[: nv - ninp],
                                      ws[ninp:nv]))
    H_g1 = msm("H", pk.H_g1_query, wit.coefficients_for_H)
    V_g2 = CV.g2_add(curve, pk.V_g2_query[0],
                     CV.g2_mul(curve, pk.V_g2_query[-1], d))
    V_g2 = CV.g2_add(curve, V_g2, msm("V2", pk.V_g2_query[1: nv + 1], ws,
                                      group="g2"))
    return Proof(V_g1, alpha_V_g1, H_g1, V_g2)


def verify(vk: VerificationKey, primary: list[int], proof: Proof) -> bool:
    curve = vk.curve
    acc = vk.encoded_IC_query[0]
    for i, x in enumerate(primary):
        acc = CV.g1_add(curve, acc,
                        CV.g1_mul(curve, vk.encoded_IC_query[i + 1], x))
    V_with_acc = CV.g1_add(curve, proof.V_g1, acc)
    one = T.FQ12_ONE
    mp = CV.multi_pairing
    # e(V+acc, G2) == e(G1, V_g2)
    if mp(curve, [(V_with_acc, curve.g2),
                  (CV.g1_neg(curve, curve.g1), proof.V_g2)]) != one:
        return False
    # e(V+acc, V_g2) == e(H, Z) * e(G1, G2)
    if mp(curve, [(V_with_acc, proof.V_g2),
                  (CV.g1_neg(curve, proof.H_g1), vk.Z_g2),
                  (CV.g1_neg(curve, curve.g1), curve.g2)]) != one:
        return False
    # e(V_g1, alpha_tilde) == e(alpha_V_g1, tilde)
    if mp(curve, [(proof.V_g1, vk.alpha_tilde_g2),
                  (CV.g1_neg(curve, proof.alpha_V_g1), vk.tilde_g2)]) != one:
        return False
    return True
