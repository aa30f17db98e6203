"""Groth16 (r1cs_gg_ppzksnark).

Counterpart of `models/groth16/__init__.py` of the JAX package
(`systems/ppzksnark/r1cs_gg_ppzksnark/` of the C++ original):
- generator (`generator.hpp:86-236`): QAP instance evaluated at toxic t,
  queries A/B/H/L via device windowed fixed-base batch exponentiation
  (`ops/msm.py::fixed_base_exp_batch`), vk with precomputed e(alpha, beta).
- prover (`prover.hpp:73-158`): device witness map (7 NTTs, `qap.py`) +
  four G1 MSMs and one G2 MSM, all through the batched-affine MSM
  (`ops/msm_affine.py`) -> (g_A, g_B, g_C).
- verifier (`verifier.hpp:138-187`): one multi-pairing check
  e(A,B) == e(alpha,beta) * e(acc,gamma) * e(C,delta), host-side.

`generate` and `prove` take the device explicitly; the default is the card
and there is no silent fallback to the CPU. `prove` records the seconds of
its phases in `LAST_PROVE_SECONDS`.
"""
from __future__ import annotations

import dataclasses
import random
import time

from ...arithmetization import qap as QAP
from ...arithmetization.r1cs import R1CSConstraintSystem
from ...fields import curves as CV
from ...ops import limbs as L
from ...ops.msm import fixed_base_exp_batch, msm_host
from ...ops.msm_affine import MSMBases

# Below this count the host double-and-add is faster than paying a device
# dispatch; above it the generator's queries go through the batched windowed
# fixed-base path (generator.hpp:163-229's window tables).
_FIXED_BASE_DEVICE_MIN = 64
# From this many bases on, an MSM runs on the device (module constants, so a
# test can lower the threshold and narrow the windows).
_DEVICE_MSM_MIN = 512
_MSM_WINDOW_BITS = 16

# seconds of the phases of the last `prove` call (host clock, each phase
# ending in host results)
LAST_PROVE_SECONDS: dict[str, float] = {}


@dataclasses.dataclass
class ProvingKey:
    curve: CV.CurveSpec
    constraint_system: R1CSConstraintSystem
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    A_query: list          # G1, len nv+1
    B_query_g1: list       # G1, len nv+1
    B_query_g2: list       # G2, len nv+1
    H_query: list          # G1, len degree-1
    L_query: list          # G1, len nv - num_inputs


@dataclasses.dataclass
class VerificationKey:
    curve: CV.CurveSpec
    alpha_g1_beta_g2: tuple       # GT
    gamma_g2: tuple
    delta_g2: tuple
    gamma_ABC_g1: list            # G1, len num_inputs+1 (index 0 = const)
    # carried for the ipp2 aggregate verifier (the reference's
    # r1cs_gg_ppzksnark_aggregate_verification_key holds these raw):
    alpha_g1: tuple | None = None
    beta_g2: tuple | None = None


@dataclasses.dataclass
class Keypair:
    pk: ProvingKey
    vk: VerificationKey


@dataclasses.dataclass
class Proof:
    g_A: tuple
    g_B: tuple    # G2
    g_C: tuple


def generate(curve: CV.CurveSpec, cs: R1CSConstraintSystem,
             rng: random.Random | None = None,
             toxic: dict | None = None, device=None) -> Keypair:
    """`r1cs_gg_ppzksnark_generator::process` (generator.hpp:86-236,393).
    `toxic` allows deterministic test CRS ({t, alpha, beta, gamma, delta})."""
    device = L.resolve_device(device)
    rng = rng if rng is not None else random.SystemRandom()
    fs = curve.fr
    p = fs.p
    cs.swap_AB_if_beneficial()
    tox = toxic or {}
    t = tox.get("t") or rng.randrange(1, p)
    alpha = tox.get("alpha") or rng.randrange(1, p)
    beta = tox.get("beta") or rng.randrange(1, p)
    gamma = tox.get("gamma") or rng.randrange(1, p)
    delta = tox.get("delta") or rng.randrange(1, p)
    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)

    qap = QAP.instance_map_with_evaluation(fs, cs, t)
    At, Bt, Ct, Ht = qap.At, qap.Bt, qap.Ct, qap.Ht

    gamma_ABC = [(beta * At[i] + alpha * Bt[i] + Ct[i]) * gamma_inv % p
                 for i in range(qap.num_inputs + 1)]
    Lt = [(beta * At[i] + alpha * Bt[i] + Ct[i]) * delta_inv % p
          for i in range(qap.num_inputs + 1, qap.num_variables + 1)]
    Ht = Ht[: len(Ht) - 2]   # Groth16's H is degree d-2

    g1 = curve.g1
    g2 = curve.g2

    def e1(k):
        return CV.g1_mul(curve, g1, k)

    def e2(k):
        return CV.g2_mul(curve, g2, k)

    def batch1(ks):
        return generator_batch(curve, ks, "g1", device)

    def batch2(ks):
        return generator_batch(curve, ks, "g2", device)

    A_query = batch1(At)
    B_query_g1 = batch1(Bt)
    B_query_g2 = batch2(Bt)
    zt_dinv = qap.Zt * delta_inv % p
    H_query = batch1([h * zt_dinv % p for h in Ht])
    L_query = batch1(Lt)

    alpha_g1 = e1(alpha)
    beta_g2 = e2(beta)
    pk = ProvingKey(curve, cs, alpha_g1, e1(beta), beta_g2,
                    e1(delta), e2(delta), A_query, B_query_g1, B_query_g2,
                    H_query, L_query)
    vk = VerificationKey(curve,
                         CV.pairing(curve, alpha_g1, beta_g2),
                         e2(gamma), e2(delta),
                         [e1(v) for v in gamma_ABC],
                         alpha_g1=alpha_g1, beta_g2=beta_g2)
    return Keypair(pk, vk)


def generator_batch(curve, ks: list[int], group: str, device) -> list:
    """[k * g for k in ks] for the group's generator g: the fixed-base batch
    on `device` from `_FIXED_BASE_DEVICE_MIN` scalars on, host scalar
    multiplications below it and on MNT curves (whose G2 lives in
    E(F_{p^k}) tuples the device's Fq2 layout does not model, and whose
    a != 0 the device formulas refuse)."""
    from ...fields import mnt as MNT
    if not isinstance(curve, MNT.MNTCurve) \
            and len(ks) >= _FIXED_BASE_DEVICE_MIN:
        return fixed_base_exp_batch(curve, curve.g1 if group == "g1"
                                    else curve.g2, ks, group=group,
                                    device=device)
    mul = CV.g1_mul if group == "g1" else CV.g2_mul
    gen = curve.g1 if group == "g1" else curve.g2
    return [mul(curve, gen, k) for k in ks]


def bases_cache(pk, device) -> dict:
    """The proving key's device-resident MSM bases (`MSMBases` by query
    name), kept on the key for the device they were encoded on."""
    cache = getattr(pk, "_msm_bases", None)
    if cache is None or cache.get("device") != device:
        cache = {"device": device}
        object.__setattr__(pk, "_msm_bases", cache)
    return cache


def _msm_skip_inf(curve, bases, scalars, group="g1", use_device=True,
                  bases_cache: dict | None = None, cache_key=None,
                  device=None):
    """MSM tolerating infinity bases / zero scalars. Device path: the
    batched-affine MSM (`ops/msm_affine.py`), G1 and G2 alike, with the
    encoded bases cached per proving-key query vector so repeated proofs
    reuse the device-resident tables. Curves with a != 0 (MNT) are refused
    for the device path before anything else: their MSMs run on the host
    scalar layer, whatever their size."""
    p = curve.fr.p
    if getattr(curve, "a", 0) != 0:
        use_device = False
    if use_device and len(bases) >= _DEVICE_MSM_MIN:
        if bases_cache is not None and cache_key in bases_cache:
            mb = bases_cache[cache_key]
        else:
            mb = MSMBases(curve, bases, group, window_bits=_MSM_WINDOW_BITS,
                          device=device)
            if bases_cache is not None:
                bases_cache[cache_key] = mb
        return mb.run(list(scalars))
    pairs = [(b, s % p) for b, s in zip(bases, scalars)
             if b is not None and s % p != 0]
    if not pairs:
        return None
    return msm_host(curve, [b for b, _ in pairs], [s for _, s in pairs],
                    group=group)


def prove(pk: ProvingKey, primary: list[int], aux: list[int],
          rng: random.Random | None = None,
          zk_rs: tuple[int, int] | None = None, device=None) -> Proof:
    """`r1cs_gg_ppzksnark_prover::process` (prover.hpp:73-158)."""
    device = L.resolve_device(device)
    curve = pk.curve
    fs = curve.fr
    p = fs.p
    rng = rng if rng is not None else random.SystemRandom()
    seconds = LAST_PROVE_SECONDS
    seconds.clear()
    t0 = time.perf_counter()
    qap_wit = QAP.witness_map(fs, pk.constraint_system, primary, aux, 0, 0, 0,
                              device=device)
    assert qap_wit.coefficients_for_H[qap_wit.degree - 1] == 0
    assert qap_wit.coefficients_for_H[qap_wit.degree] == 0
    seconds["witness_map"] = time.perf_counter() - t0

    r, s = zk_rs if zk_rs is not None else (rng.randrange(p), rng.randrange(p))
    assignment = [1] + qap_wit.coefficients_for_ABCs

    cache = bases_cache(pk, device)

    def run(name, bases, scalars, group="g1"):
        t = time.perf_counter()
        out = _msm_skip_inf(curve, bases, scalars, group=group,
                            bases_cache=cache, cache_key=name, device=device)
        seconds["msm_" + name] = time.perf_counter() - t
        return out

    eval_At = run("A", pk.A_query, assignment)
    eval_Bt_g1 = run("B1", pk.B_query_g1, assignment)
    eval_Bt_g2 = run("B2", pk.B_query_g2, assignment, group="g2")
    eval_Ht = run("H", pk.H_query,
                  qap_wit.coefficients_for_H[: qap_wit.degree - 1])
    eval_Lt = run("L", pk.L_query, assignment[qap_wit.num_inputs + 1:])

    t0 = time.perf_counter()
    add, mul = (lambda a, b: CV.g1_add(curve, a, b)), \
        (lambda a, k: CV.g1_mul(curve, a, k))
    g1_A = add(add(pk.alpha_g1, eval_At), mul(pk.delta_g1, r))
    g1_B = add(add(pk.beta_g1, eval_Bt_g1), mul(pk.delta_g1, s))
    g2_B = CV.g2_add(curve, CV.g2_add(curve, pk.beta_g2, eval_Bt_g2),
                     CV.g2_mul(curve, pk.delta_g2, s))
    g1_C = add(add(add(add(eval_Ht, eval_Lt), mul(g1_A, s)), mul(g1_B, r)),
               mul(pk.delta_g1, (-r * s) % p))
    seconds["assembly"] = time.perf_counter() - t0
    return Proof(g_A=g1_A, g_B=g2_B, g_C=g1_C)


@dataclasses.dataclass
class ProcessedVerificationKey:
    """`r1cs_gg_ppzksnark_process_verification_key` output
    (verifier.hpp:78-99): the verifier-side constants lifted out of the
    per-proof path. Pairing "precomputation" here is the GT constant plus
    the fixed G2 operands (host pairings are exact-int; there is no
    Miller-precomp table to cache)."""
    curve: CV.CurveSpec
    vk_alpha_g1_beta_g2: tuple
    vk_gamma_g2: tuple
    vk_delta_g2: tuple
    gamma_ABC_g1: list


def process_verification_key(vk: VerificationKey) -> ProcessedVerificationKey:
    return ProcessedVerificationKey(vk.curve, vk.alpha_g1_beta_g2,
                                    vk.gamma_g2, vk.delta_g2,
                                    list(vk.gamma_ABC_g1))


def online_verify_weak_ic(pvk: ProcessedVerificationKey, primary: list[int],
                          proof: Proof) -> bool:
    """`r1cs_gg_ppzksnark_online_verifier_weak_input_consistency`
    (verifier.hpp:188-260)."""
    vk = VerificationKey(pvk.curve, pvk.vk_alpha_g1_beta_g2, pvk.vk_gamma_g2,
                         pvk.vk_delta_g2, pvk.gamma_ABC_g1)
    return verify(vk, primary, proof)


def verify_strong_ic(vk: VerificationKey, primary: list[int],
                     proof: Proof) -> bool:
    """`r1cs_gg_ppzksnark_verifier_strong_input_consistency`
    (verifier.hpp:262-330): requires |primary| == CS.num_inputs exactly;
    the weak variant zero-pads shorter inputs."""
    if len(primary) + 1 != len(vk.gamma_ABC_g1):
        return False
    return verify(vk, primary, proof)


def online_verify_strong_ic(pvk: ProcessedVerificationKey,
                            primary: list[int], proof: Proof) -> bool:
    if len(primary) + 1 != len(pvk.gamma_ABC_g1):
        return False
    return online_verify_weak_ic(pvk, primary, proof)


def verify(vk: VerificationKey, primary: list[int], proof: Proof) -> bool:
    """`r1cs_gg_ppzksnark_verifier_weak_input_consistency` (verifier.hpp:
    138-187): e(A,B) * e(-acc,gamma) * e(-C,delta) == e(alpha,beta)."""
    curve = vk.curve
    assert len(vk.gamma_ABC_g1) >= len(primary) + 1
    # is_well_formed gate (verifier.hpp:164): reject off-curve / wrong-
    # subgroup proof points before they reach a pairing.
    if not (CV.g1_well_formed(curve, proof.g_A)
            and CV.g2_well_formed(curve, proof.g_B)
            and CV.g1_well_formed(curve, proof.g_C)):
        return False
    acc = vk.gamma_ABC_g1[0]
    for i, x in enumerate(primary):
        acc = CV.g1_add(curve, acc,
                        CV.g1_mul(curve, vk.gamma_ABC_g1[i + 1], x))
    lhs = CV.multi_pairing(curve, [
        (proof.g_A, proof.g_B),
        (CV.g1_neg(curve, acc), vk.gamma_g2),
        (CV.g1_neg(curve, proof.g_C), vk.delta_g2),
    ])
    return lhs == vk.alpha_g1_beta_g2
