"""TBCS / BACS ppzkSNARK frontends.

Counterpart of `models/circuit_snarks.py` of the JAX package
(`systems/ppzksnark/{tbcs,bacs}_ppzksnark/`): reductions composed with the
underlying systems — tbcs_ppzksnark = TBCS->USCS + uscs_ppzksnark;
bacs_ppzksnark = BACS->R1CS + r1cs_ppzksnark (PGHR13). `generate` and
`prove` take `device` (default: the card).
"""
from __future__ import annotations

import random

from ..arithmetization import circuits as CIR
from ..fields import curves as CV
from . import pghr13 as PG
from . import uscs_ppzksnark as UP


# --- tbcs_ppzksnark --------------------------------------------------------

def tbcs_generate(curve: CV.CurveSpec, circuit: CIR.TBCSCircuit,
                  rng: random.Random | None = None, device=None):
    cs = CIR.tbcs_to_uscs_instance(circuit)
    kp = UP.generate(curve, cs, rng, device=device)
    return kp, cs


def tbcs_prove(kp, circuit: CIR.TBCSCircuit, primary, aux,
               rng: random.Random | None = None, device=None):
    wires = CIR.tbcs_to_uscs_witness(circuit, primary, aux)
    uscs_aux = wires[circuit.primary_input_size:]
    return UP.prove(kp.pk, list(primary), uscs_aux, rng, device=device)


def tbcs_verify(kp, primary, proof) -> bool:
    return UP.verify(kp.vk, list(primary), proof)


# --- bacs_ppzksnark --------------------------------------------------------

def bacs_generate(curve: CV.CurveSpec, circuit: CIR.BACSCircuit,
                  rng: random.Random | None = None, device=None):
    cs = CIR.bacs_to_r1cs_instance(circuit)
    kp = PG.generate(curve, cs, rng, device=device)
    return kp, cs


def bacs_prove(kp, circuit: CIR.BACSCircuit, primary, aux,
               rng: random.Random | None = None, device=None):
    p = kp.pk.curve.fr.p
    wires = CIR.bacs_to_r1cs_witness(circuit, p, primary, aux)
    r1cs_aux = wires[circuit.primary_input_size:]
    return PG.prove(kp.pk, list(primary), r1cs_aux, rng, device=device)


def bacs_verify(kp, primary, proof) -> bool:
    return PG.verify(kp.vk, list(primary), proof)
