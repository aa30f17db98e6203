"""Carry keys and limb arrays from the JAX package over to this port.

The port imports nothing of the JAX package, so a caller that holds the
reference's objects hands them over as plain Python and numpy values:
`dataclasses.asdict` would deep-copy a proving key, so pass
`{f.name: getattr(key, f.name) for f in dataclasses.fields(key)}`.
Curves travel by name, constraint systems as their constraint term lists.
"""
from __future__ import annotations

import numpy as np
import torch

from .arithmetization import r1cs as R
from .fields import curves as CV
from .fields import mnt as MNT
from .models import groth16 as G16
from .ops import limbs as L


def curve_by_name(name: str):
    for mod in (CV, MNT):
        for obj in vars(mod).values():
            if isinstance(obj, (CV.CurveSpec, MNT.MNTCurve)) \
                    and obj.name == name:
                return obj
    raise KeyError(f"unknown curve {name!r}")


def _name_of(curve) -> str:
    return curve if isinstance(curve, str) else curve.name


def constraint_system_from_reference(cs) -> R.R1CSConstraintSystem:
    """Rebuild an R1CS from any object with the reference's attributes
    (`primary_input_size`, `auxiliary_input_size`, `constraints` of a/b/c
    linear combinations with `terms`)."""
    out = R.R1CSConstraintSystem(cs.primary_input_size,
                                 cs.auxiliary_input_size)
    for cst in cs.constraints:
        out.add_constraint(*(R.LinearCombination([(int(i), int(c))
                                                  for i, c in part.terms])
                             for part in (cst.a, cst.b, cst.c)))
    return out


def proving_key_from_reference(fields: dict) -> G16.ProvingKey:
    """The port's `ProvingKey` from the reference dataclass's fields."""
    f = dict(fields)
    f["curve"] = curve_by_name(_name_of(f["curve"]))
    f["constraint_system"] = constraint_system_from_reference(
        f["constraint_system"])
    for name in ("A_query", "B_query_g1", "B_query_g2", "H_query", "L_query"):
        f[name] = list(f[name])
    return G16.ProvingKey(**f)


def verification_key_from_reference(fields: dict) -> G16.VerificationKey:
    """The port's `VerificationKey` from the reference dataclass's fields."""
    f = dict(fields)
    f["curve"] = curve_by_name(_name_of(f["curve"]))
    f["gamma_ABC_g1"] = list(f["gamma_ABC_g1"])
    return G16.VerificationKey(**f)


def limbs_from_numpy(fs, arr, device=None) -> torch.Tensor:
    """A reference `(NL, ...)` uint32 digit array -> the port's int32
    tensor, bit for bit."""
    a = np.asarray(arr)
    if a.shape[0] != fs.nl:
        raise ValueError(f"expected {fs.nl} digit planes, got {a.shape[0]}")
    return L.from_numpy(a, device)
