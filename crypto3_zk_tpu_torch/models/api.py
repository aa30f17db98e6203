"""Generic proof-system frontend.

Counterpart of `models/api.py` of the JAX package
(`zk/algorithms/{generate,prove,verify}.hpp:33-65`): thin dispatchers over
the port's proof-system modules, so callers can write
`api.prove(api.GROTH16, pk, primary, aux, device=...)` uniformly; keywords
(`rng`, `device`, ...) pass through. The reference's `aggregate` (Groth16
ipp2) has no counterpart until `models/groth16/ipp2.py` is ported.
"""
from __future__ import annotations

from . import gm17 as _gm17
from . import groth16 as _groth16
from . import pghr13 as _pghr13

GROTH16 = "groth16"
GM17 = "gm17"
PGHR13 = "pghr13"

_SYSTEMS = {
    GROTH16: _groth16,
    GM17: _gm17,
    PGHR13: _pghr13,
}


def system(name: str):
    return _SYSTEMS[name]


def generate(name: str, curve, constraint_system, **kw):
    """`zk::generate<ProofSystem>` (generate.hpp)."""
    return _SYSTEMS[name].generate(curve, constraint_system, **kw)


def prove(name: str, proving_key, primary, auxiliary, **kw):
    """`zk::prove<ProofSystem>(pk, primary, auxiliary)` (prove.hpp:33-40)."""
    return _SYSTEMS[name].prove(proving_key, primary, auxiliary, **kw)


def verify(name: str, verification_key, primary, proof, **kw):
    """`zk::verify<ProofSystem>` (verify.hpp)."""
    return _SYSTEMS[name].verify(verification_key, primary, proof, **kw)
