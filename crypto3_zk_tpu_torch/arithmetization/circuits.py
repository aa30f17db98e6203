"""Circuit fixtures for the port's smoke run and profiling.

The JAX package's `arithmetization/circuits.py` holds its PLONK fixtures; the
one here is the R1CS the Groth16 path is driven with.
"""
from __future__ import annotations

from . import r1cs as R


def product_chain(p: int, ncons: int, v1: int = 3, v2: int = 5):
    """The R1CS v_{i+2} = v_i * v_{i+1}, i < ncons, over F_p, with v_1 the
    public input. Every variable stands once on the A side and once on the B
    side, so all five query vectors of a Groth16 key are dense (a circuit
    with one variable on the whole B side leaves the G2 MSM nothing to do).
    Returns (constraint system, primary input, auxiliary input)."""
    cs = R.R1CSConstraintSystem(primary_input_size=1,
                                auxiliary_input_size=ncons + 1)
    vals = [v1 % p, v2 % p]
    for i in range(ncons):
        cs.add_constraint(R.lc((1 + i, 1)), R.lc((2 + i, 1)),
                          R.lc((3 + i, 1)))
        vals.append(vals[-2] * vals[-1] % p)
    return cs, vals[:1], vals[1:]
