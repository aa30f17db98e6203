"""The R1CS v_{i+2} = v_i * v_{i+1}, i < ncons, over F_p, with v_1 the
public input.

A frozen copy of the port's `arithmetization/circuits.py::product_chain`.
Every variable stands once on the A side and once on the B side, so all
five query vectors of a Groth16 key are dense (a circuit with one variable
on the whole B side leaves the G2 MSM nothing to do). The constraints do
not depend on v1 and v2, so one key proves every witness.
"""
from __future__ import annotations


def generate(p: int, ncons: int, v1: int, v2: int, R):
    """(constraint system, primary input, auxiliary input), built with the
    classes of the r1cs module `R`."""
    cs = R.R1CSConstraintSystem(primary_input_size=1,
                                auxiliary_input_size=ncons + 1)
    vals = [v1 % p, v2 % p]
    for i in range(ncons):
        cs.add_constraint(R.lc((1 + i, 1)), R.lc((2 + i, 1)),
                          R.lc((3 + i, 1)))
        vals.append(vals[-2] * vals[-1] % p)
    return cs, vals[:1], vals[1:]
