"""The frozen traffic generators: one module a circuit family, found by the
workload's `circuit.generator` name. Each takes the module whose classes
build the circuit (the port's for the program, `zkbench/reference/`'s for
the reference), so both sides receive the same circuit from the same seed.

A PLONK generator has two parts: `build(p, rows_log2, circuit_seed, PK)`
makes the `Circuit` once (constraint system, table description, fixed
columns, public input), and `witness(circuit, p, witness_seed)` draws one
witness of it, so that a pool of witnesses costs one circuit.
"""
from __future__ import annotations

import dataclasses
import random


@dataclasses.dataclass
class Circuit:
    """A PLONK circuit without its witness."""
    cs: object
    desc: object
    public_inputs: list     # public input columns
    constants: list
    selectors: list
    public_input: list      # the public input the verifier is given
    PK: object              # the module whose classes built it

    def assignment(self, witnesses: list) -> object:
        return self.PK.Assignment(witnesses, self.public_inputs,
                                  self.constants, self.selectors)


def field_elements(rng: random.Random, p: int, n: int) -> list[int]:
    """n values in [0, p) from `rng`, each 256 drawn bits reduced mod p (a
    value drawn in bulk; the small bias does not matter to a witness)."""
    data = rng.randbytes(32 * n)
    return [int.from_bytes(data[i:i + 32], "little") % p
            for i in range(0, 32 * n, 32)]
