"""Every value the benchmark draws from `--seed`, in one place, so that the
program's side and the reference's side draw the same: the Groth16
trapdoor, the witnesses of the pool and each proof's blinding.

Each draw has its own stream, a `random.Random` seeded by a string made of
the seed and the draw's name, so that one draw never shifts another and any
whole number, however large, is a valid seed.
"""
from __future__ import annotations

import random


def stream(seed: int, *name) -> random.Random:
    return random.Random("/".join(str(part) for part in (seed,) + name))


def trapdoor(seed: int, p: int) -> dict:
    """Groth16's toxic waste (t, alpha, beta, gamma, delta), each in 1..p-1."""
    rng = stream(seed, "trapdoor")
    return {k: rng.randrange(1, p) for k in ("t", "alpha", "beta", "gamma",
                                             "delta")}


def witness_seed(seed: int, k: int) -> str:
    """The seed of the pool's k-th witness (the generators take a string)."""
    return f"{seed}/witness/{k}"


def chain_inputs(seed: int, k: int, p: int) -> tuple[int, int]:
    """(v1, v2) of the product chain's k-th witness."""
    rng = stream(seed, "witness", k)
    return rng.randrange(1, p), rng.randrange(1, p)


def blinding(seed: int, k: int, p: int) -> tuple[int, int]:
    """(r, s) of the k-th proof of a run (k = -1: the warm-up proof)."""
    rng = stream(seed, "blinding", k)
    return rng.randrange(p), rng.randrange(p)
