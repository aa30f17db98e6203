"""Kernel 5's share of its roofline in a Placeholder proof, in percent: the
least time the permutations the proof needs take at the card's published
integer rate, over the profiler's device time of kernel 5's three forms.

The work is counted from the protocol, not from the program, so that it
reads the same whatever implements it:

- permutations: every Merkle tree a proof builds over LPC/FRI (Poseidon,
  width 3, rate 2): the leaf sponges and inner nodes of the trees of the
  variable, permutation, lookup and quotient batches and of the combined
  quotient, all over the first FRI domain, and of each folded layer FRI
  commits to. The fixed batch is committed in set-up, not in a proof.
- multiply-adds a permutation: the fewest 32-bit multiply-adds of the
  permutation's schedule with sparse partial rounds (R_F = 8, R_P = 57,
  x^5): a product of two elements of NW words takes 2 NW^2 (each word
  product low and high), a square NW (NW + 1), a Montgomery reduction
  2 NW^2 + NW, and a matrix row's dot one reduction for its products; the
  matrix that enters the partial rounds is folded into the last full
  round's.
- the rate: 64 integer multiply-adds a clock on each of 132 SMs at
  1.98 GHz (CUDA C++ Programming Guide, arithmetic throughput table,
  compute capability 9.0), the H100 SXM at its full 700 W; the run prints
  the card's power limit beside it.
"""
from __future__ import annotations

RATE = 64 * 132 * 1.98e9
KERNEL_PREFIXES = ("void poseidon_kernel<", "void poseidon_shared_kernel<",
                   "void poseidon_tree_kernel<")
WIDTH, RATE_ELEMS, FULL_ROUNDS, PARTIAL_ROUNDS = 3, 2, 8, 57


def permutation_multiply_adds(nw: int = 8, t: int = WIDTH,
                              r_f: int = FULL_ROUNDS,
                              r_p: int = PARTIAL_ROUNDS) -> int:
    product, square = 2 * nw * nw, nw * (nw + 1)
    reduction = 2 * nw * nw + nw
    sbox = 2 * square + product + 3 * reduction          # x^2, x^4, x^5
    dense = t * (t * product + reduction)                 # t rows, t products
    sparse = (t * product + reduction) + (t - 1) * (product + reduction)
    return r_f * (t * sbox + dense) + r_p * (sbox + sparse)


def _tree(leaves: int, elements_a_leaf: int) -> int:
    """Permutations of one tree: a sponge a leaf, one a node."""
    sponge = -(-elements_a_leaf // RATE_ELEMS)
    return leaves * sponge + (leaves - 1)


def batch_sizes(shape: dict, rows: int) -> list[int]:
    """Polynomials in each batch committed in a proof: variable,
    permutation, lookup, quotient (Placeholder, `max_quotient_chunks` 0)."""
    lookup = shape["lookup_constraints"] > 0
    variable = shape["witness_columns"] + shape["public_columns"]
    permutation = (1 if shape["permuted_columns"] else 0) + (1 if lookup
                                                             else 0)
    sorted_columns = (shape["lookup_constraints"] + shape["table_options"]
                      if lookup else 0)
    lookup_bound = (shape["lookup_degree_sum"] + 3 * shape["table_options"]
                    if lookup else 0)
    bound = max((shape["permuted_columns"] + 2) * (rows - 1),
                (lookup_bound + 1) * (rows - 1),
                (shape["gates_degree"] + 1) * (rows - 1))
    quotient = -(-bound // rows)
    return [b for b in (variable, permutation, sorted_columns, quotient) if b]


def permutations_per_proof(shape: dict, rows_log2: int, expand_factor: int,
                           fri_step: int = 1) -> int:
    """Poseidon permutations of every tree one proof builds."""
    if fri_step != 1:
        raise ValueError("counted for FRI steps of 1")
    rows = 1 << rows_log2
    d0 = 1 << (rows_log2 + expand_factor)
    leaves = d0 >> fri_step
    total = sum(_tree(leaves, b << fri_step)
                for b in batch_sizes(shape, rows) + [1])   # + combined Q
    # FRI folds rows_log2 - 1 times; each layer but the first and the last
    # is committed over its own domain
    for i in range(1, rows_log2 - 1):
        total += _tree((d0 >> i) >> fri_step, 1 << fri_step)
    return total


def circuit_shape(workload: dict) -> dict:
    """The shape `batch_sizes` reads, from the workload's generator at a
    small size (the shape does not depend on the rows)."""
    from zkbench.reference import plonk
    from zkbench.systems.placeholder_lpc import generator

    circuit = generator(workload).build(2 ** 61 - 1, 5, 0, plonk)
    cs, desc = circuit.cs, circuit.desc
    degree_sum = sum(max(plonk.expr_max_degree(e) for e in lc.lookup_input)
                     + 1 for g in cs.lookup_gates for lc in g.constraints)
    return {
        "witness_columns": desc.witness_columns,
        "public_columns": desc.public_input_columns,
        "permuted_columns": len(cs.permuted_columns(desc)),
        "gates_degree": max(cs.max_gates_degree(),
                            cs.max_lookup_gates_degree()),
        "lookup_constraints": cs.lookup_constraints_number(),
        "lookup_degree_sum": degree_sum,
        "table_options": cs.lookup_options_number(),
    }


def read(run):
    t = run.trace
    cfg = run.config
    if t is None or (cfg.get("commitment"), cfg.get("merkle_hash")) != (
            "lpc", "poseidon"):
        return None
    device_s = sum(row[1] for name, row in t.kernels.items()
                   if name.startswith(KERNEL_PREFIXES))
    if device_s <= 0:
        return None
    from zkbench.systems.placeholder_lpc import rows_log2
    perms = permutations_per_proof(circuit_shape(run.workload),
                                   rows_log2(cfg, run.workload),
                                   cfg["expand_factor"], cfg["fri_step"])
    floor_s = t.proofs * perms * permutation_multiply_adds() / RATE
    return 100.0 * floor_s / device_s
