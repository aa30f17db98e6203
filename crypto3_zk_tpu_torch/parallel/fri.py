"""Distributed FRI precommit and query serving over a mesh.

Counterpart of `parallel/fri.py` of the JAX package. The precommit's main
cost is the batched Poseidon sponge over all leaf rows
(`commitments/merkle.py::FieldHasher.leaf_hash_rows`, kernel 5 on the
card). Here the leaf axis is sharded: each rank builds and sponges its
contiguous range of leaf rows, the digest planes are `all_gather`ed, and
the node levels run replicated on the device
(`MerkleTree.from_leaf_digests_dev`), so roots and paths equal those of
the single-device `fri.precommit`. Contiguous leaf ranges never split a
sibling pair (power-of-two rank counts).

The query phase's value gathers are served from leaf-range-sharded tables:
each rank takes the requested indices in its range and zeros elsewhere, and
one `all_reduce(SUM)` assembles the answer on every rank (the digits are
16-bit values in int32, so the sum is exact).

`CALLS` counts the calls of each function, so that a run can show that a
sharded branch was taken.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .context import axis_rank, axis_size

CALLS = {"distributed_precommit": 0, "distributed_query_gather": 0}


def distributed_precommit(polys, D, fri_step: int, params, mesh,
                          axis: str = "x"):
    """Same result as `fri.precommit`, the leaf hashing sharded over
    `mesh[axis]`. Needs a field (Poseidon) Merkle hash: byte hashes have no
    leaf sponge to shard."""
    from ..commitments.fri import Precommitment, _leaf_order_indices
    from ..commitments.merkle import MerkleTree, make_hasher

    fs = params.fs
    hasher = make_hasher(fs, params.merkle_hash)
    if hasher.kind != "field":
        raise ValueError("the distributed precommit needs a field hash")
    d = axis_size(mesh, axis)
    me = axis_rank(mesh, axis)
    if d & (d - 1):
        raise ValueError("mesh axis must be a power of two")
    CALLS["distributed_precommit"] += 1

    polys = [pl.resize(D.n) for pl in polys]
    values = torch.stack([pl.v for pl in polys], dim=0)   # (B, NL, N)
    idx = _leaf_order_indices(D.n, fri_step)             # (leafs, coset)
    leafs, coset = idx.shape
    if leafs % d:
        raise ValueError("the leaf count must split over the mesh axis")
    per = leafs // d
    # this rank's leaves [me*per, (me+1)*per): column c of each, then the
    # next column, as `fri.precommit` orders all of them
    flat = torch.from_numpy(np.ascontiguousarray(
        idx[me * per:(me + 1) * per].T).reshape(-1)).to(values.device)
    gathered = values.index_select(-1, flat)             # (B, NL, coset*per)
    rows = gathered.reshape(len(polys), fs.nl, coset, per) \
        .permute(0, 2, 1, 3).reshape(-1, fs.nl, per)      # (B*coset, NL, per)
    digests = hasher.leaf_hash_rows(rows).contiguous()    # (NL, per)
    parts = [torch.empty_like(digests) for _ in range(d)]
    dist.all_gather(parts, digests, group=mesh.get_group(axis))
    tree = MerkleTree.from_leaf_digests_dev(hasher, torch.cat(parts, dim=-1))
    return Precommitment(tree, values, D.n, fri_step)


def distributed_query_gather(values: torch.Tensor, need_idx, mesh,
                             axis: str = "x") -> torch.Tensor:
    """values (B, NL, N), whole on every rank, its last axis taken as
    sharded over `mesh[axis]` in contiguous ranges -> values[..., need_idx]
    (B, NL, K) on every rank: each rank gathers the indices in its range,
    zeros elsewhere, then one `all_reduce(SUM)`."""
    n = values.shape[-1]
    d = axis_size(mesh, axis)
    if n % d:
        raise ValueError("the value count must split over the mesh axis")
    CALLS["distributed_query_gather"] += 1
    per = n // d
    lo = axis_rank(mesh, axis) * per
    idx = torch.as_tensor(need_idx, dtype=torch.int64, device=values.device)
    local = idx - lo
    mine = (local >= 0) & (local < per)
    got = values[..., lo:lo + per].index_select(
        -1, torch.where(mine, local, torch.zeros_like(local)))
    got = torch.where(mine, got, torch.zeros_like(got)).contiguous()
    dist.all_reduce(got, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return got
