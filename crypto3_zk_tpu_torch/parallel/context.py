"""Mesh context: route single-device kernels through their distributed
counterparts without threading mesh handles through every prover call.

Counterpart of `parallel/context.py` of the JAX package. A JAX `Mesh` is one
process driving many devices; here a mesh is a
`torch.distributed.device_mesh.DeviceMesh`, one rank per device, and every
rank runs the same replicated `prove()`. Under a `mesh_context` the
commitment layer (`commitments/fri.py`) shards its Merkle leaf hashing and
its query-phase value gathers over the mesh (`parallel/fri.py`), while
everything else runs replicated, so proofs stay equal to the single-device
proofs by construction.
"""
from __future__ import annotations

import contextlib

_CTX: tuple | None = None


def get_mesh() -> tuple | None:
    """(mesh, axis_name) if a mesh context is active, else None."""
    return _CTX


@contextlib.contextmanager
def mesh_context(mesh, axis: str = "x"):
    """Within this context, mesh-aware kernels shard over `mesh[axis]`."""
    global _CTX
    prev = _CTX
    _CTX = (mesh, axis)
    try:
        yield
    finally:
        _CTX = prev


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along `axis` (`mesh.shape[axis]` of a JAX mesh)."""
    return mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (`jax.lax.axis_index`)."""
    return mesh.get_local_rank(axis)
