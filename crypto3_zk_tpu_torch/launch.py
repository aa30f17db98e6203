"""Start a `torch.distributed` world of local ranks and run calls on it.

One process a rank, started by `multiprocessing`'s spawn method: rank r
sets `torch.set_num_threads(1)`, on the card calls `torch.cuda.set_device(r)`
before anything touches "cuda", joins the world through a `FileStore` in a
temporary directory (NCCL on the card, gloo on the CPU), builds a 1-D
`DeviceMesh` over all ranks with the axis "x", runs each call
`function(mesh, device, **kwargs)` in order and sends its results back, then
destroys the group. A call names its function as "module:function", so that
a rank imports it (a function of the port's package; a child cannot import
a pytest module by name).

    world = start(4, [("crypto3_zk_tpu_torch.entry:mesh_ntt",
                       {"field": "bls12_381_fr", "coeffs": xs})], "cpu")
    per_rank = world.results()      # per_rank[rank][call]

A rank that raises sends its traceback and exits with code 1; `results`
then stops every rank and raises, and it raises too when a rank exits
without its results or the world outlives `timeout` seconds. On the card
the kernels are built once, here, before any rank starts.
"""
from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

AXIS = "x"


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank: int, world: int, store_path: str, device_type: str,
               calls: list, out, timeout: float) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        mesh = init_device_mesh(device_type, (world,),
                                mesh_dim_names=(AXIS,))
        results = [_resolve(target)(mesh, device, **kwargs)
                   for target, kwargs in calls]
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        out.close()
        out.join_thread()
        os._exit(1)              # peers may wait in a collective: no cleanup
    out.put((rank, True, results))
    dist.destroy_process_group()


class World:
    """The ranks of one `start`; `results()` waits for them."""

    def __init__(self, procs, out, tmp, timeout: float):
        self._procs, self._out, self._tmp = procs, out, tmp
        self._deadline = time.monotonic() + timeout
        self._results = None

    def _stop(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(10)
        self._tmp.cleanup()

    def results(self) -> list:
        """Every rank's list of call results, by rank."""
        if self._results is not None:
            return self._results
        got: dict[int, list] = {}
        try:
            while len(got) < len(self._procs):
                try:
                    rank, ok, payload = self._out.get(timeout=1.0)
                except queue.Empty:
                    lost = [r for r, p in enumerate(self._procs)
                            if r not in got and p.exitcode is not None]
                    if lost:
                        raise RuntimeError(f"ranks {lost} exited without "
                                           "their results")
                    if time.monotonic() > self._deadline:
                        raise TimeoutError("the world outlived its timeout")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
            for p in self._procs:
                p.join(max(self._deadline - time.monotonic(), 1.0))
            codes = [p.exitcode for p in self._procs]
            if any(code != 0 for code in codes):
                raise RuntimeError(f"ranks exited with codes {codes}")
        finally:
            self._stop()
        self._results = [got[r] for r in range(len(self._procs))]
        return self._results


def start(n_ranks: int, calls: list, device_type: str = "cuda",
          timeout: float = 600.0) -> World:
    """Start `n_ranks` ranks that run `calls` ([("module:function",
    kwargs), ...]) in order on a world over `device_type` ("cuda": one card
    a rank; "cpu"). `timeout` bounds the rendezvous, each collective and
    the whole run."""
    if device_type == "cuda":
        import torch

        from . import kernels as K
        if torch.cuda.device_count() < n_ranks:
            raise RuntimeError(f"{n_ranks} ranks need {n_ranks} cards, "
                               f"{torch.cuda.device_count()} present")
        K.build_all()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.TemporaryDirectory(prefix="zk_world_")
    store = os.path.join(tmp.name, "store")
    procs = [ctx.Process(target=_rank_main, args=(
        r, n_ranks, store, device_type, calls, out, timeout), daemon=True)
        for r in range(n_ranks)]
    for p in procs:
        p.start()
    return World(procs, out, tmp, timeout)


def run(n_ranks: int, calls: list, device_type: str = "cuda",
        timeout: float = 600.0) -> list:
    """`start(...).results()`."""
    return start(n_ranks, calls, device_type, timeout).results()
