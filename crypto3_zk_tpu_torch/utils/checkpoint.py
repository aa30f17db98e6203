"""Checkpoint/resume for long-running proving jobs.

Counterpart of `utils/checkpoint.py` of the JAX package: intermediate state
of a long MSM or NTT job is saved so that the job survives preemption and
resumes deterministically. Arrays round-trip through numpy `.npz` files,
scalar and host state through JSON; each file is written under a temporary
name and then renamed into place.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _paths(self, step: int | str):
        base = os.path.join(self.directory, f"ckpt_{step}")
        return base + ".npz", base + ".json"

    def save(self, step: int | str, arrays: dict | None = None,
             meta: dict | None = None) -> None:
        npz, js = self._paths(step)
        if arrays:
            np.savez(npz + ".tmp.npz",
                     **{k: np.asarray(v) for k, v in arrays.items()})
            os.replace(npz + ".tmp.npz", npz)    # atomic publish
        elif os.path.exists(npz):
            # drop a stale array blob of an earlier save at this step, so
            # that load() never pairs old arrays with the new meta
            os.remove(npz)
        with open(js + ".tmp", "w") as f:
            json.dump(meta or {}, f)
        os.replace(js + ".tmp", js)

    def load(self, step: int | str):
        npz, js = self._paths(step)
        if not os.path.exists(js):
            return None
        with open(js) as f:
            meta = json.load(f)
        arrays = {}
        if os.path.exists(npz):
            with np.load(npz) as data:
                arrays = {k: data[k] for k in data.files}
        return arrays, meta

    def latest(self) -> int | None:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".json"):
                tag = name[len("ckpt_"):-len(".json")]
                if tag.isdigit():
                    steps.append(int(tag))
        return max(steps) if steps else None


def _job_key(curve, points_affine, scalars, c: int, group: str) -> str:
    """A digest of the job, so that a checkpoint of another MSM is never
    resumed."""
    h = hashlib.sha256(repr((curve.name, group, c)).encode())
    h.update(repr(list(points_affine)).encode())
    h.update(repr(list(scalars)).encode())
    return h.hexdigest()


def msm_checkpointed(curve, points_affine, scalars, ckpt_dir: str,
                     c: int = 8, group: str = "g1", device=None):
    """Resumable MSM: each window's total is checkpointed, so a preempted
    job resumes at its last finished window instead of restarting. The
    windows run one at a time through `MSMBases.window_totals` (the
    batched-affine MSM: kernels 1, 3, 4 and the tail on the card; `device`
    defaults to the card) and each is saved as its host affine point; the
    host combines them."""
    from ..fields import curves as CV
    from ..ops import curve as CRV
    from ..ops import limbs as L
    from ..ops.msm_affine import MSMBases

    bases = MSMBases(curve, points_affine, group, window_bits=c,
                     device=device)
    limbs = L.encode_canonical(curve.fr, scalars, bases.device)
    key = _job_key(curve, points_affine, scalars, c, group)
    mgr = CheckpointManager(ckpt_dir)
    results: list = []
    ck = mgr.load("msm")
    if ck is not None and ck[1].get("key") == key:
        results = [_decode_pt(r) for r in ck[1]["window_results"]]
    for w in range(len(results), bases.windows):
        total = bases.window_totals(limbs, w, w + 1)
        results.append(None if total is None
                       else CRV.to_affine_host(bases.ops, total)[0])
        mgr.save("msm", meta={
            "key": key, "n": len(scalars), "c": c,
            "window_results": [_encode_pt(r) for r in results]})

    host_add = CV.g1_add if group == "g1" else CV.g2_add
    host_mul = CV.g1_mul if group == "g1" else CV.g2_mul
    acc = None
    for w in reversed(range(bases.windows)):
        if acc is not None:
            acc = host_mul(curve, acc, 1 << c)
        acc = host_add(curve, acc, results[w])
    return acc


def _encode_pt(pt):
    if pt is None:
        return "inf"

    def enc(v):
        if isinstance(v, (list, tuple)):
            return [enc(x) for x in v]
        return str(v)
    return enc(list(pt))


def _decode_pt(v):
    if v == "inf" or v is None:
        return None

    def dec(x):
        if isinstance(x, list):
            return tuple(dec(e) for e in x)
        return int(x)
    return dec(v)
