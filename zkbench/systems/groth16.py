"""Groth16 over alt_bn128 as a prover service.

Set-up: the workload's product chain, `groth16.generate` with the trapdoor
drawn from the seed, a pool of witnesses (v1, v2 drawn from the seed), one
warm-up proof. A request: `groth16.prove` of the pool's next witness, with
its blinding (r, s) drawn from the seed and handed in. The proof is three
affine points on the host when `prove` returns.

The control (`control=True`) is the program with its blinding switched off
(r = s = 0): a proof that verifies but is not zero-knowledge, which breaks
the guarantee the configuration states.
"""
from __future__ import annotations

import time

from .. import draws
from ..harness import sync
from ..circuits import product_chain


class Service:
    """The program's side of a run."""

    def __init__(self, config: dict, workload: dict, seed: int, device,
                 control: bool = False):
        self.config, self.workload = config, workload
        self.seed, self.device, self.control = seed, device, control
        self.pool_size = workload["pool"]

    def setup(self, spans: dict) -> None:
        from crypto3_zk_tpu_torch.arithmetization import r1cs
        from crypto3_zk_tpu_torch.fields import curves
        from crypto3_zk_tpu_torch.models import groth16

        self.g16 = groth16
        curve = curves.ALT_BN128
        p = curve.fr.p
        ncons = self.workload["circuit"]["constraints"]
        cs, _, _ = product_chain.generate(p, ncons, 3, 5, r1cs)
        t0 = time.perf_counter()
        self.pk = groth16.generate(curve, cs,
                                   toxic=draws.trapdoor(self.seed, p),
                                   device=self.device).pk
        sync(self.device)
        spans["keygen_s"] = time.perf_counter() - t0
        self.pool = []
        for k in range(self.pool_size):
            v1, v2 = draws.chain_inputs(self.seed, k, p)
            _, primary, aux = product_chain.generate(p, ncons, v1, v2, r1cs)
            self.pool.append((primary, aux))
        self.prove(-1)

    def prove(self, k: int, clock=None):
        """The k-th request's proof (k = -1: the warm-up)."""
        primary, aux = self.pool[k % self.pool_size]
        rs = (0, 0) if self.control else draws.blinding(
            self.seed, k, self.pk.curve.fr.p)
        proof = self.g16.prove(self.pk, primary, aux, zk_rs=rs,
                               device=self.device)
        sync(self.device)
        return proof

    def phases(self) -> list[tuple[str, float]]:
        """The last proof's phases in order, from its start (host clock,
        each phase ending with its result on the host)."""
        return list(self.g16.LAST_PROVE_SECONDS.items())

    def claims(self) -> dict:
        """What the judge takes from the program besides the proofs."""
        return {}

    def release(self) -> None:
        self.pk = self.pool = None


def plain_proof(proof) -> tuple:
    """The three points as plain tuples, all the reference reads."""
    return (proof.g_A, proof.g_B, proof.g_C)


def judge(config: dict, workload: dict, seed: int,
          done: list[tuple[int, tuple]], claims: dict) -> dict:
    """Every proof of the window against the reference's. Returns the
    compared numbers: `points_off`, the proof points (three a proof) that
    differ from the reference's."""
    from ..reference import bn254, r1cs
    from ..reference.groth16 import Groth16Reference

    p = bn254.R
    ncons = workload["circuit"]["constraints"]
    cs, _, _ = product_chain.generate(p, ncons, 3, 5, r1cs)
    ref = Groth16Reference(cs, draws.trapdoor(seed, p))
    pool = {}
    off = 0
    for k, points in done:
        i = k % workload["pool"]
        if i not in pool:
            v1, v2 = draws.chain_inputs(seed, i, p)
            _, primary, aux = product_chain.generate(p, ncons, v1, v2, r1cs)
            pool[i] = (primary, aux)
        r, s = draws.blinding(seed, k, p)
        want = ref.proof(*pool[i], r, s)
        off += sum(got != exp for got, exp in zip(points, want))
    return {"points_off": off}
