"""The Placeholder prover over LPC/FRI as a prover service.

Set-up: the workload's circuit (`circuits/<generator>.py`) built once from
its fixed circuit seed and preprocessed once by `preprocessor.
process_public` into an `LPCScheme`; a pool of witnesses of that circuit
drawn from `--seed`; one warm-up proof. The preprocessor reads the public
input column, so the pool shares it: only the witness columns differ from
one witness to the next. A request: `preprocessor.process_private` of the
pool's next witness, then `prover.prove` on `scheme.fork()`. The proof is
host integers when `prove` returns.

The control (`control=True`) is the program with half the FRI queries the
configuration states (its own `lambda_` parameter): a cheaper proof at a
lower soundness, which breaks the guarantee the configuration states.
"""
from __future__ import annotations

import importlib
import time

from .. import draws
from ..harness import sync


def rows_log2(config: dict, workload: dict) -> int:
    """The configuration's rows, unless the workload's circuit names its
    own (the CPU tests' small sizes)."""
    return workload["circuit"].get("rows_log2", config["rows_log2"])


def generator(workload: dict):
    return importlib.import_module(
        f"zkbench.circuits.{workload['circuit']['generator']}")


def build(config: dict, workload: dict, PK):
    """The cell's circuit without a witness, built with `PK`."""
    return generator(workload).build(
        config["field_modulus"], rows_log2(config, workload),
        workload["circuit"]["circuit_seed"], PK)


def witness(config: dict, workload: dict, circuit, seed: int, k: int):
    """The witness columns of the pool's k-th witness."""
    return generator(workload).witness(circuit, config["field_modulus"],
                                       draws.witness_seed(seed, k))


class Service:
    """The program's side of a run."""

    def __init__(self, config: dict, workload: dict, seed: int, device,
                 control: bool = False):
        self.config, self.workload = config, workload
        self.seed, self.device, self.control = seed, device, control
        self.pool_size = workload["pool"]
        self._phases: list[tuple[str, float]] = []

    def setup(self, spans: dict) -> None:
        from crypto3_zk_tpu_torch.arithmetization import plonk
        from crypto3_zk_tpu_torch.commitments import fri
        from crypto3_zk_tpu_torch.commitments.lpc import LPCScheme
        from crypto3_zk_tpu_torch.fields import params as P
        from crypto3_zk_tpu_torch.models.placeholder import common as C
        from crypto3_zk_tpu_torch.models.placeholder import preprocessor
        from crypto3_zk_tpu_torch.models.placeholder import prover

        self.pp, self.prover = preprocessor, prover
        cfg = self.config
        fs = P.BLS12_381_FR
        if fs.p != cfg["field_modulus"]:
            raise ValueError("the port's bls12-381 Fr is not the configured field")
        lam = cfg["lambda"] // 2 if self.control else cfg["lambda"]
        circuit = build(cfg, self.workload, plonk)
        self.cs, self.desc = circuit.cs, circuit.desc
        self.pool = [circuit.assignment(witness(cfg, self.workload, circuit,
                                                self.seed, k))
                     for k in range(self.pool_size)]
        self.params = C.PlaceholderParams(
            fs, transcript_hash=cfg["transcript_hash"],
            max_quotient_chunks=cfg["max_quotient_chunks"])
        fri_params = fri.FRIParams.build(
            fs, degree_log=rows_log2(cfg, self.workload),
            expand_factor=cfg["expand_factor"], lambda_=lam,
            merkle_hash=cfg["merkle_hash"],
            transcript_hash=cfg["transcript_hash"])
        self.scheme = LPCScheme(fri_params)
        t0 = time.perf_counter()
        self.public = preprocessor.process_public(
            self.params, self.cs, self.pool[0], self.desc, self.scheme,
            max_quotient_poly_chunks=cfg["max_quotient_chunks"],
            device=self.device)
        sync(self.device)
        spans["preprocess_s"] = time.perf_counter() - t0
        self.prove(-1)

    def prove(self, k: int, clock=None):
        """The k-th request's proof (k = -1: the warm-up). `clock`, where
        given, is the program's `PhaseClock` for the prove's phases."""
        t0 = time.perf_counter()
        private = self.pp.process_private(
            self.params, self.cs, self.pool[k % self.pool_size], self.desc,
            device=self.device)
        if clock is not None:
            clock.mark("process_private")
        t1 = time.perf_counter()
        proof = self.prover.prove(self.params, self.public, private,
                                  self.desc, self.cs, self.scheme.fork(),
                                  clock, None, self.device)
        sync(self.device)
        self._phases = list(clock.seconds.items()) if clock is not None \
            else [("process_private", t1 - t0),
                  ("prove", time.perf_counter() - t1)]
        return proof

    def phases(self) -> list[tuple[str, float]]:
        """The last proof's phases in order, from its start."""
        return self._phases

    def claims(self) -> dict:
        """What the judge takes from the program besides the proofs: the
        fixed batch's Merkle root, which every FRI query checks."""
        return {"fixed_root":
                self.public.common_data.vk.fixed_values_commitment}

    def release(self) -> None:
        self.public = self.scheme = self.pool = None


def plain_proof(proof) -> dict:
    """The proof as plain values, all the reference reads."""
    eval_proof = proof.eval_proof.eval_proof
    fri_proof = eval_proof.fri_proof
    queries = []
    for q in fri_proof.query_proofs:
        initial = {k: (ip.values, ip.leaf_index, list(ip.path))
                   for k, ip in q.initial_proof.items()}
        rounds = [(rp.y, rp.leaf_index, list(rp.path))
                  for rp in q.round_proofs]
        queries.append((initial, rounds))
    return {
        "commitments": dict(proof.commitments),
        "challenge": proof.eval_proof.challenge,
        "z": {k: [list(row) for row in eval_proof.z.z[k]]
              for k in eval_proof.z.batches()},
        "fri_roots": list(fri_proof.fri_roots),
        "final_polynomial": list(fri_proof.final_polynomial),
        "proof_of_work": fri_proof.proof_of_work,
        "queries": queries,
    }


def judge(config: dict, workload: dict, seed: int,
          done: list[tuple[int, dict]], claims: dict) -> dict:
    """The sampled proofs against the reference, one worker process a proof
    (the reference is plain Python, and a proof takes it seconds). Returns
    the compared number: `proofs_rejected`, the proofs that the reference's
    verifier rejects or whose opened column values differ from the
    reference's."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    jobs = [(config, workload, seed, k, proof, claims) for k, proof in done]
    with ProcessPoolExecutor(
            max_workers=len(jobs),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        accepted = list(pool.map(_accepts, jobs))
    return {"proofs_rejected": accepted.count(False)}


def _accepts(job) -> bool:
    """One proof against the reference, in a worker process: the circuit
    and the reference built from the configuration, the witness drawn again
    from the seed."""
    from ..reference import plonk
    from ..reference.placeholder import PlaceholderReference

    config, workload, seed, k, proof, claims = job
    circuit = build(config, workload, plonk)
    columns = witness(config, workload, circuit, seed, k % workload["pool"])
    return PlaceholderReference(config, circuit).accepts(proof, columns,
                                                         claims)
