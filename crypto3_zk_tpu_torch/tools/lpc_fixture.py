"""The LPC deployment that `chip_smoke.py` drives and `profile_prove --lpc`
profiles: one prover-side `LPCScheme` over bls12-381 Fr with Poseidon Merkle
trees and a keccak-256 transcript (the settings of the JAX package's
`bench.py` LPC stage), two batches of polynomials from a seeded numpy
generator, and the verifier-side scheme built independently of it.

    run = LPCRun(degree_log=16, lambda_=40, device="cuda")
    run.commit(torch.cuda.synchronize)       # commit(0), commit(1), preprocess
    proof, challenge = run.prove(torch.cuda.synchronize)
    ok, verifier_challenge = run.verify(proof)

Batch 0 holds 8 polynomials of degree < 2^degree_log, batch 1 holds 4 of
degree < 3 * 2^(degree_log - 2) and is marked fixed (so the eta group of the
combined quotient runs); the points are z1, z2 on batch 0 and z1 on batch 1.
"""
from __future__ import annotations

import random
import time

import numpy as np

from ..commitments import fri as FRI
from ..commitments.lpc import LPCScheme
from ..fields import params as P
from ..ops import limbs as L
from ..poly.polynomial import Poly, PolyDFS
from ..transcript.fiat_shamir import Transcript

EXPAND_FACTOR = 2
SEED = bytes(range(10))


def lpc_polys(fs, sizes, seed: int, device):
    """Polynomials with `sizes` coefficients each, from a seeded numpy
    generator: uniform 16-bit digits, the top digit below the modulus's, so
    every coefficient is below p (taken as Montgomery form)."""
    rng = np.random.default_rng(seed)
    polys = []
    for n in sizes:
        digits = rng.integers(0, 1 << 16, (fs.nl, n), dtype=np.int64)
        digits[-1] = rng.integers(0, int(fs.p_limbs[-1]), n)
        polys.append(PolyDFS.from_poly(Poly(fs, L.from_numpy(digits, device))))
    return polys


class LPCRun:
    """One prover-side LPC scheme with two batches (batch 1 fixed), points
    z1, z2 on batch 0 and z1 on batch 1, and what a verifier needs."""

    def __init__(self, degree_log: int, lambda_: int, device, seed: int = 4):
        self.fs = P.BLS12_381_FR
        self.params = FRI.FRIParams.build(
            self.fs, degree_log=degree_log, expand_factor=EXPAND_FACTOR,
            lambda_=lambda_, merkle_hash="poseidon")
        self.sizes = ([1 << degree_log] * 8, [3 << (degree_log - 2)] * 4)
        rng = random.Random(seed)
        self.z1, self.z2 = rng.randrange(self.fs.p), rng.randrange(self.fs.p)
        self.scheme = LPCScheme(self.params)
        for k, sizes in enumerate(self.sizes):
            self.scheme.append_to_batch(
                k, lpc_polys(self.fs, sizes, seed + k, device))
        self.roots = {}
        self.seconds = {}

    def _points(self, scheme):
        scheme.append_eval_point(0, self.z1)
        scheme.append_eval_point(0, self.z2)
        scheme.append_eval_point(1, self.z1)
        scheme.mark_batch_as_fixed(1)

    def _transcript(self, scheme):
        tr = Transcript("keccak_256", SEED)
        scheme.setup(tr, self.pre_data)
        return tr

    def commit(self, sync):
        for k in (0, 1):
            t0 = time.perf_counter()
            self.roots[k] = self.scheme.commit(k)
            sync()
            self.seconds[f"commit({k})"] = time.perf_counter() - t0
        self._points(self.scheme)
        t0 = time.perf_counter()
        self.pre_data = self.scheme.preprocess(
            Transcript("keccak_256", SEED))
        self.seconds["preprocess"] = time.perf_counter() - t0

    def prove(self, sync, clock=None):
        """`clock`: a `fri.PhaseClock` to take the phases' seconds."""
        tr = self._transcript(self.scheme)
        t0 = time.perf_counter()
        proof = self.scheme.proof_eval(tr, clock)
        sync()
        self.seconds["proof_eval"] = time.perf_counter() - t0
        return proof, tr.challenge(self.fs)

    def verify(self, proof):
        """An independent verifier-side scheme's answer and its
        transcript's next challenge."""
        ver = LPCScheme(self.params)
        for k, sizes in enumerate(self.sizes):
            ver.set_batch_size(k, len(sizes))
        self._points(ver)
        tv = self._transcript(ver)
        ok = ver.verify_eval(proof, self.roots, tv)
        return ok, tv.challenge(self.fs)
