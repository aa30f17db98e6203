"""The Placeholder deployment that `chip_smoke.py` drives and
`profile_prove --placeholder` profiles: `arithmetization.circuits.
placeholder_chain` (the add/mul chain with copy constraints and a range
lookup) over bls12-381 Fr, proved over LPC with the settings of the JAX
package's `bench.py` Placeholder stage: keccak-256 transcript, Poseidon
Merkle trees, `FRIParams.build(degree_log=rows_log, expand_factor=2,
lambda_=40)`.

    run = PlaceholderRun(rows_log=16, device="cuda")
    run.preprocess()                          # process_public / _private
    proof, challenge = run.prove()            # each prove on a fork
    ok, verifier_challenge = run.verify(proof)

`PlaceholderKZGRun` is the same circuit over alt_bn128 Fr proved over KZG
(`commitments/kzg.py`), as the reference's KZG runner
(`tests/test_placeholder.py:134-187` of the JAX package): keccak-256
transcript, an SRS of 4 * rows + 8 powers of tau made on the device and 8
in G2, `KZGSchemeV2` or `KZGSchemeBDFG`.
"""
from __future__ import annotations

import random
import time

from ..arithmetization.circuits import placeholder_chain
from ..commitments import fri as FRI
from ..commitments import kzg as KZG
from ..commitments.lpc import LPCScheme
from ..fields import curves as CV
from ..fields import params as P
from ..models.placeholder import common as C
from ..models.placeholder import preprocessor as PP
from ..models.placeholder.prover import prove
from ..models.placeholder.verifier import verify
from ..transcript.poseidon_transcript import make_transcript

EXPAND_FACTOR = 2


class PlaceholderRun:
    """One circuit of 2^rows_log rows, its preprocessed data on `device`
    and the verifier's side, with the seconds of each step in `seconds`."""

    def __init__(self, rows_log: int, device, lambda_: int = 40,
                 table_bits: int = 8, merkle_hash: str = "poseidon",
                 transcript_hash: str = "keccak_256", seed: int = 21):
        self.fs = P.BLS12_381_FR
        self.device = device
        self.table_bits = table_bits
        self.seconds: dict[str, float] = {}
        t0 = time.perf_counter()
        (self.cs, self.assignment, self.desc,
         self.public_input) = placeholder_chain(
            self.fs.p, (1 << rows_log) - 6, random.Random(seed), table_bits)
        self.seconds["circuit"] = time.perf_counter() - t0
        self.params = C.PlaceholderParams(self.fs,
                                          transcript_hash=transcript_hash)
        self.fri_params = FRI.FRIParams.build(
            self.fs, degree_log=rows_log, expand_factor=EXPAND_FACTOR,
            lambda_=lambda_, merkle_hash=merkle_hash,
            transcript_hash=transcript_hash)

    def new_scheme(self, prover: bool = True):
        """A fresh commitment scheme (the prover's or the verifier's)."""
        return LPCScheme(self.fri_params)

    def preprocess(self, clock: FRI.PhaseClock | None = None) -> None:
        """`process_public` (which commits the fixed batch into
        `self.scheme`) and `process_private`. `clock`: a
        `fri.PhaseClock` for process_public's steps."""
        self.scheme = self.new_scheme()
        t0 = time.perf_counter()
        self.public = PP.process_public(self.params, self.cs, self.assignment,
                                        self.desc, self.scheme,
                                        device=self.device, clock=clock)
        t1 = time.perf_counter()
        self.private = PP.process_private(self.params, self.cs,
                                          self.assignment, self.desc,
                                          device=self.device)
        self.seconds["process_public"] = t1 - t0
        self.seconds["process_private"] = time.perf_counter() - t1

    def _transcript(self):
        return make_transcript(self.params.transcript_hash, self.fs, b"")

    def prove(self, clock: FRI.PhaseClock | None = None):
        """A proof, on a fork of the preprocessed scheme, and the prover
        transcript's next challenge. `clock`: a `fri.PhaseClock` for the
        prove's phases."""
        tr = self._transcript()
        proof = prove(self.params, self.public, self.private, self.desc,
                      self.cs, self.scheme.fork(), clock, tr, self.device)
        return proof, tr.challenge(self.fs)

    def verify(self, proof, public_input=None):
        """An independent verifier-side scheme's answer (on this run's
        public input unless another is given) and its transcript's next
        challenge."""
        tr = self._transcript()
        ok = verify(self.params, self.public.common_data, proof, self.desc,
                    self.cs, self.new_scheme(prover=False),
                    public_input=self.public_input if public_input is None
                    else public_input, transcript=tr)
        return ok, tr.challenge(self.fs)


class PlaceholderKZGRun(PlaceholderRun):
    """`PlaceholderRun` over alt_bn128 Fr and KZG: `scheme` is "v2"
    (`KZGSchemeV2`) or "bdfg" (`KZGSchemeBDFG`). The SRS is made at
    construction, on `device` (its seconds in `seconds["kzg_setup"]`), from
    a tau drawn from the seed."""

    SCHEMES = {"v2": KZG.KZGSchemeV2, "bdfg": KZG.KZGSchemeBDFG}

    def __init__(self, rows_log: int, device, scheme: str = "v2",
                 table_bits: int = 8, seed: int = 21, kzg_params=None):
        self.curve = CV.ALT_BN128
        self.fs = self.curve.fr
        self.device = device
        self.table_bits = table_bits
        self.scheme_cls = self.SCHEMES[scheme]
        self.seconds: dict[str, float] = {}
        rng = random.Random(seed)
        t0 = time.perf_counter()
        (self.cs, self.assignment, self.desc,
         self.public_input) = placeholder_chain(
            self.fs.p, (1 << rows_log) - 6, rng, table_bits)
        self.seconds["circuit"] = time.perf_counter() - t0
        self.params = C.PlaceholderParams(self.fs,
                                          transcript_hash="keccak_256")
        t0 = time.perf_counter()
        self.kzg_params = kzg_params or KZG.KZGParams.setup(
            self.curve, 4 * self.desc.rows_amount + 8,
            tau=rng.randrange(2, self.fs.p), d2=8, device=device)
        self.seconds["kzg_setup"] = time.perf_counter() - t0

    def new_scheme(self, prover: bool = True):
        return self.scheme_cls(self.kzg_params,
                               self.device if prover else None)
