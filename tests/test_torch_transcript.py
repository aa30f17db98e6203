"""The port's transcripts and host hashes against the JAX package's: the
same scripted absorb / challenge sequence gives the same bytes and the same
challenges. Host code on both sides, exact equality."""
import random

import pytest

from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.transcript import fiat_shamir as FS_
from crypto3_zk_tpu.transcript import hashes as H
from crypto3_zk_tpu.transcript import poseidon_transcript as PT
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.transcript import fiat_shamir as TFS
from crypto3_zk_tpu_torch.transcript import hashes as TH
from crypto3_zk_tpu_torch.transcript import poseidon_transcript as TPT

import torch_threads  # noqa: F401  one torch thread a worker


def test_keccak_256_vectors():
    # original Keccak-256 (0x01 padding), not SHA3-256
    assert TH.keccak_256(b"").hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert TH.keccak_256(b"abc").hex() == \
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    assert TH._keccak_256_py(b"abc") == TH.keccak_256(b"abc")
    rng = random.Random(1)
    for n in (1, 55, 135, 136, 137, 272, 500):      # around the 136-byte rate
        data = bytes(rng.randrange(256) for _ in range(n))
        # the compiled version (where it builds) and the Python one
        assert TH.keccak_256(data) == TH._keccak_256_py(data) \
            == H._keccak_256_py(data)


@pytest.mark.parametrize("name", ["keccak_256", "sha2_256", "blake2b_512"])
def test_hashes_equal_the_reference(name):
    fn, size = TH.get_hash(name)
    ref, ref_size = H.get_hash(name)
    assert size == ref_size
    for data in (b"", b"\x00", bytes(range(200))):
        assert fn(data) == ref(data) and len(fn(data)) == size


def _script(tr, fs, rng):
    """A scripted absorb / challenge sequence; returns what it drew."""
    out = []
    tr.absorb(b"context")
    out.append(tr.challenge(fs))
    tr.absorb_field(fs, rng.randrange(fs.p))
    tr.absorb_fields(fs, [rng.randrange(fs.p) for _ in range(3)])
    out.extend(tr.challenges(fs, 2))
    out.append(tr.int_challenge(32))
    fork = tr.fork()
    fork.absorb(b"side")
    out.append(fork.challenge(fs))
    out.append(tr.challenge(fs))          # the fork left the parent alone
    out.append(tr.challenge(fs))          # a second squeeze without absorb
    return out


@pytest.mark.parametrize("name", ["keccak_256", "sha2_256", "blake2b_512"])
def test_transcript_equals_the_reference(name):
    seed = bytes(range(10))
    got = _script(TFS.Transcript(name, seed), TP.BLS12_381_FR,
                  random.Random(3))
    want = _script(FS_.Transcript(name, seed), P.BLS12_381_FR,
                   random.Random(3))
    assert got == want
    assert TFS.Transcript(name).state == FS_.Transcript(name).state
    assert TFS.field_bytes_len(TP.BLS12_381_FR) == 32
    assert TFS.field_to_bytes(TP.BLS12_381_FR, -1) == \
        FS_.field_to_bytes(P.BLS12_381_FR, -1)


def test_accumulative_transcript_equals_the_reference():
    got, want = TFS.AccumulativeTranscript(), FS_.AccumulativeTranscript()
    for data in (b"a", b"bc", bytes(100)):
        got.absorb(data)
        want.absorb(data)
        assert got.digest() == want.digest()
    assert got.challenge(TP.BLS12_381_FR) == 1 and got.int_challenge() == 1


@pytest.mark.parametrize("flavour,field", [("original", "BLS12_381_FR"),
                                           ("nil", "PALLAS_FQ")])
def test_poseidon_transcript_equals_the_reference(flavour, field):
    fs, rfs = getattr(TP, field), getattr(P, field)
    got = _script(TPT.PoseidonTranscript(fs, b"seed", flavour), fs,
                  random.Random(4))
    want = _script(PT.PoseidonTranscript(rfs, b"seed", flavour), rfs,
                   random.Random(4))
    assert got == want
    # second-squeeze semantics: no absorb in between re-permutes
    tr = TPT.PoseidonTranscript(fs, flavor=flavour)
    tr.absorb_field(fs, 5)
    c1, c2 = tr.challenge(fs), tr.challenge(fs)
    assert c1 != c2
    sponge = TPT.PoseidonSponge(fs, flavour)
    sponge.absorb(5)
    first = sponge.squeeze()
    assert first == c1
    assert sponge.squeeze() == c2
    # a fork keeps the parent's permutation
    assert tr.fork().sponge.pp is tr.sponge.pp


def test_make_transcript():
    fs = TP.BLS12_381_FR
    assert isinstance(TPT.make_transcript("poseidon", fs, b"s"),
                      TPT.PoseidonTranscript)
    tr = TPT.make_transcript("sha2_256", fs, b"s")
    assert isinstance(tr, TFS.Transcript) and tr.hash_name == "sha2_256"
    with pytest.raises(AssertionError):
        TPT.PoseidonTranscript(fs).absorb_field(TP.ALT_BN128_FR, 1)
