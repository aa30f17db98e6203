"""The port's SHA-256 (`ops/sha256.py`: kernel 7's plain version on the CPU)
and its sha2 Merkle trees against `hashlib` and the JAX package's
`ops/sha256.py` and `commitments/merkle.py`: single- and multi-block
messages, the JAX package's word contract, canonical big-endian leaf bytes
made from device rows, and a tree of 256 leaves level by level, its root,
paths that validate and the batched host-list helpers. Exact equality."""
import functools
import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto3_zk_tpu.commitments import merkle as RM
from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.ops import limbs as RL
from crypto3_zk_tpu.ops import sha256 as RS
from crypto3_zk_tpu.transcript import fiat_shamir as RF
from crypto3_zk_tpu_torch import convert as C
from crypto3_zk_tpu_torch.commitments import merkle as TM
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.ops import sha256 as SH
from crypto3_zk_tpu_torch.transcript.fiat_shamir import field_to_bytes

import torch_threads  # noqa: F401  one torch thread a worker


def _messages(n, length, seed):
    rng = random.Random(seed)
    return [bytes(rng.randrange(256) for _ in range(length))
            for _ in range(n)]


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 119, 150, 256])
def test_plain_version_against_hashlib(length):
    msgs = _messages(9, length, length)
    assert SH.sha256_many(msgs, "cpu") == [hashlib.sha256(m).digest()
                                           for m in msgs]


@pytest.mark.parametrize("msgs", [
    [bytes([i % 256]) * 64 for i in range(40)],      # one block + padding
    [bytes(range(150))] * 3,                         # three blocks
], ids=["64-byte", "150-byte"])
def test_equal_to_the_jax_package(msgs):
    """The reference test's messages (`tests/test_aux_components.py`), and
    the JAX package's (N, n_blocks, 16) word contract."""
    assert SH.sha256_many(msgs, "cpu") == RS.sha256_many(msgs)
    raw = np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(len(msgs), -1)
    blocks, _ = RS._pad_messages(raw)
    want = np.asarray(RS.sha256_batch_blocks(jnp.asarray(blocks)))
    got = SH.sha256_batch_blocks(torch.from_numpy(
        blocks.astype(np.int64)).to(torch.int32))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_node_form_and_digest_round_trip():
    digests = [hashlib.sha256(m).digest() for m in _messages(16, 7, 3)]
    words = SH.bytes_to_digests(digests, "cpu")
    assert words.shape == (8, 16) and words.dtype == torch.int32
    assert SH.digests_to_bytes(words) == digests
    assert SH.digests_to_bytes(SH.sha256_nodes_hopper(words)) == [
        hashlib.sha256(digests[2 * i] + digests[2 * i + 1]).digest()
        for i in range(8)]


@pytest.mark.parametrize("field", ["BLS12_381_FR", "MNT4_FR", "GOLDILOCKS",
                                   "BLS12_381_FQ"])
def test_leaf_bytes_from_device_rows(field):
    """`field_rows_to_bytes` gives `field_to_bytes` of every element, row
    after row, for even and odd byte lengths (MNT4 Fr: 38 bytes)."""
    fs = getattr(TP, field)
    rng = random.Random(11)
    k, n = 3, 5
    vals = [[rng.randrange(fs.p) for _ in range(n)] for _ in range(k)]
    vals[0][0], vals[1][0] = 0, fs.p - 1
    rows = torch.stack([TL.encode(fs, v, "cpu") for v in vals])
    got = SH.field_rows_to_bytes(fs, rows)
    for j in range(n):
        want = b"".join(field_to_bytes(fs, vals[i][j]) for i in range(k))
        assert bytes(got[j].tolist()) == want


@pytest.mark.parametrize("field,k", [
    (f, k) for f in ("BLS12_381_FR", "GOLDILOCKS", "MNT4_FR", "BLS12_381_FQ")
    for k in (1, 2, 8)] + [("GOLDILOCKS", 7), ("MNT4_FR", 5)])
def test_leaf_form_equals_the_jax_package(field, k):
    """`sha256_field_rows_hopper` (on the CPU its plain version) on leaves
    of k elements made with numpy from a seed, against the JAX package's
    `sha256_batch_blocks` on its own padding of the same leaves'
    `field_to_bytes` and its `sha256_many`; 7 Goldilocks and 5 MNT4 Fr
    values put the bit length in a block of its own."""
    fs, rfs = getattr(TP, field), getattr(P, field)
    rng = np.random.default_rng(k * 131 + fs.nl)
    n = 6
    vals = [[int.from_bytes(rng.bytes(fs.bits // 8 + 8), "little") % fs.p
             for _ in range(n)] for _ in range(k)]
    vals[0][0] = fs.p - 1
    rows = torch.stack([TL.encode(fs, v, "cpu") for v in vals])
    got = SH.sha256_field_rows_hopper(fs, rows)
    assert torch.equal(got, SH.sha256_field_rows_plain(fs, rows))
    msgs = [b"".join(RF.field_to_bytes(rfs, vals[e][i]) for e in range(k))
            for i in range(n)]
    raw = np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(n, -1)
    blocks, _ = RS._pad_messages(raw)
    want = np.asarray(RS.sha256_batch_blocks(jnp.asarray(blocks)))
    np.testing.assert_array_equal(got.T.numpy().astype(np.uint32), want)
    assert SH.digests_to_bytes(got) == RS.sha256_many(msgs)


@pytest.mark.parametrize("length", [0, 64, 128, 256])
def test_padding_schedule_against_a_compression(length):
    """Rounds that take K + W from `padding_schedule(length)` give the
    compression of the padding block from any state (Python ints)."""
    M = 0xFFFFFFFF

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & M

    rng = random.Random(length)
    st = [rng.randrange(1 << 32) for _ in range(8)]
    a, b, c, d, e, f, g, h = st
    for kw in SH.padding_schedule(length):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        t1 = (h + s1 + ((e & f) ^ (~e & g & M)) + kw) & M
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M, c, b, a,
                                  (t1 + s0 + ((a & b) ^ (a & c) ^ (b & c)))
                                  & M)
    got = [(x + y) & M for x, y in zip(st, (a, b, c, d, e, f, g, h))]
    pad = SH.pad_messages(torch.zeros((1, length), dtype=torch.int64))
    block = SH._to_u32(pad[-16:, 0])
    want = SH._compress_plain([torch.tensor([v]) for v in st],
                              list(block.reshape(16, 1)))
    assert got == [int(v) for v in want]
    for bad in (1, 63, 65):
        with pytest.raises(ValueError):
            SH.padding_schedule(bad)


def test_block_form_length_is_checked():
    """Given a length, the padded words must be that length's blocks; on
    the CPU the plain version runs either way."""
    msgs = _messages(3, 64, 5)
    raw = torch.tensor([list(m) for m in msgs], dtype=torch.int64)
    words = SH.pad_messages(raw)
    assert SH.digests_to_bytes(SH.sha256_blocks_hopper(words, 64)) == \
        [hashlib.sha256(m).digest() for m in msgs]
    with pytest.raises(ValueError):
        SH.sha256_blocks_hopper(words, 128)
    with pytest.raises(ValueError):
        SH.sha256_field_rows_hopper(TP.BLS12_381_FR, torch.zeros(
            (2, 4, 3), dtype=torch.int32))


@functools.lru_cache(maxsize=None)
def _trees(n=256, k=4, seed=0xA5):
    """The reference's sha2 tree of host rows and the port's of device
    rows (the plain kernel on the CPU), built once per module."""
    rfs, fs = P.BLS12_381_FR, TP.BLS12_381_FR
    rng = random.Random(seed)
    rows = [[rng.randrange(fs.p) for _ in range(k)] for _ in range(n)]
    ref_dev = jnp.stack([RL.encode(rfs, [r[i] for r in rows])
                         for i in range(k)])
    dev = torch.stack([C.limbs_from_numpy(fs, np.asarray(ref_dev[i]), "cpu")
                       for i in range(k)])
    ref = RM.MerkleTree(RM.ByteHasher(rfs, "sha2_256"), leaf_rows_host=rows)
    hasher = TM.ByteHasher(fs, "sha2_256")
    return rows, ref, TM.MerkleTree(hasher, leaf_rows_dev=dev), hasher


def test_sha2_tree_equals_the_jax_package():
    rows, ref, tree, hasher = _trees()
    assert tree.levels_host is None
    assert [lv.shape for lv in tree.levels_dev] == \
        [(8, 256 >> i) for i in range(9)]
    for lv, ref_lv in zip(tree.levels_dev, ref.levels_host):
        assert hasher.decode_digests(lv) == ref_lv
    root = tree.root()
    assert root == ref.root()
    for idx in (0, 77, 128, 255):
        path = tree.proof(idx)
        assert path == ref.proof(idx) and len(path) == 8
        assert TM.MerkleTree.validate(hasher, root, rows[idx], idx, path)
        assert RM.MerkleTree.validate(RM.ByteHasher(P.BLS12_381_FR,
                                                    "sha2_256"),
                                      root, rows[idx], idx, path)
        assert not TM.MerkleTree.validate(hasher, root, rows[idx], idx ^ 1,
                                          path)


def test_batched_host_list_helpers():
    """`leaf_hash_rows_many` / `node_hash_many` as the JAX package's: from
    64 equal-length messages through kernel 7 (here its plain version),
    below that `hashlib`; the same digests either way."""
    rows, ref, tree, hasher = _trees()
    rh = RM.ByteHasher(P.BLS12_381_FR, "sha2_256")
    for count in (128, 9):
        got = hasher.leaf_hash_rows_many(rows[:count], "cpu")
        assert got == rh.leaf_hash_rows_many(rows[:count])
        assert got == [hasher.leaf_hash_rows_host(r) for r in rows[:count]]
        assert hasher.node_hash_many(got[0::2], got[1::2], "cpu") == \
            rh.node_hash_many(got[0::2], got[1::2])
