"""The port's Merkle trees (`commitments/merkle.py`) against the JAX
package's: same leaves from a seed, the same root, `proof`, `proofs`, and
`validate` accepts and rejects. A Poseidon tree of the port is hashed by the
batched permutation down to the root at 256 leaves and at 8 (the JAX package
finishes under 128 digests on the host); a byte hasher's tree is host lists.
Exact equality."""
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto3_zk_tpu.commitments import merkle as RM
from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.ops import limbs as L
from crypto3_zk_tpu_torch import convert as C
from crypto3_zk_tpu_torch.commitments import merkle as TM
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.ops import limbs as TL

import torch_threads  # noqa: F401  one torch thread a worker

CASES = [("poseidon", "BLS12_381_FR"), ("poseidon_nil", "PALLAS_FQ"),
         ("keccak_256", "BLS12_381_FR"), ("sha2_256", "BLS12_381_FR")]


@functools.lru_cache(maxsize=None)
def _trees(name, field, n, k, seed=7):
    """(leaf rows, the reference's tree, the port's tree, the port's
    hasher), built once per module: the tests only read them."""
    rfs, fs = getattr(P, field), getattr(TP, field)
    rng = random.Random(seed)
    rows = [[rng.randrange(fs.p) for _ in range(k)] for _ in range(n)]
    ref_dev = jnp.stack([L.encode(rfs, [r[i] for r in rows])
                         for i in range(k)])                  # (k, NL, n)
    dev = torch.stack([C.limbs_from_numpy(fs, np.asarray(ref_dev[i]), "cpu")
                       for i in range(k)])
    ref_h, h = RM.make_hasher(rfs, name), TM.make_hasher(fs, name)
    return (rows, RM.MerkleTree(ref_h, leaf_rows_dev=ref_dev),
            TM.MerkleTree(h, leaf_rows_dev=dev), h)


@pytest.mark.parametrize("name,field", CASES)
@pytest.mark.parametrize("n,k", [(256, 2), (8, 3)])
def test_tree_equals_the_reference(name, field, n, k):
    rows, ref, tree, hasher = _trees(name, field, n, k)
    batched = hasher.kind == "field"
    assert (tree.levels_dev is not None) == batched
    assert (tree.levels_host is None) == batched
    if batched:
        # every level is a tensor, the root's included
        assert [lv.shape[-1] for lv in tree.levels_dev] == \
            [n >> i for i in range(n.bit_length())]
        for lv, ref_lv in zip(tree.levels_dev, ref.levels_dev or []):
            np.testing.assert_array_equal(
                lv.numpy(), np.asarray(ref_lv).astype(np.int32))
        # the levels the reference keeps as host ints
        ref_tail = ref.levels_host_tail if ref.levels_dev is not None \
            else ref.levels_host
        for lv, ref_lv in zip(tree.levels_dev[-len(ref_tail):], ref_tail):
            assert TL.decode(hasher.fs, lv) == ref_lv
    assert tree.n_leaves == ref.n_leaves == n
    root = tree.root()
    assert root == ref.root()
    picks = [0, 1, n // 2 + 1, n - 1]
    for idx in picks:
        path = tree.proof(idx)
        assert path == ref.proof(idx)
        assert len(path) == n.bit_length() - 1
        assert TM.MerkleTree.validate(hasher, root, rows[idx], idx, path)
        assert not TM.MerkleTree.validate(hasher, root, rows[idx], idx ^ 1,
                                          path)
    assert tree.proofs(picks) == [tree.proof(i) for i in picks] \
        == ref.proofs(picks)
    assert tree.proofs([]) == []
    bad = list(rows[3])
    bad[0] = (bad[0] + 1) % hasher.fs.p
    assert not TM.MerkleTree.validate(hasher, root, bad, 3, tree.proof(3))


def test_odd_row_count_leaves_element_one_alone():
    rows, ref, tree, hasher = _trees("poseidon", "BLS12_381_FR", 128, 3)
    assert tree.levels_dev is not None and len(tree.levels_dev) == 8
    assert tree.root() == ref.root()
    digests = TL.decode(hasher.fs, tree.levels_dev[0])
    assert digests[5] == hasher.leaf_hash_rows_host(rows[5])


def test_from_leaf_digests_and_host_rows():
    rows, ref, tree, hasher = _trees("poseidon", "BLS12_381_FR", 256, 2)
    again = TM.MerkleTree.from_leaf_digests_dev(hasher, tree.levels_dev[0])
    assert again.root() == tree.root()
    assert again.proof(200) == tree.proof(200)
    # a single digest is its own root, with an empty path
    lone = TM.MerkleTree.from_leaf_digests_dev(hasher,
                                               tree.levels_dev[0][:, 5:6])
    assert lone.root() == TL.decode(hasher.fs, tree.levels_dev[0])[5]
    assert lone.proofs([0]) == [[]] and lone.n_leaves == 1
    host = TM.MerkleTree(hasher, leaf_rows_host=rows[:8])
    assert host.levels_dev is None
    assert host.root() == TM.MerkleTree(
        hasher, leaf_rows_dev=torch.stack(
            [TL.encode(hasher.fs, [r[i] for r in rows[:8]], "cpu")
             for i in range(2)])).root()
    assert hasher.digest_bytes(5) == (5).to_bytes(32, "big")
    byte_hasher = TM.make_hasher(TP.BLS12_381_FR, "blake2b_512")
    assert byte_hasher.kind == "bytes" and byte_hasher.digest_len == 64
    assert byte_hasher.digest_bytes(b"xy") == b"xy"
