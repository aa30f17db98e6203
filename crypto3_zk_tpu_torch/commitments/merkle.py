"""Merkle trees (arity 2) with pluggable hashing.

Counterpart of `commitments/merkle.py` of the JAX package: the equivalent of
`containers::merkle_tree<Hash,2>` / `merkle_proof` as driven by FRI
(`basic_fri.hpp:102-105,407,494`). Two hasher families:

- `FieldHasher`: Poseidon over the commitment field. Leaf rows and node
  levels are hashed with kernel 5 (`ops/hopper_hash.py`): one launch per two
  absorbed rows, one per level down to `TREE_MAX` states, and one for all
  the levels below; digests are field elements. Host scalar mirror for
  proof validation.
- `ByteHasher`: keccak/sha2/blake2b over big-endian serialized field
  elements; digests are bytes. sha2_256 hashes whole levels with kernel 7
  (`ops/sha256.py`): leaf rows that live on a device become their canonical
  big-endian bytes there, one launch hashes the leaves and one each level
  above (digests as (8, n) word planes). The other names run `hashlib` on
  the host, as does every validation.

Trees whose leaf rows live on a device keep every level there, root
included (`levels_dev`, for Poseidon and sha2_256); only the root and the
queried authentication paths are ever decoded to host. The JAX package
finishes Poseidon levels under 128 digests on the host to save its
dispatches; here the card's tree form hashes them in one launch, so a
Poseidon tree has no host part.
"""
from __future__ import annotations

import torch

from ..fields.params import FieldSpec
from ..ops import hopper_hash as HH
from ..ops import limbs as L
from ..ops import poseidon as PO
from ..ops import sha256 as SH
from ..transcript.fiat_shamir import field_to_bytes
from ..transcript.hashes import get_hash


def _po_mod(pp):
    """Dispatch to the permutation module matching the params flavor
    (original Grain-LFSR Poseidon vs the nil/zkLLVM kimchi-style one)."""
    from ..ops import nil_poseidon as NP
    return NP if isinstance(pp, NP.NilPoseidonParams) else PO


class FieldHasher:
    """Poseidon 2-to-1 / sponge hashing; digests are field ints.

    `flavor="nil"` selects the NilFoundation permutation recovered from
    the reference's zkLLVM circuit dump (`ops/nil_poseidon.py`): the
    constants the reference's own poseidon Merkle trees use."""

    kind = "field"
    device_levels = True

    def __init__(self, fs: FieldSpec, flavor: str = "original"):
        self.fs = fs
        if flavor == "nil":
            from ..ops import nil_poseidon as NP
            self.pp = NP.get_params(fs)
        else:
            self.pp = PO.get_params(fs)

    @property
    def _po(self):
        # computed, not stored: a module attribute would break
        # copy.deepcopy of scheme objects holding trees/hashers
        return _po_mod(self.pp)

    # device
    def leaf_hash_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """rows: (k, NL, n): sponge-absorb k elements per batch lane, two
        rows a permutation (an odd count leaves element 1 alone in the last
        one). The absorb rides in the permutation's launch, and the last
        launch writes element 0 only. Returns (NL, n) digests."""
        k = rows.shape[0]
        state = (None, None, None)
        for i in range(0, k, 2):
            adds = (rows[i], rows[i + 1] if i + 1 < k else None)
            last = i + 2 >= k
            out = HH.poseidon_permute_hopper(self.pp, state, adds,
                                             lane0_only=last)
            if last:
                return out
            state = (out[:, 0], out[:, 1], out[:, 2])
        raise ValueError("leaf_hash_rows: no rows")

    def node_hash(self, left: torch.Tensor,
                  right: torch.Tensor) -> torch.Tensor:
        return self._po.hash2_batch(self.pp, left, right)

    def node_level(self, cur: torch.Tensor) -> torch.Tensor:
        """The level above (NL, 2m) digests: (NL, m)."""
        return self.node_hash(cur[..., 0::2], cur[..., 1::2])

    def node_levels(self, digests: torch.Tensor) -> list[torch.Tensor]:
        """Every level above (NL, 2S) digests, S a power of two up to
        `hopper_hash.TREE_MAX`, down to the root: one launch."""
        return HH.poseidon_tree_hopper(self.pp, digests)

    def decode_digests(self, digests: torch.Tensor) -> list[int]:
        return L.decode(self.fs, digests)

    # host
    def leaf_hash_rows_host(self, elems: list[int]) -> int:
        state = [0, 0, 0]
        for i in range(0, len(elems), 2):
            state[0] = (state[0] + elems[i]) % self.fs.p
            if i + 1 < len(elems):
                state[1] = (state[1] + elems[i + 1]) % self.fs.p
            state = self._po.permute_host(self.pp, state)
        return state[0]

    def node_hash_host(self, left: int, right: int) -> int:
        return self._po.hash2_host(self.pp, left, right)

    def digest_bytes(self, digest: int) -> bytes:
        return field_to_bytes(self.fs, digest)


class ByteHasher:
    """Byte hash over serialized field elements; digests are bytes."""

    kind = "bytes"

    def __init__(self, fs: FieldSpec, hash_name: str = "keccak_256"):
        self.fs = fs
        self.hash_name = hash_name
        self._h, self.digest_len = get_hash(hash_name)

    def leaf_hash_rows_host(self, elems: list[int]) -> bytes:
        data = b"".join(field_to_bytes(self.fs, e) for e in elems)
        return self._h(data)

    def node_hash_host(self, left: bytes, right: bytes) -> bytes:
        return self._h(left + right)

    def digest_bytes(self, digest: bytes) -> bytes:
        return digest

    # device levels: sha2_256 only (kernel 7); digests are (8, n) words
    @property
    def device_levels(self) -> bool:
        return self.hash_name == "sha2_256"

    def leaf_hash_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """rows: (k, NL, n) Montgomery leaf rows -> (8, n) digest words of
        each leaf's k canonical big-endian elements, on rows' device (kernel
        7's leaf form, reading the rows' canonical digits)."""
        return SH.sha256_field_rows_hopper(self.fs, rows)

    def node_level(self, cur: torch.Tensor) -> torch.Tensor:
        """The level above (8, 2m) digest words: (8, m)."""
        return SH.sha256_nodes_hopper(cur)

    def decode_digests(self, digests: torch.Tensor) -> list[bytes]:
        return SH.digests_to_bytes(digests)

    # batched host-list hashing, as the JAX package's: sha2_256 batches of
    # at least `_DEVICE_BATCH_MIN` equal-length messages go to kernel 7 on
    # `device` (default: the card), the rest to `hashlib`
    _DEVICE_BATCH_MIN = 64

    def leaf_hash_rows_many(self, rows: list[list[int]],
                            device=None) -> list[bytes]:
        msgs = [b"".join(field_to_bytes(self.fs, e) for e in r) for r in rows]
        if (self.hash_name == "sha2_256"
                and len(msgs) >= self._DEVICE_BATCH_MIN
                and len({len(m) for m in msgs}) == 1):
            return SH.sha256_many(msgs, device)
        return [self._h(m) for m in msgs]

    def node_hash_many(self, lefts: list[bytes], rights: list[bytes],
                       device=None) -> list[bytes]:
        if (self.hash_name == "sha2_256"
                and len(lefts) >= self._DEVICE_BATCH_MIN):
            level = SH.bytes_to_digests(
                [d for pair in zip(lefts, rights) for d in pair],
                L.resolve_device(device))
            return SH.digests_to_bytes(SH.sha256_nodes_hopper(level))
        return [self._h(a + b) for a, b in zip(lefts, rights)]


def _device_levels(hasher, digests: torch.Tensor) -> list[torch.Tensor]:
    """(W, n) leaf digests -> the digest planes of every level down to the
    root, one launch a level (a level's even and odd digests are read in
    place); Poseidon's tree form takes every level from `TREE_MAX` states
    down in one launch."""
    levels = [digests]
    tree_form = getattr(hasher, "node_levels", None)
    while levels[-1].shape[-1] > 1:
        cur = levels[-1]
        n = cur.shape[-1]
        if tree_form and n <= 2 * HH.TREE_MAX and n & (n - 1) == 0:
            levels.extend(tree_form(cur))
            break
        levels.append(hasher.node_level(cur))
    return levels


class MerkleTree:
    """Built from leaf ROWS of field elements (each row = one leaf).

    Poseidon and sha2_256 trees of device rows keep every level where the
    rows live, root included (`levels_dev`); the other byte hashers, and
    leaf rows given as host ints, build lists of host digests
    (`levels_host`).
    """

    def __init__(self, hasher, leaf_rows_dev: torch.Tensor | None = None,
                 leaf_rows_host: list[list[int]] | None = None):
        self.hasher = hasher
        self.levels_dev = self.levels_host = None
        self._root = None
        if hasher.device_levels and leaf_rows_dev is not None:
            # leaf_rows_dev: (k, NL, n_leaves)
            self.levels_dev = _device_levels(
                hasher, hasher.leaf_hash_rows(leaf_rows_dev))
            return
        if leaf_rows_host is None:
            # decode device rows, hash on host (limb axis must be FIRST
            # for decode: (k, NL, n) -> (NL, k, n))
            k, nl, n = leaf_rows_dev.shape
            flat = L.decode(hasher.fs, leaf_rows_dev.permute(1, 0, 2))
            leaf_rows_host = [[flat[i * n + j] for i in range(k)]
                              for j in range(n)]
        digests = [hasher.leaf_hash_rows_host(r) for r in leaf_rows_host]
        self.levels_host = [digests]
        while len(digests) > 1:
            digests = [hasher.node_hash_host(digests[i], digests[i + 1])
                       for i in range(0, len(digests), 2)]
            self.levels_host.append(digests)

    @classmethod
    def from_leaf_digests_dev(cls, hasher, digests: torch.Tensor,
                              ) -> "MerkleTree":
        """Build from precomputed (NL, n_leaves) field leaf digests; node
        levels run on device exactly as the standard constructor."""
        assert hasher.kind == "field"
        self = cls.__new__(cls)
        self.hasher = hasher
        self.levels_dev = _device_levels(hasher, digests)
        self.levels_host = self._root = None
        return self

    @property
    def n_leaves(self) -> int:
        if self.levels_dev is not None:
            return self.levels_dev[0].shape[-1]
        return len(self.levels_host[0])

    def root(self):
        if self._root is None:
            self._root = self.levels_host[-1][0] if self.levels_dev is None \
                else self.hasher.decode_digests(self.levels_dev[-1])[0]
        return self._root

    def proof(self, idx: int) -> list:
        """Sibling digests bottom-up (`merkle_proof` over arity 2)."""
        return self.proofs([idx])[0]

    def proofs(self, indices: list[int]) -> list[list]:
        """Batched `proof` for many leaves. Device levels: the siblings of
        every level are gathered where they live and decoded together, one
        transfer each way for the whole batch."""
        if not indices:
            return []
        depth = len(self.levels_dev or self.levels_host) - 1
        sibs, idxs = [], list(indices)          # sibs[level][query]
        for _ in range(depth):
            sibs.append([i ^ 1 for i in idxs])
            idxs = [i // 2 for i in idxs]
        if self.levels_dev is None:
            return [[self.levels_host[lvl][sibs[lvl][q]]
                     for lvl in range(depth)] for q in range(len(indices))]
        if depth == 0:
            return [[] for _ in indices]
        q = len(indices)
        sib_dev = torch.tensor(sibs, dtype=torch.int64,
                               device=self.levels_dev[0].device)
        vals = self.hasher.decode_digests(torch.cat(
            [self.levels_dev[lvl].index_select(-1, sib_dev[lvl])
             for lvl in range(depth)], dim=-1))
        return [[vals[lvl * q + j] for lvl in range(depth)]
                for j in range(q)]

    @staticmethod
    def validate(hasher, root, leaf_row: list[int], idx: int, path: list) -> bool:
        d = hasher.leaf_hash_rows_host(leaf_row)
        for sib in path:
            d = hasher.node_hash_host(d, sib) if idx % 2 == 0 \
                else hasher.node_hash_host(sib, d)
            idx //= 2
        return d == root


def make_hasher(fs: FieldSpec, name: str):
    if name == "poseidon":
        return FieldHasher(fs)
    if name == "poseidon_nil":
        return FieldHasher(fs, flavor="nil")
    return ByteHasher(fs, name)
