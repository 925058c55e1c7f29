"""Merkle trees: build, proofs and verification (counterpart of
icicle_tpu/ops/merkle.py; reference F9: include/icicle/merkle/
merkle_tree.h:15-209, merkle_proof.h; CPU backend cpu_merkle_tree.cpp).

A tree is a list of per-layer hashers over the word-level `Hash`
interface. Layers are int32 word tensors on the leaves' device, and a layer
is one `hash_words` call over `cur.reshape(n_out, arity * words)`, a view
of the contiguous layer below: on the card a 2^29-leaf binary Poseidon2
tree is 29 kernel launches and nothing else. Proofs copy only the `arity`
rows of each group they read to the host; verification hashes one group a
layer on the tree's device.

Layer i's arity is hashers[i].default_input_words over the words below it
(the leaf layer: leaf_words). Padding policies are the reference's: none
(the leaf count must be the product of the arities), zero, last_value.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from icicle_tpu_torch.ops.hash.hash import Hash
from icicle_tpu_torch.runtime.config import HashConfig, MerkleTreeConfig
from icicle_tpu_torch.runtime.device import resolve
from icicle_tpu_torch.runtime.errors import IcicleError, IcicleException, check


def _words_np(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> host uint32 array with the same bits."""
    return t.cpu().numpy().view(np.uint32)


def _as_words(leaves) -> torch.Tensor:
    """An int32 word tensor as it is (on its device), or anything numpy reads
    as uint32 words, on the default device."""
    if isinstance(leaves, torch.Tensor):
        check(leaves.dtype == torch.int32, IcicleError.INVALID_ARGUMENT,
              f"leaves must be int32 words, got {leaves.dtype}")
        return leaves
    words = np.ascontiguousarray(np.asarray(leaves, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(words).to(resolve(None))


@dataclasses.dataclass
class MerkleProof:
    """reference merkle_proof.h: leaf (+index), root, path, pruned flag."""

    leaf: np.ndarray          # uint32 words of the leaf chunk
    leaf_idx: int
    root: np.ndarray          # uint32 words
    path: list[np.ndarray]    # per layer: sibling group words (pruned) or full group
    pruned: bool

    def serialize(self) -> bytes:
        """Reference BinarySerializer<MerkleProof> layout
        (merkle_proof_serializer.h): u8 pruned, u64 leaf_index,
        u64 leaf_nbytes + leaf, u64 root_nbytes + root, u64 path_nbytes +
        the path segments as ONE flat byte blob."""
        leaf = self.leaf.astype("<u4").tobytes()
        root = self.root.astype("<u4").tobytes()
        path = b"".join(seg.astype("<u4").tobytes() for seg in self.path)
        return (struct.pack("<BQQ", int(self.pruned), self.leaf_idx, len(leaf))
                + leaf + struct.pack("<Q", len(root)) + root
                + struct.pack("<Q", len(path)) + path)

    @classmethod
    def deserialize(cls, data: bytes) -> "MerkleProof":
        """Inverse of serialize. The path arrives as one flat blob (what the
        reference stores); MerkleTree.verify re-segments it from the tree's
        layer geometry."""
        off = 0
        pruned, leaf_idx, nleaf = struct.unpack_from("<BQQ", data, off)
        off += struct.calcsize("<BQQ")

        def read_arr(nbytes):
            nonlocal off
            arr = np.frombuffer(data, dtype="<u4", count=nbytes // 4,
                                offset=off).astype(np.uint32)
            off += nbytes
            return arr

        leaf = read_arr(nleaf)
        (nroot,) = struct.unpack_from("<Q", data, off)
        off += 8
        root = read_arr(nroot)
        (npath,) = struct.unpack_from("<Q", data, off)
        off += 8
        path = [read_arr(npath)]
        return cls(leaf=leaf, leaf_idx=leaf_idx, root=root, path=path,
                   pruned=bool(pruned))


class MerkleTree:
    """reference MerkleTree::create(layer_hashes, leaf_element_size,
    output_store_min_layer)."""

    def __init__(self, layer_hashes: list[Hash], leaf_words: int,
                 output_store_min_layer: int = 0):
        check(len(layer_hashes) >= 1, IcicleError.INVALID_ARGUMENT, "need >= 1 layer")
        self.hashers = list(layer_hashes)
        self.leaf_words = leaf_words
        self.min_store_layer = output_store_min_layer
        # arity of layer i in units of the layer below's outputs
        self.arities: list[int] = []
        prev_words = leaf_words
        for i, h in enumerate(self.hashers):
            in_words = h.default_input_words or prev_words
            check(in_words % prev_words == 0, IcicleError.INVALID_ARGUMENT,
                  f"layer {i}: input {in_words} not divisible by prev {prev_words}")
            self.arities.append(in_words // prev_words)
            prev_words = h.digest_words
        self.layers: list[torch.Tensor | None] = []

    def expected_leaves(self) -> int:
        n = 1
        for a in self.arities:
            n *= a
        return n

    def build(self, leaves, cfg: MerkleTreeConfig = MerkleTreeConfig(),
              chunks: int = 1) -> np.ndarray:
        """leaves: (nof_leaves, leaf_words) int32 words (or a flat multiple),
        or a uint32 array, which goes to the default device. Returns the
        root.

        One `hash_words` call a layer (reference build,
        cpu_merkle_tree.cpp:55-80), with `cfg.backend` as the hash's
        backend. `chunks` (the JAX package's split of its large layers) must
        divide the leaf count when > 1; here it splits each layer into at
        most `chunks` calls of at most ceil(rows / chunks) output rows, and
        never changes a layer's contents."""
        x = _as_words(leaves)
        if x.dim() == 1:
            check(x.numel() % self.leaf_words == 0, IcicleError.INVALID_ARGUMENT,
                  "flat leaves not a multiple of leaf size")
            x = x.reshape(-1, self.leaf_words)
        want = self.expected_leaves()
        have = x.shape[0]
        if have != want:
            check(have <= want, IcicleError.INVALID_ARGUMENT, "too many leaves")
            if cfg.padding_policy == "zero":
                pad = x.new_zeros((want - have, x.shape[1]))
            elif cfg.padding_policy == "last_value":
                pad = x[-1].expand(want - have, x.shape[1])
            else:
                raise IcicleException(IcicleError.INVALID_ARGUMENT,
                                      f"{have} leaves != {want} and no padding policy")
            x = torch.cat([x, pad])
        if chunks > 1:
            check(want % chunks == 0, IcicleError.INVALID_ARGUMENT,
                  "chunks must divide the leaf count")
        hcfg = HashConfig(backend=cfg.backend)
        self.layers = [x]
        cur = x
        for h, ar in zip(self.hashers, self.arities):
            n_out = cur.shape[0] // ar
            rows = cur.reshape(n_out, ar * cur.shape[1])
            step = -(-n_out // max(chunks, 1))
            parts = [h.hash_words(rows[i:i + step], hcfg) for i in range(0, n_out, step)]
            cur = parts[0] if len(parts) == 1 else torch.cat(parts)
            self.layers.append(cur)
        # drop layers below min_store_layer (the leaves stay: index 0)
        for j in range(1, self.min_store_layer + 1):
            if j < len(self.layers) - 1:
                self.layers[j] = None
        return self.get_root()

    def get_root(self) -> np.ndarray:
        check(bool(self.layers), IcicleError.INVALID_ARGUMENT, "tree not built")
        return _words_np(self.layers[-1]).reshape(-1)

    def _layer(self, i: int) -> torch.Tensor:
        check(self.layers[i] is not None, IcicleError.INVALID_ARGUMENT,
              f"layer {i} not stored (min_store_layer={self.min_store_layer})")
        return self.layers[i]

    def get_merkle_proof(self, leaves, leaf_idx: int, pruned: bool = True) -> MerkleProof:
        """Extract a proof for one leaf (reference get_merkle_proof; pruned
        path = sibling digests only, full = whole hash-input groups). Layer 0
        is `leaves` as given; each group's rows are sliced where the layer
        lives and only they are copied to the host."""
        leaves = (leaves.reshape(-1, self.leaf_words) if isinstance(leaves, torch.Tensor)
                  else np.asarray(leaves, dtype=np.uint32).reshape(-1, self.leaf_words))
        path = []
        idx = leaf_idx
        for i, arity in enumerate(self.arities):
            start = (idx // arity) * arity
            layer = leaves if i == 0 else self._layer(i)
            group = layer[start:start + arity]
            group = _words_np(group) if isinstance(group, torch.Tensor) else group
            if pruned:
                path.append(np.concatenate([group[j] for j in range(arity)
                                            if start + j != idx]).reshape(-1))
            else:
                path.append(group.reshape(-1))
            idx //= arity
        leaf = leaves[leaf_idx]
        leaf = _words_np(leaf) if isinstance(leaf, torch.Tensor) else leaf.copy()
        return MerkleProof(leaf=leaf, leaf_idx=leaf_idx, root=self.get_root(), path=path,
                           pruned=pruned)

    def verify(self, proof: MerkleProof) -> bool:
        """Recompute the root from the proof (reference MerkleTree::verify),
        one group a layer, on the device of the built tree (else the default
        device).

        The path is consumed as a flat word stream, so both locally built
        (per-layer segments) and deserialized (one flat blob) proofs
        verify."""
        dev = self.layers[-1].device if self.layers else resolve(None)
        flat = np.concatenate(proof.path) if len(proof.path) else np.zeros((0,), np.uint32)
        off = 0
        cur = proof.leaf
        idx = proof.leaf_idx
        for h, arity in zip(self.hashers, self.arities):
            pos = idx % arity
            rows = arity - 1 if proof.pruned else arity
            need = rows * cur.size
            seg = flat[off:off + need].reshape(rows, -1)
            off += need
            if proof.pruned:
                parts = [seg[j] for j in range(pos)] + [cur] + \
                        [seg[j] for j in range(pos, arity - 1)]
            else:
                if not np.array_equal(seg[pos], cur):
                    return False
                parts = [seg[j] for j in range(arity)]
            block = np.concatenate(parts).astype(np.uint32).reshape(1, -1)
            cur = _words_np(h.hash_words(torch.from_numpy(block.view(np.int32)).to(dev)))
            cur = cur.reshape(-1)
            idx //= arity
        return np.array_equal(cur, proof.root)
