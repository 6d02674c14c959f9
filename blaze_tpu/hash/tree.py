"""8-ary Poseidon Merkle tree builder.

Behavioral parity with the reference's tree engine:
  * 8-ary tree of the given height; base layer has 8^(height-1) nodes and
    the total is sum_i 8^i, i < height — 585 nodes for height 4
    (`/root/reference/src/ingo_hash/utils.rs:2-14`,
    `tests/integration_poseidon.rs:23,165`);
  * TreeC mode column-hashes 11 input elements per leaf (the 11-element
    feed loop at integration_poseidon.rs:151-155; t=12 sponge), TreeD mode
    takes leaves directly (`utils.rs:16-30` TreeMode);
  * results are (hash, layer_id, hash_id) records mirroring
    PoseidonResult::parse_poseidon_hash_results (poseidon_api.rs:42-71).

Unlike the reference, hash values here are oracle-checked (tests) — blaze
never validates them (SURVEY §4.3).
"""
from __future__ import annotations

import enum

import jax
import jax.numpy as jnp
import numpy as np

from ..fields.spec import FieldSpec
from .params import PoseidonParams, generate_params
from .poseidon import Poseidon

ARITY = 8
LEAF_ARITY = 11  # elements column-hashed into one leaf (TreeC)


class TreeMode(enum.IntEnum):
    # values match the reference's start-layer encoding (utils.rs:16-30)
    TREE_C = 0
    TREE_D = 1


def num_tree_nodes(height: int) -> int:
    """Sum of 8^i for i < height (utils.rs:2-10)."""
    return sum(ARITY**i for i in range(height))


def base_layer_size(height: int) -> int:
    """8^(height-1) (utils.rs:12-14)."""
    return ARITY ** (height - 1)


class TreeResult:
    """All tree nodes, leaf layer first; mirrors the drained result records.

    Layers are DEVICE arrays until drained: building is async (JAX
    dispatch), like the reference's streaming engine that emits internal
    layers while leaves are still being fed (integration_poseidon.rs:81-119).
    `records()`/`root` force the transfer; `block_until_ready()` is the
    wait_result hook.
    """

    def __init__(self, layers: list):
        self.layers = layers            # (count, L) canonical limbs per layer

    def block_until_ready(self):
        jax.block_until_ready(self.layers)

    def records(self):
        """(hash_limbs, layer_id, hash_id) triples, streaming order."""
        out = []
        for layer_id, layer in enumerate(self.layers):
            for hash_id, h in enumerate(np.asarray(layer)):
                out.append((h, layer_id, hash_id))
        return out

    @property
    def root(self):
        return np.asarray(self.layers[-1])[0]

    def __len__(self):
        return sum(layer.shape[0] for layer in self.layers)


class MerkleTreeBuilder:
    """Level-synchronous 8-ary tree builder over batched Poseidon kernels."""

    def __init__(
        self,
        spec: FieldSpec,
        leaf_params: PoseidonParams | None = None,
        node_params: PoseidonParams | None = None,
    ):
        self.spec = spec
        self.leaf_params = leaf_params or generate_params(spec, LEAF_ARITY + 1)
        self.node_params = node_params or generate_params(spec, ARITY + 1)
        self.leaf_hasher = Poseidon(self.leaf_params)
        self.node_hasher = Poseidon(self.node_params)
        self.field = self.leaf_hasher.field

    # --------------------------------------------- streaming (incremental)
    #
    # The reference's engine hashes leaves WHILE elements are still being
    # fed and emits results incrementally (rayon producer/consumer pair,
    # tests/integration_poseidon.rs:81-119; drain loop
    # poseidon_api.rs:128-145).  These methods split the build into a
    # per-chunk leaf sponge and a tree-closing pass so the client can
    # dispatch leaf hashing as soon as enough columns have arrived.

    def hash_leaves(self, cols):
        """Chunk leaf sponge: (Bc, LEAF_ARITY, L) canonical ->
        (Bc, L) Montgomery leaf hashes (async)."""
        mont = self.field.jit_op("to_mont")(jnp.asarray(cols))
        return self.leaf_hasher.hash(mont, self.leaf_hasher.domain_tag(0))

    def close(self, leaf_layer_mont, height: int) -> TreeResult:
        """Node levels over a complete (B, L) mont leaf layer."""
        if leaf_layer_mont.shape[0] != base_layer_size(height):
            raise ValueError(
                f"want {base_layer_size(height)} leaves, "
                f"got {leaf_layer_mont.shape[0]}"
            )
        f = self.field
        layer = leaf_layer_mont
        layers_mont = [layer]
        tag = self.node_hasher.domain_tag(0)
        while layer.shape[0] > 1:
            grouped = layer.reshape(-1, ARITY, layer.shape[-1])
            layer = self.node_hasher.hash(grouped, tag)
            layers_mont.append(layer)
        layers = [f.jit_op("from_mont")(l) for l in layers_mont]
        return TreeResult(layers=layers)

    def build(
        self,
        elements,
        height: int,
        mode: TreeMode = TreeMode.TREE_C,
    ) -> TreeResult:
        """elements: canonical uint32 limbs —
        TREE_C: (8^(h-1), 11, L) column elements;
        TREE_D: (8^(h-1), L) precomputed leaves.
        """
        f = self.field
        nleaves = base_layer_size(height)
        # device arrays must not round-trip through the host
        arr = (elements if isinstance(elements, jax.Array)
               else jnp.asarray(np.asarray(elements, dtype=np.uint32)))
        if mode == TreeMode.TREE_C:
            if arr.shape[:2] != (nleaves, LEAF_ARITY):
                raise ValueError(
                    f"TreeC wants ({nleaves}, {LEAF_ARITY}, L), got {arr.shape}"
                )
            mont = f.jit_op("to_mont")(arr)
            tag = self.leaf_hasher.domain_tag(0)
            layer = self.leaf_hasher.hash(mont, tag)        # (nleaves, L)
        else:
            if arr.shape[0] != nleaves:
                raise ValueError(f"TreeD wants ({nleaves}, L), got {arr.shape}")
            layer = f.jit_op("to_mont")(arr)

        # leave layers on device (async dispatch); drained by records()
        return self.close(layer, height)
