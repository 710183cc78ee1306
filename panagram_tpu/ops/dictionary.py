"""Pan-genome k-mer dictionary: sorted u64 keys -> N-bit presence masks.

Device replacement for the reference's one-hot KMC databases merged by
`kmc_tools complex -ocsum` (reference panagram/index.py:391-426 and
workflow/Snakefile:54-68): genome g contributes bit (g % 32) of word
(g // 32), so a key's mask words reproduce exactly the ceil(N/32) 32-bit
counters the reference stores across its bitvec databases.

The merge is a device-side sort of (key, genome) pairs followed by a
segmented sum of one-hot word contributions — a deterministic, order-fixed
reduction (no atomics), as required for bit-identical output (SURVEY §5.8).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .codec import SENTINEL


@partial(jax.jit, static_argnums=(2,))
def _merge_sets(keys: jax.Array, gids: jax.Array, nwords: int):
    """keys u64 [T] (SENTINEL-padded), gids int32 [T].

    Returns (keys u64 [T] sentinel-padded sorted distinct, masks u32 [T, W],
    count).
    """
    T = keys.shape[0]
    keys_s, g = jax.lax.sort((keys, gids), num_keys=1)
    real = keys_s != SENTINEL
    is_start = jnp.concatenate([jnp.ones(1, bool), keys_s[1:] != keys_s[:-1]]) & real
    seg = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    count = seg[-1] + 1

    safe_keys = jnp.where(real, keys_s, jnp.uint64(0))
    out_keys = jax.ops.segment_max(safe_keys, seg, num_segments=T)
    out_keys = jnp.where(jnp.arange(T) < count, out_keys, SENTINEL)

    word = g // 32
    bit = (jnp.uint32(1) << (g % 32).astype(jnp.uint32))
    cols = []
    for w in range(nwords):
        contrib = jnp.where(real & (word == w), bit, jnp.uint32(0))
        cols.append(jax.ops.segment_sum(contrib, seg, num_segments=T))
    masks = jnp.stack(cols, axis=1)
    masks = jnp.where((jnp.arange(T) < count)[:, None], masks, jnp.uint32(0))
    return out_keys, masks, count


@dataclasses.dataclass
class PanKmerDict:
    """The HBM-resident pan-kmer dictionary (host mirror).

    keys:  sorted distinct keys, u64 [D] — canonical k-mers (key_space
           "canon") or their splitmix64 mixes (key_space "mixed", produced
           by the device-resident builder, ops/devdict.py)
    masks: presence masks, u32 [D, W], W = ceil(ngenomes/32)
    """

    keys: np.ndarray
    masks: np.ndarray
    ngenomes: int
    k: int
    key_space: str = "canon"

    @property
    def nwords(self) -> int:
        return self.masks.shape[1]

    @property
    def nbytes_row(self) -> int:
        return (self.ngenomes + 7) // 8

    def __len__(self):
        return len(self.keys)

    def save(self, path: str):
        # atomic write: readers (e.g. other hosts of a distributed build)
        # must never observe a partially-written dictionary
        import os

        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, keys=self.keys, masks=self.masks,
                     ngenomes=self.ngenomes, k=self.k,
                     key_space=self.key_space)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "PanKmerDict":
        z = np.load(path)
        key_space = str(z["key_space"]) if "key_space" in z else "canon"
        return cls(z["keys"], z["masks"], int(z["ngenomes"]), int(z["k"]),
                   key_space)

    def pairwise_shared(self, block: int = 1 << 20) -> np.ndarray:
        """Genome x genome shared-distinct-kmer counts via a blocked
        popcount matmul on device (SURVEY §7.2 L-scale; the primitive
        behind reference scripts/pairwise_comp.py and mash distances)."""
        n = self.ngenomes
        out = np.zeros((n, n), np.int64)
        for s in range(0, len(self.keys), block):
            m = self.masks[s : s + block]
            out += np.asarray(_pairwise_block(jnp.asarray(m), n))
        return out


@partial(jax.jit, static_argnums=(1,))
def _pairwise_block(masks: jax.Array, ngenomes: int):
    """bits^T @ bits over a block of mask rows (int32 accumulation)."""
    D = masks.shape[0]
    bits = _unpack_bits(masks, ngenomes)  # [D, N] int8
    return jnp.dot(bits.T.astype(jnp.int32), bits.astype(jnp.int32),
                   preferred_element_type=jnp.int32)


@partial(jax.jit, static_argnums=(1,))
def _unpack_bits(masks: jax.Array, ngenomes: int):
    """u32 [*, W] -> int8 bit columns [*, N] (little-endian bit order,
    matching np.unpackbits(bitorder='little'), reference index.py:824-825)."""
    cols = []
    for g in range(ngenomes):
        w, b = divmod(g, 32)
        cols.append(((masks[..., w] >> np.uint32(b)) & jnp.uint32(1)).astype(jnp.int8))
    return jnp.stack(cols, axis=-1)


def build_dictionary(genome_sets: list[np.ndarray], k: int,
                     ngenomes: int | None = None) -> PanKmerDict:
    """Merge per-genome sorted distinct key sets into a PanKmerDict.

    genome_sets[g] is genome g's sorted distinct u64 keys (order of the list
    = genome id order, matching samples.tsv ids, reference index.py:283).
    """
    N = ngenomes if ngenomes is not None else len(genome_sets)
    W = (N + 31) // 32
    total = int(sum(len(s) for s in genome_sets))
    if total == 0:
        return PanKmerDict(np.zeros(0, np.uint64), np.zeros((0, W), np.uint32), N, k)
    keys = np.full(total, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    gids = np.zeros(total, np.int32)
    off = 0
    for g, s in enumerate(genome_sets):
        keys[off : off + len(s)] = s
        gids[off : off + len(s)] = g
        off += len(s)
    out_keys, masks, count = _merge_sets(jnp.asarray(keys), jnp.asarray(gids), W)
    D = int(count)
    return PanKmerDict(np.asarray(out_keys)[:D], np.asarray(masks)[:D], N, k)
