"""Canonical k-mer codec (JAX/XLA).

Device restatement of KMC's k-mer extraction (the role of `kmc` counting
input parsing + CKmerAPI canonicalization in the reference; see
reference cpp/anchor.cpp:148 GetCountersForRead and SURVEY §7.1):

* bases are 2-bit encoded (A=0,C=1,G=2,T=3); non-ACGT marks the window
  invalid (KMC returns counter 0 for such windows);
* a k-mer is packed into a u64 with the first base most significant;
* the canonical form is min(forward, reverse-complement).

Everything here is shape-static and jit-friendly: the packing is k shifted
elementwise accumulations that XLA fuses into a single memory-bound pass.
k <= 31 so the packed value fits 62 bits, leaving u64 max free as a
sentinel for padding/invalid slots.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_K = 31

# Sentinel key: compares greater than any valid (2k<=62-bit) kmer.
# A NUMPY scalar on purpose: a jnp scalar at module scope would initialize
# the XLA backend at import time, which breaks multi-host bring-up
# (jax.distributed.initialize must run before any backend use) and makes
# `import panagram_tpu` touch the accelerator.  All uses are inside
# x64-enabled traces, where np.uint64 keeps its 64-bit dtype.
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _check_k(k: int):
    if not (1 <= k <= MAX_K):
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


@partial(jax.jit, static_argnums=(1,))
def pack_kmers(codes: jax.Array, k: int):
    """codes: uint8 [L] (values 0-3 valid, >=4 invalid).

    Returns (canon: u64 [L-k+1], valid: bool [L-k+1]).  Invalid windows get
    canon == SENTINEL so they never match a dictionary key.

    Implemented as a STATICALLY UNROLLED loop over base pairs accumulating
    into u32 (hi, lo) halves: k is static, so every shift is a
    compile-time constant and the whole window packing fuses into one
    elementwise pass, where a fori_loop/dynamic-slice formulation would
    carry a 5-array state through device memory k/2 times.  The unrolled
    HLO is still tiny (~20 ops per pair, k <= 31).
    """
    n = codes.shape[0] - k + 1
    c32 = codes.astype(jnp.uint32)
    three = jnp.uint32(3)

    def put(hi, lo, val, s: int):
        """(hi, lo) |= val << s for a 4-bit val at STATIC even shift s."""
        if s < 32:
            lo = lo | (val << np.uint32(s))
            if s > 28:  # the 4-bit value straddles the 32-bit boundary
                hi = hi | (val >> np.uint32(32 - s))
        else:
            hi = hi | (val << np.uint32(s - 32))
        return hi, lo

    # derive the inits from the input so their varying-axis type matches
    # under shard_map (zeros literals would be "unvarying" there)
    z = jax.lax.slice(c32, (0,), (n,)) & jnp.uint32(0)
    fhi = flo = rhi = rlo = z
    valid = z == 0
    for j in range(k // 2):
        i = 2 * j
        c0 = jax.lax.slice(c32, (i,), (i + n,))
        c1 = jax.lax.slice(c32, (i + 1,), (i + 1 + n,))
        fpair = ((c0 & three) << 2) | (c1 & three)
        rpair = (((three - c1) & three) << 2) | ((three - c0) & three)
        fhi, flo = put(fhi, flo, fpair, 2 * (k - 2) - 4 * j)
        rhi, rlo = put(rhi, rlo, rpair, 4 * j)
        valid = valid & (c0 < 4) & (c1 < 4)

    if k % 2 == 1:
        # odd k: one single-base tail at i = k-1 (static shifts)
        ci = jax.lax.slice(c32, (k - 1,), (k - 1 + n,))
        flo = flo | (ci & three)  # forward shift 0
        s = 2 * (k - 1)
        rv = (three - ci) & three
        if s < 32:
            rlo = rlo | (rv << np.uint32(s))
            if s > 28:
                rhi = rhi | (rv >> np.uint32(32 - s))
        else:
            rhi = rhi | (rv << np.uint32(s - 32))
        valid = valid & (ci < 4)

    take_f = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    chi = jnp.where(take_f, fhi, rhi).astype(jnp.uint64)
    clo = jnp.where(take_f, flo, rlo).astype(jnp.uint64)
    canon = (chi << np.uint64(32)) | clo
    canon = jnp.where(valid, canon, SENTINEL)
    return canon, valid


def _pair_reverse64(x: jax.Array) -> jax.Array:
    """Reverse the ORDER of the 32 2-bit pairs of a u64 (log-steps of
    masked swaps at 32/16/8/4/2 bit granularity; pairs stay intact)."""
    U = jnp.uint64
    x = (x << U(32)) | (x >> U(32))
    m = U(0x0000FFFF0000FFFF)
    x = ((x & m) << U(16)) | ((x >> U(16)) & m)
    m = U(0x00FF00FF00FF00FF)
    x = ((x & m) << U(8)) | ((x >> U(8)) & m)
    m = U(0x0F0F0F0F0F0F0F0F)
    x = ((x & m) << U(4)) | ((x >> U(4)) & m)
    m = U(0x3333333333333333)
    x = ((x & m) << U(2)) | ((x >> U(2)) & m)
    return x


@partial(jax.jit, static_argnums=(2, 3))
def pack_kmers_packed(packed: jax.Array, nmask: jax.Array, L: int, k: int):
    """Canonical k-mers DIRECTLY from the 2-bit packed transfer encoding
    (pack_bases_np layout) — the fast path of anchor_chunk_*.

    The k-step sliding accumulation of pack_kmers costs one offset slice
    per base; this instead assembles the
    LITTLE-ENDIAN 2-bit window W[i] = sum_t c[i+t] << 2t from EIGHT byte
    slices of the (L/4-byte) packed array plus a 4-way sub-byte phase
    interleave (minor-axis reshape, zero data movement), then uses two
    identities:

      forward  = pair_reverse(W) >> (64 - 2k)      (msb-first repack)
      revcomp  = ~W & (4^k - 1)                     (complement of the
                 little-endian window IS the msb-first reverse complement)

    so both strands come from ONE windowed build.  Validity is the same
    trick over the nmask bit stream (8-way phase interleave)."""
    _check_k(k)
    n = L - k + 1
    nb = -(-n // 4)
    n8 = -(-n // 8)
    U = jnp.uint64

    # bytes b..b+8 of the packed stream, zero-padded so every window loads
    p = packed
    if p.shape[0] < nb + 9:
        p = jnp.concatenate(
            [p, jnp.zeros(nb + 9 - p.shape[0], jnp.uint8)])
    p64 = p.astype(U)
    D = jax.lax.slice(p64, (0,), (nb,))
    for t in range(1, 8):
        D = D | (jax.lax.slice(p64, (t,), (t + nb,)) << U(8 * t))
    E = jax.lax.slice(p64, (8,), (8 + nb,))

    mask2k = U((1 << (2 * k)) - 1)
    phases = []
    for r in range(4):
        w = D >> U(2 * r) if r else D
        if r:
            w = w | (E << U(64 - 2 * r))
        phases.append(w & mask2k)
    W = jnp.stack(phases, axis=1).reshape(4 * nb)
    W = jax.lax.slice(W, (0,), (n,))

    fwd = _pair_reverse64(W) >> U(64 - 2 * k)
    rc = (~W) & mask2k
    canon = jnp.minimum(fwd, rc)

    # windowed validity over the nmask bit stream
    m = nmask
    if m.shape[0] < n8 + 8:
        m = jnp.concatenate(
            [m, jnp.zeros(n8 + 8 - m.shape[0], jnp.uint8)])
    m64 = m.astype(U)
    NB = jax.lax.slice(m64, (0,), (n8,))
    for t in range(1, 6):
        NB = NB | (jax.lax.slice(m64, (t,), (t + n8,)) << U(8 * t))
    kmask = U((1 << k) - 1)
    inv = [((NB >> U(rr)) & kmask) != 0 for rr in range(8)]
    bad = jnp.stack(inv, axis=1).reshape(8 * n8)
    valid = ~jax.lax.slice(bad, (0,), (n,))

    canon = jnp.where(valid, canon, SENTINEL)
    return canon, valid


def pack_bases_np(codes: np.ndarray):
    """Host-side 2-bit packing for cheap host->device transfer: returns
    (packed u8 [ceil(L/4)] with 4 bases/byte little-endian, nmask u8
    [ceil(L/8)] with bit i set when base i is non-ACGT, L).

    The reference streams raw ASCII into KMC (1 B/base); through a narrow
    host<->device link 2-bit packing is a 4x win (SURVEY §7.4.5 host IO)."""
    codes = np.asarray(codes, np.uint8)
    L = len(codes)
    invalid = codes >= 4
    c = np.where(invalid, 0, codes).astype(np.uint8)
    pad = (-L) % 4
    c4 = np.concatenate([c, np.zeros(pad, np.uint8)]).reshape(-1, 4)
    packed = (c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4) | (c4[:, 3] << 6))
    nmask = np.packbits(
        np.concatenate([invalid, np.zeros((-L) % 8, bool)]), bitorder="little"
    )
    return packed.astype(np.uint8), nmask, L


@partial(jax.jit, static_argnums=(2,))
def unpack_bases(packed: jax.Array, nmask: jax.Array, L: int) -> jax.Array:
    """Device-side unpack of pack_bases_np output -> u8 codes [L]
    (0-3 valid, 255 invalid).

    Broadcast-unpack + contiguous reshape, NOT a gather: position i = 4q+r
    maps to element (q, r) of a [ceil(L/4), 4] array, so the little-endian
    bit slices land in order with zero data movement.  (The previous
    jnp.take formulation issued two L-element narrow gathers — the
    issue-rate-bound op this module otherwise avoids, ~60 ms / 4 M chunk.)"""
    sh4 = jnp.arange(4, dtype=jnp.uint8) * 2
    codes = ((packed[:, None] >> sh4) & 3).astype(jnp.uint8).reshape(-1)[:L]
    bit8 = jnp.arange(8, dtype=jnp.uint8)
    bad = ((nmask[:, None] >> bit8) & 1).astype(jnp.uint8).reshape(-1)[:L]
    return jnp.where(bad == 1, jnp.uint8(255), codes)


def canonical_kmers(codes, k: int):
    """Host-friendly wrapper: accepts numpy uint8 codes, returns numpy
    (canon, valid) with invalid canon zeroed (oracle convention)."""
    _check_k(k)
    codes = jnp.asarray(codes, jnp.uint8)
    if codes.shape[0] < k:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    canon, valid = pack_kmers(codes, k)
    canon = np.asarray(canon)
    valid = np.asarray(valid)
    canon = np.where(valid, canon, np.uint64(0))
    return canon, valid
