"""Anchoring: streamed dictionary lookup + popcount + histograms.

Device replacement for the reference's hot path (cpp/anchor.cpp:112-195:
GetCountersForRead -> byte-pack -> __builtin_popcount -> occupancy
histogram): each anchor position's canonical k-mer is looked up in the
sorted dictionary (vectorized binary search), the presence-mask row is
gathered, and popcounts / per-genome column sums / per-bin occupancy
histograms are fused reductions over the same pass.
"""

from __future__ import annotations

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .codec import SENTINEL, pack_kmers


def _query_packed(packed, nmask, L: int, k: int, table, nbits: int,
                  cap: int, nwords: int):
    """Packed 2-bit stream -> position-ordered mask rows u32 [P, W]: the
    XLA codec (pack_kmers_packed) feeding the one-gather probe
    (lookup.bucket_query).  Every anchor_chunk_* kernel probes here."""
    from .codec import pack_kmers_packed
    from .lookup import bucket_query

    canon, _ = pack_kmers_packed(packed, nmask, L, k)
    return bucket_query(canon, table, nbits, cap, nwords)


@jax.jit
def anchor_lookup(canon: jax.Array, keys: jax.Array, masks: jax.Array):
    """canon u64 [P]; keys u64 [D] sorted (may be SENTINEL-padded);
    masks u32 [D, W].  Returns mask rows u32 [P, W] (0 for misses)."""
    D = keys.shape[0]
    idx = jnp.searchsorted(keys, canon)
    idx_c = jnp.clip(idx, 0, D - 1)
    hit = (keys[idx_c] == canon) & (canon != SENTINEL)
    rows = jnp.take(masks, idx_c, axis=0)
    return jnp.where(hit[:, None], rows, jnp.uint32(0))


@jax.jit
def mask_popcount(rows: jax.Array) -> jax.Array:
    """Popcount across mask words -> occupancy per position (int32 [P]).
    The explicit accumulator dtype stops jnp.sum promoting to int64 under
    the package's x64 mode (scattering int64 into int32 buffers warns now
    and will become an error)."""
    return jnp.sum(jax.lax.population_count(rows).astype(jnp.int32), axis=-1,
                   dtype=jnp.int32)


@jax.jit
def masks_to_bytes(rows: jax.Array) -> jax.Array:
    """u32 [P, W] -> little-endian uint8 [P, 4W].  The caller truncates to
    nbytes = ceil(N/8) columns, reproducing the reference's per-DB byte
    slice layout (panagram/index.py:937-947, cpp/anchor.cpp:138-165)."""
    P, W = rows.shape
    shifts = np.array([0, 8, 16, 24], np.uint32)
    b = (rows[:, :, None] >> shifts[None, None, :]) & jnp.uint32(0xFF)
    return b.astype(jnp.uint8).reshape(P, 4 * W)


def _colsum_list(rows: jax.Array, n: int) -> jax.Array:
    """Per-genome presence totals over the first n bits (int64 [n]).

    Eight fused shift+mask+sum passes over the byte view — memory-bounded
    at one [P, 4W] u8 temp per pass (a full broadcast-unpack would
    materialise [P, 32W], which aborted the 8-virtual-device CPU mesh at
    the 4M-position chunk; a per-genome loop would make n passes)."""
    P, W = rows.shape
    by = jax.lax.bitcast_convert_type(rows, jnp.uint8)       # [P, W, 4] LE
    byf = by.reshape(P, 4 * W)
    cols = [jnp.sum(((byf >> jnp.uint8(b)) & jnp.uint8(1)).astype(jnp.int32),
                    axis=0) for b in range(8)]               # 8 x [4W]
    sums = jnp.stack(cols, axis=1).reshape(32 * W)           # g = byte*8+bit
    return sums[:n].astype(jnp.int64)


@partial(jax.jit, static_argnums=(1,))
def genome_column_sums(rows: jax.Array, ngenomes: int) -> jax.Array:
    """Per-genome presence totals over positions (int64 [N]) — the
    paircount_sums of reference index.py:1051."""
    return _colsum_list(rows, ngenomes)


@partial(jax.jit, static_argnums=(1, 2, 3))
def occupancy_histogram(popc: jax.Array, binlen: int, nbins: int, ngenomes: int):
    """Per-bin occupancy histogram: [nbins, N+1] counts of positions whose
    popcount == occ (reference cpp/anchor.cpp:179-189, index.py:1169-1183).
    popc is int32 [P] where P <= nbins*binlen; pad entries must carry
    popc == -1 (ignored)."""
    P = popc.shape[0]
    bins = (jnp.arange(P) // binlen).astype(jnp.int32)
    ok = popc >= 0
    flat = jnp.where(ok, bins * (ngenomes + 1) + popc, nbins * (ngenomes + 1))
    hist = jnp.zeros(nbins * (ngenomes + 1) + 1, jnp.int32).at[flat].add(1)
    return hist[:-1].reshape(nbins, ngenomes + 1)


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def anchor_chunk_fast(packed: jax.Array, nmask: jax.Array,
                      table: jax.Array,
                      L: int, k: int, nbits: int, cap: int,
                      nwords: int, nbytes: int):
    """Fused fast path: packed 2-bit codes -> bitmap bytes (device-sliced to
    nbytes) + popcounts + per-genome totals, using the bucketed-hash lookup
    (ops/lookup.py) instead of binary search.

    Minimises host<->device traffic: input is 0.375 B/base, outputs are
    nbytes/position + tiny reductions (SURVEY §7.4.5)."""
    rows = _query_packed(packed, nmask, L, k, table, nbits, cap, nwords)
    popc = mask_popcount(rows)
    by = masks_to_bytes(rows)[:, :nbytes]
    colsums = _colsum_list(rows, 32 * nwords)
    return by, popc, colsums


def rle_row_bytes(nbytes: int) -> int:
    """v3 data-row width: [delta u8 | mask bytes], floored at 4 so the
    count header (u32 LE in row 0) always fits."""
    return max(1 + nbytes, 4)


def _run_structure(rows: jax.Array):
    """Shared run decomposition for the RLE protocols: mask rows u32
    [P, W] -> (change bool [P], count i32 (total runs)).

    A "run" starts wherever the mask row differs from the previous
    position, plus injected continuation rows every 255 positions inside
    long runs (same mask, delta 255) so every gap fits u8; the worst
    case adds P/255 rows.  Deltas are derived AFTER compaction as
    consecutive-position differences (_compact_runs), which removed the
    second cummax and the cumsum this used to run over the full chunk."""
    P = rows.shape[0]
    change0 = jnp.concatenate([
        jnp.ones(1, bool), jnp.any(rows[1:] != rows[:-1], axis=1)
    ])
    iota = jnp.arange(P, dtype=jnp.int32)
    # distance from the last REAL change; continuation rows at every
    # multiple of 255 keep all gaps <= 255
    last0 = jax.lax.cummax(jnp.where(change0, iota, -1))
    dist = iota - last0
    change = change0 | ((dist > 0) & (dist % 255 == 0))
    count = jnp.sum(change.astype(jnp.int32))
    return change, count


def _compact_runs(rows: jax.Array, change: jax.Array, prefix: int):
    """Stream compaction of the run rows: one STABLE multi-operand sort
    (non-changes sort last; stability preserves position order) + a static
    prefix slice, in place of a .at[slots].set scatter.  Which of the two
    is faster on the GPU has not been measured (ROADMAP speed item 4).

    The sort carries each run's POSITION; deltas come out as consecutive
    differences on the compacted prefix (512K elements instead of a
    full-chunk cummax).  Run 0 sits at position 0, so its "difference"
    (pos[0] - 0) is the required delta 0.

    Returns (delta u8 [prefix], masks u32 [prefix, W]); entries past the
    true run count are GARBAGE (not zeros) — every consumer reads only
    `count` rows."""
    P, W = rows.shape
    n = min(prefix, P)
    iota = jnp.arange(P, dtype=jnp.uint32)
    # ONE u32 key: bit 31 = non-change, low bits = position — ascending
    # order IS "changes first, position-stable" (P < 2^31 always), so the
    # flag+iota operand pair collapses into a single sort operand
    ckey = jnp.where(change, iota, iota | jnp.uint32(1 << 31))
    ops = (ckey,) + tuple(rows[:, w] for w in range(W))
    srt = jax.lax.sort(ops, num_keys=1)
    pos_c = (jax.lax.slice(srt[0], (0,), (n,))
             & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), pos_c[:-1]])
    delta_c = (pos_c - prev).astype(jnp.uint8)
    rmask = jnp.stack(
        [jax.lax.slice(srt[1 + w], (0,), (n,)) for w in range(W)], axis=1)
    if n < prefix:
        delta_c = jnp.concatenate(
            [delta_c, jnp.zeros(prefix - n, delta_c.dtype)])
        rmask = jnp.concatenate(
            [rmask, jnp.zeros((prefix - n, W), rmask.dtype)])
    return delta_c, rmask


def rle_payload(rows: jax.Array, nbytes: int, capacity: int):
    """Shared RLE compaction (protocol v3): mask rows u32 [P, W] ->
    (out u8 [capacity + 1, rle_row_bytes(nbytes)], count i32).

    Output row i < count is [delta u8 | mask bytes]: delta is the
    position gap to the PREVIOUS data row (row 0 sits at position 0 with
    delta 0), so host decode is a u8 cumsum — 2 fewer bytes per row than
    an absolute u24 position.  Runs longer than 255 positions carry
    injected continuation rows (see _run_structure).  Popcounts and per-genome totals are
    host-derived from the mask bytes (unpack_rle2 / rle2_colsums), so the
    device ships only what cannot be recomputed.  Compaction is the
    sort-based _compact_runs; rows past `count` are garbage and rows past
    `capacity` are simply not represented — `count` always reports the
    true run count so the caller can detect overflow."""
    change, count = _run_structure(rows)
    delta_c, rmask = _compact_runs(rows, change, capacity + 1)
    by = masks_to_bytes(rmask)[:, :nbytes]
    rowb = rle_row_bytes(nbytes)
    parts = [delta_c[:, None], by]
    if rowb > 1 + nbytes:
        parts.append(jnp.zeros((capacity + 1, rowb - 1 - nbytes), jnp.uint8))
    out = jnp.concatenate(parts, axis=1)
    return out, count


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8))
def anchor_chunk_rle2(inbuf: jax.Array, table: jax.Array,
                      L: int, k: int, nbits: int, cap: int,
                      nwords: int, nbytes: int, capacity: int):
    """Transfer-optimal fast path: ONE u8 input buffer (packed bases ++
    N-mask, from pack_bases_combined) and ONE u8 output buffer per chunk.

    Returns combined u8 [capacity + 2, rle_row_bytes(nbytes)]:
      row 0        header — bytes 0:4 hold the true run count (u32 LE)
      rows 1..cnt  RLE v3 data rows [delta u8 | mask bytes]
    Folding the count into the buffer means the host learns count AND
    receives the typical-case payload in a SINGLE speculative prefix
    transfer (collect_rle2), with no separate round trip for a stats
    array.  Host side: collect_rle2 -> unpack_rle2 /
    rle2_colsums.  count > capacity signals overflow (rows were dropped);
    the caller falls back to anchor_chunk_fast.
    """
    n4 = (L + 3) // 4
    packed = jax.lax.slice(inbuf, (0,), (n4,))
    nmask = jax.lax.slice(inbuf, (n4,), (inbuf.shape[0],))
    rows = _query_packed(packed, nmask, L, k, table, nbits, cap, nwords)
    body, count = rle_payload(rows, nbytes, capacity)

    cnt32 = count.astype(jnp.uint32)
    cshift = np.array([0, 8, 16, 24], np.uint32)
    header = jnp.zeros((1, rle_row_bytes(nbytes)), jnp.uint8).at[0, :4].set(
        ((cnt32 >> cshift) & 0xFF).astype(jnp.uint8))
    return jnp.concatenate([header, body], axis=0)


def pack_bases_combined(codes: np.ndarray):
    """Host-side single-buffer companion of pack_bases_np: returns
    (inbuf u8 [ceil(L/4) + ceil(L/8)], L)."""
    from .codec import pack_bases_np

    packed, nmask, L = pack_bases_np(codes)
    return np.concatenate([packed, nmask]), L


# ---------------------------------------------------------------------------
# RLE protocol v4: palette-coded data rows.
#
# v3 ships [delta u8 | nbytes mask bytes] per run — 5 B/run at 30 genomes,
# 14 B/run at 100.  Real pan-genome bitmaps draw their rows from a SMALL set
# of distinct masks (haplotype structure), so v4 ships each chunk's distinct
# masks once (the palette) and references them with a u16 index:
#
#   data buffer u8 [pal_work + 1, 3]: rows [delta u8 | palette idx u16 LE]
#   palette buffer u8 [PAL_CAP + 3, rle4_pal_bytes(nbytes)]:
#       row 0: run count (u32 LE)        row 1: palette size U (u32 LE)
#       rows 2..2+U: palette entries (little-endian mask bytes)
#
# 3 B/run + U*4W bytes — 40% fewer d2h bytes than v3 at 30 genomes and
# ~4.7x fewer at 100.
# The palette is built on device from the run rows only (a pal_work-sized
# prefix, not the full chunk): sort runs by mask value, group-change flags
# -> palette ids, one inverse sort back to run order.  Overflow (run count
# > pal_work, or U > PAL_CAP) is signalled through the header and the
# caller falls back to the dense path — both need adversarially diverse
# masks that real pangenomes don't produce.
# ---------------------------------------------------------------------------

PAL_CAP = 1 << 16          # u16 index space
_PAL_PIECE = 1 << 12       # palette-buffer transfer piece (rows)


def rle4_pal_bytes(nbytes: int) -> int:
    """v4 palette-row width: the bitmap's nbytes mask bytes, floored at 4
    so the u32 count/U headers (rows 0-1) fit."""
    return max(nbytes, 4)


def pal_work_for(capacity: int) -> int:
    """Palette working-prefix size: how many leading runs participate in
    palette construction (beyond it the chunk falls back to protocol v3).
    An eighth of the chunk gives ~1.6x headroom over the run densities of
    the synthetic bench pangenome (323k runs per 4M-position chunk) while
    keeping the two palette sorts ~8x smaller than chunk-sized ones."""
    env = os.environ.get("PANAGRAM_TPU_PAL_WORK_LOG2")
    if env:
        return min(1 << int(env), capacity)
    return max(capacity >> 3, min(capacity, PAL_CAP))


def rle4_payload(rows: jax.Array, nbytes: int, pal_work: int):
    """Protocol-v4 compaction: mask rows u32 [P, W] ->
    (data u8 [pal_work + 1, 3], pal u8 [PAL_CAP + 3,
    rle4_pal_bytes(nbytes)], count i32, U i32).  count/U also ride in
    the pal header (rows 0-1) for single-buffer consumers.  See the
    protocol comment above for the layout.

    A chunk is only valid under v4 when count <= pal_work (the caller
    falls back to v3 otherwise), so delta and mask words compact to a
    [pal_work + 1] prefix via the sort-based _compact_runs.  Rows past
    `count` are garbage; the palette stage masks them by run index and
    the host reads only `count` rows."""
    P, W = rows.shape
    change, count = _run_structure(rows)
    delta_col, rmask = _compact_runs(rows, change, pal_work + 1)

    # palette grouping: sort runs by (validity, mask words) carrying the
    # run index; valid runs sort first, equal masks group together
    run_iota = jnp.arange(pal_work + 1, dtype=jnp.int32)
    valid = run_iota < jnp.minimum(count, pal_work)
    inv = (~valid).astype(jnp.uint32)
    srt = jax.lax.sort(
        (inv,) + tuple(rmask[:, w] for w in range(W)) + (run_iota,),
        num_keys=1 + W)
    vs = srt[0] == 0
    ms = srt[1 : 1 + W]
    io_s = srt[1 + W]
    diff = jnp.zeros(pal_work, bool)
    for m in ms:
        diff = diff | (m[1:] != m[:-1])
    chg = vs & jnp.concatenate([jnp.ones(1, bool), diff])
    gid = jnp.cumsum(chg.astype(jnp.int32)) - 1
    U = gid[-1] + 1      # >= 1: run 0 always exists and starts a group

    # palette table: every member of a group writes the SAME value, so
    # duplicate scatter indices are deterministic in value
    gidc = jnp.where(vs, jnp.minimum(gid, PAL_CAP), PAL_CAP)
    palw = jnp.zeros((PAL_CAP + 1, W), jnp.uint32).at[gidc].set(
        jnp.stack(ms, axis=1), mode="drop")

    # inverse permutation: sort (run index, gid) back to run order (a
    # gather would reintroduce the issue-rate wall)
    inv_srt = jax.lax.sort((io_s, gidc), num_keys=1)
    idx16 = inv_srt[1]
    idx_lo = (idx16 & 0xFF).astype(jnp.uint8)
    idx_hi = ((idx16 >> 8) & 0xFF).astype(jnp.uint8)
    data = jnp.stack([delta_col, idx_lo, idx_hi], axis=1)

    # palette rows carry exactly the bitmap's nbytes mask bytes (width
    # floored at 4 so the u32 headers in rows 0-1 fit)
    pal_w = rle4_pal_bytes(nbytes)
    cshift = np.array([0, 8, 16, 24], np.uint32)
    hdr_vals = jnp.stack([count.astype(jnp.uint32), U.astype(jnp.uint32)])
    hdr = jnp.zeros((2, pal_w), jnp.uint8).at[:, :4].set(
        ((hdr_vals[:, None] >> cshift[None, :]) & 0xFF).astype(jnp.uint8))
    pal = jnp.concatenate([hdr, masks_to_bytes(palw)[:, :pal_w]], axis=0)
    return data, pal, count, U


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8))
def anchor_chunk_rle4(inbuf: jax.Array, table: jax.Array,
                      L: int, k: int, nbits: int, cap: int,
                      nwords: int, nbytes: int, pal_work: int):
    """Palette-protocol twin of anchor_chunk_rle2: ONE u8 input buffer ->
    (data u8 [pal_work + 1, 3], pal u8 [PAL_CAP + 3,
    rle4_pal_bytes(nbytes)]).  Host side:
    dispatch_rle4_prefix -> collect_rle4 -> unpack_rle4."""
    n4 = (L + 3) // 4
    packed = jax.lax.slice(inbuf, (0,), (n4,))
    nmask = jax.lax.slice(inbuf, (n4,), (inbuf.shape[0],))
    rows = _query_packed(packed, nmask, L, k, table, nbits, cap, nwords)
    data, pal, _count, _u = rle4_payload(rows, nbytes, pal_work)
    return data, pal


try:  # native memcpy decoders (faster than np.repeat); optional build
    from ..native.anchor_cpu import (
        rle_expand_native as _rle_expand_native,
        rle_expand_pal_native as _rle_expand_pal_native,
    )
except OSError:  # pragma: no cover - library not built
    _rle_expand_native = None
    _rle_expand_pal_native = None


def _rle_pos(rowsc: np.ndarray) -> np.ndarray:
    """v3 delta column -> absolute positions, int64 [count] (row 0 has
    delta 0 == position 0, so a plain cumsum reconstructs)."""
    return np.cumsum(rowsc[:, 0].astype(np.int64))


_POPC8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                       axis=1).sum(axis=1).astype(np.int32)


def unpack_rle2(data_rows: np.ndarray, count: int, total: int,
                nbytes: int, out=None):
    """Host-side decode of RLE v3 data rows ([delta u8 | mask bytes],
    width rle_row_bytes(nbytes), header already stripped): returns
    (bytes [total, nbytes], popc i32 [total]).  popc is recomputed from
    the mask bytes — cheaper to rebuild per ROW here than to ship per
    run over the link.

    `out=(out_b, out_p)` reuses caller buffers (see rle_expand_native)."""
    if _rle_expand_native is not None and count > 0:
        return _rle_expand_native(data_rows, count, total, nbytes, out=out)
    rowsc = data_rows[:count]
    pos = _rle_pos(rowsc)
    by = rowsc[:, 1 : 1 + nbytes]
    popc = _POPC8[by].sum(axis=1, dtype=np.int32)
    reps = np.diff(pos, append=total)
    return np.repeat(by, reps, axis=0), np.repeat(popc, reps)


_BIT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1,
                      bitorder="little").astype(np.int64)   # [256, 8]


def rle2_colsums(data_rows: np.ndarray, count: int, total: int,
                 ngenomes: int) -> np.ndarray:
    """Exact per-genome presence totals from RLE rows x run lengths —
    host-side replacement for the device column-sum reductions (the
    paircount_sums of reference index.py:1051).  `total` must be the REAL
    position count (padding rows are zero anyway).

    Per mask BYTE: bincount the 256 byte values weighted by run lengths,
    then expand through an 8-bit table — O(count) adds and a [256, 8]
    product instead of materialising a [count, N] unpacked bit matrix."""
    nbytes = (ngenomes + 7) // 8
    rowsc = data_rows[:count]
    reps = np.diff(_rle_pos(rowsc), append=total).clip(min=0)
    out = np.empty(nbytes * 8, np.int64)
    for b in range(nbytes):
        w = np.bincount(rowsc[:, 1 + b], weights=reps, minlength=256)
        out[b * 8 : b * 8 + 8] = (w[:, None] * _BIT8).sum(axis=0)
    return out[:ngenomes]


def rle4_colsums(data_rows: np.ndarray, pal_bytes: np.ndarray, count: int,
                 total: int, ngenomes: int) -> np.ndarray:
    """v4 per-genome totals straight from the palette: aggregate run
    lengths per palette entry (one bincount over the u16 indices), then
    one [U, N] bit expansion — U is typically a few thousand, so this is
    ~free next to the v3 unpack."""
    nbytes = (ngenomes + 7) // 8
    pos = np.cumsum(data_rows[:count, 0].astype(np.int64))
    reps = np.diff(pos, append=total).clip(min=0)
    idx = data_rows[:count, 1].astype(np.int32) \
        | (data_rows[:count, 2].astype(np.int32) << 8)
    U = pal_bytes.shape[0]
    weights = np.bincount(idx, weights=reps, minlength=U)[:U]
    bits = np.unpackbits(np.ascontiguousarray(pal_bytes[:, :nbytes]),
                         axis=1, bitorder="little")[:, :ngenomes]
    return (weights[:, None] * bits).sum(axis=0).astype(np.int64)


def rle2_popc(data_rows: np.ndarray, count: int, total: int,
              nbytes: int, out: np.ndarray | None = None) -> np.ndarray:
    """Popcount-only decode of RLE v3 rows -> i32 [total].

    The multi-host sharded drain (index.Genome._mesh_chunk_results) gives
    every process the compact RLE buffers (lockstep control flow), but
    only the owning host expands a shard's mask BYTES; the popcounts —
    needed on every host for the bin/gene histograms to stay identical —
    are ~nbytes x cheaper to expand than the bytes."""
    rowsc = data_rows[:count]
    popc = _POPC8[rowsc[:, 1 : 1 + nbytes]].sum(axis=1, dtype=np.int32)
    reps = np.diff(_rle_pos(rowsc), append=total)
    res = np.repeat(popc, reps)
    if out is not None:
        out[:total] = res
        return out[:total]
    return res


def rle4_popc(data_rows: np.ndarray, pal_bytes: np.ndarray, count: int,
              total: int, nbytes: int,
              out: np.ndarray | None = None) -> np.ndarray:
    """v4 twin of rle2_popc: per-palette-entry popcounts (U rows) gathered
    through the u16 run indices, then run-length expanded."""
    pal_popc = _POPC8[np.ascontiguousarray(pal_bytes[:, :nbytes])].sum(
        axis=1, dtype=np.int32)
    idx = data_rows[:count, 1].astype(np.int32) \
        | (data_rows[:count, 2].astype(np.int32) << 8)
    idx = np.minimum(idx, pal_popc.shape[0] - 1)
    pos = np.cumsum(data_rows[:count, 0].astype(np.int64))
    reps = np.diff(pos, append=total)
    res = np.repeat(pal_popc[idx], reps)
    if out is not None:
        out[:total] = res
        return out[:total]
    return res


# rows per transfer piece (one cached slice program per size).  Bigger
# pieces mean fewer d2h calls per chunk at the cost of coarser
# over-transfer quantization.
_PIECE = 1 << int(os.environ.get("PANAGRAM_TPU_PIECE_LOG2", "16"))
# chunks dispatched ahead of the drain point: deeper pipelines hide more
# d2h behind compute, at ~rle-buffer host memory per in-flight chunk
PIPELINE_DEPTH = int(os.environ.get("PANAGRAM_TPU_PIPELINE_DEPTH", "4"))
# decode pool width: collect+decode of different chunks overlap each other
# AND the dispatch thread (d2h waits, the ctypes RLE expander, and numpy
# reductions all release the GIL)
DECODE_WORKERS = int(os.environ.get("PANAGRAM_TPU_DECODE_WORKERS", "2"))
_piece_fns: dict = {}


def piece_fn(rows: int, rowb: int, dtype, piece_rows: int = _PIECE):
    """The cached fixed-size piece-slice program for a buffer shape (ONE
    program per shape — a static slice per observed count would
    recompile).  Exposed so ops.prewarm can AOT-compile the exact programs
    a run will need."""
    import jax as _jax

    piece = min(piece_rows, rows)
    key = (rows, rowb, str(jnp.dtype(dtype)), piece)
    fn = _piece_fns.get(key)
    if fn is None:
        def _slice(arr, s):
            return jax.lax.dynamic_slice(arr, (s, jnp.int32(0)),
                                         (piece, rowb))
        fn = _jax.jit(_slice)
        _piece_fns[key] = fn
    return fn, piece


def _piece_dev(combined: jax.Array, start: int, piece_rows: int = _PIECE):
    """Device dynamic-slice of one fixed-size piece via piece_fn.  Returns
    (device array [piece, rowb], piece)."""
    rows, rowb = combined.shape
    fn, piece = piece_fn(rows, rowb, combined.dtype, piece_rows)
    return fn(combined, jnp.int32(start)), piece


def _dispatch_prefix(combined: jax.Array, target: int, piece_rows: int):
    """Queue async d2h copies of the first `target` rows in fixed-size
    pieces; returns the piece list [(start, device array)]."""
    total = combined.shape[0]
    target = min(target, total)
    pieces = []
    s = 0
    while s < target:
        piece_len = min(piece_rows, total)
        sa = min(s, total - piece_len)
        arr, piece_len = _piece_dev(combined, sa, piece_rows)
        try:
            arr.copy_to_host_async()
        except Exception:  # pragma: no cover - backend without async copies
            pass
        pieces.append((sa, arr))
        s = sa + piece_len
    return pieces


def _fetch_rows(pieces, combined: jax.Array, need: int,
                buf: np.ndarray | None, piece_rows: int = _PIECE
                ) -> np.ndarray:
    """Assemble the first `need` rows from dispatched pieces into `buf`,
    fetching any uncovered tail synchronously through the same cached
    slice programs.  Returns buf[:need] (or a single piece's view when it
    already covers the read — no copy).  buf=None allocates lazily, only
    when the fast path misses."""
    total_rows = combined.shape[0]
    first_np = np.asarray(pieces[0][1])
    if pieces[0][0] == 0 and need <= first_np.shape[0]:
        return first_np[:need]
    if buf is None:
        buf = np.empty((need, combined.shape[1]), np.uint8)
    assert buf.shape[0] >= need and buf.shape[1] == combined.shape[1]
    covered = 0
    for sa, arr in pieces:
        if covered >= need:
            break
        a = np.asarray(arr)
        hi = min(sa + a.shape[0], need)
        if hi > covered:
            buf[covered:hi] = a[covered - sa: hi - sa]
            covered = hi
    while covered < need:                 # speculative read fell short
        piece_len = min(piece_rows, total_rows)
        sa = min(covered, total_rows - piece_len)
        arr, piece_len = _piece_dev(combined, sa, piece_rows)
        part = np.asarray(arr)
        hi = min(sa + piece_len, need)
        buf[covered:hi] = part[covered - sa: hi - sa]
        covered = hi
    return buf[:need]


def dispatch_rle_prefix(combined: jax.Array, hint: int | None = None):
    """Start the device->host copies for an anchor_chunk_rle2 result
    immediately after the kernel dispatch: fixed-size dynamic-slice pieces
    (exact-size to ~12% over the expected run count, where pow2 prefix
    slices would over-transfer) are queued with copy_to_host_async, so
    they overlap later chunks' compute/host work.  Piece 0 carries the
    count header.
    hint=None (no observed count yet) covers the WHOLE buffer — an
    undersized read costs a synchronous piece round trip at drain time.
    Returns the piece list for collect_rle2."""
    total = combined.shape[0]
    if hint is None:
        # no observed count yet: read 1/8 of the buffer (run counts land
        # far below that on real pangenomes — a miss costs one synchronous
        # piece round trip, once per process)
        target = max(total // 8, min(total, _PIECE))
    else:
        target = min(hint + (hint >> 3) + 2, total)
    return _dispatch_prefix(combined, target, _PIECE)


def collect_rle2(pieces, combined: jax.Array, out: np.ndarray | None = None):
    """Host-side collection of an anchor_chunk_rle2 result from its
    dispatched piece list.

    Returns (data_rows u8 [count, 3 + nbytes] | None, count): None when
    count overflowed the device capacity (the caller re-runs the chunk
    through anchor_chunk_fast).  The speculative pieces usually satisfy
    the whole read; a larger count fetches the remainder synchronously
    through the same cached slice program.  `out` (u8 [>= count + 1,
    rowb]) reuses a caller buffer for the assembly (see
    rle_expand_native)."""
    total_rows = combined.shape[0]
    first = np.asarray(pieces[0][1])
    count = int(first[0, :4].copy().view("<u4")[0])
    capacity = total_rows - 2
    if count > capacity:
        return None, count
    need = count + 1                      # rows including the header
    rows = _fetch_rows(pieces, combined, need, out)
    return rows[1:need], count


def dispatch_rle4_prefix(data: jax.Array, pal: jax.Array,
                         hint: int | None = None,
                         pal_hint: int | None = None):
    """v4 twin of dispatch_rle_prefix: queue async prefix copies of BOTH
    output buffers right after the kernel dispatch.  The run count and
    palette size ride in the palette buffer's first (small) piece, so the
    drain normally needs zero synchronous round trips.  Returns
    (data pieces, pal pieces) for collect_rle4."""
    total = data.shape[0]
    if hint is None:
        target = max(total // 8, min(total, _PIECE))
    else:
        target = min(hint + (hint >> 3) + 2, total)
    if pal_hint is None:
        ptarget = _PAL_PIECE
    else:
        ptarget = 2 + pal_hint + (pal_hint >> 2) + 16
    # palette pieces queue FIRST: piece 0 carries the headers the drain
    # reads before anything else, and link transfers complete in order
    pp = _dispatch_prefix(pal, ptarget, _PAL_PIECE)
    dp = _dispatch_prefix(data, target, _PIECE)
    return dp, pp


def collect_rle4(prefix, data: jax.Array, pal: jax.Array, pal_work: int,
                 out: np.ndarray | None = None,
                 pal_out: np.ndarray | None = None):
    """Host-side collection of an anchor_chunk_rle4 result.

    Returns (data_rows u8 [count, 3], pal_bytes u8 [U, pal width],
    count, U);
    data_rows/pal_bytes are None on overflow (count > pal_work or
    U > PAL_CAP) — the caller falls back to v3.  `out` /
    `pal_out` reuse caller buffers (see rle_expand_native)."""
    dp, pp = prefix
    first = np.asarray(pp[0][1])
    count = int(first[0, :4].copy().view("<u4")[0])
    U = int(first[1, :4].copy().view("<u4")[0])
    if count > pal_work or count > data.shape[0] - 1 or U > PAL_CAP:
        return None, None, count, U
    pal_rows = _fetch_rows(pp, pal, 2 + U, pal_out, _PAL_PIECE)
    data_rows = _fetch_rows(dp, data, count, out, _PIECE)
    return data_rows, pal_rows[2: 2 + U], count, U


def rle4_to_v3_rows(data_rows: np.ndarray, pal_bytes: np.ndarray,
                    count: int, nbytes: int, tmp=None) -> np.ndarray:
    """Reconstruct v3-layout rows ([delta | mask bytes]) from v4 data +
    palette — a count*(1+nbytes) byte copy (the pure-Python decode path
    and the protocol-parity tests)."""
    rowb = rle_row_bytes(nbytes)
    t = tmp if tmp is not None else np.empty((max(count, 1), rowb), np.uint8)
    t = t[:count]
    idx = data_rows[:count, 1].astype(np.int32) \
        | (data_rows[:count, 2].astype(np.int32) << 8)
    # corrupt/truncated palettes (idx >= U) must not raise an uncaught
    # IndexError in this decode path — clamp; device-produced data never
    # trips this (the native expander raises a clean ValueError instead)
    idx = np.minimum(idx, pal_bytes.shape[0] - 1)
    t[:, 0] = data_rows[:count, 0]
    t[:, 1: 1 + nbytes] = pal_bytes[idx][:, :nbytes]
    return t


def unpack_rle4(data_rows: np.ndarray, pal_bytes: np.ndarray, count: int,
                total: int, nbytes: int, out=None, tmp=None):
    """Decode v4 rows -> (bytes [total, nbytes], popc i32 [total]).  The
    native expander reads mask bytes straight from the palette; without
    it, v3 rows are reconstructed on the host and fed to the v3 decoder."""
    if _rle_expand_pal_native is not None and count > 0:
        return _rle_expand_pal_native(data_rows, pal_bytes, count, total,
                                      nbytes, out=out)
    t = rle4_to_v3_rows(data_rows, pal_bytes, count, nbytes, tmp=tmp)
    return unpack_rle2(t, count, total, nbytes, out=out)


def rle_proto(nbytes: int) -> int:
    """Transfer-protocol choice: v4 (palette) pays off once mask rows are
    wider than its 3-byte data rows; PANAGRAM_TPU_RLE_PROTO=3|4
    overrides."""
    env = os.environ.get("PANAGRAM_TPU_RLE_PROTO")
    if env:
        return int(env)
    return 4 if nbytes >= 3 else 3


def stream_anchor_chunks(codes: np.ndarray, nkmers: int, chunk: int,
                         buf: np.ndarray, table, bd, nbytes: int,
                         ngenomes: int, k: int, state: dict | None = None,
                         capacity: int | None = None, trace: bool = False):
    """The single-chip streamed anchor engine (shared by Genome.run_anchor
    and bench.py — the benchmark measures the exact product path).

    Dispatches every chunk's fused RLE kernel asynchronously with its
    prefix d2h copies, keeps up to PIPELINE_DEPTH chunks in flight, and
    drains in order.  Yields (start, m, bitmap bytes u8 [m, nbytes],
    popc i32 [m], colsums i64 [ngenomes]) per chunk.

    `state` (a dict) carries the observed run-count/palette hints across
    chromosomes so only a genome's very first chunks pay the speculative
    full-prefix transfer.  The transfer protocol (v3 mask rows / v4
    palette) follows rle_proto(nbytes); RLE overflow falls back to the
    dense anchor_chunk_fast path per chunk.

    The collect (d2h wait) + host decode of each chunk runs on a small
    thread pool so a slow transfer or a host stall never blocks the
    dispatch loop — the device keeps computing the next chunks while
    earlier ones decode.  Each
    in-flight chunk decodes into its own buffer set from a ring of
    PIPELINE_DEPTH + 2 (a set is provably idle again by the time it
    recurs: its yield is 2 yields past before the slot is redispatched)."""
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as _jnp

    proto = rle_proto(nbytes)
    if capacity is None:
        # every RLE row consumes >= 1 position, so capacity = chunk can
        # never overflow; transfers are sized by the observed count
        capacity = chunk
    pal_work = pal_work_for(capacity)
    if state is None:
        state = {}
    pending: list = []

    # per-slot persistent decode buffers, so no chunk pays fresh multi-MB
    # allocations and page faults — fill() commits the pages once.
    nslots = PIPELINE_DEPTH + 2

    class _Slot:
        __slots__ = ("out_b", "out_p", "rle_buf", "pal_buf", "v3_tmp")

        def __init__(self):
            self.out_b = np.empty((chunk, nbytes), np.uint8)
            self.out_p = np.empty(chunk, np.int32)
            self.out_b.fill(0)
            self.out_p.fill(0)
            if proto == 4:
                self.rle_buf = np.empty((pal_work + 1, 3), np.uint8)
                self.pal_buf = np.empty(
                    (PAL_CAP + 3, rle4_pal_bytes(nbytes)), np.uint8)
                self.pal_buf.fill(0)
            else:
                self.rle_buf = np.empty(
                    (capacity + 2, rle_row_bytes(nbytes)), np.uint8)
            self.rle_buf.fill(0)
            self.v3_tmp = None   # v4 palette-overflow fallback only (rare)

    slots = [_Slot() for _ in range(nslots)]

    def _dense(inbuf, L, m):
        n4 = (L + 3) // 4
        by_d, popc_d, colsums_d = anchor_chunk_fast(
            _jnp.asarray(inbuf[:n4]), _jnp.asarray(inbuf[n4:]),
            table, L, k, bd.nbits, bd.cap, bd.nwords, nbytes)
        return (np.asarray(by_d)[:m], np.asarray(popc_d)[:m].astype(np.int32),
                np.asarray(colsums_d)[:ngenomes])

    def _v3_chunk(inbuf, L, m, slot):
        """Palette overflow fallback: the v3 kernel handles ANY run count
        up to `capacity` and still ships only count*(1+nbytes) bytes —
        strictly cheaper than the dense path's P*nbytes."""
        P = L - k + 1
        combined = anchor_chunk_rle2(
            _jnp.asarray(inbuf), table, L, k, bd.nbits, bd.cap, bd.nwords,
            nbytes, capacity)
        data_rows, count = collect_rle2(dispatch_rle_prefix(combined, None),
                                        combined)
        if data_rows is None:           # count > capacity: impossible by
            return _dense(inbuf, L, m)  # construction, kept as a backstop
        by, popc_np = unpack_rle2(data_rows, count, P, nbytes,
                                  out=(slot.out_b[:P], slot.out_p[:P]))
        return (by[:m], popc_np[:m],
                rle2_colsums(data_rows, count, P, ngenomes))

    def _decode(item):
        """Collect + decode one in-flight chunk (runs on a pool thread:
        the d2h wait, the native RLE expansion, and the colsum reductions
        all release the GIL, so decodes overlap both each other and the
        dispatch thread's device work)."""
        t0 = _time.perf_counter()
        start, m, L, inbuf, combined, prefix, slot = item
        P = L - k + 1
        if proto == 4:
            data, pal = combined
            data_rows, pal_bytes, count, U = collect_rle4(
                prefix, data, pal, pal_work,
                out=slot.rle_buf, pal_out=slot.pal_buf)
            t1 = _time.perf_counter()
            if data_rows is None:       # palette overflow: v3 fallback
                by, popc_np, chunk_colsums = _v3_chunk(inbuf, L, m, slot)
            else:
                state["hint"] = count
                state["pal_hint"] = U
                by, popc_np = unpack_rle4(
                    data_rows, pal_bytes, count, P, nbytes,
                    out=(slot.out_b[:P], slot.out_p[:P]), tmp=slot.v3_tmp)
                by = by[:m]
                popc_np = popc_np[:m]
                chunk_colsums = rle4_colsums(data_rows, pal_bytes, count,
                                             P, ngenomes)
            if trace:
                print(f"  drain: count={count} pal={U} "
                      f"collect={1e3*(t1-t0):.0f}ms "
                      f"decode={1e3*(_time.perf_counter()-t1):.0f}ms",
                      file=sys.stderr, flush=True)
        else:
            data_rows, count = collect_rle2(prefix, combined,
                                            out=slot.rle_buf)
            t1 = _time.perf_counter()
            if data_rows is None:       # RLE overflow: dense fallback
                by, popc_np, chunk_colsums = _dense(inbuf, L, m)
            else:
                state["hint"] = count
                by, popc_np = unpack_rle2(
                    data_rows, count, P, nbytes,
                    out=(slot.out_b[:P], slot.out_p[:P]))
                by = by[:m]
                popc_np = popc_np[:m]
                chunk_colsums = rle2_colsums(data_rows, count, P, ngenomes)
            if trace:
                print(f"  drain: count={count} "
                      f"collect={1e3*(t1-t0):.0f}ms "
                      f"decode={1e3*(_time.perf_counter()-t1):.0f}ms",
                      file=sys.stderr, flush=True)
        return start, m, by, popc_np, chunk_colsums

    ex = ThreadPoolExecutor(max_workers=DECODE_WORKERS,
                            thread_name_prefix="panagram-decode")
    try:
        for i, start in enumerate(range(0, nkmers, chunk)):
            m = min(chunk, nkmers - start)
            buf[:] = 255
            buf[: m + k - 1] = codes[start : start + m + k - 1]
            inbuf, L = pack_bases_combined(buf)
            ib = _jnp.asarray(inbuf)
            hint = state.get("hint")
            pal_hint = state.get("pal_hint")
            # dispatch through the AOT-prewarmed executable when one
            # exists (ops/prewarm.py)
            from .prewarm import get_compiled

            if proto == 4:
                fn = get_compiled(("rle4", inbuf.shape[0],
                                   tuple(table.shape), L, k, bd.nbits,
                                   bd.cap, bd.nwords, nbytes, pal_work))
                combined = fn(ib, table) if fn is not None else \
                    anchor_chunk_rle4(ib, table, L, k, bd.nbits, bd.cap,
                                      bd.nwords, nbytes, pal_work)
                prefix = dispatch_rle4_prefix(combined[0], combined[1],
                                              hint, pal_hint)
            else:
                fn = get_compiled(("rle2", inbuf.shape[0],
                                   tuple(table.shape), L, k, bd.nbits,
                                   bd.cap, bd.nwords, nbytes, capacity))
                combined = fn(ib, table) if fn is not None else \
                    anchor_chunk_rle2(ib, table, L, k, bd.nbits, bd.cap,
                                      bd.nwords, nbytes, capacity)
                prefix = dispatch_rle_prefix(combined, hint)
            pending.append(ex.submit(
                _decode, (start, m, L, inbuf, combined, prefix,
                          slots[i % nslots])))
            if len(pending) >= PIPELINE_DEPTH:
                yield pending.pop(0).result()
        while pending:
            yield pending.pop(0).result()
    finally:
        for f in pending:
            f.cancel()
        ex.shutdown(wait=True, cancel_futures=True)


@partial(jax.jit, static_argnums=(3,))
def anchor_chunk(codes: jax.Array, keys: jax.Array, masks: jax.Array, k: int):
    """Fused anchor step over one (k-1)-halo'd sequence chunk:
    codes u8 [CH + k - 1] -> (bytes u8 [CH, 4W], popc i32 [CH],
    colsum contribution i64 [N-words*32 via genome_column_sums done by
    caller], valid mask).

    Returns (rows u32 [CH, W], popc i32 [CH]).  Byte-packing and column
    sums are separate jitted calls so XLA can still fuse what it wants
    while keeping the output set flexible.
    """
    canon, _ = pack_kmers(codes, k)
    rows = anchor_lookup(canon, keys, masks)
    popc = mask_popcount(rows)
    return rows, popc
