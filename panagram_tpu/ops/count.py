"""Per-genome distinct canonical k-mer sets (sort-based counting).

Device replacement for KMC's counting stage (reference
workflow/Snakefile rule kmc_count; SURVEY §7.2 L-count): the multiset of
canonical k-mers is reduced to a sorted distinct set by an on-device sort +
neighbor-compare dedup.  Shapes stay static by padding with SENTINEL keys,
which sort to the tail and are dropped on the host.

Counting a genome streams fixed-size chunks (one XLA compilation) through
pack+sort+dedup; the per-chunk sorted distinct sets are merged host-side.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .codec import SENTINEL, pack_kmers, _check_k


@jax.jit
def _sort_dedup(canon: jax.Array) -> jax.Array:
    """Sort keys and replace duplicates with SENTINEL, then re-sort so the
    distinct keys are packed at the front (static-shape unique)."""
    s = jnp.sort(canon)
    dup = jnp.concatenate([jnp.zeros(1, bool), s[1:] == s[:-1]])
    s = jnp.where(dup, SENTINEL, s)
    return jnp.sort(s)


@partial(jax.jit, static_argnums=(1,))
def _chunk_distinct(codes: jax.Array, k: int) -> jax.Array:
    canon, _ = pack_kmers(codes, k)
    return _sort_dedup(canon)


def distinct_kmers(codes, k: int) -> np.ndarray:
    """Sorted distinct canonical k-mers of one sequence (device compute,
    host-materialized, sentinel-stripped)."""
    _check_k(k)
    codes = jnp.asarray(codes, jnp.uint8)
    if codes.shape[0] < k:
        return np.zeros(0, np.uint64)
    out = np.asarray(_chunk_distinct(codes, k))
    n = np.searchsorted(out, np.uint64(SENTINEL))
    return out[:n]


DEFAULT_CHUNK = 1 << 22  # 4M positions per device chunk


def distinct_kmers_chunked(code_arrays, k: int, chunk: int = DEFAULT_CHUNK) -> np.ndarray:
    """Distinct canonical k-mers over many sequences (a genome).

    Streams (k-1)-halo'd fixed-size chunks through the device (the
    sequence-chunking pattern of reference cpp/anchor.cpp:112-147, SURVEY
    §5.7), then merges per-chunk sorted sets host-side.
    """
    _check_k(k)
    parts: list[np.ndarray] = []
    buf = np.full(chunk + k - 1, 255, np.uint8)
    for codes in code_arrays:
        codes = np.asarray(codes, np.uint8)
        n = len(codes) - k + 1
        if n <= 0:
            continue
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            buf[:] = 255  # pad: invalid base -> SENTINEL kmers
            buf[: m + k - 1] = codes[start : start + m + k - 1]
            out = np.asarray(_chunk_distinct(jnp.asarray(buf), k))
            nn = np.searchsorted(out, np.uint64(SENTINEL))
            parts.append(out[:nn])
    if not parts:
        return np.zeros(0, np.uint64)
    if len(parts) == 1:
        return parts[0]
    return sorted_distinct(np.concatenate(parts))


def sorted_distinct(a: np.ndarray) -> np.ndarray:
    """np.unique of a 1D array, as an in-place sort plus a neighbour
    compare (`a` is consumed).  Some NumPy versions' np.unique takes
    minutes on a genome's ~3e7 u64 keys where np.sort takes under a
    second (PERF.md, PR 1)."""
    a.sort()
    keep = np.empty(len(a), bool)
    keep[:1] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


@partial(jax.jit, static_argnums=(1,))
def _chunk_counts(codes: jax.Array, k: int):
    """Sorted (distinct key, multiplicity) pairs of one chunk — the
    COUNTING twin of _chunk_distinct (KMC's -ci thresholds need
    multiplicities, reference workflow/Snakefile:88 `-ci2 -fq`).

    Sort groups equal keys; a scatter-add over run ids counts them; the
    (key, count) pairs compact to the front via one more sort.  Static
    shapes throughout (SENTINEL pads sort to the tail and is dropped on
    the host)."""
    canon, _ = pack_kmers(codes, k)
    s = jnp.sort(canon)
    P = s.shape[0]
    valid = s != SENTINEL
    start = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]]) & valid
    seg = jnp.cumsum(start.astype(jnp.int32)) - 1
    cnt = jnp.zeros(P, jnp.int32).at[
        jnp.where(valid, seg, P)].add(1, mode="drop")
    cnt_at = cnt[jnp.clip(seg, 0, P - 1)]
    keys = jnp.where(start, s, SENTINEL)
    ks, cs = jax.lax.sort(
        (keys, jnp.where(start, cnt_at, 0)), num_keys=1)
    return ks, cs


def _merge_counted(parts):
    """Merge sorted (keys, counts) chunk outputs: one stable sort over the
    concatenation + segment sums (np.add.reduceat)."""
    if len(parts) == 1:
        return parts[0]
    allk = np.concatenate([p[0] for p in parts])
    allc = np.concatenate([p[1] for p in parts])
    if allk.size == 0:
        return allk, allc
    order = np.argsort(allk, kind="stable")
    ks = allk[order]
    cs = allc[order]
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    return ks[starts], np.add.reduceat(cs, starts)


def counted_kmers_chunked(code_arrays, k: int, min_count: int = 2,
                          chunk: int = DEFAULT_CHUNK) -> np.ndarray:
    """Distinct canonical k-mers occurring >= min_count times across many
    sequences (a FASTQ read set) — KMC's `-ci` semantics at device rate.

    Reads are packed into fixed-size device buffers back to back with one
    invalid (255) separator byte, so no k-mer window spans two reads; each
    buffer runs ONE sort+count kernel (_chunk_counts).  Host memory stays
    bounded by the number of DISTINCT keys (plus up to 8 in-flight chunk
    outputs, tree-merged) — never the read multiset, which at real
    coverage is 100x larger (the round-3 _count_fastq concatenated every
    read's k-mers into one host array; VERDICT r3 item 2).

    The count threshold applies to GLOBAL multiplicities (merged across
    chunks), exactly like KMC's."""
    _check_k(k)
    buf = np.full(chunk + k - 1, 255, np.uint8)
    pos = 0
    acc: tuple | None = None
    pending: list[tuple] = []

    def _flush_chunk():
        nonlocal pos
        if pos == 0:
            return
        buf[pos:] = 255
        ks, cs = _chunk_counts(jnp.asarray(buf), k)
        ks = np.asarray(ks)
        n = int(np.searchsorted(ks, np.uint64(SENTINEL)))
        pending.append((ks[:n], np.asarray(cs)[:n]))
        pos = 0

    def _drain_pending(force=False):
        nonlocal acc
        if len(pending) >= 8 or (force and pending):
            parts = ([acc] if acc is not None else []) + pending
            acc = _merge_counted(parts)
            pending.clear()

    cap = buf.shape[0]
    for codes in code_arrays:
        codes = np.asarray(codes, np.uint8)
        n = len(codes)
        if n < k:
            continue
        if n > cap:
            # long read: split into halo'd chunk-sized pieces
            for s0 in range(0, n - k + 1, chunk):
                piece = codes[s0 : s0 + chunk + k - 1]
                _flush_chunk()
                buf[: len(piece)] = piece
                pos = len(piece)
                _flush_chunk()
                _drain_pending()
            continue
        if pos + n + 1 > cap:
            _flush_chunk()
            _drain_pending()
        buf[pos : pos + n] = codes
        # the separator byte must be EXPLICITLY invalid: after the first
        # flush the buffer holds stale bases from the previous chunk, and a
        # valid stale byte here would let windows span two reads.  A read of
        # length exactly cap fills the buffer completely — no separator slot
        # exists or is needed (the flush below ends the window run).
        if pos + n < cap:
            buf[pos + n] = 255
        pos += n + 1
    _flush_chunk()
    _drain_pending(force=True)
    if acc is None:
        return np.zeros(0, np.uint64)
    keys, counts = acc
    return keys[counts >= min_count]
