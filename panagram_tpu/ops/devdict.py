"""Device-resident pan-kmer dictionary builder.

The file-cached pipeline (pipeline.py) materialises each genome's distinct
k-mer set on the host (good resume granularity, but the set transfer
dominates on narrow host links).  This builder keeps EVERYTHING on device:
sequence chunks stream in 2-bit packed, each chunk's canonical k-mers are
sorted/deduped on device and merged straight into the growing (keys, masks)
dictionary with the genome's presence bit — nothing but tiny counters
leaves the device until the final dictionary is saved.

Keys live in splitmix64-mixed space (ops/lookup.mix64), so the finished
arrays feed BucketedDict.build(mixed=True) without re-sorting and bucket
boundaries are uniform.  Merge = concat + lax.sort with mask-word payloads
+ neighbor OR (runs have length <= 2: both inputs hold distinct keys) +
sentinel compaction — a deterministic reduction order, preserving
bit-identical outputs (SURVEY §5.8).

Capacities grow in power-of-two steps so the number of distinct compiled
programs stays logarithmic.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .codec import SENTINEL, pack_kmers_packed
from .lookup import mix64


@partial(jax.jit, static_argnums=(2,))
def _chunk_mixed_distinct(packed: jax.Array, nmask: jax.Array, Lk: tuple):
    """packed/nmask (pack_bases_np) -> sorted distinct mixed keys
    (SENTINEL-padded, static shape [L - k + 1])."""
    L, k = Lk
    canon, _ = pack_kmers_packed(packed, nmask, L, k)
    m = jnp.where(canon == SENTINEL, SENTINEL, mix64(canon))
    s = jnp.sort(m)
    dup = jnp.concatenate([jnp.zeros(1, bool), s[1:] == s[:-1]])
    return jnp.sort(jnp.where(dup, SENTINEL, s))


@jax.jit
def _union_sorted(a: jax.Array, b: jax.Array) -> jax.Array:
    """Union of two sorted SENTINEL-padded distinct key arrays ->
    sorted distinct [|a| + |b|], SENTINEL-padded."""
    s = jnp.sort(jnp.concatenate([a, b]))
    dup = jnp.concatenate([jnp.zeros(1, bool), s[1:] == s[:-1]])
    return jnp.sort(jnp.where(dup, SENTINEL, s))


@partial(jax.jit, static_argnums=(3,))
def _merge_into(keys: jax.Array, masks: jax.Array, new_keys: jax.Array,
                nwords: int, gid: jax.Array):
    """Merge a genome's sorted distinct key chunk into the dictionary.

    keys u64 [C] sentinel-padded sorted; masks u32 [C, W]; new_keys u64 [M]
    sentinel-padded sorted; gid i32 scalar.  Returns ([C] keys, [C, W]
    masks, count) with sentinels at the tail — the output is truncated back
    to the input capacity C (the caller guarantees count + M <= C), so the
    builder's arrays keep a FIXED shape and the merge compiles once per
    capacity instead of growing by M per call.
    """
    C = keys.shape[0]
    bit = (jnp.uint32(1) << (gid % 32).astype(jnp.uint32))
    word = gid // 32
    new_masks = jnp.where(
        (jnp.arange(nwords) == word)[None, :]
        & (new_keys != SENTINEL)[:, None],
        bit, jnp.uint32(0),
    )

    allk = jnp.concatenate([keys, new_keys])
    allm = jnp.concatenate([masks, new_masks], axis=0)
    ops = (allk,) + tuple(allm[:, w] for w in range(nwords))
    out = jax.lax.sort(ops, num_keys=1)
    ks = out[0]
    ms = jnp.stack(out[1:], axis=1)

    # runs of equal keys have length <= 2: OR the pair into the first slot,
    # sentinel out the second
    dup_next = jnp.concatenate([ks[:-1] == ks[1:], jnp.zeros(1, bool)])
    dup_prev = jnp.concatenate([jnp.zeros(1, bool), ks[1:] == ks[:-1]])
    real = ks != SENTINEL
    merged = jnp.where((dup_next & real)[:, None],
                       ms | jnp.roll(ms, -1, axis=0), ms)
    ks = jnp.where(dup_prev & real, SENTINEL, ks)
    merged = jnp.where((dup_prev & real)[:, None], jnp.uint32(0), merged)

    ops2 = (ks,) + tuple(merged[:, w] for w in range(nwords))
    out2 = jax.lax.sort(ops2, num_keys=1)
    ks2 = out2[0][:C]
    ms2 = jnp.stack(out2[1:], axis=1)[:C]
    count = jnp.sum(ks2 != SENTINEL)
    return ks2, ms2, count


_D2H_PIECE = 1 << 20    # rows per d2h piece (one cached slice program)
_slice_fns: dict = {}


def slice_fn(shape: tuple, dtype, piece: int):
    """The cached fixed-size dynamic-slice program for a row-array shape
    (ONE program per (shape, dtype, piece)); exposed for ops.prewarm."""
    key = (tuple(shape), str(jnp.dtype(dtype)), piece)
    fn = _slice_fns.get(key)
    if fn is None:
        sizes = (piece,) + tuple(shape[1:])
        zeros = (jnp.int32(0),) * (len(shape) - 1)
        fn = jax.jit(lambda a, s: jax.lax.dynamic_slice(a, (s,) + zeros,
                                                        sizes))
        _slice_fns[key] = fn
    return fn


def _piece_slice(arr: jax.Array, start: int, piece: int) -> jax.Array:
    """Fixed-size device dynamic-slice [start:start+piece] of a row
    array via slice_fn."""
    return slice_fn(arr.shape, arr.dtype, piece)(arr, jnp.int32(start))


_flat_fns: dict = {}


def flat_fn(shape: tuple, dtype):
    """Cached device flatten program for a 2D row array (a trivial copy).

    _stream_rows flattens 2D [capacity, W] arrays on device and streams
    the 1D form, so the only d2h slice programs are 1D ones (one compiled
    program per dtype and piece size, shared by every W).  Whether the
    GPU needs this is open (ROADMAP design item 6)."""
    key = (tuple(shape), str(jnp.dtype(dtype)))
    fn = _flat_fns.get(key)
    if fn is None:
        n = int(np.prod(shape))
        fn = jax.jit(lambda a: a.reshape(n))
        _flat_fns[key] = fn
    return fn


def _stream_rows(arr: jax.Array, count: int) -> np.ndarray:
    """d2h only the first `count` rows of a capacity-sized device array.

    A whole-array np.asarray ships the FULL capacity to the host — 2-4x
    the live rows whenever the capacity hint overshoots.  Instead the live
    prefix streams in fixed-size dynamic-slice pieces (clamped at the tail
    so shapes stay static), queued async so the pieces pipeline."""
    from collections import deque

    cap = arr.shape[0]
    if arr.ndim == 2 and cap > _D2H_PIECE and count < cap:
        # stream the flat view (see flat_fn)
        ncols = arr.shape[1]
        flat = flat_fn(arr.shape, arr.dtype)(arr)
        return _stream_rows(flat, count * ncols).reshape(count, ncols)
    if count >= cap or cap <= _D2H_PIECE:
        return np.asarray(arr)[:count]
    pieces: deque = deque()
    for s in range(0, count, _D2H_PIECE):
        start = min(s, cap - _D2H_PIECE)
        p = _piece_slice(arr, start, _D2H_PIECE)
        try:
            p.copy_to_host_async()
        except AttributeError:
            pass
        pieces.append((start, p))
    out = np.empty((count,) + arr.shape[1:], arr.dtype)
    # drain FIFO, dropping each device piece as soon as it lands on host
    # so HBM frees while later pieces are still in flight (holding the
    # whole list would transiently double the live prefix in HBM)
    while pieces:
        start, p = pieces.popleft()
        end = min(start + _D2H_PIECE, count)
        out[start:end] = np.asarray(p)[: end - start]
        del p
    return out


class DeviceDictBuilder:
    """Incremental on-device dictionary construction over genome streams.

    Chunks do NOT merge into the dictionary one by one (each merge sorts
    the full capacity — O(chunks x capacity) for long genomes): up to
    FLUSH_CHUNKS chunk key-sets are buffered per genome and tree-unioned
    (pairwise sorted unions at pow2 sizes, a handful of compiled shapes)
    before ONE capacity-sized merge — 8x fewer big sorts, and the only
    host synchronisation is one count read per flush."""

    FLUSH_CHUNKS = 8

    def __init__(self, k: int, ngenomes: int, chunk: int = 1 << 22,
                 capacity_hint: int | None = None):
        self.k = k
        self.ngenomes = ngenomes
        self.nwords = (ngenomes + 31) // 32
        self.chunk = chunk
        self.keys = None   # device u64 [cap]
        self.masks = None  # device u32 [cap, W]
        self.count = 0          # last SYNCED key count (host int)
        self._cnt_dev = None    # device scalar from the latest merge
        self._pending = 0       # merges since the last sync
        self._buf = []          # buffered chunk key-sets (one genome)
        self._buf_gid = None
        self._buf_real = 0      # upper bound on REAL keys in the buffer
        # stage walls (seconds), for the count+merge breakdown the scale
        # rows report (VERDICT r4 item 2): dispatch walls measure QUEUEING
        # cost only — all device work lands in 'sync', the one blocking
        # read per flush
        self.walls = {"pack": 0.0, "chunk_dispatch": 0.0,
                      "union_dispatch": 0.0, "merge_dispatch": 0.0,
                      "sync": 0.0, "first_sync": 0.0, "flushes": 0}
        if capacity_hint:
            # pre-size so the merge program compiles exactly once (capacity
            # growth would otherwise recompile per power-of-two step)
            self._ensure_capacity(capacity_hint + chunk)

    def _ensure_capacity(self, needed: int):
        cap = 1 << max(int(np.ceil(np.log2(max(needed, 2)))), 10)
        # loud capacity guard before allocating: the builder's merge
        # transients are ~4x (8+4W) bytes/key (concat + sort in/out at 2C)
        # WITHOUT a table (the query-table layout has its own guard and a
        # host fallback in BucketedDict.build_device)
        from .lookup import check_hbm_budget

        check_hbm_budget(cap, self.nwords, what="device dictionary builder",
                         include_table=False)
        if self.keys is None:
            self.keys = jnp.full(cap, SENTINEL, jnp.uint64)
            self.masks = jnp.zeros((cap, self.nwords), jnp.uint32)
        elif self.keys.shape[0] < cap:
            pad = cap - self.keys.shape[0]
            self.keys = jnp.concatenate(
                [self.keys, jnp.full(pad, SENTINEL, jnp.uint64)])
            self.masks = jnp.concatenate(
                [self.masks, jnp.zeros((pad, self.nwords), jnp.uint32)])

    def add_sequence(self, gid: int, codes: np.ndarray):
        """Stream one sequence of genome `gid` (uint8 codes) into the dict."""
        from .codec import pack_bases_np

        k = self.k
        n = len(codes) - k + 1
        if n <= 0:
            return
        if self._buf_gid is not None and self._buf_gid != gid:
            self._flush_buffer()
        self._buf_gid = gid

        import time as _time

        chunk = self.chunk
        buf = np.full(chunk + k - 1, 255, np.uint8)
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            t0 = _time.perf_counter()
            buf[:] = 255
            buf[: m + k - 1] = codes[start : start + m + k - 1]
            packed, nmask, L = pack_bases_np(buf)
            t1 = _time.perf_counter()
            self._buf.append(_chunk_mixed_distinct(
                jnp.asarray(packed), jnp.asarray(nmask), (L, k)))
            self._buf_real += m
            t2 = _time.perf_counter()
            self.walls["pack"] += t1 - t0
            self.walls["chunk_dispatch"] += t2 - t1
            if len(self._buf) >= self.FLUSH_CHUNKS:
                self._flush_buffer()

    def _flush_buffer(self):
        """Tree-union the buffered chunk key-sets and merge once.  The
        buffered gid is NOT cleared here: a long sequence flushes
        mid-stream and keeps buffering chunks of the same genome
        (add_sequence resets it on a genome switch)."""
        if not self._buf:
            return
        import time as _time

        parts = self._buf
        self._buf = []
        t0 = _time.perf_counter()
        # pad to a power of two with SENTINEL-only arrays so the union
        # tree only ever sees (c,c), (2c,2c), ... shapes — a handful of
        # compiled programs regardless of how many chunks a genome ends
        # with
        while len(parts) & (len(parts) - 1):
            parts.append(jnp.full(parts[0].shape[0], SENTINEL, jnp.uint64))
        while len(parts) > 1:
            nxt = []
            for i in range(0, len(parts) - 1, 2):
                nxt.append(_union_sorted(parts[i], parts[i + 1]))
            if len(parts) % 2:
                nxt.append(parts[-1])
            parts = nxt
        new_keys = parts[0]
        gid = self._buf_gid
        real_bound = self._buf_real
        self._buf_real = 0
        t1 = _time.perf_counter()
        # capacity must cover the worst case (every buffered key new) so
        # the truncated merge output is always complete; ONE count sync
        # per flush.  The worst case is bounded by the number of REAL
        # (non-sentinel) buffered keys — the chunk position count, tracked
        # for free — NOT the pow2-padded array size: the padded bound
        # forced a spurious capacity double (and a ~60 s merge recompile)
        # mid-build on the 30-genome row
        self._sync_count()
        t2 = _time.perf_counter()
        self._ensure_capacity(self.count
                              + min(int(new_keys.shape[0]), real_bound))
        self.keys, self.masks, cnt = _merge_into(
            self.keys, self.masks, new_keys, self.nwords, jnp.int32(gid))
        self._cnt_dev = cnt
        self._pending += 1
        self.walls["union_dispatch"] += t1 - t0
        self.walls["sync"] += t2 - t1
        if self.walls["flushes"] == 0:
            self.walls["first_sync"] = t2 - t1
        self.walls["merge_dispatch"] += _time.perf_counter() - t2
        self.walls["flushes"] += 1

    def _sync_count(self):
        if self._cnt_dev is not None and self._pending:
            self.count = int(self._cnt_dev)
            self._pending = 0

    def synced_count(self) -> int:
        """The exact key count (one device round trip if merges are
        pending) — for progress logs and final sizing."""
        import time as _time

        self._flush_buffer()
        t0 = _time.perf_counter()
        self._sync_count()
        self.walls["sync"] += _time.perf_counter() - t0
        return self.count

    def add_genome(self, gid: int, code_arrays):
        for codes in code_arrays:
            self.add_sequence(gid, np.asarray(codes, np.uint8))

    def to_host(self):
        """Materialise (mixed-sorted keys, masks) on the host.  Only the
        live `count`-row prefix crosses the link (piece-sliced on device),
        not the full pow2 capacity."""
        from .dictionary import PanKmerDict

        self._flush_buffer()
        self._sync_count()
        keys = _stream_rows(self.keys, self.count)
        masks = _stream_rows(self.masks, self.count)
        return PanKmerDict(keys, masks, self.ngenomes, self.k,
                           key_space="mixed")

    def bucketed(self):
        """Build the query-time layout directly ON DEVICE: the builder's
        sentinel-padded arrays feed BucketedDict.build_device without any
        host copy of keys, masks, or the finished table."""
        from .lookup import BucketedDict

        self._flush_buffer()
        self._sync_count()
        # the merge invariant keeps self.keys globally sorted by mixed
        # value — the sorted layout path halves HBM transients (no
        # grouping sort), keeping 1e8-key tables on device
        return BucketedDict.build_device(self.keys, self.masks,
                                         self.ngenomes, self.k,
                                         mixed=True, count=self.count,
                                         sorted_input=True)
