"""Bucketed-hash dictionary lookup — the anchor path's probe.

The reference's hot loop is KMC's per-position random access into its
prefix/suffix arrays (reference cpp/anchor.cpp:148 GetCountersForRead;
SURVEY §7.4.6 "sorted-array binary search has poor locality — prefer
bucketed/hashed layout with one HBM read per probe").  XLA's searchsorted
lowers to ~27 *dependent* narrow gathers per query.

This module implements the recommended design:

* keys pass through an invertible 64-bit mix (splitmix64 finalizer), so
  their high bits are uniform;
* the dictionary is ONE table of 2^b buckets, each a row of `stride` u32s
  (a multiple of 64) holding `cap` slots of (key_hi, key_lo, mask words);
* a query computes its bucket elementwise, gathers the row — a single
  contiguous read per probe — and compares against all slots in parallel;
* there is NO overflow structure: the builder retries with more buckets
  until every bucket fits its keys (splitmix-uniform loads make the retry
  loop terminate immediately in practice), so one gather resolves every
  query.  The cost is ~3x the raw key+mask bytes in padding.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

U64 = np.uint64
_SENTINEL32 = np.uint32(0xFFFFFFFF)
# flat 1D scatter indices are int32: tables at or beyond 2^31 u32 elements
# (the 1e8-key W=1 table is exactly 2^31) scatter through a [rows, 128]
# view instead (layout_rows; tests lower this to exercise that path)
_FLAT_SCATTER_MAX = 2**31

_M1 = U64(0xBF58476D1CE4E5B9)
_M2 = U64(0x94D049BB133111EB)


def mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (invertible on u64)."""
    x = x.astype(U64, copy=True)
    x ^= x >> U64(30)
    x *= _M1
    x ^= x >> U64(27)
    x *= _M2
    x ^= x >> U64(31)
    return x


def mix64(x: jax.Array) -> jax.Array:
    x = x.astype(jnp.uint64)
    x = x ^ (x >> U64(30))
    x = x * _M1
    x = x ^ (x >> U64(27))
    x = x * _M2
    x = x ^ (x >> U64(31))
    return x


def row_pack(stride: int, n_buckets: int) -> int:
    """Adjacent buckets stored per table row, so that a row is a multiple
    of 128 u32 wide: the device table has the packed-row shape
    [B/pack, stride*pack].  The form dates from a device that padded a
    [B, 64] array to 128 lanes; on the GPU [B, stride] is just as dense,
    and the packing only costs bucket_query a `pack`-times wider gather
    per query (ROADMAP, speed item on the probe's gathered bytes)."""
    pack = 1
    while (stride * pack) % 128 or n_buckets % pack:
        pack *= 2
    return pack


def table_geometry(D: int, W: int, mean_load: int | None = None):
    """Bucket-table geometry for D keys x W mask words:
    (nbits, cap, stride).  Shared sizing rule of every builder."""
    if mean_load is None:
        mean_load = BucketedDict.MEAN_LOAD
    slot_w = 2 + W
    stride = 64
    while stride // slot_w < 3 * mean_load:
        stride += 64
    cap = stride // slot_w
    nbits = max(int(np.ceil(np.log2(max(D / mean_load, 1)))), 2)
    return nbits, cap, stride


def hbm_limit_bytes() -> int | None:
    """Per-device memory budget for capacity guards: the backend's own
    limit, or PANAGRAM_TPU_HBM_GB when set (e.g. for planning runs on the
    CPU backend).  None when neither says — then there is no budget."""
    env = os.environ.get("PANAGRAM_TPU_HBM_GB")
    if env:
        return int(float(env) * (1 << 30))
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    return limit if limit > 0 else None


def hbm_need_bytes(D: int, W: int, n_shards: int = 1,
                   device_layout: bool | str = True,
                   include_table: bool = True) -> tuple[int, int]:
    """Modelled per-device bytes (bucket table, layout transients) for a
    dictionary of D keys x W mask words split over n_shards:

      table bytes   = 2^ceil(log2(D / MEAN_LOAD)) * stride * 4
                    ~ (stride * 4 / MEAN_LOAD) * D ... 2x that after
                      pow2 rounding
      per key       ~ 43-85 B  (W=1, stride 64)
                    ~ 85-171 B (W=4, stride 128)
      device layout + ~4x (8 + 4W) * D transients (keys/masks + sort
                      in/out + scatter temps — a HOST-side layout needs
                      only the finished table on device)

    The transient coefficients are a model, not a fit to measurements on
    the current device (ROADMAP reach item 1)."""
    per_shard = -(-D // max(n_shards, 1))
    nbits, cap, stride = table_geometry(per_shard, W)
    table = (1 << nbits) * stride * 4 if include_table else 0
    if device_layout == "chunked":
        # P bucket-range passes over the sorted input, scattering into a
        # DONATED full table: only the inputs stay key-proportional; each
        # pass's slice transients are bounded by the fixed piece size
        layout = (8 + 4 * W) * per_shard + (40 << 24)
    elif device_layout == "sorted":
        # no grouping sort: inputs stay live (8 + 4W B/key) plus the i32
        # slot/base transients (~12 B/key) — about half the sorting
        # layout's footprint
        layout = (8 + 4 * W + 12) * per_shard
    else:
        trans = 4 if device_layout else 0
        layout = (8 + 4 * W) * per_shard * trans
    return table, layout


def check_hbm_budget(D: int, W: int, n_shards: int = 1,
                     what: str = "dictionary",
                     device_layout: bool | str = True,
                     include_table: bool = True):
    """Fail LOUDLY (before any allocation) when a requested dictionary
    cannot fit one device's memory (hbm_need_bytes' model against 80% of
    hbm_limit_bytes), instead of running out of memory mid-build.  Past
    the table ceiling itself, hash-shard across devices: `panagram_tpu
    index --mesh N` splits the table by key range, so capacity scales
    linearly with N.  No-op when the device reports no limit."""
    if D <= 0:
        return
    limit = hbm_limit_bytes()
    if limit is None:
        return
    per_shard = -(-D // max(n_shards, 1))
    table, layout = hbm_need_bytes(D, W, n_shards, device_layout,
                                   include_table)
    per_key_layout = layout / max(per_shard, 1)
    need = table + layout
    budget = int(limit * 0.8)  # reserve for chunk buffers
    if need > budget:
        # smallest shard count whose per-shard table fits
        _, _, stride = table_geometry(per_shard, W)
        n_fit = n_shards
        while n_fit < 4096:
            n_fit *= 2
            nb2, _, _ = table_geometry(-(-D // n_fit), W)
            t2 = (1 << nb2) * stride * 4 if include_table else 0
            if t2 + per_key_layout * (-(-D // n_fit)) <= budget:
                break
        raise RuntimeError(
            f"{what}: {D:,} keys x {W} mask words needs ~{need / 1e9:.1f} GB "
            f"per device (bucket table {table / 1e9:.1f} GB + layout "
            f"{layout / 1e9:.1f} GB) but the per-device budget is "
            f"~{budget / 1e9:.1f} GB. Shard the dictionary across devices: "
            f"panagram_tpu index --mesh {max(n_fit, 2)} (key-range "
            f"hash sharding; capacity scales linearly with mesh size).")


def pad_pow2(keys: np.ndarray, masks: np.ndarray):
    """SENTINEL-pad (keys, masks) to the next power-of-two length: the
    device layout drops sentinel rows, and pow2-quantized input shapes
    mean one compiled layout program per octave instead of one per exact
    dictionary size (ops/prewarm.py can then AOT-compile it ahead)."""
    D = len(keys)
    P = 1 << max(int(np.ceil(np.log2(max(D, 2)))), 1)
    if P == D:
        return keys, masks
    W = masks.shape[1] if masks.ndim == 2 else 1
    pk = np.full(P, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    pk[:D] = keys
    pm = np.zeros((P, W), np.uint32)
    pm[:D] = masks.reshape(D, W)
    return pk, pm


@dataclasses.dataclass
class BucketedDict:
    """Single-probe bucketed hash layout of a pan-kmer dictionary."""

    table: np.ndarray       # u32 [2^b, stride]
    nbits: int
    cap: int
    stride: int
    ngenomes: int
    k: int
    nwords: int

    MEAN_LOAD = 6

    @classmethod
    def build(cls, keys: np.ndarray, masks: np.ndarray, ngenomes: int,
              k: int, mixed: bool = False) -> "BucketedDict":
        """keys: distinct u64 canonical k-mers (any order); masks u32 [D, W].
        Set mixed=True when keys are already splitmix64-mixed."""
        D = max(len(keys), 1)
        W = masks.shape[1] if masks.ndim == 2 else 1
        masks = masks.reshape(len(keys), W)
        m = keys.astype(U64) if mixed else mix64_np(keys.astype(U64))
        if np.any(m == U64(0xFFFFFFFFFFFFFFFF)):
            raise RuntimeError("key mixes to the reserved all-ones value")

        # lane-aligned stride: smallest multiple of 64 u32 that fits a
        # safe capacity (>= 3x mean load so overflow is essentially never)
        nbits, cap, stride = table_geometry(D, W)
        check_hbm_budget(D, W, what="bucketed dict (host layout)",
                         device_layout=False)
        for attempt in range(8):
            table, overflow = cls._layout(m, masks, nbits, cap, stride)
            if overflow == 0:
                return cls(table=table, nbits=nbits, cap=cap, stride=stride,
                           ngenomes=ngenomes, k=k, nwords=W)
            nbits += 1  # halve the mean load and retry
        raise RuntimeError("bucketed dict: bucket overflow persisted after "
                           "8 doublings — pathological key distribution")

    @staticmethod
    def _layout(mixed, masks, nbits, cap, stride):
        B = 1 << nbits
        W = masks.shape[1]
        slot_w = 2 + W
        bucket = (mixed >> U64(64 - nbits)).astype(np.int64)
        order = np.argsort(bucket, kind="stable")
        b_sorted = bucket[order]
        counts = np.bincount(b_sorted, minlength=B)
        overflow = int(np.maximum(counts - cap, 0).sum())
        if overflow:
            return None, overflow
        offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
        slot = np.arange(len(mixed)) - offsets[b_sorted]

        table = np.full((B, stride), _SENTINEL32, np.uint32)
        m_sorted = mixed[order]
        rows = np.empty((len(mixed), slot_w), np.uint32)
        rows[:, 0] = (m_sorted >> U64(32)).astype(np.uint32)
        rows[:, 1] = (m_sorted & U64(0xFFFFFFFF)).astype(np.uint32)
        rows[:, 2:] = masks[order]
        view = table[:, : cap * slot_w].reshape(B, cap, slot_w)
        view[b_sorted, slot] = rows
        return table, 0

    def device_arrays(self):
        """Device handle of the bucket table in PACKED-ROW form
        ([B/pack, stride*pack], see row_pack), MEMOIZED: jnp.asarray of a
        host table is an h2d copy of the whole (3x-padded) table, which
        must not be repeated for every anchor genome."""
        dev = getattr(self, "_dev", None)
        if dev is None:
            t = self.table
            if isinstance(t, np.ndarray):
                pack = row_pack(self.stride, t.shape[0])
                t = t.reshape(t.shape[0] // pack, self.stride * pack)
            dev = (jnp.asarray(t),)
            object.__setattr__(self, "_dev", dev)
        return dev

    @classmethod
    def build_device(cls, keys, masks, ngenomes: int, k: int,
                     mixed: bool = False, count: int | None = None,
                     min_nbits: int = 2,
                     sorted_input: bool = False) -> "BucketedDict":
        """Device-side layout: same result as build() but the argsort +
        scatter run on the accelerator and `table` stays a device array —
        no host round-trip of the table (SURVEY §7.4.2 scale requirement).

        keys may be SENTINEL-padded (e.g. the device-resident builder's
        fixed-capacity arrays); `count` is the number of real keys (for
        sizing only; defaults to len(keys)).  sorted_input=True asserts
        keys are already globally sorted by MIXED value (requires
        mixed=True; the device builder's merge invariant) — the layout
        then skips its grouping sort, roughly halving HBM transients, so
        1e8-key tables lay out on device instead of the host fallback."""
        D = max(int(count) if count is not None else len(keys), 1)
        W = masks.shape[1] if masks.ndim == 2 else 1
        keys = jnp.asarray(keys, jnp.uint64)
        masks = jnp.asarray(masks, jnp.uint32).reshape(keys.shape[0], W)
        assert not sorted_input or mixed, \
            "sorted_input requires mixed-space keys"

        nbits, cap, stride = table_geometry(D, W)
        nbits = max(nbits, min_nbits)
        # route: single-pass (small tables), chunked P-pass (sorted input
        # whose single-pass transients or flat int32 indices won't fit),
        # or host layout (unsorted input beyond the transient budget)
        route = "single"
        try:
            check_hbm_budget(
                D, W, what="bucketed dict (device layout)",
                device_layout="sorted" if sorted_input else True)
            if sorted_input and (1 << nbits) * stride >= _FLAT_SCATTER_MAX:
                route = "chunked"
        except RuntimeError:
            route = "chunked" if sorted_input else "host"
        if route == "chunked":
            try:
                check_hbm_budget(D, W, what="bucketed dict (chunked "
                                 "device layout)", device_layout="chunked")
            except RuntimeError:
                route = "host"
        if route == "host":
            # table alone fits but the device layout's transients do not:
            # route the LAYOUT via host (numpy bucket sort + one upload)
            # — only re-raise when the finished table cannot fit, where
            # --mesh is the answer
            check_hbm_budget(D, W, what="bucketed dict",
                             device_layout=False)
            import logging

            logging.getLogger(__name__).warning(
                "device dictionary layout at %s keys exceeds HBM "
                "transient budget; building the table on the HOST and "
                "uploading once", f"{D:,}")
            hk = np.asarray(keys)[:D]
            hm = np.asarray(masks)[:D]
            return cls.build(hk, hm, ngenomes, k, mixed=bool(mixed))
        from .prewarm import get_compiled

        for _ in range(8):
            # mixing happens INSIDE the jitted layout: at the 1e8-key scale
            # a second keys-sized array alive across the call is the
            # difference between fitting HBM and not (pre-mixed keys pass
            # straight through — no extra array at all).  Use the
            # AOT-prewarmed executable when one exists.
            if route == "chunked":
                table, overflow = _layout_device_chunked(
                    keys, masks, nbits, cap, stride, D)
            else:
                fn = get_compiled(("layout", keys.shape[0], W, nbits, cap,
                                   stride, bool(mixed), bool(sorted_input)))
                if fn is not None:
                    table, overflow = fn(keys, masks)
                else:
                    table, overflow = _layout_device(keys, masks, nbits,
                                                     cap, stride, mixed,
                                                     sorted_input)
            if int(overflow) == 0:
                pack = row_pack(stride, 1 << nbits)
                tshape = ((1 << nbits) // pack, stride * pack)
                if table.shape != tshape:
                    # an EAGER reshape of a near-memory-sized table can
                    # COPY it: the chunked driver already returns
                    # [B*stride/128, 128], which for stride 64/128 IS the
                    # packed-row shape — only oddball strides (192 etc.)
                    # retile here
                    table = table.reshape(tshape)
                return cls(table=table, nbits=nbits, cap=cap, stride=stride,
                           ngenomes=ngenomes, k=k, nwords=W)
            nbits += 1
        raise RuntimeError("bucketed dict: bucket overflow persisted after "
                           "8 doublings — pathological key distribution")


def layout_rows(m: jax.Array, masks: jax.Array, bucket: jax.Array,
                n_buckets: int, cap: int, stride: int,
                bucket_in_key: bool = False, pre_sorted: bool = False):
    """Traced core of the device bucket layout (also used inside the
    distributed build's shard_map body, parallel/shard.py).

    m u64 [D] mixed keys (SENTINEL rows are padding and dropped); masks
    u32 [D, W]; bucket i32 [D] — the destination bucket of each row (any
    derivation: top bits, low bits, shard-offset).

    bucket_in_key=True asserts the bucket is the TOP bits of m (the
    single-table and genome-sharded layouts): sorting by m alone then
    yields (bucket, key) order, dropping one [D] operand from the sort —
    near the device's memory ceiling every operand counts.

    Returns (table u32 FLAT [n_buckets * stride], overflow i32): rows
    beyond a bucket's capacity are dropped and counted in overflow (the
    caller retries with more buckets)."""
    D = m.shape[0]
    W = masks.shape[1]
    slot_w = 2 + W

    real = m != jnp.uint64(0xFFFFFFFFFFFFFFFF)

    if bucket_in_key:
        nbits = (n_buckets - 1).bit_length()
        if pre_sorted:
            # input already globally sorted by mixed key (the device
            # builder's merge output) — the grouping sort is a no-op, and
            # DROPPING it cuts the layout's transients ~2x (the sort's
            # in+out operand copies)
            srt = (m,) + tuple(masks[:, w] for w in range(W))
        else:
            ops = (m,) + tuple(masks[:, w] for w in range(W))
            srt = jax.lax.sort(ops, num_keys=1)
        ms = srt[0]
        real_s = ms != jnp.uint64(0xFFFFFFFFFFFFFFFF)
        bs = jnp.where(real_s,
                       (ms >> U64(64 - nbits)).astype(jnp.int32),
                       n_buckets)
        srt = (bs,) + srt
    else:
        b = jnp.where(real, bucket, n_buckets).astype(jnp.int32)
        # deterministic grouping: sort by (bucket, key) — keys are
        # distinct, so the order (hence slot assignment) is a fixed total
        # order
        ops = (b, m) + tuple(masks[:, w] for w in range(W))
        srt = jax.lax.sort(ops, num_keys=2)
        bs, ms = srt[0], srt[1]

    # i32 throughout: every [D] transient here is 2x smaller than the
    # x64 defaults, which matters exactly at the memory-limit scales this
    # path exists for (D < 2^31 always)
    counts = jnp.bincount(bs, length=n_buckets + 1).astype(jnp.int32)
    offsets = (jnp.cumsum(counts) - counts).astype(jnp.int32)
    slot = jnp.arange(D, dtype=jnp.int32) - offsets[bs]
    overflow = jnp.sum(jnp.maximum(counts[:n_buckets] - cap, 0))

    ok = (bs < n_buckets) & (slot < cap)
    # ONE scatter per slot column, all with 1D payloads: a [D, slot_w]
    # payload with a narrow minor dim can be padded by the device layout
    # (a 42x blowup where minor dims pad to 128)
    cols = [(ms >> U64(32)).astype(jnp.uint32),
            (ms & U64(0xFFFFFFFF)).astype(jnp.uint32)]
    cols += [srt[2 + w] for w in range(W)]
    flat_n = n_buckets * stride
    if flat_n < _FLAT_SCATTER_MAX:
        base = jnp.where(ok, bs * jnp.int32(stride)
                         + slot * jnp.int32(slot_w), jnp.int32(flat_n))
        table = jnp.full(flat_n, _SENTINEL32, jnp.uint32)
        for c, colv in enumerate(cols):
            table = table.at[base + c].set(colv, mode="drop")
    else:
        # a flat int32 index cannot address >= 2^31 elements (the 1e8-key
        # W=1 table is EXACTLY 2^31 u32) — scatter into a [rows, 128]
        # view instead, with row/lane derived in 64-lane units so every
        # intermediate stays int32: stride = 64*s, so the flat offset is
        # 64*(bs*s + inner>>6) + (inner&63) with bs*s <= flat_n/64 < 2^26
        s = stride // 64
        nrows = flat_n // 128
        inner = slot * jnp.int32(slot_w)       # < stride
        q = bs * jnp.int32(s)
        table = jnp.full((nrows, 128), _SENTINEL32, jnp.uint32)
        for c, colv in enumerate(cols):
            innc = inner + jnp.int32(c)
            q64 = q + (innc >> 6)              # 64-lane unit index
            r = jnp.where(ok, q64 >> 1, jnp.int32(nrows))
            lane = ((q64 & 1) << 6) | (innc & 63)
            table = table.at[r, lane].set(colv, mode="drop")
        table = table.reshape(flat_n)
    # FLAT return: callers reshape to the packed-row form (row_pack) or to
    # [n_buckets, stride] host-side.
    return table, overflow.astype(jnp.int32)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _layout_device(keys: jax.Array, masks: jax.Array, nbits: int, cap: int,
                   stride: int, mixed: bool = True,
                   pre_sorted: bool = False):
    m = keys if mixed else jnp.where(
        keys == U64(0xFFFFFFFFFFFFFFFF), keys, mix64(keys))
    dummy = jnp.zeros((), jnp.int32)   # bucket derives from m's top bits
    return layout_rows(m, masks, dummy, 1 << nbits, cap, stride,
                       bucket_in_key=True, pre_sorted=pre_sorted)


def chunked_layout_pieces(N: int, nbits: int) -> int:
    """Pass count for the chunked device layout: smallest power of two
    keeping each pass's slice (hence its transients) under 2^24 rows
    (PANAGRAM_TPU_LAYOUT_PIECE_ROWS overrides, for probes), clamped so
    every piece covers at least one bucket."""
    bound = int(os.environ.get("PANAGRAM_TPU_LAYOUT_PIECE_ROWS", 1 << 24))
    P = 2
    while -(-N // P) > bound:
        P *= 2
    return min(P, 1 << nbits)


@partial(jax.jit, static_argnums=(1,))
def _piece_bounds(keys: jax.Array, P: int):
    """Row index of each bucket-range boundary in the globally sorted
    mixed-key array: piece p of P covers mixed values [p, p+1) * 2^64/P,
    i.e. buckets [p, p+1) * B/P for any nbits >= log2(P)."""
    log2p = P.bit_length() - 1
    vals = jnp.arange(1, P, dtype=jnp.uint64) << jnp.uint64(64 - log2p)
    return jnp.searchsorted(keys, vals)


@partial(jax.jit, static_argnums=(7, 8, 9, 10), donate_argnums=(0,))
def _layout_piece(table: jax.Array, keys: jax.Array, masks: jax.Array,
                  start: jax.Array, lo: jax.Array, hi: jax.Array,
                  base_bucket: jax.Array, nbits: int, cap: int, stride: int,
                  S: int):
    """One bucket-range pass of the chunked device layout: scatter the
    sorted rows [start+lo, start+hi) — a complete range of buckets
    [base_bucket, base_bucket + B/P) — into the DONATED full table.

    Only this pass's S-row slice produces transients; the table buffer
    is reused in place across passes (donate_argnums=0), so a
    2^31-element (1e8-key) layout needs no key-proportional scatter
    temps."""
    W = masks.shape[1]
    slot_w = 2 + W
    n_buckets = (table.shape[0] * 128) // stride  # == 1 << nbits
    m = jax.lax.dynamic_slice(keys, (start,), (S,))
    mk = jax.lax.dynamic_slice(masks, (start, jnp.int32(0)), (S, W))
    idx = jnp.arange(S, dtype=jnp.int32)
    valid = (idx >= lo) & (idx < hi)
    bs = (m >> U64(64 - nbits)).astype(jnp.int32)
    # local bucket ids for slot assignment: [lo, hi) is bucket-aligned, so
    # valid rows land in [0, B/P); everything else (previous piece's tail,
    # next piece's overrun, sentinel padding) parks in the sentinel bin so
    # it can neither shift offsets nor fake an overflow.  length=B+1 is
    # safe for any P and tiny next to the slice transients.
    local = jnp.where(valid, bs - base_bucket, jnp.int32(n_buckets))
    counts = jnp.bincount(local, length=n_buckets + 1).astype(jnp.int32)
    offsets = (jnp.cumsum(counts) - counts).astype(jnp.int32)
    slot = idx - lo - offsets[local]
    ok = valid & (slot < cap)
    overflow = jnp.sum(jnp.maximum(counts[:n_buckets] - cap, 0))

    s64 = stride // 64
    nrows = table.shape[0]
    inner = slot * jnp.int32(slot_w)
    q = bs * jnp.int32(s64)
    cols = [(m >> U64(32)).astype(jnp.uint32),
            (m & U64(0xFFFFFFFF)).astype(jnp.uint32)]
    cols += [mk[:, w] for w in range(W)]
    for c, colv in enumerate(cols):
        innc = inner + jnp.int32(c)
        q64 = q + (innc >> 6)
        r = jnp.where(ok, q64 >> 1, jnp.int32(nrows))
        lane = ((q64 & 1) << 6) | (innc & 63)
        table = table.at[r, lane].set(colv, mode="drop")
    return table, overflow.astype(jnp.int32)


def _layout_device_chunked(keys: jax.Array, masks: jax.Array, nbits: int,
                           cap: int, stride: int, count: int):
    """Chunked device layout driver: P bucket-range passes with a donated
    table (bounded transients — the all-device answer to the >9e7-key
    host fallback).  keys must be globally sorted in MIXED space with
    sentinel padding at the tail; `count` is the number of real rows."""
    from .prewarm import get_compiled

    N = keys.shape[0]
    W = masks.shape[1]
    P = chunked_layout_pieces(N, nbits)
    fnb = get_compiled(("piece_bounds", N, P))
    bounds = fnb(keys) if fnb is not None else _piece_bounds(keys, P)
    bounds = np.concatenate([[0], np.asarray(bounds), [count]]).astype(
        np.int64)
    S = 1 << max(int(np.ceil(np.log2(max(np.diff(bounds).max(), 2)))), 1)
    nrows = ((1 << nbits) * stride) // 128
    table = jnp.full((nrows, 128), _SENTINEL32, jnp.uint32)
    ovs = []
    for p in range(P):
        start = int(min(bounds[p], N - S))
        lo = int(bounds[p] - start)
        hi = int(bounds[p + 1] - start)
        # ALWAYS the jit path here, never the prewarmed AOT executable:
        # calling a Compiled object does not invalidate the donated table
        # argument, so the runtime would copy a table-sized buffer instead
        # of aliasing it
        table, ov = _layout_piece(
            table, keys, masks, jnp.int32(start), jnp.int32(lo),
            jnp.int32(hi), jnp.int32(p * ((1 << nbits) // P)),
            nbits, cap, stride, S)
        # per-piece completion barrier: with all P donated calls queued
        # asynchronously, the in-flight pieces' scatter temps stack up
        ovs.append(int(ov))
    # return the [B*stride/128, 128] form as-is: flattening 2^31 elements
    # eagerly would dispatch a COPY of the whole near-memory-sized table
    return table, sum(ovs)


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def bucket_query(canon: jax.Array, table: jax.Array,
                 nbits: int, cap: int, nwords: int,
                 pre_mixed: bool = False):
    """canon u64 [Q] -> mask rows u32 [Q, W] in ONE wide gather.  Misses
    (including SENTINEL / invalid windows) return zero masks, matching
    KMC's counter-0 behaviour for absent or N-containing k-mers.

    `table` may be the plain [B, stride] layout (mesh shard tables, host
    uploads in tests) or the PACKED-ROW [B/pack, stride*pack] device form
    (device_arrays / build_device); the packing is derived from the
    shapes and unpicked with a log2(pack) select chain."""
    m = canon.astype(jnp.uint64) if pre_mixed else mix64(canon)
    qhi = (m >> U64(32)).astype(jnp.uint32)
    qlo = (m & U64(0xFFFFFFFF)).astype(jnp.uint32)
    bucket = (m >> U64(64 - nbits)).astype(jnp.int32)

    B = 1 << nbits
    pack = max(B // table.shape[0], 1)
    stride = table.shape[1] // pack
    logp = pack.bit_length() - 1
    rows = jnp.take(table, bucket >> logp, axis=0)    # [Q, stride*pack]
    off = bucket & (pack - 1)
    for bit in reversed(range(logp)):
        half = rows.shape[1] // 2
        upper = ((off >> bit) & 1) == 1
        rows = jnp.where(upper[:, None], rows[:, half:], rows[:, :half])
    slot_w = 2 + nwords
    rows = rows[:, : cap * slot_w].reshape(rows.shape[0], cap, slot_w)
    hit = (rows[:, :, 0] == qhi[:, None]) & (rows[:, :, 1] == qlo[:, None])
    # empty slots are hi=lo=0xFFFFFFFF; exclude the (single, astronomically
    # unlikely) all-ones mixed value from matching
    hit = hit & (m != U64(0xFFFFFFFFFFFFFFFF))[:, None]
    sel = jnp.where(hit[:, :, None], rows[:, :, 2:], jnp.uint32(0))
    return sel.sum(axis=1, dtype=jnp.uint32)
