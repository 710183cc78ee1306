"""Concurrent AOT prewarming of jitted programs.

Every distinct XLA program costs a compile the first time a process needs
it, and by default that happens serially, exactly when a stage first
calls the program.  This module fires ``fn.lower(ShapeDtypeStruct...)
.compile()`` for every program a stage WILL need on a small thread pool at
stage start — abstract shapes only, no device buffers — so the compiles
overlap each other and whatever IO/host work runs meanwhile, and the
finished executables are published for the consumers to dispatch
through.  A mispredicted shape wastes only pool time; it can never
corrupt results.

It was built for a backend whose compiles were slow and uncached.  Where
JAX's persistent compile cache (panagram_tpu/cache.py) is warm, the
compiles here become cache loads; whether the module still pays for itself
on the GPU is measured with PANAGRAM_TPU_PREWARM=0 against 1 (ROADMAP
design item 1).
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("panagram_tpu")

_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()
_futures: list[Future] = []
# AOT executables by structured key: consumers (stream_anchor_chunks,
# build_device) dispatch through these DIRECTLY when available, so the
# jit path does not lower and look the program up again
_compiled: dict = {}

# cap concurrent compile requests
_WORKERS = int(os.environ.get("PANAGRAM_TPU_PREWARM_WORKERS", "8"))
# global submit dedup: repeated prewarm calls (dict stage + per-anchor)
# must not occupy pool slots recompiling identical programs
_submitted: set = set()


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=_WORKERS, thread_name_prefix="panagram-prewarm")
        return _pool


def enabled() -> bool:
    """Prewarming is on by default; PANAGRAM_TPU_PREWARM=0 disables (e.g.
    for compile-cost measurements)."""
    return os.environ.get("PANAGRAM_TPU_PREWARM", "1") != "0"


_exec_lock = threading.Lock()


def submit(label: str, fn, *args, key: tuple | None = None,
           execute: bool = False) -> Future | None:
    """Queue one AOT compile: fn.lower(*args).compile() on the pool.

    args mix ShapeDtypeStructs (traced) and real values (static);
    failures are logged and swallowed — a warm miss must never break the
    build.  With `key`, the finished Compiled executable is published in
    the registry for get_compiled() consumers.

    execute=True additionally runs the executable ONCE on zero-filled
    dummy arguments, so that whatever the first execution of a program
    costs on the device (module load, autotuning) is paid during the
    warm.  Dummy allocations are serialized under a lock and freed
    immediately (one table-sized transient at a time)."""
    if not enabled():
        return None
    dedup = key if key is not None else label
    if dedup in _submitted:
        return None
    _submitted.add(dedup)

    def _work():
        import time

        t0 = time.perf_counter()
        try:
            compiled = fn.lower(*args).compile()
            if key is not None:
                _compiled[key] = compiled
            logger.info(
                f"prewarm {label}: compiled in "
                f"{time.perf_counter() - t0:.1f}s")
        except Exception as e:  # noqa: BLE001 - warm misses are non-fatal
            logger.info(f"prewarm {label}: skipped ({type(e).__name__}: {e})")
            return
        if not execute:
            return
        t0 = time.perf_counter()
        try:
            with _exec_lock:
                dargs = [jnp.zeros(a.shape, a.dtype) for a in args
                         if isinstance(a, jax.ShapeDtypeStruct)]
                out = compiled(*dargs)
                jax.block_until_ready(out)
                # tiny d2h as the completion barrier
                leaf = jax.tree_util.tree_leaves(out)[0]
                np.asarray(leaf.ravel()[:1])
                del out, dargs
            logger.info(
                f"prewarm {label}: loaded+executed in "
                f"{time.perf_counter() - t0:.1f}s")
        except Exception as e:  # noqa: BLE001
            logger.info(f"prewarm {label}: execute skipped "
                        f"({type(e).__name__}: {e})")

    f = _get_pool().submit(_work)
    _futures.append(f)
    return f


def get_compiled(key: tuple):
    """The AOT executable for `key`, or None (never compiled / still in
    flight — callers fall back to the jit path)."""
    return _compiled.get(key)


def wait_all(timeout: float | None = None):
    """Barrier for tests/tools; production never waits."""
    for f in list(_futures):
        try:
            f.result(timeout=timeout)
        except Exception:  # noqa: BLE001
            pass


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(tuple(shape), dtype)


def _pow2ceil(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def prewarm_dict_programs(k: int, ngenomes: int, chunk: int,
                          capacity: int, genome_kmer_counts):
    """Queue compiles for everything DeviceDictBuilder will run: the
    chunk distinct-kmer kernel, the union-tree shapes, and the
    capacity-sized merges the given genome sizes will produce."""
    if not enabled():
        return
    from .devdict import _chunk_mixed_distinct, _merge_into, _union_sorted

    W = (ngenomes + 31) // 32
    L = chunk + k - 1
    n4, n8 = -(-L // 4), -(-L // 8)
    submit("dict.chunk_kernel", _chunk_mixed_distinct,
           _sds((n4,), jnp.uint8), _sds((n8,), jnp.uint8), (L, k))

    # union tree levels + merge new_keys sizes implied by the flush rule
    # (FLUSH_CHUNKS=8 mid-genome, remainder at genome end)
    union_sizes: set[int] = set()
    merge_sizes: set[int] = set()
    from .devdict import DeviceDictBuilder

    FC = DeviceDictBuilder.FLUSH_CHUNKS
    for nk in genome_kmer_counts:
        nch = max(-(-int(nk) // chunk), 1)
        for flush in ([FC] * (nch // FC) + ([nch % FC] if nch % FC else [])):
            p = _pow2ceil(flush)
            merge_sizes.add(chunk * p)
            s = chunk
            while s < chunk * p:
                union_sizes.add(s)
                s *= 2
    for s in sorted(union_sizes):
        submit(f"dict.union_{s}", _union_sorted,
               _sds((s,), jnp.uint64), _sds((s,), jnp.uint64))
    for m in sorted(merge_sizes):
        # also warm the one-step-grown capacity: if the size estimate was
        # low the builder doubles once and would otherwise eat a serial
        # merge recompile mid-build
        for cap_ in (capacity, capacity * 2):
            submit(f"dict.merge_{m}@{cap_}", _merge_into,
                   _sds((cap_,), jnp.uint64),
                   _sds((cap_, W), jnp.uint32),
                   _sds((m,), jnp.uint64), W,
                   _sds((), jnp.int32))
    # to_host's d2h piece-slice programs.  Masks stream FLAT
    # (devdict.flat_fn)
    from .devdict import _D2H_PIECE, flat_fn, slice_fn

    if capacity > _D2H_PIECE:
        for shape, dt in (((capacity,), jnp.uint64),
                          ((capacity * W,), jnp.uint32)):
            fn = slice_fn(shape, dt, _D2H_PIECE)
            submit(f"dict.piece_{dt.__name__}", fn,
                   _sds(shape, dt), _sds((), jnp.int32))
        submit("dict.flat_masks", flat_fn((capacity, W), jnp.uint32),
               _sds((capacity, W), jnp.uint32))


def prewarm_anchor_programs(k: int, ngenomes: int, chunk: int,
                            d_estimates, capacity: int | None = None):
    """Queue compiles for the streamed anchor engine against a dictionary
    of ~D keys, for each candidate D in `d_estimates` (layout geometry is
    pow2-quantized, so bracketing the estimate catches the real table
    shape; a miss costs only concurrent compile time).  Covers the fused
    RLE chunk kernel, the d2h piece-slice programs, and the sorted-input
    device layout (for pow2-padded key arrays — index.pad_pow2)."""
    if not enabled():
        return
    from .anchor import (
        PAL_CAP,
        _PAL_PIECE,
        _PIECE,
        anchor_chunk_rle2,
        anchor_chunk_rle4,
        pal_work_for,
        piece_fn,
        rle4_pal_bytes,
        rle_proto,
        rle_row_bytes,
    )
    from .lookup import _layout_device, row_pack, table_geometry

    W = (ngenomes + 31) // 32
    nbytes = (ngenomes + 7) // 8
    L = chunk + k - 1
    inlen = -(-L // 4) + (-(-L // 8))
    cap_rle = capacity if capacity is not None else chunk
    pal_work = pal_work_for(cap_rle)
    proto = rle_proto(nbytes)
    seen: set[tuple] = set()
    layouts: set[tuple] = set()
    # dummy executions serialize on the single device (and with the REAL
    # work): only the LIKELY geometries — the first two estimates, plus
    # one octave of layout-P insurance — are execute-warmed; the outer
    # bracket candidates compile-only, so a dummy execute for a D that
    # never materialises cannot hold the device during the real anchor.
    likely_P: set[int] = {2 * _pow2ceil(int(d_estimates[0]))} \
        if d_estimates else set()
    for i, D in enumerate(d_estimates):
        nbits, cap, stride = table_geometry(max(int(D), 1), W)
        nbits = max(nbits, 2)
        B = 1 << nbits
        pack = row_pack(stride, B)
        tshape = (B // pack, stride * pack)
        # sorted-input layout over pow2-padded keys: P(D) is octave-
        # quantized independently of nbits(D), so warm both P candidates
        # for this geometry
        P = _pow2ceil(int(D))
        layouts.add((P, nbits, cap, stride))
        layouts.add((2 * P, nbits, cap, stride))
        if i < 2:
            likely_P.add(P)
        key = (tshape, nbits)
        if key in seen:
            continue
        seen.add(key)
        # execution-warm when the dummy table transient is modest
        texec = i < 2 and tshape[0] * tshape[1] * 4 <= (2 << 30)
        if proto == 4:
            submit(f"anchor.rle4_c{chunk}_D{D}", anchor_chunk_rle4,
                   _sds((inlen,), jnp.uint8),
                   _sds(tshape, jnp.uint32),
                   L, k, nbits, cap, W, nbytes, pal_work,
                   key=("rle4", inlen, tshape, L, k, nbits, cap, W,
                        nbytes, pal_work), execute=texec)
        else:
            submit(f"anchor.rle2_c{chunk}_D{D}", anchor_chunk_rle2,
                   _sds((inlen,), jnp.uint8),
                   _sds(tshape, jnp.uint32),
                   L, k, nbits, cap, W, nbytes, cap_rle,
                   key=("rle2", inlen, tshape, L, k, nbits, cap, W,
                        nbytes, cap_rle), execute=texec)
    from .lookup import (
        _FLAT_SCATTER_MAX,
        _layout_piece,
        _piece_bounds,
        check_hbm_budget,
        chunked_layout_pieces,
    )

    for (P, nbits, cap, stride) in sorted(layouts):
        chunked = (1 << nbits) * stride >= _FLAT_SCATTER_MAX
        if not chunked:
            try:
                check_hbm_budget(P, W, what="prewarm probe",
                                 device_layout="sorted")
            except RuntimeError:
                chunked = True
        if chunked:
            # the P-pass chunked layout's programs: bucket-range bounds +
            # the donated-table piece scatter.  The runtime piece size is
            # pow2ceil(max real piece); under mix64 the pieces are uniform
            # so the mean's octave (and one above, insurance) covers it.
            np_ = chunked_layout_pieces(P, nbits)
            # execution-warm: its dummy is only the keys array
            submit(f"anchor.piece_bounds_P{P}", _piece_bounds,
                   _sds((P,), jnp.uint64), np_,
                   key=("piece_bounds", P, np_),
                   execute=P * 8 <= (2 << 30))
            nrows = ((1 << nbits) * stride) // 128
            S0 = _pow2ceil(-(-P // np_))
            for S in {max(S0 // 2, 2), S0, 2 * S0}:
                # NO registry key: the piece program DONATES its table
                # argument, and calling a prewarmed Compiled object does
                # not invalidate the donated array (the runtime would copy
                # a table-sized buffer).  The submit only warms the
                # compile (and the persistent cache) for the jit path.
                submit(f"anchor.layout_piece_P{P}_b{nbits}_S{S}",
                       _layout_piece,
                       _sds((nrows, 128), jnp.uint32),
                       _sds((P,), jnp.uint64), _sds((P, W), jnp.uint32),
                       _sds((), jnp.int32), _sds((), jnp.int32),
                       _sds((), jnp.int32), _sds((), jnp.int32),
                       nbits, cap, stride, S)
            continue
        lexec = P in likely_P and \
            (P * (8 + 4 * W) + (1 << nbits) * stride * 4) <= (2 << 30)
        submit(f"anchor.layout_P{P}_b{nbits}", _layout_device,
               _sds((P,), jnp.uint64), _sds((P, W), jnp.uint32),
               nbits, cap, stride, True, True,
               key=("layout", P, W, nbits, cap, stride, True, True),
               execute=lexec)
    # d2h piece-slice programs (the drain's transfer path)
    if proto == 4:
        fn, _ = piece_fn(pal_work + 1, 3, jnp.uint8, _PIECE)
        submit("anchor.piece_data", fn,
               _sds((pal_work + 1, 3), jnp.uint8), _sds((), jnp.int32))
        pw = rle4_pal_bytes(nbytes)
        fn, _ = piece_fn(PAL_CAP + 3, pw, jnp.uint8, _PAL_PIECE)
        submit("anchor.piece_pal", fn,
               _sds((PAL_CAP + 3, pw), jnp.uint8), _sds((), jnp.int32))
    else:
        rowb = rle_row_bytes(nbytes)
        fn, _ = piece_fn(cap_rle + 2, rowb, jnp.uint8, _PIECE)
        submit("anchor.piece_rle2", fn,
               _sds((cap_rle + 2, rowb), jnp.uint8), _sds((), jnp.int32))
