#!/usr/bin/env python
"""Stage ablation for the device dictionary builder (VERDICT r4 item 2):
times each devdict op in isolation (block_until_ready) on the attached
accelerator — chunk distinct-kmer kernel, union tree levels, the
capacity-sized merge — so the count+merge wall decomposes into kernel /
transfer / dispatch / compile instead of one opaque number.

Run as the only process on the card:
    python tools/dict_ablate.py [--chunks 8] [--cap-log2 24] [--k 21]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from panagram_tpu.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def _force(out):
    """Force completion: block_until_ready PLUS a tiny d2h of every
    leaf."""
    import jax

    jax.block_until_ready(out)
    for leaf in jax.tree_util.tree_leaves(out):
        np.asarray(leaf.ravel()[:1])


def t(fn, reps=3):
    """best-of wall for a blocking call, (first, best_rest)."""
    t0 = time.perf_counter()
    _force(fn())
    first = time.perf_counter() - t0
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        _force(fn())
        best = min(best, time.perf_counter() - t0)
    return first, best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--chunk-log2", type=int, default=22)
    ap.add_argument("--cap-log2", type=int, default=24)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--nwords", type=int, default=1)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import panagram_tpu  # noqa: F401
    from panagram_tpu.ops.codec import SENTINEL, pack_bases_np
    from panagram_tpu.ops.devdict import (
        _chunk_mixed_distinct,
        _merge_into,
        _union_sorted,
    )

    k = args.k
    chunk = 1 << args.chunk_log2
    cap = 1 << args.cap_log2
    W = args.nwords
    rng = np.random.default_rng(0)
    print(f"devices={jax.devices()}", flush=True)

    codes = rng.integers(0, 4, chunk + k - 1).astype(np.uint8)
    packed, nmask, L = pack_bases_np(codes)

    t0 = time.perf_counter()
    pd = jnp.asarray(packed)
    nd = jnp.asarray(nmask)
    jax.block_until_ready((pd, nd))
    print(f"h2d {packed.nbytes + nmask.nbytes} B: "
          f"{1e3*(time.perf_counter()-t0):.0f} ms", flush=True)
    print(f"array devices: {pd.devices()}", flush=True)

    first, best = t(lambda: _chunk_mixed_distinct(pd, nd, (L, k)))
    print(f"chunk_mixed_distinct [{chunk}]: first {first:.2f}s "
          f"steady {1e3*best:.0f} ms", flush=True)

    a = _chunk_mixed_distinct(pd, nd, (L, k))
    first, best = t(lambda: _union_sorted(a, a))
    print(f"union (c,c) [{chunk}]: first {first:.2f}s "
          f"steady {1e3*best:.0f} ms", flush=True)

    u = _union_sorted(a, a)
    first, best = t(lambda: _union_sorted(u, u))
    print(f"union (2c,2c): first {first:.2f}s steady {1e3*best:.0f} ms",
          flush=True)

    keys = jnp.full(cap, SENTINEL, jnp.uint64)
    masks = jnp.zeros((cap, W), jnp.uint32)
    jax.block_until_ready((keys, masks))
    new_keys = _union_sorted(u, u)    # 4c
    first, best = t(lambda: _merge_into(keys, masks, new_keys, W,
                                        jnp.int32(3)))
    print(f"merge_into cap=2^{args.cap_log2} (+{int(new_keys.shape[0])} "
          f"new, W={W}): first {first:.2f}s steady {1e3*best:.0f} ms",
          flush=True)

    # raw sort rate reference
    x = jnp.asarray(rng.integers(0, 1 << 63, chunk).astype(np.uint64))
    jax.block_until_ready(x)
    srt = jax.jit(jnp.sort)
    first, best = t(lambda: srt(x))
    print(f"raw u64 sort [{chunk}]: first {first:.2f}s "
          f"steady {1e3*best:.0f} ms "
          f"({chunk/best/1e6:.0f} M keys/s)", flush=True)

    x32 = jnp.asarray(rng.integers(0, 1 << 31, chunk).astype(np.uint32))
    jax.block_until_ready(x32)
    first, best = t(lambda: srt(x32))
    print(f"raw u32 sort [{chunk}]: first {first:.2f}s "
          f"steady {1e3*best:.0f} ms "
          f"({chunk/best/1e6:.0f} M keys/s)", flush=True)

    # two-operand lax.sort (key + one u32 payload), the merge's shape
    ky = jnp.asarray(rng.integers(0, 1 << 63, cap).astype(np.uint64))
    pl = jnp.asarray(rng.integers(0, 1 << 31, cap).astype(np.uint32))
    jax.block_until_ready((ky, pl))
    s2 = jax.jit(lambda a_, b_: jax.lax.sort((a_, b_), num_keys=1))
    first, best = t(lambda: s2(ky, pl))
    print(f"lax.sort u64+u32 [2^{args.cap_log2}]: first {first:.2f}s "
          f"steady {1e3*best:.0f} ms ({cap/best/1e6:.0f} M rows/s)",
          flush=True)


if __name__ == "__main__":
    main()
