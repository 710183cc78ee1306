#!/usr/bin/env python
"""Measure device-side BucketedDict layout at dictionary scale.

VERDICT #6 done-criterion: layout time for a >= 1e8-key dictionary with no
host copy of keys, masks, or the finished table (SURVEY §7.4.2 — 100-genome
pangenomes reach O(1e9-1e10) distinct k-mers; per-chip shards are O(1e8-1e9),
so the per-shard layout must run on device, not as a host argsort).

Keys are generated ON DEVICE (threefry bits -> u64); nothing of size D is ever
copied from the host.  Random u64 keys stand in for splitmix64-mixed canonical
k-mers (the layout only sees mixed keys, which are uniform by construction;
expected collisions at 1e8 keys are ~2.7e-4 — irrelevant to timing).

Usage: python tools/measure_layout.py [--count 100000000] [--genomes 30]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from panagram_tpu.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=100_000_000)
    ap.add_argument("--genomes", type=int, default=30)
    args = ap.parse_args()

    import panagram_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp

    from panagram_tpu.ops.lookup import BucketedDict, bucket_query

    D = args.count
    W = (args.genomes + 31) // 32
    dev = jax.devices()[0]
    print(f"device={dev} keys={D:.3e} ({D*8/1e9:.2f} GB) mask words={W}")

    @jax.jit
    def gen(seed):
        k = jax.random.key(seed)
        bits = jax.random.bits(k, (2, D), dtype=jnp.uint32)
        keys = bits[0].astype(jnp.uint64) << jnp.uint64(32) | bits[1]
        # reserve all-ones (sentinel) by clearing its low bit
        keys = jnp.where(keys == jnp.uint64(0xFFFFFFFFFFFFFFFF),
                         keys - jnp.uint64(1), keys)
        masks = jax.random.bits(k, (D, W), dtype=jnp.uint32)
        return keys, masks

    keys, masks = jax.block_until_ready(gen(0))
    print("keys generated on device")

    t0 = time.perf_counter()
    bd = BucketedDict.build_device(keys, masks, args.genomes, 31, mixed=True)
    jax.block_until_ready(bd.table)
    cold = time.perf_counter() - t0
    print(f"cold build_device (incl compile): {cold:.2f} s")
    assert not isinstance(bd.table, np.ndarray), "table left the device!"
    print(f"table: {bd.table.shape} u32 on {bd.table.device} "
          f"({bd.table.size*4/1e9:.2f} GB), nbits={bd.nbits} cap={bd.cap}")

    keys2, masks2 = jax.block_until_ready(gen(1))
    t0 = time.perf_counter()
    bd2 = BucketedDict.build_device(keys2, masks2, args.genomes, 31,
                                    mixed=True, min_nbits=bd.nbits)
    jax.block_until_ready(bd2.table)
    warm = time.perf_counter() - t0
    print(f"warm build_device: {warm:.2f} s ({D/warm/1e6:.0f} M keys/s)")

    # spot-check: probe 1e6 of the original keys, expect exact mask rows
    q = keys2[: 1 << 20]
    rows = np.asarray(bucket_query(q, bd2.table, bd2.nbits, bd2.cap, W,
                                   pre_mixed=True))
    want = np.asarray(masks2[: 1 << 20])
    ok = (rows == want).all()
    print(f"probe spot-check (2^20 keys): {'OK' if ok else 'MISMATCH'}")
    assert ok


if __name__ == "__main__":
    main()
