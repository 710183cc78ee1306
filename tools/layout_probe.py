#!/usr/bin/env python
"""Chunked device layout probe at arbitrary D without the counting phase:
uniform random u64 keys are exactly the mixed-key distribution, so
np.sort(random u64) reproduces the device builder's layout input.

    python tools/layout_probe.py [--d 104000000] [--w 1] [--verify]
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
    ap.add_argument("--d", type=int, default=104_000_000)
    ap.add_argument("--w", type=int, default=1)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--no-prewarm", action="store_true")
    args = ap.parse_args()

    import panagram_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp

    from panagram_tpu.ops.lookup import (
        BucketedDict,
        chunked_layout_pieces,
        pad_pow2,
        table_geometry,
    )

    D, W = args.d, args.w
    print(f"devices={jax.devices()}  D={D:,} W={W}", flush=True)
    rng = np.random.default_rng(1)
    keys = np.sort(rng.integers(0, 1 << 63, D, dtype=np.uint64) * 2 + 1)
    keys = np.unique(keys)
    D = len(keys)
    masks = rng.integers(1, 1 << 32, (D, W), dtype=np.uint32)
    nbits, cap, stride = table_geometry(D, W)
    P = 1 << int(np.ceil(np.log2(D)))
    print(f"geometry: nbits={nbits} cap={cap} stride={stride} "
          f"table {(1 << nbits) * stride * 4 / 2**30:.1f} GiB  "
          f"pieces={chunked_layout_pieces(P, nbits)}", flush=True)

    if not args.no_prewarm:
        from panagram_tpu.ops.prewarm import prewarm_anchor_programs, wait_all

        ng = W * 32
        prewarm_anchor_programs(21, ng, 1 << 22, [D])
        t0 = time.perf_counter()
        wait_all()
        print(f"prewarm joined in {time.perf_counter() - t0:.1f}s",
              flush=True)

    pk, pm = pad_pow2(keys, masks)
    t0 = time.perf_counter()
    dk = jnp.asarray(pk)
    dm = jnp.asarray(pm)
    jax.block_until_ready((dk, dm))
    print(f"h2d {pk.nbytes / 2**30 + pm.nbytes / 2**30:.2f} GiB in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    bd = BucketedDict.build_device(dk, dm, W * 32, 21, mixed=True,
                                   count=D, sorted_input=True)
    (t1,) = bd.device_arrays()
    np.asarray(t1[:1, :1])  # completion barrier (block_until_ready lies)
    wall = time.perf_counter() - t0
    print(f"LAYOUT: {wall:.1f}s for {D:,} keys "
          f"(2^{bd.nbits} x {bd.stride}, on device)", flush=True)

    if args.verify:
        from panagram_tpu.ops.lookup import bucket_query

        idx = rng.choice(D, 100_000, replace=False)
        q = jnp.asarray(keys[idx])
        rows = np.asarray(bucket_query(q, t1, bd.nbits, bd.cap, bd.nwords,
                                       pre_mixed=True))
        assert np.array_equal(rows, masks[idx]), "probe mismatch"
        # absent keys must miss
        q2 = jnp.asarray(rng.integers(0, 1 << 63, 10_000,
                                      dtype=np.uint64) * 2)
        rows2 = np.asarray(bucket_query(q2, t1, bd.nbits, bd.cap,
                                        bd.nwords, pre_mixed=True))
        present = np.isin(np.asarray(q2), keys)
        assert not rows2[~present].any(), "absent key returned a mask"
        print("verify OK: 100k present keys + 10k absent keys", flush=True)


if __name__ == "__main__":
    main()
