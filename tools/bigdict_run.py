#!/usr/bin/env python
"""Big-dictionary demonstration: build + anchor against >= 1e8 keys on ONE
device (SURVEY §7.4.2: the hash-sharding claim needs a measured
per-device capacity point, not prose).

4 synthetic random genomes x 26 Mbp (random sequence is ~all-distinct at
k=21) stream through the device-resident builder; the union is ~1.04e8
mixed keys.  BucketedDict.build_device lays the table out on device
(2^25 buckets x 64 u32 = 8.6 GB of device memory),
then a 32 Mbp slice anchors through the production stream_anchor_chunks.

Run as the only process on the card:
    python tools/bigdict_run.py [--mbp 26] [--genomes 4] [--anchor-mbp 32]
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
    ap.add_argument("--mbp", type=float, default=26.0,
                    help="Mbp per genome")
    ap.add_argument("--genomes", type=int, default=4)
    ap.add_argument("--anchor-mbp", type=float, default=32.0)
    ap.add_argument("--k", type=int, default=21)
    args = ap.parse_args()

    import panagram_tpu  # noqa: F401
    import jax

    from panagram_tpu.ops.anchor import rle_proto, stream_anchor_chunks
    from panagram_tpu.ops.devdict import DeviceDictBuilder

    k = args.k
    glen = int(args.mbp * 1e6)
    n = args.genomes
    print(f"devices={jax.devices()}  {n} genomes x {glen/1e6:.0f} Mbp "
          f"k={k}", flush=True)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    b = DeviceDictBuilder(k, n, capacity_hint=int(n * glen * 1.05))
    # fire the anchor-stage + chunked-layout compiles NOW so they overlap
    # the counting phase (the service compiles concurrently)
    from panagram_tpu.ops.prewarm import prewarm_anchor_programs

    prewarm_anchor_programs(k, n, 1 << 22,
                            [int(n * glen), int(n * glen) // 2])
    genomes = []
    for g in range(n):
        codes = rng.integers(0, 4, glen, dtype=np.uint8)
        genomes.append(codes)
        tg = time.perf_counter()
        b.add_sequence(g, codes)
        cnt = b.synced_count()
        print(f"  merged genome {g}: {cnt:,} keys "
              f"({time.perf_counter()-tg:.1f}s)", flush=True)
    t_count = time.perf_counter() - t0
    D = b.synced_count()
    print(f"count+merge: {D:,} keys in {t_count:.1f}s "
          f"({n*glen/t_count/1e6:.1f} Mbp/s)", flush=True)
    assert D >= 1e8, f"expected >= 1e8 keys, got {D:,}"

    t0 = time.perf_counter()
    # Device layout at 1e8 keys (VERDICT r4 item 5): the merge invariant
    # keeps the builder's arrays globally sorted by mixed key, so the
    # sorted-input layout (no grouping sort — its in+out operand copies
    # were what forced the round-4 host fallback) stays within HBM:
    # 8.6 GB table + (8+4W+12) B/key transients.  No host round-trip of
    # keys or table at all.
    bd = b.bucketed()
    del b
    (t1,) = bd.device_arrays()
    jax.block_until_ready(t1)
    t_layout = time.perf_counter() - t0
    table_gb = t1.size * 4 / 1e9
    print(f"bucket table: 2^{bd.nbits} x {bd.stride} u32 = {table_gb:.1f} GB "
          f"resident on device after {t_layout:.1f}s "
          f"(sorted-input device layout)", flush=True)

    nbytes = (n + 7) // 8
    alen = int(args.anchor_mbp * 1e6)
    reps = -(-alen // glen)
    anchor_codes = np.tile(genomes[0], reps)[:alen]
    chunk = 1 << 22
    buf = np.full(chunk + k - 1, 255, np.uint8)
    state = {}

    def run():
        total = 0
        for _s, m, _by, _p, _c in stream_anchor_chunks(
                anchor_codes, alen - k + 1, chunk, buf, t1, bd, nbytes,
                n, k, state=state):
            total += m
        return total

    print(f"anchor warmup (rle v{rle_proto(nbytes)})...", flush=True)
    run()
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        total = run()
        best = max(best, total / (time.perf_counter() - t0))
        print(f"  anchor rep: {total/(time.perf_counter()-t0)/1e6:.1f} "
              f"Mkmers/s", flush=True)
    print(f"RESULT: {D:,}-key dict on one chip; table {table_gb:.1f} GB; "
          f"count+merge {t_count:.1f}s; layout {t_layout:.1f}s; "
          f"anchor {best/1e6:.1f} Mkmers/s", flush=True)


if __name__ == "__main__":
    main()
