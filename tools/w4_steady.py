#!/usr/bin/env python
"""Steady-state W=4 anchoring rate over multi-chunk sequences.

The 100-genome scale row anchors 2 Mbp genomes — ONE 2^21 chunk each, so
its per-genome wall is dominated by fixed costs (pipeline spin-up, writer
open/close, header transfers) rather than the W=4 compute rate.  This
tool measures the rate the engine actually sustains once chunks pipeline:
it loads the scale run's kept index dictionary (default
/tmp/panagram_scale/idx), lays it out on device once, then streams
`--mbp`-sized sequences through ops.anchor.stream_anchor_chunks (the
exact production engine, incl. RLE/palette decode + colsums) and reports
per-sequence walls with the first (compile-join) sequence separated.

Usage: python tools/w4_steady.py [--idx DIR] [--mbp 8] [--reps 3]
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
    ap.add_argument("--idx", default="/tmp/panagram_scale/idx")
    ap.add_argument("--mbp", type=float, default=8.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=21,
                    help="log2 chunk (match the producing run)")
    args = ap.parse_args()

    import panagram_tpu  # noqa: F401
    import jax

    from panagram_tpu.ops import anchor as A
    from panagram_tpu.ops.dictionary import PanKmerDict
    from panagram_tpu.ops.lookup import BucketedDict, pad_pow2
    from panagram_tpu.ops.prewarm import prewarm_anchor_programs

    d = PanKmerDict.load(os.path.join(args.idx, "kmc", "pandict.npz"))
    N, k, W = d.ngenomes, d.k, d.masks.shape[1]
    nbytes = (N + 7) // 8
    chunk = 1 << args.chunk
    print(f"devices={jax.devices()} dict D={len(d.keys)} N={N} k={k} W={W}",
          flush=True)

    t0 = time.perf_counter()
    prewarm_anchor_programs(k, N, chunk, [len(d.keys)])
    is_mixed = getattr(d, "key_space", "canon") == "mixed"
    pk, pm = pad_pow2(d.keys, d.masks)
    bd = BucketedDict.build_device(pk, pm, N, k, mixed=is_mixed,
                                   count=len(d.keys), sorted_input=is_mixed)
    (t1,) = bd.device_arrays()
    print(f"layout: {time.perf_counter()-t0:.1f}s table {t1.shape}",
          flush=True)

    rng = np.random.default_rng(3)
    L = int(args.mbp * 1e6)
    base = rng.integers(0, 4, L, dtype=np.uint8)
    buf = np.empty(chunk + k - 1, np.uint8)
    state: dict = {}
    walls = []
    for rep in range(args.reps + 1):
        codes = base.copy()
        pos = rng.choice(L, L // 1000, replace=False)
        codes[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        nkmers = L - k + 1
        t0 = time.perf_counter()
        total = colsum = 0
        for start, m, by, popc, cs in A.stream_anchor_chunks(
                codes, nkmers, chunk, buf, t1, bd, nbytes, N, k,
                state=state):
            total += m
            colsum += int(cs[0])
        dt = time.perf_counter() - t0
        walls.append(dt)
        tag = "first (compile/load join)" if rep == 0 else "steady"
        print(f"rep {rep}: {dt:.2f}s = {L/dt/1e6:.2f} Mbp/s "
              f"({total/dt/1e6:.1f} M kmers/s) [{tag}]", flush=True)
    best = min(walls[1:])
    print(f"W={W} steady: {L/best/1e6:.2f} Mbp/s best of {args.reps} "
          f"({args.mbp} Mbp sequences, chunk 2^{args.chunk})")


if __name__ == "__main__":
    main()
