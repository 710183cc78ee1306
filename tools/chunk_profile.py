#!/usr/bin/env python
"""Device-time profile of one anchor chunk against a full-size table.

Builds a bucket table of --keys uniform mixed keys (the geometry of a
dictionary that size: 7e7 keys is the 8 x A. thaliana chr1 k=31 smoke
index), with every k-mer of one random 2^22-position chunk present, then
times and traces on the GPU:

  chunk  -- anchor_chunk_rle2, the fused program Genome.run_anchor runs
  query  -- ops.anchor._query_packed: codec + probe
  pack   -- mix64(pack_kmers_packed): the codec alone
  probe  -- lookup.bucket_query on precomputed k-mers

Each is reported as its median wall time (block_until_ready) and its
device time summed from a jax.profiler trace, with the kernels that take
most of the chunk.  The probe's bytes (Q gathered table rows + Q x W
result words + Q input keys) over its device time give its share of the
card's published memory bandwidth.

Run as the only process on the card:
    python tools/chunk_profile.py [--keys 70000000] [--genomes 8]
"""

import argparse
import glob
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# published memory bandwidth by device_kind (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def build_table(n_keys: int, ngenomes: int, k: int, chunk: int, seed: int):
    """(BucketedDict, inbuf, L, canon): a table of n_keys keys that holds
    every canonical k-mer of one random chunk, and that chunk's packed
    input buffer."""
    import jax
    import jax.numpy as jnp

    from panagram_tpu.ops.anchor import pack_bases_combined
    from panagram_tpu.ops.codec import pack_kmers
    from panagram_tpu.ops.lookup import BucketedDict, mix64

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, chunk + k - 1, dtype=np.uint8)
    canon, _ = pack_kmers(jnp.asarray(codes), k)
    mine = jnp.unique(mix64(canon))
    rand = jax.random.bits(jax.random.key(seed), (n_keys - mine.shape[0],),
                           jnp.uint64)
    keys = jnp.concatenate([mine, rand])
    masks = jax.random.bits(jax.random.key(seed + 1), (n_keys, 1),
                            jnp.uint32) & jnp.uint32((1 << ngenomes) - 1)
    bd = BucketedDict.build_device(keys, masks, ngenomes, k, mixed=True,
                                   count=n_keys)
    inbuf, L = pack_bases_combined(codes)
    return bd, jnp.asarray(inbuf), L, canon


def timed(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def device_kernels(fn, reps: int):
    """Per-kernel device nanoseconds of `reps` calls, from a profiler
    trace: {kernel name: ns} summed over the GPU planes."""
    import jax

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as tdir:
        with jax.profiler.trace(tdir):
            for _ in range(reps):
                jax.block_until_ready(fn())
        (path,) = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True)
        prof = jax.profiler.ProfileData.from_file(path)
    out: dict = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # XLA ops line duplicates the kernels line on GPU planes
            if "XLA Ops" in line.name or "Modules" in line.name:
                continue
            for ev in line.events:
                out[ev.name] = out.get(ev.name, 0) + ev.duration_ns
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=70_000_000)
    ap.add_argument("--genomes", type=int, default=8)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--chunk-log2", type=int, default=22)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import panagram_tpu  # noqa: F401
    import jax

    from panagram_tpu.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chunk_profile: no GPU (platform {dev.platform!r})")
    peak = PEAK_BYTES_PER_S[dev.device_kind]

    from panagram_tpu.ops.anchor import _query_packed, anchor_chunk_rle2
    from panagram_tpu.ops.codec import pack_kmers_packed
    from panagram_tpu.ops.lookup import bucket_query, mix64

    chunk, k, N = 1 << args.chunk_log2, args.k, args.genomes
    bd, ib, L, canon = build_table(args.keys, N, k, chunk, args.seed)
    (table,) = bd.device_arrays()
    W, nbytes = bd.nwords, (N + 7) // 8
    print(f"device {dev.device_kind}; table {tuple(table.shape)} u32 "
          f"(2^{bd.nbits} buckets x stride {bd.stride}, cap {bd.cap}); "
          f"chunk {chunk} positions", flush=True)

    n4 = (L + 3) // 4
    packed, nmask = ib[:n4], ib[n4:]
    progs = {
        "chunk": lambda: anchor_chunk_rle2(ib, table, L, k, bd.nbits,
                                           bd.cap, W, nbytes, chunk),
        "query": jax.jit(lambda p, n, t: _query_packed(
            p, n, L, k, t, bd.nbits, bd.cap, W)),
        "pack": jax.jit(lambda p, n: mix64(pack_kmers_packed(p, n, L, k)[0])),
        "probe": lambda: bucket_query(canon, table, bd.nbits, bd.cap, W),
    }
    calls = {"chunk": progs["chunk"],
             "query": lambda: progs["query"](packed, nmask, table),
             "pack": lambda: progs["pack"](packed, nmask),
             "probe": progs["probe"]}
    dev_ns = {}
    for name, fn in calls.items():
        wall = timed(fn, args.reps)
        kern = device_kernels(fn, 5)
        dev_ns[name] = sum(kern.values()) / 5
        print(f"{name:6s} wall {wall * 1e3:8.3f} ms   device "
              f"{dev_ns[name] / 1e6:8.3f} ms", flush=True)
        if name == "chunk":
            for kname, ns in sorted(kern.items(), key=lambda x: -x[1])[:12]:
                print(f"    {ns / 5 / 1e6:8.3f} ms  {kname[:90]}", flush=True)

    Q = chunk
    pack = table.shape[1] // bd.stride
    probe_bytes = Q * (table.shape[1] * 4 + W * 4 + 8)
    t = dev_ns["probe"] / 1e9
    print(f"probe: {probe_bytes / 1e9:.3f} GB moved (rows of {pack} "
          f"bucket(s) x {bd.stride} u32) in {t * 1e3:.3f} ms = "
          f"{probe_bytes / t / 1e9:.1f} GB/s, {probe_bytes / t / peak:.1%} "
          f"of {peak / 1e12:.2f} TB/s; {dev_ns['probe'] / dev_ns['chunk']:.1%}"
          " of the chunk's device time", flush=True)


if __name__ == "__main__":
    main()
