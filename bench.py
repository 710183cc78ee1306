"""Benchmark: anchoring throughput (the north-star hot loop).

Measures the streamed anchor pipeline — 2-bit packed host->device transfer,
canonical k-mer packing, bucketed-hash dictionary lookup (one wide HBM
gather per probe), popcount, and run-length-compacted device->host output —
on the GPU, and compares against a CPU implementation of the same
computation (the C++ hash anchorer in panagram_tpu/native, standing in for
the reference's KMC + cpp/run_anchor path, whose KMC binaries are not
shipped with the reference).  Exits non-zero when JAX finds no GPU: a
number from any other backend is not a device number.

Prints ONE JSON line:
  {"metric": "anchor_kmers_per_s", "value": N, "unit": "kmers/s",
   "vs_baseline": N / cpu_reference_kmers_per_s, ...,
   "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

import json
import os
import sys
import time

import numpy as np


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    quick = "--quick" in sys.argv

    import panagram_tpu  # noqa: F401  (x64 on)
    import jax

    from panagram_tpu.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX platform {dev.platform!r}); "
                 "refusing to report a device number")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    from panagram_tpu.ops.anchor import rle_proto, stream_anchor_chunks
    from panagram_tpu.ops.lookup import BucketedDict

    k = 21
    ngenomes = 30
    seq_len = 1 << (20 if quick else 25)          # anchor sequence (bp)
    dict_genome_len = 1 << (18 if quick else 21)  # per-genome source length
    # chunk log2 override for chunk-size experiments
    chunk = 1 << int(os.environ.get("PANAGRAM_TPU_BENCH_CHUNK_LOG2",
                                    18 if quick else 22))

    rng = np.random.default_rng(0)
    _log(f"bench: devices={jax.devices()} quick={quick}")

    # dictionary from 30 related genomes (1% divergence).  Setup is untimed:
    # use the numpy oracle (fast, no accelerator compiles) — the benchmark
    # proper is the anchoring loop below.
    from panagram_tpu.ops.ref_impl import build_dict_np, canonical_kmers_np

    # founder/haplotype structure: genomes share variant blocks (real
    # pangenomes are haplotype-structured; fully independent per-genome
    # mutations would be adversarial noise), plus small private variation.
    base = rng.integers(0, 4, dict_genome_len, dtype=np.uint8)
    founders = []
    for f in range(4):
        mut = base.copy()
        pos = rng.choice(dict_genome_len, dict_genome_len // 100, replace=False)
        mut[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        founders.append(mut)
    genomes = []
    for g in range(ngenomes):
        mut = founders[g % 4].copy()
        n_priv = dict_genome_len // 1000
        pos = rng.choice(dict_genome_len, n_priv, replace=False)
        mut[pos] = rng.integers(0, 4, n_priv, dtype=np.uint8)
        genomes.append(mut)
    sets = []
    for mut in genomes:
        canon, valid = canonical_kmers_np(mut, k)
        sets.append(np.unique(canon[valid]))
    keys, masks = build_dict_np(sets)

    from panagram_tpu.ops.dictionary import PanKmerDict

    d = PanKmerDict(keys, masks, ngenomes, k)
    _log(f"bench: dict {len(d)} keys x {d.nwords} words")

    bd = BucketedDict.build(d.keys, d.masks, ngenomes, k)
    (t1,) = bd.device_arrays()
    nbytes = d.nbytes_row
    _log(f"bench: bucketed {bd.table.shape} stride {bd.stride}")

    # anchor sequence: genome 0 tiled to seq_len
    reps = -(-seq_len // dict_genome_len)
    anchor_codes = np.tile(genomes[0], reps)[:seq_len]

    _log(f"bench: rle protocol v{rle_proto(nbytes)}")

    # run-count/palette hints PERSIST across reps (in `state`): with
    # PIPELINE_DEPTH chunks in flight, every dispatch before the first
    # drain would otherwise fall back to the hint=None total//8 prefix.
    # The warmup rep establishes the real count; timed reps then ship ~12%
    # over it.
    state = {}
    trace = os.environ.get("PANAGRAM_BENCH_TRACE") == "1"
    buf = np.full(chunk + k - 1, 255, np.uint8)

    def run_once():
        # the exact product engine (Genome.run_anchor drives the same
        # generator): bounded dispatch-ahead pipeline with async prefix
        # d2h pieces sized by the observed counts
        total = 0
        for _start, m, _by, _popc, _cs in stream_anchor_chunks(
                anchor_codes, seq_len - k + 1, chunk, buf, t1, bd,
                nbytes, ngenomes, k, state=state, trace=trace):
            total += m
        return total

    run_once()  # compile + warm
    _log("bench: warmup done")

    # device parity spot-check vs the numpy oracle: the unit tests run on
    # the CPU backend — this catches GPU-side miscompiles before reporting
    # a number
    from panagram_tpu.ops.ref_impl import anchor_np, masks_to_bytes_np

    p_n = min(1 << 17, seq_len - k + 1)
    got = np.concatenate([by.copy() for _s, _m, by, _p, _c in
                          stream_anchor_chunks(
                              anchor_codes[: p_n + k - 1], p_n, chunk, buf,
                              t1, bd, nbytes, ngenomes, k,
                              state=dict(state))])
    want = anchor_np(anchor_codes[: p_n + k - 1], k, d.keys, d.masks)
    assert np.array_equal(got, masks_to_bytes_np(want, nbytes)), \
        "device/oracle bitmap mismatch"
    _log("bench: device parity vs oracle OK")
    # best-of-3: the host is shared and noisy — the best rep is the
    # steady-state capability; the same policy is applied to the CPU
    # baseline below so the ratio stays fair
    reps = 1 if quick else 3
    device_rate = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        total = run_once()
        dt = time.perf_counter() - t0
        device_rate = max(device_rate, total / dt)
        _log(f"bench: device rep {total/dt/1e6:.2f} Mkmers/s")
    _log(f"bench: device {device_rate/1e6:.2f} Mkmers/s")

    # device-COMPUTE-only rate: the fused RLE chunk program alone
    # (dispatch -> block_until_ready, inputs resident, no transfers or
    # host decode).
    import jax.numpy as jnp

    from panagram_tpu.ops.anchor import (
        anchor_chunk_rle2,
        anchor_chunk_rle4,
        pack_bases_combined,
        pal_work_for,
    )

    inbuf, L = pack_bases_combined(anchor_codes[: chunk + k - 1])
    ib = jnp.asarray(inbuf)
    jax.block_until_ready(ib)
    pal_work = pal_work_for(chunk)

    if rle_proto(nbytes) == 4:
        def compute_once():
            out = anchor_chunk_rle4(ib, t1, L, k, bd.nbits, bd.cap,
                                    bd.nwords, nbytes, pal_work)
            jax.block_until_ready(out)
    else:
        def compute_once():
            out = anchor_chunk_rle2(ib, t1, L, k, bd.nbits, bd.cap,
                                    bd.nwords, nbytes, chunk)
            jax.block_until_ready(out)

    compute_once()  # already compiled by the streamed runs; warm anyway
    compute_rate = 0.0
    for _ in range(max(reps, 3)):
        t0 = time.perf_counter()
        compute_once()
        compute_rate = max(compute_rate,
                           (L - k + 1) / (time.perf_counter() - t0))
    _log(f"bench: device-compute-only {compute_rate/1e6:.2f} Mkmers/s "
         f"(fused rle chunk, no transfers)")

    # CPU baseline: the multithreaded C++ open-addressed-hash anchorer
    # (panagram_tpu/native/anchor_cpu.cpp) standing in for KMC +
    # cpp/run_anchor — strictly FAVOURABLE to the reference (hash probe
    # beats KMC's prefix/suffix binary search), so vs_baseline is an
    # honest-or-pessimistic ratio.
    ncores = os.cpu_count() or 1
    cpu_len = (1 << 18 if quick else seq_len) - k + 1
    try:
        from panagram_tpu.native.anchor_cpu import CpuAnchorer

        ca = CpuAnchorer(d.keys, d.masks)
        # same buffer-reuse courtesy as the device loop (both sides of
        # the ratio get persistent, pre-touched outputs)
        cpu_b = np.empty((cpu_len, nbytes), np.uint8)
        cpu_p = np.empty(cpu_len, np.int32)
        cpu_b.fill(0)
        cpu_p.fill(0)
        cpu_rate = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            ca.anchor(anchor_codes[: cpu_len + k - 1], k, nbytes,
                      threads=ncores, out=(cpu_b, cpu_p))
            cpu_rate = max(cpu_rate, cpu_len / (time.perf_counter() - t0))
        _log(f"bench: cpu baseline (C++ hash, {ncores} threads) "
             f"{cpu_rate/1e6:.2f} Mkmers/s")
    except OSError:
        _log("bench: WARNING libanchor_cpu.so not built "
             "(make -C panagram_tpu/native); falling back to numpy")
        from panagram_tpu.ops.ref_impl import (
            anchor_np,
            masks_to_bytes_np,
            popcount_np,
        )

        sample = 1 << 16 if quick else 1 << 19
        seq = "".join("ACGT"[c] for c in anchor_codes[: sample + k - 1])
        t0 = time.perf_counter()
        rows = anchor_np(seq, k, d.keys, d.masks)
        _ = masks_to_bytes_np(rows, nbytes)
        _ = popcount_np(rows)
        cpu_rate = sample / (time.perf_counter() - t0)
        _log(f"bench: numpy fallback {cpu_rate/1e6:.2f} Mkmers/s")

    print(json.dumps({
        "metric": "anchor_kmers_per_s",
        "value": round(device_rate),
        "unit": "kmers/s",
        "vs_baseline": round(device_rate / cpu_rate, 3),
        "device_compute_kmers_per_s": round(compute_rate),
        "device": device,
    }))


if __name__ == "__main__":
    main()
