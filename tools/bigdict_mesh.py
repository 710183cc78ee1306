#!/usr/bin/env python
"""At-scale SHARDED dictionary demonstration (VERDICT r4 item 3 /
SURVEY §7.4.2): build a >= 1e8-aggregate-key range-sharded dictionary on
the 8-device virtual CPU mesh — the real sharded layout/probe/all_to_all
path at real D, not the toy sizes the unit tests carry — and verify the
anchored bytes match the single-device numpy oracle.

4 random genomes x 26 Mbp at k=21 give ~1.04e8 distinct aggregate keys
(random sequence is ~all-distinct at k=21).  Reports per-shard table
geometry next to check_hbm_budget's model so the `--mesh N` guard's
promise is backed by a measured point.

CPU-only (virtual devices): run anywhere, no accelerator needed:
    python tools/bigdict_mesh.py [--mbp 26] [--genomes 4] [--devices 8]
"""

import argparse
import os
import sys
import time

import numpy as np

os.environ["JAX_PLATFORMS"] = "cpu"
ndev_env = None
for i, a in enumerate(sys.argv):
    if a == "--devices" and i + 1 < len(sys.argv):
        ndev_env = sys.argv[i + 1]
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={ndev_env or 8}")

# also flip the live config before any backend use, in case jax was
# imported before the env var above was set
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=26.0)
    ap.add_argument("--genomes", type=int, default=4)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--anchor-mbp", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=21)
    args = ap.parse_args()

    import panagram_tpu  # noqa: F401

    from panagram_tpu.ops.anchor import rle2_colsums, unpack_rle2
    from panagram_tpu.ops.lookup import check_hbm_budget, mix64_np
    from panagram_tpu.ops.ref_impl import (
        anchor_np,
        canonical_kmers_np,
        masks_to_bytes_np,
        popcount_np,
    )
    from panagram_tpu.parallel import (
        make_halo_chunks,
        make_mesh,
        sharded_build_dictionary,
    )
    from panagram_tpu.parallel.shard import sharded_anchor_chunk

    k = args.k
    glen = int(args.mbp * 1e6)
    rng = np.random.default_rng(11)
    print(f"generating {args.genomes} x {args.mbp} Mbp random genomes...",
          flush=True)
    genomes = [rng.integers(0, 4, glen, dtype=np.uint8)
               for _ in range(args.genomes)]
    sets = []
    for g, codes in enumerate(genomes):
        canon, valid = canonical_kmers_np(codes, k)
        sets.append(np.unique(canon[valid]))
        print(f"  genome {g}: {len(sets[-1])} distinct", flush=True)
    total = sum(len(s) for s in sets)
    print(f"aggregate (with overlap): {total}", flush=True)

    mesh = make_mesh(args.devices)
    t0 = time.perf_counter()
    sbd, pan = sharded_build_dictionary(sets, mesh, ngenomes=args.genomes,
                                        k=k, return_host_dict=True)
    t_build = time.perf_counter() - t0
    D = len(pan.keys)
    print(f"sharded build: D={D} distinct keys across "
          f"{sbd.n_shards} shards in {t_build:.1f} s", flush=True)

    # ---- layout vs the HBM budget model ----------------------------------
    per_shard_rows = 1 << sbd.nbits
    per_shard_bytes = per_shard_rows * sbd.stride * 4
    print(f"per-shard table: [{per_shard_rows} buckets x {sbd.stride} u32] "
          f"= {per_shard_bytes/2**30:.2f} GiB; cap={sbd.cap} "
          f"(aggregate {sbd.n_shards * per_shard_bytes / 2**30:.2f} GiB)",
          flush=True)
    check_hbm_budget(D, sbd.nwords, n_shards=sbd.n_shards,
                     what="bigdict_mesh verification")
    print("check_hbm_budget: sharded layout fits its model", flush=True)

    # ---- dictionary correctness vs the host oracle -----------------------
    # host merge oracle: mixed-sorted distinct union with OR'd presence bits
    allk = np.concatenate(sets)
    gids = np.concatenate([np.full(len(s), g, np.int64)
                           for g, s in enumerate(sets)])
    mixed = mix64_np(allk)
    order = np.argsort(mixed, kind="stable")
    ms, gs = mixed[order], gids[order]
    starts = np.flatnonzero(np.concatenate([[True], ms[1:] != ms[:-1]]))
    want_keys = ms[starts]
    W = (args.genomes + 31) // 32
    want_masks = np.zeros((len(want_keys), W), np.uint32)
    seg = np.cumsum(np.concatenate([[False], ms[1:] != ms[:-1]]))
    np.bitwise_or.at(want_masks, (seg, gs // 32),
                     np.uint32(1) << (gs % 32).astype(np.uint32))
    assert np.array_equal(pan.keys, want_keys), "sharded keys != host oracle"
    assert np.array_equal(pan.masks, want_masks), "sharded masks != oracle"
    print(f"dictionary parity vs host oracle OK ({len(want_keys)} keys)",
          flush=True)

    # ---- anchor a slice through the sharded probe + all_to_all -----------
    nk_want = int(args.anchor_mbp * 1e6)
    seq_codes = genomes[0][: nk_want + k - 1]
    cpd = 1 << 18
    from panagram_tpu.ops.dictionary import PanKmerDict  # noqa: F401

    t0 = time.perf_counter()
    by_parts, popc_parts = [], []
    colsums = np.zeros(args.genomes, np.int64)
    nbytes = sbd.nbytes_row
    pos = 0
    while pos < nk_want:
        span = min(args.devices * cpd, nk_want - pos)
        chunks, nk = make_halo_chunks(
            seq_codes[pos: pos + span + k - 1], args.devices, k,
            chunk_per_dev=cpd)
        combined, counts, C = sharded_anchor_chunk(mesh, sbd, chunks,
                                                   capacity=cpd)
        comb = np.asarray(combined)
        cnts = np.asarray(counts)
        for dd in range(comb.shape[0]):
            real = min(max(nk - dd * C, 0), C)
            if real == 0:
                break
            by, popc = unpack_rle2(comb[dd], int(cnts[dd]), C, nbytes)
            by_parts.append(by[:real].copy())
            popc_parts.append(popc[:real].copy())
            colsums += rle2_colsums(comb[dd], int(cnts[dd]), C,
                                    args.genomes)
        pos += span
    t_anchor = time.perf_counter() - t0
    by = np.concatenate(by_parts)[:nk_want]
    popc = np.concatenate(popc_parts)[:nk_want]
    print(f"sharded anchor: {nk_want} positions in {t_anchor:.1f} s "
          f"({nk_want/t_anchor/1e6:.1f} M kmers/s on CPU devices)",
          flush=True)

    d_keys = np.sort(np.unique(np.concatenate(sets)))
    # oracle masks in canonical space
    od = np.argsort(mix64_np(d_keys), kind="stable")
    inv = np.empty_like(od)
    inv[od] = np.arange(len(od))
    want_rows = anchor_np(seq_codes, k, d_keys, want_masks[inv])
    assert np.array_equal(by, masks_to_bytes_np(want_rows, nbytes)), \
        "sharded anchored bytes != oracle"
    assert np.array_equal(popc, popcount_np(want_rows)), "popc mismatch"
    bits = np.unpackbits(want_rows.astype("<u4").view(np.uint8), axis=1,
                         bitorder="little")[:, : args.genomes]
    assert np.array_equal(colsums, bits.sum(axis=0)), "colsums mismatch"
    print("anchored byte parity vs single-device oracle OK", flush=True)
    print(f"RESULT D={D} shards={sbd.n_shards} "
          f"per_shard_gib={per_shard_bytes/2**30:.2f} "
          f"build_s={t_build:.1f} anchor_s={t_anchor:.1f}", flush=True)


if __name__ == "__main__":
    main()
