#!/usr/bin/env python
"""End-to-end scale run: one founder-structured pan-genome through the CLI path.

Generates a founder-structured pan-genome (default: the 30-genome k=31
row), builds the full index through the production CLI path
(pipeline.build_index with the device dictionary), and prints per-stage
wall times from the pipeline's benchmark TSVs plus aggregate rates
(Mbp/s anchoring, k-mers/s counting).

Usage: python tools/scale_run.py [--genomes 30] [--mbp 5] [--k 31]
                                 [--anchors 2] [--workdir DIR] [--keep]
"""

import argparse
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from panagram_tpu.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def write_fasta(path, name, codes, width=80):
    seq = np.frombuffer(b"ACGT", np.uint8)[codes]
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        for i in range(0, len(seq), width):
            f.write(seq[i: i + width].tobytes())
            f.write(b"\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=30)
    ap.add_argument("--mbp", type=float, default=5.0)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--anchors", type=int, default=2)
    ap.add_argument("--workdir", default="/tmp/panagram_scale")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    import panagram_tpu  # noqa: F401
    import jax

    from panagram_tpu.pipeline import build_index

    work = args.workdir
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "fa"))

    glen = int(args.mbp * 1e6)
    rng = np.random.default_rng(0)
    print(f"devices={jax.devices()}", flush=True)
    print(f"generating {args.genomes} x {args.mbp} Mbp "
          f"(founder-structured)...", flush=True)
    base = rng.integers(0, 4, glen, dtype=np.uint8)
    founders = []
    for f in range(4):
        mut = base.copy()
        pos = rng.choice(glen, glen // 100, replace=False)
        mut[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        founders.append(mut)
    names = []
    for g in range(args.genomes):
        mut = founders[g % 4].copy()
        pos = rng.choice(glen, glen // 1000, replace=False)
        mut[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
        name = f"g{g:02d}"
        write_fasta(os.path.join(work, "fa", f"{name}.fa"), "chr1", mut)
        names.append(name)

    anchors = names[: args.anchors]
    with open(os.path.join(work, "samples.tsv"), "w") as f:
        f.write("name\tfasta\n")
        for n in names:
            f.write(f"{n}\tfa/{n}.fa\n")

    t0 = time.perf_counter()
    idx = build_index(os.path.join(work, "samples.tsv"),
                      prefix=os.path.join(work, "idx"), k=args.k,
                      anchor_genomes=anchors, device_dict=True)
    wall = time.perf_counter() - t0
    total_mbp = args.genomes * args.mbp
    anchored_mbp = args.anchors * args.mbp

    print(f"\n=== scale run: {args.genomes} genomes x {args.mbp} Mbp, "
          f"k={args.k}, {args.anchors} anchors ===", flush=True)
    print(f"total wall: {wall:.1f} s "
          f"({total_mbp / wall:.2f} Mbp/s of input)", flush=True)

    logdir = os.path.join(work, "idx", "logs")
    stage_s = {}
    for fn in sorted(os.listdir(logdir)):
        if fn.endswith(".benchmark.txt"):
            with open(os.path.join(logdir, fn)) as f:
                f.readline()
                row = f.readline().split("\t")
            stage = fn.replace(".benchmark.txt", "")
            stage_s[stage] = float(row[0])
    count_s = sum(v for k_, v in stage_s.items() if k_.startswith("kmc."))
    anchor_s = sum(v for k_, v in stage_s.items() if k_.startswith("anchor."))
    dict_s = stage_s.get("dict", 0.0)
    if count_s:
        print(f"counting: {count_s:.1f} s "
              f"({total_mbp * 1e6 / max(count_s, 1e-9) / 1e6:.1f} M kmers/s)",
              flush=True)
    print(f"dictionary (count+merge on device): {dict_s:.1f} s "
          f"({total_mbp / max(dict_s + count_s, 1e-9):.2f} Mbp/s)",
          flush=True)
    print(f"anchoring ({args.anchors} genomes): {anchor_s:.1f} s "
          f"({anchored_mbp / max(anchor_s, 1e-9):.2f} Mbp/s)", flush=True)
    for stage, v in sorted(stage_s.items()):
        print(f"  {stage:28s} {v:8.1f} s", flush=True)

    print(f"index at {idx.prefix}", flush=True)
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
