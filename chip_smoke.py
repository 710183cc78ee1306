#!/usr/bin/env python3
"""Smoke test of the index build on one GPU, end to end, in ONE process.

Phases, in order:

1. device  -- JAX version and devices, the card's name and power limit
              (nvidia-smi); exits non-zero unless JAX's platform is 'gpu'.
2. build   -- writes 8 simulated A. thaliana chr1 genomes (30,427,671 bp
              each; 4 founders at ~1% SNP divergence, ~0.1% private SNPs per
              genome, N runs in g7) as FASTA from --seed, then runs
              `panagram_tpu index samples.tsv -k 31 --anchor-genomes g0 g7`
              twice: --device-dict, then the default builder.
3. verify  -- against an oracle built from the FASTAs alone with
              ops/ref_impl.py (sorted per-genome canonical k-mer sets,
              membership by binary search): three 100,000-position windows per
              anchored genome read back through Index.query_bitmap
              (including the chromosome end and an N run), step=100 against
              step=1[::100], byte-identical bitmaps from the two builds, and
              `bitdump` on a range.  All values are integers: exact equality.
4. kernels -- hand-written kernels against their plain references.  None
              exists: every device op of the build is compiled by XLA.

`--devices 4` runs instead, on the same input, only `index --mesh 4` with
`--mesh-strategy range` and `genomes` and a 1-card default build to compare
them with byte for byte, and checks that each card held a shard.

Run on a GPU host from the repository root:
    python chip_smoke.py              # one card
    python chip_smoke.py --devices 4  # four cards of one host

The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}};
any failure exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

GENOME_BP = 30_427_671        # A. thaliana TAIR10 chr1
N_GENOMES = 8
N_FOUNDERS = 4
K = 31
ANCHORS = ("g0", "g7")        # g7 carries the N runs
WINDOW = 100_000
CHROM = "chr1"
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------- input


def n_runs(length: int):
    """(start, length) of the assembly gaps written into g7."""
    scale = length / GENOME_BP
    return [(int(f * length), max(int(n * scale), 50))
            for f, n in ((0.2, 25_000), (0.5, 60_000), (0.8, 5_000))]


def make_genomes(workdir: str, seed: int, length: int):
    """Founder-structured genomes as FASTA + samples.tsv; returns the
    samples.tsv path."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, length, dtype=np.uint8)
    founders = []
    for _ in range(N_FOUNDERS):
        f = base.copy()
        pos = rng.choice(length, length // 100, replace=False)
        f[pos] = (f[pos] + rng.integers(1, 4, len(pos), dtype=np.uint8)) & 3
        founders.append(f)
    os.makedirs(os.path.join(workdir, "fa"), exist_ok=True)
    rows = []
    for g in range(N_GENOMES):
        codes = founders[g % N_FOUNDERS].copy()
        pos = rng.choice(length, length // 1000, replace=False)
        codes[pos] = (codes[pos]
                      + rng.integers(1, 4, len(pos), dtype=np.uint8)) & 3
        if f"g{g}" == ANCHORS[1]:
            for s, n in n_runs(length):
                codes[s:s + n] = 4
        path = os.path.join(workdir, "fa", f"g{g}.fa")
        write_fasta(path, codes)
        rows.append(f"g{g}\t{path}")
    samples = os.path.join(workdir, "samples.tsv")
    with open(samples, "w") as f:
        f.write("name\tfasta\n" + "\n".join(rows) + "\n")
    return samples


def write_fasta(path: str, codes: np.ndarray, width: int = 60):
    seq = np.frombuffer(b"ACGTN", np.uint8)[codes]
    pad = (-len(seq)) % width
    lines = np.concatenate([seq, np.zeros(pad, np.uint8)]).reshape(-1, width)
    lines = np.concatenate(
        [lines, np.full((len(lines), 1), ord("\n"), np.uint8)], axis=1)
    body = lines.reshape(-1).tobytes()
    if pad:
        body = body[: -(pad + 1)] + b"\n"
    with open(path, "wb") as f:
        f.write(f">{CHROM}\n".encode() + body)


def read_fasta_codes(path: str) -> np.ndarray:
    """The single record of a smoke FASTA as base codes (A=0 .. T=3, N=4),
    parsed here rather than by the package under test."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    assert lines[0] == f">{CHROM}".encode()
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    return lut[np.frombuffer(b"".join(lines[1:]), np.uint8)]


# ---------------------------------------------------------------- phases


def device_phase(want: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"device: jax {jax.__version__}, platform={d.platform}, "
        f"kind={d.device_kind}, count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    if d.platform != "gpu":
        sys.exit(f"chip_smoke: JAX platform is {d.platform!r}, not 'gpu'")
    if len(devs) < want:
        sys.exit(f"chip_smoke: {want} cards needed, JAX sees {len(devs)}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def run_cli(argv):
    from panagram_tpu.__main__ import main

    log(f"$ panagram_tpu {' '.join(argv)}")
    t0 = time.perf_counter()
    main(list(argv))
    log(f"  wall {time.perf_counter() - t0:.1f} s")


def stage_walls(prefix: str):
    logdir = os.path.join(prefix, "logs")
    for fn in sorted(os.listdir(logdir)):
        if fn.endswith(".benchmark.txt"):
            with open(os.path.join(logdir, fn)) as f:
                f.readline()
                secs = float(f.readline().split("\t")[0])
            log(f"  stage {fn[:-len('.benchmark.txt')]:<16s} {secs:9.2f} s")


def report_dict(prefix: str, device_layout, peak_of: str):
    """Keys, table bytes, and the card's peak memory (process-wide, so
    `peak_of` says which builds it covers) next to check_hbm_budget's
    model of this dictionary."""
    import jax

    from panagram_tpu.ops.dictionary import PanKmerDict
    from panagram_tpu.ops.lookup import hbm_need_bytes, table_geometry

    d = PanKmerDict.load(os.path.join(prefix, "kmc", "pandict.npz"))
    D, W = len(d.keys), d.nwords
    nbits, cap, stride = table_geometry(D, W)
    table, layout = hbm_need_bytes(D, W, device_layout=device_layout)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  dictionary: {D:,} keys x {W} word(s); bucket table "
        f"2^{nbits} x {stride} u32 = {(1 << nbits) * stride * 4:,} bytes")
    log(f"  device peak_bytes_in_use ({peak_of}) "
        f"{stats.get('peak_bytes_in_use', 0):,} "
        f"vs check_hbm_budget model {table + layout:,} "
        f"(table {table:,} + layout {layout:,}, layout={device_layout})")
    return D


def windows(nk: int, length: int):
    """Three window starts (multiples of 100, so step=100 rows align)."""
    w = min(WINDOW, nk // 10)
    gap_s, _ = n_runs(length)[1]
    starts = [(nk // 3) // 100 * 100,
              max(gap_s - w // 5, 0) // 100 * 100,
              (nk - w) // 100 * 100]
    return [(s, min(s + w, nk)) for s in starts]


def genome_kmer_set(path: str, block: int = 1 << 20) -> np.ndarray:
    """Sorted distinct canonical k-mers of one FASTA: ref_impl's
    canonical_kmers_np over 1M-position blocks (so its per-base
    temporaries stay small and are reused), then a sort and a neighbour
    compare (np.unique and np.isin take minutes at this size with some
    NumPy versions)."""
    from panagram_tpu.ops.ref_impl import canonical_kmers_np

    codes = read_fasta_codes(path)
    n = len(codes) - K + 1
    out = np.empty(n, np.uint64)
    m = 0
    for s in range(0, n, block):
        canon, valid = canonical_kmers_np(codes[s:min(s + block, n) + K - 1],
                                          K)
        hits = canon[valid]
        out[m:m + len(hits)] = hits
        m += len(hits)
    keys = np.sort(out[:m])
    return keys[np.concatenate([[True], keys[1:] != keys[:-1]])]


def oracle_bits(fastas, anchor_codes, wins):
    """Expected presence rows for every (anchor, window), from the FASTAs
    alone: per-genome sorted canonical sets, membership by binary search
    (np.searchsorted)."""
    from panagram_tpu.ops.ref_impl import canonical_kmers_np

    queries, valids, spans = [], [], []
    for a, codes in anchor_codes.items():
        for s, e in wins:
            c, v = canonical_kmers_np(codes[s:e + K - 1], K)
            spans.append((a, s, e, len(queries)))
            queries.append(c)
            valids.append(v)

    def member(path):
        genome_set = genome_kmer_set(path)
        last = len(genome_set) - 1
        return [(genome_set[np.minimum(np.searchsorted(genome_set, q), last)]
                 == q) & ok for q, ok in zip(queries, valids)]

    with ThreadPoolExecutor(4) as ex:
        cols = list(ex.map(member, fastas))
    return {(a, s, e): np.stack([col[i] for col in cols], axis=1)
            .astype(np.int64) for a, s, e, i in spans}


def verify_phase(prefixes, samples, length):
    from panagram_tpu.index import Index

    with open(samples) as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    fastas = [p for _, p in rows]
    anchor_codes = {a: read_fasta_codes(dict(rows)[a]) for a in ANCHORS}
    nk = length - K + 1
    wins = windows(nk, length)
    t0 = time.perf_counter()
    want = oracle_bits(fastas, anchor_codes, wins)
    log(f"verify: oracle from {len(fastas)} FASTAs in "
        f"{time.perf_counter() - t0:.1f} s")

    idx = Index(prefixes[0])
    try:
        for (a, s, e), exp in want.items():
            got = idx.query_bitmap(a, CHROM, s, e, 1).to_numpy()
            if not np.array_equal(got, exp):
                bad = np.argwhere(got != exp)[:5].tolist()
                raise AssertionError(
                    f"{a}:{s}-{e} differs from the oracle at {bad}")
            low = idx.query_bitmap(a, CHROM, s, e, 100).to_numpy()
            if not np.array_equal(low, got[::100]):
                raise AssertionError(f"{a}:{s}-{e} step=100 != step=1[::100]")
            log(f"  {a}:{s}-{e} == oracle ({exp.sum():,} bits set, "
                f"{int((exp.sum(axis=1) == 0).sum()):,} empty rows); "
                f"step=100 == step=1[::100]")
        # the N run must read back as empty rows in g7's own windows, and
        # as g7's missing bit in g0's
        gap_s, gap_n = n_runs(length)[1]
        g7 = want[(ANCHORS[1], *wins[1])]
        in_gap = slice(gap_s - wins[1][0], gap_s - wins[1][0] + gap_n - K)
        assert (g7[in_gap] == 0).all() and g7.any()
        g0 = want[(ANCHORS[0], *wins[1])]
        assert g0[in_gap, 7].sum() == 0 and g0[in_gap, 0].all()
    finally:
        idx.close()

    for a in ANCHORS:
        for step in (1, 100):
            files = [os.path.join(p, "anchor", a, f"bitmap.{step}.gz")
                     for p in prefixes]
            blobs = [open(f, "rb").read() for f in files]
            if blobs[0] != blobs[1]:
                raise AssertionError(f"{files[0]} != {files[1]}")
            log(f"  {a} bitmap.{step}.gz byte-identical across builds "
                f"({len(blobs[0]):,} bytes)")

    s = gap_s - K - 5      # rows turn empty where k-mers reach the gap
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        from panagram_tpu.__main__ import main

        main(["bitdump", prefixes[1], ANCHORS[1], CHROM, str(s),
              str(s + 10), "-v"])
    lines = out.getvalue().strip().splitlines()
    got = np.array([[int(x) for x in ln.split()] for ln in lines[1:]])
    exp = want[(ANCHORS[1], *wins[1])][s - wins[1][0]: s - wins[1][0] + 10]
    if lines[0].split() != [f"g{g}" for g in range(N_GENOMES)] \
            or not np.array_equal(got, exp):
        raise AssertionError(f"bitdump {s}-{s + 10}:\n{out.getvalue()}")
    log(f"  bitdump {ANCHORS[1]} {CHROM} {s} {s + 10} == oracle")


def mesh_phase(samples, work):
    """--mesh 4 (range, genomes) against a 1-card default build.  The mesh
    builds resume from the 1-card build's per-genome k-mer sets (counting
    runs on one card in every mode); their dictionary merge, layout and
    anchoring run on the mesh."""
    import jax

    ref = os.path.join(work, "one")
    args = ["index", samples, "-k", str(K), "--anchor-genomes", *ANCHORS]
    run_cli(args + ["-o", ref])
    stage_walls(ref)
    outs = {}
    for strategy in ("range", "genomes"):
        prefix = os.path.join(work, f"mesh_{strategy}")
        os.makedirs(os.path.join(prefix, "kmc"))
        for fn in os.listdir(os.path.join(ref, "kmc")):
            if fn.endswith(".kmers.npz"):
                shutil.copy(os.path.join(ref, "kmc", fn),
                            os.path.join(prefix, "kmc", fn))
        run_cli(args + ["-o", prefix, "--mesh", "4",
                        "--mesh-strategy", strategy])
        stage_walls(prefix)
        outs[strategy] = prefix
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()[:4]]
    log(f"  per-card peak_bytes_in_use: {peaks}")
    # cards 1-3 only ever held mesh shards (the 1-card build uses card 0);
    # a backend without memory stats (the CPU rehearsal) cannot say
    if None not in peaks and min(peaks[1:]) < (256 << 20):
        raise AssertionError(f"shards did not land on all four cards: {peaks}")
    for strategy, prefix in outs.items():
        for a in ANCHORS:
            for name in ("bitmap.1.gz", "bitmap.100.gz", "chrs.tsv",
                         "bitsum.bins.tsv"):
                x = open(os.path.join(ref, "anchor", a, name), "rb").read()
                y = open(os.path.join(prefix, "anchor", a, name), "rb").read()
                if x != y:
                    raise AssertionError(
                        f"--mesh 4 --mesh-strategy {strategy}: {a}/{name} "
                        "differs from the 1-card build")
        log(f"  --mesh-strategy {strategy}: bitmaps, chrs, bins "
            "byte-identical to the 1-card build")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(HERE, ".smoke"),
                    help="scratch directory for the FASTAs and indexes "
                         "(emptied first, removed at the end)")
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cuda"      # no silent CPU fallback
    device = device_phase(args.devices)

    import panagram_tpu  # noqa: F401  (x64 on)
    from panagram_tpu.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    shutil.rmtree(args.workdir, ignore_errors=True)
    t0 = time.perf_counter()
    samples = make_genomes(args.workdir, args.seed, GENOME_BP)
    log(f"input: {N_GENOMES} x {GENOME_BP:,} bp FASTA (seed {args.seed}) "
        f"in {time.perf_counter() - t0:.1f} s")
    try:
        if args.devices == 4:
            mesh_phase(samples, args.workdir)
        else:
            prefixes = [os.path.join(args.workdir, "idx_default"),
                        os.path.join(args.workdir, "idx_devdict")]
            base = ["index", samples, "-k", str(K),
                    "--anchor-genomes", *ANCHORS]
            # --device-dict first: the card's peak is process-wide, so only
            # the first build's line shows that build's own peak
            log("build: --device-dict")
            run_cli(base + ["-o", prefixes[1], "--device-dict"])
            stage_walls(prefixes[1])
            report_dict(prefixes[1], "sorted", "this build")
            log("build: default builder")
            run_cli(base + ["-o", prefixes[0]])
            stage_walls(prefixes[0])
            report_dict(prefixes[0], True, "max over both builds")
            verify_phase(prefixes, samples, GENOME_BP)
            log("kernels: none hand-written (every device op is XLA's); "
                "nothing to compare")
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
