"""Index-build driver: the explicit stage DAG replacing Snakemake.

The reference orchestrates its build with Snakemake over external KMC/mash
processes (reference workflow/Snakefile; SURVEY §2.7 P1).  Here the stages
run in-process on the device engine, with the same file-based caching/resume
property: a stage is skipped when its outputs exist and are newer than its
inputs (SURVEY §5.3-5.4), and per-stage wall-clock telemetry is written to
logs/*.benchmark.txt like Snakemake's `benchmark:` directives (SURVEY §5.1).

Stage DAG (mirrors rules kmc_count -> opdefs/kmc_bitvec -> anchor plus
mash_sample/mash_triangle):

  count[g]   per-genome distinct canonical k-mer set  -> kmc/<g>.kmers.npz
  dict       merged presence-mask dictionary          -> kmc/pandict.npz
  anchor[g]  per-anchor bitmaps + summaries           -> anchor/<g>/*
  dist       exact-Jaccard genome distances           -> genome_dist.tsv
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from .distances import write_genome_dist
from .index import Index, init_logger
from .io.fasta import iter_fasta, seq_to_codes
from .ops.count import counted_kmers_chunked, distinct_kmers_chunked
from .ops.dictionary import PanKmerDict, build_dictionary

logger = logging.getLogger(__name__)

FASTQ_EXTS = (".fastq", ".fastq.gz", ".fq", ".fq.gz")


def _benchmark(prefix: str, name: str, t0: float):
    os.makedirs(os.path.join(prefix, "logs"), exist_ok=True)
    s = time.time() - t0
    hms = time.strftime("%H:%M:%S", time.gmtime(s))
    with open(os.path.join(prefix, "logs", f"{name}.benchmark.txt"), "w") as f:
        f.write("s\th:m:s\n")
        f.write(f"{s:.4f}\t{hms}\n")


def _outputs_fresh(outputs, inputs) -> bool:
    if not outputs or not all(os.path.exists(o) for o in outputs):
        return False
    out_mtime = min(os.path.getmtime(o) for o in outputs)
    in_mtime = max(
        (os.path.getmtime(i) for i in inputs if i and os.path.exists(i)), default=0
    )
    return out_mtime >= in_mtime


def _iter_fastq(path):
    import gzip

    opn = gzip.open if str(path).endswith(".gz") else open
    with opn(path, "rt") as f:
        while True:
            h = f.readline()
            if not h:
                break
            seq = f.readline().strip()
            f.readline()
            f.readline()
            if seq:
                yield "read", seq


def _sequence_size_estimate(path) -> int:
    """Decompressed byte size of a (possibly gzipped) sequence file.

    For .gz files, read the ISIZE trailer (uncompressed length mod 2^32);
    when that is implausibly small vs the compressed size (a >4 GB genome
    wrapped around, or a multi-member file) fall back to 4x compressed."""
    raw = os.path.getsize(path)
    if not str(path).endswith(".gz"):
        return raw
    try:
        with open(path, "rb") as f:
            f.seek(-4, os.SEEK_END)
            isize = int.from_bytes(f.read(4), "little")
        if isize >= raw // 2:
            return isize
    except OSError:
        pass
    return raw * 4


def count_genome(index: Index, name: str, force=False) -> str:
    """Stage count[g]: distinct canonical k-mers of one genome.

    Role of `kmc -ci1 -fm` for FASTA and `-ci2 -fq` for FASTQ (reference
    workflow/Snakefile:81-110): FASTQ k-mers must occur >= 2 times to drop
    sequencing errors."""
    out = index.kmer_set_fname(name)
    g = index.genomes[name]
    fasta = g._fasta_path
    if not force and index.conf.kmc.use_existing and os.path.exists(out):
        return out
    if not force and _outputs_fresh([out], [fasta]):
        return out

    t0 = time.time()
    os.makedirs(index.kmer_dir, exist_ok=True)
    k = index.k

    if str(fasta).endswith(FASTQ_EXTS):
        # KMC `-ci2 -fq` semantics (reference workflow/Snakefile:88): reads
        # stream through the device sort+count kernel in fixed-size chunks;
        # host memory is bounded by distinct keys, not the read multiset
        codes = (seq_to_codes(seq) for _, seq in _iter_fastq(fasta))
        kmers = counted_kmers_chunked(codes, k, min_count=2)
    else:
        codes = (seq_to_codes(seq) for _, seq in iter_fasta(fasta))
        kmers = distinct_kmers_chunked(codes, k)
    # atomic write: a distributed peer may np.load this the moment its
    # barrier opens — it must never observe a partially-written file
    tmp = out + f".tmp.{os.getpid()}"
    np.savez(tmp, kmers=kmers, k=k)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", out)
    _benchmark(index.prefix, f"kmc.{name}", t0)
    logger.info(f"counted {name}: {len(kmers)} distinct {k}-mers")
    return out


def build_dict_device(index: Index, force=False) -> str:
    """Alternative count+dict stage: stream every genome through the
    device-resident builder (ops/devdict.py) — no per-genome set files,
    nothing leaves HBM until the final dictionary is saved.  Used with
    --device-dict; resume granularity is the whole dictionary."""
    out = index.dict_fname
    fastas = [index.genomes[n]._fasta_path for n in index.genome_names]
    if not force and _outputs_fresh([out], fastas):
        return out
    t0 = time.time()
    os.makedirs(index.kmer_dir, exist_ok=True)

    from .ops.devdict import DeviceDictBuilder

    # upper bound on distinct canonical k-mers: the largest genome plus
    # divergence headroom (the union is far below the sum for related
    # genomes); the builder grows if the estimate is exceeded.  For
    # gzipped FASTA the file size is ~4x too small a proxy, which would
    # defeat the compile-exactly-once capacity — use the real
    # decompressed length instead (gzip ISIZE trailer, exact below 4 GB)
    size_by_name = {}
    for n in index.genome_names:
        f = index.genomes[n]._fasta_path
        if f and os.path.exists(f):
            size_by_name[n] = _sequence_size_estimate(f)
    sizes = list(size_by_name.values())
    hint = int(max(sizes) * 1.5) if sizes else None

    b = DeviceDictBuilder(index.k, index.ngenomes, capacity_hint=hint)
    # fire every compile this stage AND the anchor stage will need on the
    # prewarm pool NOW, so they overlap each other and the FASTA streaming
    # below (ops/prewarm.py)
    if b.keys is not None:
        from .ops.prewarm import prewarm_anchor_programs, prewarm_dict_programs

        kmer_counts = [max(s - index.k + 1, 1) for s in sizes]
        prewarm_dict_programs(index.k, index.ngenomes, b.chunk,
                              b.keys.shape[0], kmer_counts)
        # anchor-table geometry from bracketed D estimates (pow2-quantized
        # layouts make the bracket forgiving; a miss only wastes compile
        # time).  hint is max-genome x 1.5; the union across genomes lands
        # between hint and a few x hint.
        from .index import ANCHOR_CHUNK

        # warm the pow2 chunk sizes the anchors will actually use
        # (Genome._anchor_chunk): the genome size bounds its largest
        # chromosome, so {est, est/2} brackets the real pick
        amax = max((size_by_name.get(n, 0)
                    for n in index.anchor_genomes), default=0)
        est = min(ANCHOR_CHUNK,
                  max(1 << 18, 1 << max(int(np.ceil(np.log2(
                      max(amax, 2)))), 1)))
        # est first: it is the size the anchors will actually use, and
        # pool slots are finite — duplicate submits are deduped globally
        for ch in ([est] + ([ANCHOR_CHUNK] if ANCHOR_CHUNK != est else [])):
            prewarm_anchor_programs(index.k, index.ngenomes, ch,
                                    [hint, 2 * hint, 4 * hint])
    phase = {"io": 0.0, "device": 0.0}
    for gid, name in enumerate(index.genome_names):
        g = index.genomes[name]
        if g.fasta is None:
            continue
        for _, seq in iter_fasta(g._fasta_path):
            tp = time.perf_counter()
            codes = seq_to_codes(seq)
            phase["io"] += time.perf_counter() - tp
            tp = time.perf_counter()
            b.add_sequence(gid, codes)
            phase["device"] += time.perf_counter() - tp
        tp = time.perf_counter()
        n_keys = b.synced_count()    # flushes the genome's buffered merge
        phase["device"] += time.perf_counter() - tp
        logger.info(f"device dict: merged {name} ({n_keys} keys)")
    tp = time.perf_counter()
    d = b.to_host()
    d.save(out)
    save_s = time.perf_counter() - tp
    w = b.walls
    logger.info(
        f"dict phases: io={phase['io']:.1f}s device={phase['device']:.1f}s "
        f"to_host+save={save_s:.1f}s | pack={w['pack']:.1f}s "
        f"chunk_disp={w['chunk_dispatch']:.1f}s "
        f"union_disp={w['union_dispatch']:.1f}s "
        f"merge_disp={w['merge_dispatch']:.1f}s sync={w['sync']:.1f}s "
        f"(first {w['first_sync']:.1f}s) over {w['flushes']} flushes")
    _benchmark(index.prefix, "dict", t0)
    logger.info(f"device dictionary: {len(d)} keys x {d.nwords} words")
    return out


def build_dict_mesh(index: Index, mesh, force=False):
    """Mesh dict stage: merge the per-genome k-mer sets with the
    DISTRIBUTED builder (all_to_all routing + on-device bucket layout,
    parallel/shard.py) and persist the host mirror as pandict.npz (mixed
    key space) for resume + the distance stage.

    Returns (ShardedBucketedDict, PanKmerDict)."""
    from .parallel.shard import shard_dictionary, sharded_build_dictionary

    out = index.dict_fname
    set_files = [index.kmer_set_fname(n) for n in index.genome_names
                 if index.genomes[n].fasta is not None]
    fresh = bool(not force and _outputs_fresh([out], set_files))
    # the cached path and the collective build run DIFFERENT collective
    # programs — a cross-process disagreement here must fail loudly, not
    # die in the transport layer
    from .parallel.mesh import assert_lockstep

    assert_lockstep("dict-cache", fresh)
    if fresh:
        pan = PanKmerDict.load(out)
        return shard_dictionary(pan, mesh), pan

    t0 = time.time()
    sets = []
    for name in index.genome_names:
        if index.genomes[name].fasta is None:
            sets.append(np.zeros(0, np.uint64))
            continue
        f = index.kmer_set_fname(name)
        z = np.load(f)
        if int(z["k"]) != index.k:
            raise ValueError(f"{f}: k={int(z['k'])} != index k={index.k}")
        sets.append(z["kmers"])
    sbd, pan = sharded_build_dictionary(
        sets, mesh, ngenomes=index.ngenomes, k=index.k,
        return_host_dict=True)
    pan.save(out)
    _benchmark(index.prefix, "dict", t0)
    logger.info(f"mesh dictionary: {len(pan)} keys x {pan.nwords} words "
                f"over {mesh.devices.size} devices")
    return sbd, pan


def build_dict_stage(index: Index, force=False) -> str:
    out = index.dict_fname
    # only genomes with sequence data have k-mer sets (annotation-only rows
    # contribute nothing; their presence bit stays 0)
    set_files = [index.kmer_set_fname(n) for n in index.genome_names
                 if index.genomes[n].fasta is not None]
    if not force and _outputs_fresh([out + ".npz" if not out.endswith(".npz") else out], set_files):
        return out
    t0 = time.time()
    sets = []
    # genome id g == position in genome_names (presence bit g); genomes
    # without sequence data contribute an empty set so ids stay aligned
    for name in index.genome_names:
        if index.genomes[name].fasta is None:
            sets.append(np.zeros(0, np.uint64))
            continue
        f = index.kmer_set_fname(name)
        z = np.load(f)
        if int(z["k"]) != index.k:
            raise ValueError(f"{f}: k={int(z['k'])} != index k={index.k}")
        sets.append(z["kmers"])
    d = build_dictionary(sets, index.k, ngenomes=index.ngenomes)
    d.save(out)
    _benchmark(index.prefix, "dict", t0)
    logger.info(f"dictionary: {len(d)} keys x {d.nwords} words")
    return out


def anchor_stage(index: Index, name: str, pan_dict=None, force=False,
                 bucketed=None, per_stage_logfile=True, mesh=None,
                 sharded=None):
    g = index.genomes[name]
    outs = [g.chrs_fname, g.bins_fname] + [
        g.bitmap_gz_fname(s) for s in index.steps
    ]
    if mesh is not None:
        from .parallel.mesh import sharded_writes_enabled

        if sharded_writes_enabled():
            # sharded multi-host writes: the stitched bitmap exists only
            # under the primary's prefix, so every process must key the
            # resume-skip off THAT copy or the collective call sequences
            # desynchronize on a partial rerun
            outs = [g.chrs_fname, g.bins_fname] + [
                g.primary_bitmap_fname(s) for s in index.steps
            ]
    ins = [index.dict_fname, g._fasta_path]
    skip = bool(not force and _outputs_fresh(outs, ins))
    if mesh is not None:
        # a process that skips while a peer re-anchors would desync the
        # chunk collectives; verify the decision matches everywhere
        from .parallel.mesh import assert_lockstep

        assert_lockstep(f"anchor-skip:{name}", skip)
    if skip:
        return
    t0 = time.time()
    if pan_dict is None and sharded is None:
        pan_dict = PanKmerDict.load(index.dict_fname)
    # per-stage logfiles re-point the root logger (basicConfig force); in
    # threaded runs keep the shared stderr logger instead
    log = None
    if per_stage_logfile:
        log = os.path.join(index.prefix, "logs", f"anchor.{name}.log.txt")
        os.makedirs(os.path.dirname(log), exist_ok=True)
    g.run_anchor(pan_dict, logfile=log, bucketed=bucketed, mesh=mesh,
                 sharded=sharded)
    _benchmark(index.prefix, f"anchor.{name}", t0)


def dist_stage(index: Index, pan_dict=None, force=False) -> str:
    out = index.genome_dist_fname
    if not force and _outputs_fresh([out], [index.dict_fname]):
        return out
    t0 = time.time()
    if pan_dict is None:
        pan_dict = PanKmerDict.load(index.dict_fname)
    write_genome_dist(pan_dict, list(index.genome_names), out)
    _benchmark(index.prefix, "mash.triangle", t0)
    return out


def build_index(samples_or_dir: str, prefix=None, force=False,
                device_dict=False, mesh_devices=None,
                mesh_strategy="range", **params) -> Index:
    """Run the full build DAG.  `samples_or_dir` is a samples.tsv (fresh
    build) or an initialized index dir (resume).  device_dict=True streams
    counting+merge entirely on device (no per-genome set artifacts).
    mesh_devices=N runs the dictionary merge AND anchoring on the
    N-device distributed engine (parallel/shard.py) — the production
    multi-chip path; outputs are byte-identical to the single-device
    build (tests/test_parallel.py).  mesh_strategy picks the sharding:
    "range" (key-range-sharded dictionary + sequence sharding with
    all_to_all routing — SURVEY P4/P8) or "genomes" (mask words split
    across devices, bit-plane tensor parallelism — SURVEY P5; the better
    fit when the genome count, not the dictionary, is what scales)."""
    index = Index(samples_or_dir, mode="w", prefix=prefix, **params)
    logdir = os.path.join(index.prefix, "logs")
    os.makedirs(logdir, exist_ok=True)
    init_logger()

    if mesh_devices:
        return _build_index_mesh(index, mesh_devices, force, mesh_strategy)

    if device_dict:
        build_dict_device(index, force=force)
    else:
        for name in index.genome_names:
            if index.genomes[name].fasta is not None:
                count_genome(index, name, force=force)
        build_dict_stage(index, force=force)
    pan_dict = PanKmerDict.load(index.dict_fname)

    # lay out the query-time bucketed dictionary ONCE for all anchors,
    # ON DEVICE: uploading keys+masks and scattering there moves ~3.4x
    # fewer bytes than uploading a host-built (3x-padded) table, and the
    # table never leaves HBM.  Keys are padded to a pow2 length so the
    # layout program's shape is one prewarm_anchor_programs already
    # compiled, and mixed dictionaries take the sorted-input layout
    # (halved transients).
    from .ops.lookup import BucketedDict, pad_pow2

    is_mixed = pan_dict.key_space == "mixed"
    pk, pm = pad_pow2(pan_dict.keys, pan_dict.masks)
    bucketed = BucketedDict.build_device(
        pk, pm, index.ngenomes, index.k,
        mixed=is_mixed, count=len(pan_dict.keys), sorted_input=is_mixed)

    cores = max(int(getattr(index.conf, "cores", 1) or 1), 1)
    if cores > 1 and len(index.anchor_genomes) > 1:
        # anchor genomes in parallel threads (the reference's OpenMP-over-
        # genomes, cpp/anchor.cpp:217-223): device work serializes inside
        # JAX while host-side packing/BGZF/reconstruction overlaps
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=cores) as ex:
            futures = [
                ex.submit(anchor_stage, index, name, pan_dict, force,
                          bucketed, False)
                for name in index.anchor_genomes
            ]
            for f in futures:
                f.result()
    else:
        for name in index.anchor_genomes:
            anchor_stage(index, name, pan_dict, force=force,
                         bucketed=bucketed)

    dist_stage(index, pan_dict, force=force)

    return Index(index.prefix)


def _build_index_mesh(index: Index, mesh_devices: int, force: bool,
                      strategy: str = "range") -> Index:
    """The distributed build DAG: count per genome (cached artifacts),
    merge + lay out the dictionary across the mesh, anchor every genome
    through the selected sharded engine, then distances from the host
    mirror."""
    import jax

    from .parallel import make_mesh

    if strategy not in ("range", "genomes"):
        raise ValueError(f"unknown mesh strategy '{strategy}'")
    if len(jax.devices()) < mesh_devices:
        raise RuntimeError(
            f"--mesh {mesh_devices}: only {len(jax.devices())} devices "
            "visible (for a virtual CPU mesh set XLA_FLAGS="
            f"--xla_force_host_platform_device_count={mesh_devices})")
    mesh = make_mesh(mesh_devices)

    for name in index.genome_names:
        if index.genomes[name].fasta is not None:
            count_genome(index, name, force=force)

    if strategy == "genomes":
        # genome-dimension (bit-plane) sharding: one replicated-key table
        # per device, each holding a slice of the mask words
        from .parallel.shard import shard_dictionary_genomes

        build_dict_stage(index, force=force)
        pan_dict = PanKmerDict.load(index.dict_fname)
        sharded = shard_dictionary_genomes(pan_dict, mesh)
    else:
        sharded, pan_dict = build_dict_mesh(index, mesh, force=force)

    for name in index.anchor_genomes:
        anchor_stage(index, name, pan_dict, force=force, mesh=mesh,
                     sharded=sharded)

    dist_stage(index, pan_dict, force=force)
    from .parallel.mesh import sharded_writes_enabled

    if jax.process_index() != 0 and sharded_writes_enabled():
        # a non-primary mirror holds only the derived tables (the stitched
        # bitmaps live under the primary's prefix) — nothing to re-open
        return index
    return Index(index.prefix)
