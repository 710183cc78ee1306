"""CLI dispatcher: panagram_tpu {index,view,bitdump,annotate,intros}.

Mirrors the reference CLI surface (reference panagram/__main__.py:14-194)
with argparse (simple_parsing is not available in this environment).
A hidden --cprof flag profiles any subcommand like the reference's.
"""

from __future__ import annotations

import argparse
import cProfile
import sys


def _add_index(sub):
    p = sub.add_parser("index", help="Build a pan-kmer index from a samples.tsv")
    p.add_argument("input", metavar="config_file",
                   help="samples.tsv (name/fasta[/gff] columns) or initialized index dir")
    p.add_argument("-o", "--prefix", default=None, help="output index directory")
    p.add_argument("-k", type=int, default=21, help="k-mer length (<=31)")
    p.add_argument("-c", "--cores", type=int, default=1)
    p.add_argument("--lowres-step", type=int, default=100)
    p.add_argument("--max-bin-kbp", type=int, default=200)
    p.add_argument("--min-bin-count", type=int, default=100)
    p.add_argument("--anchor-genomes", nargs="*", default=None)
    p.add_argument("--gff-gene-types", nargs="*", default=["gene"])
    p.add_argument("--gff-anno-types", nargs="*", default=None)
    p.add_argument("--gff-name", default="Name")
    p.add_argument("-p", "--prepare", action="store_true",
                   help="write config.yaml/samples.tsv without building")
    p.add_argument("--force", action="store_true", help="ignore cached stage outputs")
    p.add_argument("--device-dict", action="store_true",
                   help="count + merge the dictionary entirely on device "
                        "(no per-genome k-mer set files)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="build on an N-device mesh: distributed dictionary "
                        "merge (all_to_all) + sequence-sharded anchoring; "
                        "outputs are byte-identical to the 1-device build")
    p.add_argument("--mesh-strategy", choices=("range", "genomes"),
                   default="range",
                   help="mesh sharding: 'range' = key-range-sharded dict + "
                        "sequence sharding; 'genomes' = mask words split "
                        "across devices (bit-plane parallelism, for large "
                        "genome counts)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="distributed build: total processes/hosts")
    p.add_argument("--process-id", type=int, default=0,
                   help="distributed build: this process's id")
    p.add_argument("--coordinator", default=None,
                   help="jax.distributed coordinator address (host:port)")
    return p


def _run_index(args):
    if args.mesh_strategy != "range" and not args.mesh:
        raise SystemExit(
            "--mesh-strategy requires --mesh N (it selects how the mesh "
            "is sharded)")
    if args.mesh and args.num_processes > 1 and not args.coordinator:
        raise SystemExit(
            "--mesh with --num-processes runs ONE collective engine across "
            "hosts (jax.distributed) and needs --coordinator host:port")
    if args.mesh and args.num_processes > 1 and not args.prepare:
        # must run before ANY backend-initializing jax call (the engine
        # imports below deliberately avoid touching the backend); --prepare
        # never computes, so it must not block waiting for peer processes
        from .parallel.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, args.mesh)
    from .pipeline import build_index
    from .index import Index

    params = dict(
        k=args.k,
        cores=args.cores,
        lowres_step=args.lowres_step,
        max_bin_kbp=args.max_bin_kbp,
        min_bin_count=args.min_bin_count,
        anchor_genomes=args.anchor_genomes,
        gff_gene_types=args.gff_gene_types,
        gff_anno_types=args.gff_anno_types,
        gff_name=args.gff_name,
    )
    if args.prepare:
        idx = Index(args.input, mode="w", prefix=args.prefix, **params)
        print(f"Prepared index at {idx.prefix}. "
              f"Run 'panagram_tpu index {idx.prefix}' to build.")
    elif args.mesh and args.num_processes > 1:
        # multi-host collective build: every process joins ONE global mesh
        # (jax.distributed + Mesh over jax.devices()); the shard_map
        # engines are unchanged — their all_to_all/psum now cross hosts.
        # Control flow stays lockstep (every process drains the compact
        # RLE outputs), but each process expands + BGZF-writes only ITS
        # devices' bitmap rows as piece files under its '<prefix>.pN'
        # mirror; the primary stitches them in position order (no
        # recompression) into the final bitmaps.  Mirrors keep the derived
        # TSVs as a cross-host identity check; PANAGRAM_TPU_SHARD_WRITES=0
        # restores full per-process decode+write.  Run all processes from
        # equivalent stage states (fresh dirs or --force): divergent
        # mtime-skips would desynchronize the collectives.
        if not args.prefix:
            raise SystemExit("--mesh with --num-processes requires -o PREFIX")
        prefix = args.prefix.rstrip("/")
        if args.process_id:
            prefix += f".p{args.process_id}"
        idx = build_index(args.input, prefix=prefix, force=args.force,
                          device_dict=args.device_dict,
                          mesh_devices=args.mesh,
                          mesh_strategy=args.mesh_strategy, **params)
        print(f"Index built at {idx.prefix} "
              f"(process {args.process_id}/{args.num_processes})")
    elif args.num_processes > 1:
        from .parallel.distributed import build_index_distributed

        idx = build_index_distributed(
            args.input, prefix=args.prefix,
            num_processes=args.num_processes, process_id=args.process_id,
            coordinator=args.coordinator, force=args.force, **params)
        if idx is not None:
            print(f"Index built at {idx.prefix}")
        else:
            print(f"Process {args.process_id} finished its shard")
    else:
        idx = build_index(args.input, prefix=args.prefix, force=args.force,
                          device_dict=args.device_dict,
                          mesh_devices=args.mesh,
                          mesh_strategy=args.mesh_strategy, **params)
        print(f"Index built at {idx.prefix}")


def _add_bitdump(sub):
    p = sub.add_parser("bitdump", help="Query the pan-kmer bitmap")
    p.add_argument("index_dir")
    p.add_argument("genome")
    p.add_argument("chrom")
    p.add_argument("start", type=int, nargs="?", default=None)
    p.add_argument("end", type=int, nargs="?", default=None)
    p.add_argument("step", type=int, nargs="?", default=1)
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _run_bitdump(args):
    from .index import Index

    idx = Index(args.index_dir)
    bits = idx.query_bitmap(args.genome, args.chrom, args.start, args.end, args.step)
    if args.verbose:
        print(" ".join(idx.genomes))
        arr = bits.to_numpy()
        for i in range(len(arr)):
            print(" ".join(arr[i].astype(str)))
    else:
        print(bits)
    idx.close()


def _add_view(sub):
    p = sub.add_parser("view", help="Serve the pan-genome browser")
    p.add_argument("index_dir")
    p.add_argument("genome", nargs="?", default=None)
    p.add_argument("chrom", nargs="?", default=None)
    p.add_argument("start", type=int, nargs="?", default=None)
    p.add_argument("end", type=int, nargs="?", default=None)
    p.add_argument("--port", default="8050")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--ndebug", action="store_true")
    p.add_argument("--max-chr-bins", type=int, default=350)
    p.add_argument("--bookmarks", default=None)
    p.add_argument("--order", nargs="*", default=None,
                   help="fixed genome row order for heatmaps (default: "
                        "ward-clustering order)")
    return p


def _run_view(args):
    from .view.server import serve

    serve(args)


def _add_annotate(sub):
    p = sub.add_parser("annotate", help="(Re-)annotate an anchored genome from a GFF")
    p.add_argument("index_dir")
    p.add_argument("genome")
    p.add_argument("gff_file")
    p.add_argument("--nogene", action="store_true")
    return p


def _run_annotate(args):
    from .index import Index

    idx = Index(args.index_dir)
    idx[args.genome].run_annotate(args.gff_file, nogene=args.nogene)
    idx.close()


def _add_intros(sub):
    p = sub.add_parser("intros", help="Introgression calling pipeline")
    p.add_argument("target", help="config.yaml, or one of: heatmap, bed2txt, simulate")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("extra", nargs=argparse.REMAINDER)
    return p


def _run_intros(args):
    from .intros.runner import main as intros_main

    intros_main(args)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    cprof = None
    if "--cprof" in argv:
        i = argv.index("--cprof")
        cprof = argv[i + 1]
        del argv[i : i + 2]

    parser = argparse.ArgumentParser(prog="panagram_tpu",
                                     description="Accelerator pan-genome k-mer engine")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_index(sub)
    _add_view(sub)
    _add_bitdump(sub)
    _add_annotate(sub)
    _add_intros(sub)

    args = parser.parse_args(argv)
    from .cache import enable_compile_cache

    enable_compile_cache()
    run = {
        "index": _run_index,
        "view": _run_view,
        "bitdump": _run_bitdump,
        "annotate": _run_annotate,
        "intros": _run_intros,
    }[args.cmd]

    if cprof:
        cProfile.runctx("run(args)", globals(), locals(), filename=cprof)
    else:
        run(args)


if __name__ == "__main__":
    main()
