#!/bin/bash
# Legacy manual stage-by-stage pipeline (equivalent of reference
# scripts/preprocess.sh:1-87, the pre-Snakemake flow: per-sample KMC count
# -> 2^i set_counts relabel -> per-32-genome complex-union -> index).
#
# The device engine folds counting, the one-hot bit assignment (bit g%32 of
# word g//32) and the union merge into the device dictionary builder, so
# the manual flow maps to explicit CLI stages with on-disk checkpoints:
#
#   stage 1  --prepare        parse samples.tsv, write config.yaml + .fai
#   stage 2  index (count)    per-sample distinct-kmer sets + merged
#                             dictionary (resumable; kmc/ dir caches)
#   stage 3  annotate         (re)ingest GFF gene/annotation tables
#
# Usage: scripts/preprocess.sh <samples.tsv> <k> <outdir> [cores]
set -euo pipefail

input=$1
k=$2
outdir=$3
cores=${4:-1}

# stage 1: initialize the index directory (no counting yet)
python -m panagram_tpu index "$input" -o "$outdir" -k "$k" --prepare

# stage 2: full build, resuming from whatever stage 1 left on disk; the
# per-stage wall-clock lands in $outdir/logs/*.benchmark.txt
python -m panagram_tpu index "$outdir" -c "$cores"

# stage 3: refresh annotations for every sample that declares a GFF —
# the manual analogue of the build's ingest.  Columns are located by
# HEADER (the Python reader is header-driven, not positional), and
# relative GFF paths resolve against the samples.tsv directory exactly
# like the indexer does (panagram_tpu/index.py init_config).
tsv_dir=$(cd "$(dirname "$input")" && pwd)
name_col=$(head -1 "$input" | tr '\t' '\n' | grep -nx name | cut -d: -f1 || true)
gff_col=$(head -1 "$input" | tr '\t' '\n' | grep -nx gff | cut -d: -f1 || true)
if [ -n "$gff_col" ]; then
    tail -n +2 "$input" | while IFS= read -r row; do
        name=$(printf '%s\n' "$row" | cut -f"$name_col")
        gff=$(printf '%s\n' "$row" | cut -f"$gff_col")
        [ -n "$gff" ] || continue
        case "$gff" in /*) ;; *) gff="$tsv_dir/$gff" ;; esac
        if [ -e "$gff" ]; then
            python -m panagram_tpu annotate "$outdir" "$name" "$gff"
        else
            echo "preprocess: WARNING gff not found for $name: $gff" >&2
        fi
    done
fi

echo "preprocess: index ready at $outdir"
