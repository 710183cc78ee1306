"""The pan-kmer index: write + read API over the reference-compatible
on-disk format (SURVEY §2.3; reference panagram/index.py).

Write path: the device engine (panagram_tpu.ops) replaces KMC + cpp/anchor.cpp —
per-genome distinct canonical k-mer sets are counted on device, merged into
a presence-mask dictionary, and each anchor genome is streamed through a
lookup + popcount pipeline.  Outputs are byte-identical in decompressed
content to the reference's:

  anchor/<name>/bitmap.{1,100}.gz + .gzi   (reference index.py:539-543)
  anchor/<name>/chrs.tsv                   (size = L - k + 1, index.py:576-590)
  anchor/<name>/bitsum.bins.tsv            (index.py:1169-1183, anchor.cpp:179-189)
  anchor/<name>/total_paircounts.csv       (index.py:1068-1074)
  anchor/<name>/{gene,anno}.bed.gz + .csi  (index.py:785-791)
  anchor/<name>/bitsum.genes.tsv           (index.py:1079-1082)

Read path: mirrors the reference query API (Index.query_bitmap,
Genome.query, query_genes, query_anno, bitmap_to_bins, ...; reference
index.py:297-465,804-920) so downstream consumers (viewer, introgression
caller, analysis scripts) are drop-in.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import defaultdict

import numpy as np
import pandas as pd

from .config import IndexConfig, config_path, samples_path
from .io.bgzf import BgzfReader, BgzfWriter
from .io.fasta import FastaFile, iter_fasta, seq_to_codes
from .io.gff import split_gff
from .io.tabix import TabixFile, write_tabix

logger = logging.getLogger(__name__)

NAME_REGEX = "[A-Za-z0-9_-]+"
ANCHOR_DIR = "anchor"
BGZ_SUFFIX = "gz"
IDX_SUFFIX = "gzi"
TABIX_COLS = ["chr", "start", "end", "type", "name"]
TABIX_TYPES = {"start": int, "end": int}
GENE_COLS = ["chr", "start", "end", "name"]

# positions per streamed anchor chunk (k-1 halo added); large chunks
# amortize per-call host<->device latency.  The value has not been tuned on
# the current device; the env knob exists for A/B runs and for tests that
# need many small chunks
ANCHOR_CHUNK = 1 << int(os.environ.get("PANAGRAM_TPU_CHUNK_LOG2", "22"))


def init_logger(logfile=None):
    logging.basicConfig(
        filename=logfile,
        level=logging.INFO,
        format="[%(asctime)s %(levelname)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        force=logfile is not None,
    )


class Index:
    """Read/write handle on an index directory.

    Index(dir)                    -> read mode
    Index(samples_tsv, prefix=..) -> write mode (initializes config)
    """

    def __init__(self, input, mode=None, prefix=None, **params):
        self.conf = IndexConfig()
        if mode is None:
            write_mode = os.path.isfile(input)
        else:
            write_mode = mode == "w"
        self.write_mode = write_mode

        if write_mode:
            if os.path.isdir(input):
                self.prefix = input
                if not (os.path.isfile(config_path(input))
                        and os.path.isfile(samples_path(input))):
                    raise ValueError("Index write directory not initialized")
                self.load_config()
            elif os.path.isfile(input):
                self.prefix = prefix if prefix else (os.path.dirname(input) or ".")
                for key, val in params.items():
                    setattr(self.conf, key, val)
                self.init_config(input)
            else:
                raise ValueError("Index input must be sample TSV or initialized directory")
        else:
            if not os.path.isdir(input):
                raise ValueError("Index input must be directory in mode='r'")
            self.prefix = input
            self.load_config()

        self.samples = pd.read_csv(samples_path(self.prefix), sep="\t").set_index("name")
        self.ngenomes = len(self.samples)

        self.genomes = {}
        for name, row in self.samples.iterrows():
            self.genomes[name] = Genome(
                self, row["id"], name,
                row.get("fasta"), row.get("gff"), row.get("anchor"),
                write=self.write_mode,
            )

        self.chrs = None
        if not self.write_mode:
            self._init_read()

    # ---------------- configuration ----------------

    def init_config(self, samples_tsv):
        samples = pd.read_csv(samples_tsv, sep="\t")
        missing = {"name", "fasta"} - set(samples.columns)
        if missing:
            raise ValueError(
                f"samples.tsv is missing required column(s) "
                f"{sorted(missing)}; expected a tab-separated header with "
                f"at least 'name' and 'fasta' (optional 'gff')")
        if "gff" not in samples:
            samples["gff"] = pd.NA

        bad = samples["name"][~samples["name"].str.fullmatch(NAME_REGEX)]
        if len(bad):
            raise ValueError(
                f"genome name(s) {list(bad)} are not usable as file-path "
                f"components; names must match r'{NAME_REGEX}'")

        # resolve fasta/gff paths relative to the samples.tsv location
        src_dir = os.path.dirname(os.path.abspath(samples_tsv))

        def _resolve(p):
            if pd.isna(p) or os.path.isabs(str(p)):
                return p
            return os.path.relpath(os.path.join(src_dir, str(p)), self.prefix)

        samples["fasta"] = samples["fasta"].map(_resolve)
        samples["gff"] = samples["gff"].map(_resolve)

        samples = samples[["name", "fasta", "gff"]].set_index("name").dropna(how="all")
        samples["id"] = np.arange(len(samples), dtype=int)

        if self.conf.anchor_genomes is None:
            seqs = samples["fasta"].dropna()
            fastq = seqs.str.endswith((".fastq", ".fastq.gz", ".fq", ".fq.gz"))
            self.conf.anchor_genomes = list(seqs[~fastq].index)
        samples["anchor"] = samples.index.isin(self.conf.anchor_genomes)

        os.makedirs(self.prefix, exist_ok=True)
        samples.to_csv(samples_path(self.prefix), sep="\t")
        self.conf.input = os.path.basename(samples_tsv)
        self.write_config()

    def write_config(self):
        self.conf.save(config_path(self.prefix))

    def load_config(self):
        self.conf = IndexConfig.load(config_path(self.prefix))

    # config passthroughs used across the codebase + by viewer/intros
    @property
    def k(self):
        return self.conf.k

    @property
    def lowres_step(self):
        return self.conf.lowres_step

    @property
    def anchor_genomes(self):
        return self.conf.anchor_genomes or []

    @property
    def steps(self):
        return self.conf.steps

    @property
    def params(self):
        d = self.conf.to_dict(exclude=())
        d["prefix"] = self.prefix
        return d

    @property
    def genome_names(self):
        return self.samples.index

    @property
    def bitsum_index(self):
        return pd.RangeIndex(0, self.ngenomes + 1)

    @property
    def genome_dist_fname(self):
        return os.path.join(self.prefix, "genome_dist.tsv")

    def get_subdir(self, name):
        return os.path.join(self.prefix, name)

    @property
    def kmer_dir(self):
        """Per-genome k-mer set + dictionary cache (role of reference kmc/)."""
        return self.get_subdir("kmc")

    def kmer_set_fname(self, name):
        return os.path.join(self.kmer_dir, f"{name}.kmers.npz")

    @property
    def dict_fname(self):
        return os.path.join(self.kmer_dir, "pandict.npz")

    # ---- read-mode aggregation across anchors (same summaries as
    # reference index.py:297-342, rebuilt from each Genome's tables) ----

    def _init_read(self):
        """Stack every anchored genome's per-bin / per-chromosome occupancy
        summaries into index-wide tables and derive frequency + mean-
        occupancy views of them."""
        loaded = [(name, self.genomes[name]) for name in self.anchor_genomes
                  if self.genomes[name].chrs is not None]
        names = [n for n, _ in loaded]

        def stack(frames, levels):
            return pd.concat(frames, keys=names, names=levels)

        self.chrs = stack([g.chrs for _, g in loaded], ["genome", "chr"])
        self.bitsum_bins = stack(
            [g.bitsum_bins for _, g in loaded], ["genome", "chr", "start"]
        ).sort_index()
        # per-chromosome rows carry a (genome, chr) MultiIndex like the
        # reference's keyed concat (index.py:314-326) — anchors share
        # chromosome names, so chr-only indices would be ambiguous
        self.bitsum_chrs = stack([g.bitsum_chrs for _, g in loaded],
                                 ["genome", "chr"])
        self.bitfreq_chrs = stack([g.bitfreq_chrs for _, g in loaded],
                                  ["genome", "chr"])

        # one genome-wide occupancy histogram row per anchor
        totals = pd.DataFrame(
            [g.bitsum_total for _, g in loaded], index=pd.Index(names))
        self.bitsum_totals = totals
        self.bitfreq_totals = totals.div(totals.sum(axis=1), axis=0)

        # mean occupancy = sum over occ of occ * freq(occ), per row
        occ = self.bitfreq_totals.columns.to_numpy()

        def mean_occ(freqs):
            # nansum: an all-zero (hence all-NaN-frequency) row averages
            # to 0, matching pandas' skipna sum semantics
            vals = np.nansum(freqs.to_numpy() * occ, axis=1)
            return pd.Series(vals, index=freqs.index).sort_values()

        self.bitsum_totals_avg = mean_occ(self.bitfreq_totals)
        self.bitsum_chrs_avg = mean_occ(self.bitfreq_chrs)

        per_genome = self.chrs.groupby("genome")["size"]
        self.genome_sizes = pd.DataFrame(
            {"length": per_genome.sum(), "chr_count": per_genome.size()})

    # ---------------- query API ----------------

    def __getitem__(self, genome):
        return self.genomes[genome]

    def query_bitmap(self, genome, chrom, start=None, end=None, step=1):
        return self.genomes[genome].query(chrom, start, end, step)

    def query_genes(self, genome, chrom=None, start=None, end=None):
        return self.genomes[genome].query_genes(chrom, start, end)

    def query_anno(self, genome, chrom, start, end):
        return self.genomes[genome].query_anno(chrom, start, end)

    def bitsum_count(self, occs):
        ret = np.zeros(self.ngenomes, "uint32")
        occs, counts = np.unique(occs, return_counts=True)
        ret[occs - 1] = counts
        return ret

    # ---- bin transforms (same outputs as reference index.py:438-465,
    # computed with numpy scatter-adds instead of pandas groupby chains) ----

    @staticmethod
    def _bin_layout(positions, binlen):
        """Map bitmap row positions to bin ids: returns (unique bin ids,
        per-row bin slot index)."""
        which = np.asarray(positions) // binlen
        return np.unique(which, return_inverse=True)

    def _occupancy_by_bin(self, occupancy, slots, n_bins):
        """Histogram of occupancy values within each bin: [N+1, n_bins]."""
        counts = np.zeros((self.ngenomes + 1, n_bins), np.int64)
        np.add.at(counts, (np.asarray(occupancy), slots), 1)
        return counts

    @staticmethod
    def _normalize_per_bin(sums):
        """Scale each bin's per-genome totals by that bin's max (empty
        bins -> NaN, like a 0/0 division)."""
        peak = sums.max(axis=0, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(peak > 0, sums / peak, np.nan)

    def bitmap_to_bins(self, bitmap, binlen):
        bins, slots = self._bin_layout(bitmap.index, binlen)
        presence = bitmap.to_numpy()

        occ_hist = self._occupancy_by_bin(presence.sum(axis=1), slots, len(bins))
        pancount_bins = pd.DataFrame(occ_hist, index=self.bitsum_index,
                                     columns=bins)

        sums = np.zeros((len(bins), presence.shape[1]), np.int64)
        np.add.at(sums, slots, presence)
        paircount_bins = pd.DataFrame(
            self._normalize_per_bin(sums.T),
            index=bitmap.columns, columns=bins * binlen)
        return pancount_bins, paircount_bins

    def bitmap_to_pancount(self, bitmap):
        return pd.Series(bitmap.to_numpy().sum(axis=1), index=bitmap.index)

    def bitmap_to_paircount_bins(self, bitmap, binlen):
        _, paircount_bins = self.bitmap_to_bins(bitmap, binlen)
        return paircount_bins

    def pancount_to_bins(self, pancnts, binlen):
        bins, slots = self._bin_layout(pancnts.index, binlen)
        occ_hist = self._occupancy_by_bin(pancnts.to_numpy(), slots, len(bins))
        return pd.DataFrame(occ_hist, index=self.bitsum_index, columns=bins)

    def close(self):
        for b in self.genomes.values():
            b.close()


class Genome:
    """One genome of the index; anchored genomes own an anchor/<name>/ dir."""

    def __init__(self, idx, id, name, fasta=None, gff=None, anchor=None, write=False):
        self.index = idx
        self.id = id
        self.name = name
        self.fasta = fasta if not pd.isna(fasta) else None
        self.gff = gff if (gff is not None and not pd.isna(gff)) else None
        self.write_mode = write
        # FASTQ read sets contribute presence bits to the dictionary
        # (counted with min-count 2, reference Snakefile:88 -ci2) but have
        # no assembly to anchor
        is_fastq = self.fasta is not None and str(self.fasta).endswith(
            (".fastq", ".fastq.gz", ".fq", ".fq.gz"))
        self.anchored = bool(anchor) if anchor is not None and not pd.isna(anchor) \
            else (self.fasta is not None)
        if is_fastq:
            self.anchored = False
        self.annotated = self.gff is not None

        self.prefix = os.path.join(idx.prefix, ANCHOR_DIR, name)
        self.genome_names = idx.genome_names
        self.ngenomes = idx.ngenomes
        self.nbytes = int(np.ceil(self.ngenomes / 8))
        self.bitmaps = None
        self.chrs = None
        self.steps = list(idx.steps)

        if not self.anchored:
            return

        self.bitmap_lens = defaultdict(int)

        if os.path.exists(self.chrs_fname):
            self.load_chrs()
        elif self.fasta is not None and os.path.exists(self._fasta_path):
            self.init_chrs()
        else:
            self.chrs = None

        if not self.write_mode and self.chrs is not None \
                and os.path.exists(self.bitmap_gz_fname(1)):
            self.init_read()
        elif not self.write_mode:
            self.chrs = None

    # ---------------- paths ----------------

    @property
    def _fasta_path(self):
        if self.fasta is None:
            return None
        if os.path.isabs(self.fasta):
            return self.fasta
        return os.path.join(self.index.prefix, self.fasta)

    @property
    def _gff_path(self):
        if self.gff is None:
            return None
        if os.path.isabs(self.gff):
            return self.gff
        return os.path.join(self.index.prefix, self.gff)

    @property
    def chrs_fname(self):
        return os.path.join(self.prefix, "chrs.tsv")

    @property
    def bins_fname(self):
        return os.path.join(self.prefix, "bitsum.bins.tsv")

    @property
    def chr_genes_fname(self):
        return os.path.join(self.prefix, "bitsum.genes.tsv")

    @property
    def anno_types_fname(self):
        return os.path.join(self.prefix, "anno_types.txt")

    def bitmap_gz_fname(self, step):
        return os.path.join(self.prefix, f"bitmap.{step}.{BGZ_SUFFIX}")

    def bitmap_gzi_fname(self, step):
        return os.path.join(self.prefix, f"bitmap.{step}.{IDX_SUFFIX}")

    def _peer_anchor_dir(self, pid):
        """Process ``pid``'s anchor directory under the '<prefix>.pN'
        mirror convention of multi-host mesh builds (__main__.py: process
        0 owns the bare prefix).  Requires the mirrors to share a
        filesystem — the same assumption the file-coordinated DAG already
        makes."""
        import jax

        base = self.index.prefix.rstrip("/")
        me = jax.process_index()
        if me and base.endswith(f".p{me}"):
            base = base[: -len(f".p{me}")]
        if pid:
            base = f"{base}.p{pid}"
        return os.path.join(base, ANCHOR_DIR, self.name)

    def _bitmap_piece_fname(self, step, pid, peer=False):
        """Piece-file path for a multi-host sharded bitmap write (see
        run_anchor).  Each process writes pieces under its OWN index
        prefix; ``peer=True`` resolves process ``pid``'s directory so the
        primary can stitch."""
        adir = self._peer_anchor_dir(pid) if peer else self.prefix
        return os.path.join(adir, f".bitmap.{step}.p{pid}.part")

    def primary_bitmap_fname(self, step):
        """Where the stitched bitmap of a multi-host sharded build lives:
        always under the PRIMARY process's prefix (mirrors keep only the
        derived tables).  Equal to bitmap_gz_fname on the primary."""
        return os.path.join(self._peer_anchor_dir(0),
                            f"bitmap.{step}.{BGZ_SUFFIX}")

    def tabix_fname(self, typ):
        return os.path.join(self.prefix, f"{typ}.bed.gz")

    def tabix_idx_fname(self, typ):
        return self.tabix_fname(typ) + ".csi"

    @property
    def chrom_umaps_filename(self):
        return os.path.join(self.prefix, "chrom_umaps.csv")

    @property
    def genome_umap_filename(self):
        return os.path.join(self.prefix, "genome_umap.csv")

    @property
    def anchor_filenames(self):
        if not self.anchored:
            return []
        ret = [self.chrs_fname, self.bins_fname]
        for s in self.steps:
            ret += [self.bitmap_gz_fname(s), self.bitmap_gzi_fname(s)]
        if self.annotated:
            ret.append(self.chr_genes_fname)
            for t in ["gene", "anno"]:
                ret += [self.tabix_fname(t), self.tabix_idx_fname(t)]
        return ret

    # ---------------- chrs table (reference index.py:576-604) ----------------

    @property
    def bitsum_index(self):
        return pd.RangeIndex(0, self.ngenomes + 1)

    @property
    def gene_tabix_cols(self):
        return GENE_COLS + [1, self.ngenomes]

    @property
    def gene_tabix_types(self):
        r = {"start": int, "end": int}
        for i in [1, self.ngenomes]:
            r[i] = int
        return r

    @property
    def chr_count(self):
        return len(self.chrs)

    def _anchor_chunk(self) -> int:
        """Pow2 chunk ladder: a genome whose largest chromosome is far
        below ANCHOR_CHUNK would otherwise pad every (single) chunk to 4M
        positions — at the 100-genome scale row that is 2x wasted device
        compute per 2 Mbp genome.  Pow2 quantization keeps the number of
        distinct compiled programs logarithmic (and
        prewarm_anchor_programs warms the expected size)."""
        max_pos = int(self.chrs["size"].max()) if self.chrs is not None \
            and len(self.chrs) else ANCHOR_CHUNK
        return min(ANCHOR_CHUNK,
                   max(1 << 18, 1 << max(int(np.ceil(np.log2(
                       max(max_pos, 2)))), 1)))

    def init_chrs(self):
        fa = FastaFile(self._fasta_path)
        k = self.index.k
        # size = L - k + 1 (reference index.py:580), clamped at 0 for
        # scaffolds shorter than k: a negative size would corrupt the
        # cumulative byte offsets of every later chromosome
        chrs = pd.DataFrame(
            [
                (i, name, max(fa.get_reference_length(name) - k + 1, 0))
                for i, name in enumerate(fa.references)
            ],
            columns=["id", "name", "size"],
        ).set_index("name")
        fa.close()
        self.set_chrs(chrs)
        return chrs

    def write_chrs(self):
        self.chrs.to_csv(self.chrs_fname, sep="\t")

    def load_chrs(self):
        self.set_chrs(pd.read_csv(self.chrs_fname, sep="\t", index_col="name"))

    def set_chrs(self, chrs):
        self.chrs = chrs
        if "gene_count" not in self.chrs.columns:
            self.chrs["gene_count"] = 0
        self.sizes = chrs["size"]
        step_sizes = pd.DataFrame(
            {step: np.ceil(self.sizes / step) for step in self.steps}, dtype=int
        )
        self.offsets = step_sizes.cumsum().shift(fill_value=0)

    def seq_len(self, seq_name):
        return self.sizes.loc[seq_name]

    # ---------------- read mode (reference index.py:615-658) ----------------

    def init_read(self):
        # one indexed reader per stored resolution; the .gzi lives inside
        # the reader (BgzfReader.read_at does the block search + seek)
        self.bitmaps = {
            s: BgzfReader(self.bitmap_gz_fname(s), self.bitmap_gzi_fname(s))
            for s in self.steps
        }
        # BgzfReader is stateful (seek+read); queries may come from thread
        # pools (introgression caller threads, the threaded viewer server)
        self._query_lock = threading.Lock()

        self.bitsum_bins = self._read_bitsum_bins()
        self.bitsum_chrs = self.bitsum_bins.groupby("chr").sum()
        self.bitsum_total = self.bitsum_bins.sum()

        sum2freq = lambda df: df.divide(df.sum(axis=1), axis=0)
        self.bitfreq_bins = sum2freq(self.bitsum_bins)
        self.bitfreq_chrs = sum2freq(self.bitsum_chrs)

        self.gene_tabix = self._load_tabix("gene")
        self.anno_tabix = self._load_tabix("anno")
        self.annotated = self.gene_tabix is not None or self.anno_tabix is not None

        self._init_anno_types()

        if self.annotated and os.path.exists(self.chr_genes_fname):
            self.bitsum_genes = pd.read_csv(
                self.chr_genes_fname, sep="\t"
            ).set_index("chr")
            self.bitsum_genes.columns = self.bitsum_genes.columns.astype(int)
            self.bitfreq_genes = sum2freq(self.bitsum_genes)
        else:
            self.bitfreq_genes = self.bitsum_genes = pd.DataFrame(
                0, index=self.chrs.index, columns=self.gene_tabix_cols
            )

        tp = os.path.join(self.prefix, "total_paircounts.csv")
        self.total_paircounts = (
            pd.read_csv(tp, index_col="name") if os.path.exists(tp) else None
        )

        self.load_umaps()

    def _init_anno_types(self):
        if os.path.exists(self.anno_types_fname):
            with open(self.anno_types_fname) as f:
                anno_types = [l.strip() for l in f if l.strip()]
            if "exon" in anno_types:
                if anno_types[0] != "exon":
                    anno_types = ["exon"] + [a for a in anno_types if a != "exon"]
                id0 = 0
            else:
                id0 = 1
            self.gff_anno_types = set(anno_types)
            self.anno_type_ids = pd.Series({a: id0 + i for i, a in enumerate(anno_types)})
        else:
            self.gff_anno_types = None
            self.anno_type_ids = None

    def _load_tabix(self, typ):
        fname = self.tabix_fname(typ)
        if not os.path.exists(fname):
            return None
        return TabixFile(fname, self.tabix_idx_fname(typ))

    def _read_bitsum_bins(self):
        df = pd.read_csv(self.bins_fname, sep="\t")
        df["chr"] = self.chrs.index[df["chr"]]
        df.set_index(["chr", "start"], inplace=True)
        df.columns = df.columns.astype(int)
        return df

    def load_umaps(self):
        if os.path.exists(self.chrom_umaps_filename):
            self.chrom_umaps = pd.read_csv(self.chrom_umaps_filename, index_col="chrom")
        else:
            self.chrom_umaps = None
        if os.path.exists(self.genome_umap_filename):
            self.genome_umap = pd.read_csv(self.genome_umap_filename)
        else:
            self.genome_umap = None

    # ---- the universal read primitive (semantics of reference
    # index.py:804-845, re-expressed over io.bgzf.BgzfReader.read_at) ----

    def query(self, name, start=None, end=None, step=1):
        """Presence bits for chromosome `name` over [start, end) at the
        given stride, as a DataFrame indexed by position with one bool-int
        column per genome.

        Rows are served from the coarsest stored bitmap resolution whose
        step divides the requested stride (the two-resolution trick of
        SURVEY §5.7), then thinned host-side to the exact stride."""
        if start is None:
            start = 0
        if end is None:
            end = self.seq_len(name)

        stored = max((s for s in self.steps if step % s == 0), default=1)
        first_row = start // stored
        n_rows = (end - 1 - start) // stored + 1

        # uncompressed byte offset of this chromosome's rows at `stored`
        # resolution: cumulative chromosome offset + rows into it
        row_base = int(self.offsets.at[name, stored]) + first_row
        with self._query_lock:
            raw = self.bitmaps[stored].read_at(
                row_base * self.nbytes, n_rows * self.nbytes)

        mat = np.frombuffer(raw, np.uint8).reshape(-1, self.nbytes)
        thin = step // stored
        if thin > 1:
            mat = mat[::thin]

        bits = np.unpackbits(mat, axis=1, bitorder="little")
        coords = pd.RangeIndex(start, end, step)
        return pd.DataFrame(bits[: len(coords), : self.ngenomes],
                            index=coords, columns=self.genome_names)

    def query_genes(self, chrom=None, start=None, end=None):
        if self.gene_tabix is None:
            rows = []
        else:
            try:
                rows = list(self.gene_tabix.fetch(chrom, start, end))
            except ValueError:
                rows = []
        return pd.DataFrame(rows, columns=self.gene_tabix_cols).astype(self.gene_tabix_types)

    def query_anno(self, chrom, start, end):
        if self.anno_tabix is None:
            return pd.DataFrame(columns=TABIX_COLS)
        try:
            rows = list(self.anno_tabix.fetch(chrom, start, end))
        except ValueError:
            rows = []
        df = pd.DataFrame(rows, columns=TABIX_COLS).astype(TABIX_TYPES)
        if self.anno_type_ids is not None and len(df):
            df["type_id"] = self.anno_type_ids.reindex(df["type"]).to_numpy()
        else:
            df["type_id"] = pd.Series(dtype=float)
        return df

    def iter_fasta(self):
        yield from iter_fasta(self._fasta_path)

    # ---------------- write mode: anchoring ----------------

    def _init_gff(self):
        """Parse GFF into gene table (+ occupancy columns) and write the
        annotation tabix (reference index.py:720-783)."""
        conf = self.index.conf
        genes, annos = split_gff(
            self._gff_path,
            gene_types=conf.gff_gene_types,
            anno_types=conf.gff_anno_types,
            name_attr=conf.gff_name,
        )

        write_tabix(
            annos[TABIX_COLS].itertuples(index=False),
            self.tabix_fname("anno"),
            self.tabix_idx_fname("anno"),
        )

        if conf.gff_anno_types is None:
            self.gff_anno_types = set(annos["type"].unique())
        else:
            self.gff_anno_types = set(conf.gff_anno_types).intersection(annos["type"])
        with open(self.anno_types_fname, "w") as f:
            for t in self.gff_anno_types:
                f.write(f"{t}\n")

        for i in self.bitsum_index:
            genes[i] = 0
        return genes.set_index(["chr", "start", "end"]).sort_index()

    def bin_bitsum_binlen(self, nkmers):
        """Bin length rule shared by both reference builders
        (index.py:1169-1173 == anchor.cpp:114-118)."""
        binlen = self.index.conf.max_bin_kbp * 1000
        if nkmers / binlen < self.index.conf.min_bin_count:
            binlen = nkmers // self.index.conf.min_bin_count
        return max(int(binlen), 1)

    def _device_chunk_results(self, codes, nkmers, chunk, buf, t1, bd,
                              state=None, capacity=None):
        """Single-chip streamed chunk engine: dispatch every chunk's fused
        RLE kernel asynchronously, then drain in order.  Yields
        (start, m, bitmap bytes [m, nbytes], popc i32 [m], colsums [N]).

        `state` (a dict) carries the observed run-count/palette hints
        across chromosomes so only the very first chunks of a genome pay
        the full-buffer speculative transfer.  The loop itself lives in
        ops.anchor.stream_anchor_chunks (shared with bench.py, so the
        benchmark measures the exact product path)."""
        from .ops.anchor import stream_anchor_chunks

        yield from stream_anchor_chunks(
            codes, nkmers, chunk, buf, t1, bd, self.nbytes, self.ngenomes,
            self.index.k, state=state, capacity=capacity)

    def _mesh_chunk_results(self, mesh, sharded, codes, nkmers, chunk,
                            local_devs=None):
        """Distributed chunk engine (parallel/shard.py): each chunk is
        sequence-sharded over the mesh with (k-1) halos, anchored via
        all_to_all routing into the per-shard bucket tables, and returned
        as per-device RLE buffers that this host decodes and concatenates.
        Yields the same tuples as _device_chunk_results — the entire write
        path downstream is shared, so mesh builds are byte-identical.

        ``local_devs`` (a set of mesh device positions) switches to the
        multi-host sharded drain: every process still gathers the compact
        RLE buffers (control flow — overflow retries, prefix sizes — must
        stay in lockstep) and decodes the cheap popcounts/colsums for ALL
        devices, but expands mask BYTES only for its own devices; the
        payload becomes a list of (row_start_in_chunk, bytes) pieces for
        the per-host BGZF piece writer instead of the full [m, nbytes]
        rows."""
        from .ops.anchor import (
            PAL_CAP,
            pal_work_for,
            rle2_colsums,
            rle2_popc,
            rle4_colsums,
            rle4_popc,
            rle_proto,
            unpack_rle2,
            unpack_rle4,
        )
        from .parallel.mesh import host_view
        from .parallel.shard import (
            make_halo_chunks,
            prefix_rows,
            sharded_anchor_chunk,
            sharded_anchor_chunk_pal,
        )

        k = self.index.k
        N = self.ngenomes
        nbytes = self.nbytes
        S = mesh.devices.size
        C_dev = -(-chunk // S)
        capacity = C_dev   # v3 count <= positions: overflow unreachable
        proto = rle_proto(nbytes)
        pal_work = pal_work_for(capacity)

        # per-device persistent decode buffers (see _device_chunk_results:
        # fresh allocations stall on sandbox page faults); one slab per
        # device because the decoded views are held until concatenation
        out_b = np.empty((S, C_dev, nbytes), np.uint8)
        out_p = np.empty((S, C_dev), np.int32)
        out_b.fill(0)
        out_p.fill(0)

        from .ops.anchor import PIPELINE_DEPTH

        pending = []

        def _decode_v3(combined, cnts, m):
            # ship only the live prefix of the per-device RLE buffers
            # (pow2-quantized device slice), not the full capacity
            comb, _ = prefix_rows(combined, int(cnts.max()))
            parts_by, parts_popc = [], []
            chunk_colsums = np.zeros(N, np.int64)
            for d in range(S):
                cd = int(cnts[d])
                real = min(max(m - d * C_dev, 0), C_dev)
                if real == 0:
                    break
                if local_devs is None or d in local_devs:
                    by_d, popc_d = unpack_rle2(comb[d], cd, C_dev, nbytes,
                                               out=(out_b[d], out_p[d]))
                    parts_by.append((d * C_dev, by_d[:real]))
                else:
                    popc_d = rle2_popc(comb[d], cd, C_dev, nbytes,
                                       out=out_p[d])
                parts_popc.append(popc_d[:real])
                # padding rows carry zero masks, so the full-slice totals
                # are exact
                chunk_colsums += rle2_colsums(comb[d], cd, C_dev, N)
            popc_np = np.concatenate(parts_popc)
            if local_devs is None:
                return (np.concatenate([p for _, p in parts_by]), popc_np,
                        chunk_colsums)
            return parts_by, popc_np, chunk_colsums

        def _drain():
            start, m, halo, outs = pending.pop(0)
            if proto == 4:
                data, pal, counts, us = outs
                cnts = host_view(counts)
                uvals = host_view(us)
                if np.any(cnts > pal_work) or np.any(uvals > PAL_CAP):
                    # palette overflow on some device: redo through v3
                    combined, counts, _ = sharded_anchor_chunk(
                        mesh, sharded, halo, C_dev)
                    by, popc_np, chunk_colsums = _decode_v3(
                        combined, host_view(counts), m)
                    return start, m, by, popc_np, chunk_colsums
                dpref, _ = prefix_rows(data, int(cnts.max()))
                ppref, _ = prefix_rows(pal, 2 + int(uvals.max()))
                parts_by, parts_popc = [], []
                chunk_colsums = np.zeros(N, np.int64)
                for d in range(S):
                    cd = int(cnts[d])
                    real = min(max(m - d * C_dev, 0), C_dev)
                    if real == 0:
                        break
                    pal_bytes = ppref[d][2: 2 + int(uvals[d])]
                    if local_devs is None or d in local_devs:
                        by_d, popc_d = unpack_rle4(dpref[d], pal_bytes, cd,
                                                   C_dev, nbytes,
                                                   out=(out_b[d], out_p[d]))
                        parts_by.append((d * C_dev, by_d[:real]))
                    else:
                        popc_d = rle4_popc(dpref[d], pal_bytes, cd, C_dev,
                                           nbytes, out=out_p[d])
                    parts_popc.append(popc_d[:real])
                    chunk_colsums += rle4_colsums(dpref[d], pal_bytes, cd,
                                                  C_dev, N)
                popc_np = np.concatenate(parts_popc)
                if local_devs is None:
                    return (start, m,
                            np.concatenate([p for _, p in parts_by]),
                            popc_np, chunk_colsums)
                return start, m, parts_by, popc_np, chunk_colsums

            combined, counts = outs
            cnts = host_view(counts)
            if np.any(cnts > capacity):
                # RLE overflow on some device: redo the chunk with a
                # capacity that can never overflow (count <= C_dev)
                combined, counts, _ = sharded_anchor_chunk(
                    mesh, sharded, halo, C_dev)
                cnts = host_view(counts)
            by, popc_np, chunk_colsums = _decode_v3(combined, cnts, m)
            return start, m, by, popc_np, chunk_colsums

        # bounded dispatch-ahead (same PIPELINE_DEPTH as the single-device
        # engine): an unbounded queue would hold every chunk's per-device
        # RLE buffer in HBM at once on long chromosomes
        for start in range(0, nkmers, chunk):
            m = min(chunk, nkmers - start)
            sub = codes[start : start + m + k - 1]
            halo, _ = make_halo_chunks(sub, S, k, C_dev)
            if proto == 4:
                data, pal, counts, us, _ = sharded_anchor_chunk_pal(
                    mesh, sharded, halo, pal_work)
                pending.append((start, m, halo, (data, pal, counts, us)))
            else:
                combined, counts, _ = sharded_anchor_chunk(
                    mesh, sharded, halo, capacity)
                pending.append((start, m, halo, (combined, counts)))
            if len(pending) >= PIPELINE_DEPTH:
                yield _drain()
        while pending:
            yield _drain()

    def _genome_mesh_chunk_results(self, mesh, gsd, codes, nkmers, chunk):
        """Genome-dimension-sharded chunk engine (SURVEY §2.7 P5): every
        device anchors the SAME positions against its own slice of the
        mask words (bit-plane / tensor parallelism over the genome axis),
        popcounts are psum'd on device, and the host hstacks the
        per-shard byte slices exactly like the reference concatenates
        per-KMC-DB byte slices (reference index.py:936-947).  Yields the
        same tuples as _device_chunk_results, so the write path is
        shared and mesh builds stay byte-identical."""
        from .ops.anchor import (
            PAL_CAP,
            PIPELINE_DEPTH,
            pal_work_for,
            rle4_colsums,
            rle_proto,
            unpack_rle4,
        )
        from .parallel.mesh import host_view
        from .parallel.shard import (
            assemble_genome_shards,
            genome_sharded_anchor_chunk,
            genome_sharded_anchor_chunk_pal,
            prefix_rows,
        )

        k = self.index.k
        N = self.ngenomes
        nbytes = self.nbytes
        S = mesh.devices.size
        Wl = gsd.nwords_local
        buf = np.full(chunk + k - 1, 255, np.uint8)
        proto = rle_proto(nbytes)
        pal_work = pal_work_for(chunk)

        # persistent per-shard decode buffers (fresh multi-MB allocations
        # stall on sandbox page faults; see rle_expand_native) — held per
        # shard until the byte-slice concatenation
        if proto == 4:
            out_b = np.empty((S, chunk, 4 * Wl), np.uint8)
            out_p = np.empty((S, chunk), np.int32)
            out_b.fill(0)
            out_p.fill(0)

        pending = []

        def _drain_dense(m, by_dev, popc_dev, cs_dev):
            by = assemble_genome_shards(host_view(by_dev), nbytes)[:m]
            popc_np = host_view(popc_dev)[:m].astype(np.int32)
            # padding positions past m carry zero masks, so the device's
            # full-slice totals are exact
            colsums = host_view(cs_dev)[:N]
            return by, popc_np, colsums

        def _drain():
            start, m, chunk_buf, outs = pending.pop(0)
            if proto == 4:
                data, pal, counts, us, C = outs
                cnts = host_view(counts)
                uvals = host_view(us)
                if np.any(cnts > pal_work) or np.any(uvals > PAL_CAP):
                    by, popc_np, colsums = _drain_dense(
                        m, *genome_sharded_anchor_chunk(mesh, gsd,
                                                        chunk_buf))
                    return start, m, by, popc_np, colsums
                dpref, _ = prefix_rows(data, int(cnts.max()))
                ppref, _ = prefix_rows(pal, 2 + int(uvals.max()))
                nb_loc = 4 * Wl
                slices = []
                popc_np = np.zeros(m, np.int32)
                colsums = np.zeros(S * 32 * Wl, np.int64)
                for s in range(S):
                    pal_bytes = ppref[s][2: 2 + int(uvals[s])]
                    by_s, popc_s = unpack_rle4(dpref[s], pal_bytes,
                                               int(cnts[s]), C, nb_loc,
                                               out=(out_b[s], out_p[s]))
                    slices.append(by_s[:m])
                    # per-shard local popcounts sum to the global occupancy
                    popc_np += popc_s[:m]
                    colsums[s * 32 * Wl: (s + 1) * 32 * Wl] = rle4_colsums(
                        dpref[s], pal_bytes, int(cnts[s]), C, 32 * Wl)
                by = np.concatenate(slices, axis=1)[:, :nbytes]
                return start, m, by, popc_np, colsums[:N]
            by, popc_np, colsums = _drain_dense(m, *outs)
            return start, m, by, popc_np, colsums

        for start in range(0, nkmers, chunk):
            m = min(chunk, nkmers - start)
            buf[:] = 255
            buf[: m + k - 1] = codes[start : start + m + k - 1]
            if proto == 4:
                outs = genome_sharded_anchor_chunk_pal(
                    mesh, gsd, buf, pal_work)
                pending.append((start, m, buf.copy(), outs))
            else:
                outs = genome_sharded_anchor_chunk(mesh, gsd, buf)
                pending.append((start, m, None, outs))
            if len(pending) >= PIPELINE_DEPTH:
                yield _drain()
        while pending:
            yield _drain()

    def run_anchor(self, pan_dict=None, logfile=None, bucketed=None,
                   mesh=None, sharded=None):
        """Anchor this genome against the pan-kmer dictionary.

        The streamed per-chunk pipeline replaces cpp/anchor.cpp:112-195:
        2-bit encode -> canonical pack -> dictionary gather -> byte-pack /
        popcount / histograms, all device-side per chunk; chunk kernels are
        dispatched asynchronously and drained in order so device compute
        overlaps host packing, transfers, and BGZF writes.

        `bucketed` (a prebuilt ops.lookup.BucketedDict) avoids re-laying
        out the dictionary per anchor genome.

        `mesh` + `sharded` switch the per-chunk kernel to a DISTRIBUTED
        engine — same bytes, any number of chips:
        * a parallel.shard.ShardedBucketedDict selects the range-sharded
          engine (sequence-sharded slices with (k-1) halos, all_to_all
          query routing, per-device RLE outputs);
        * a parallel.shard.GenomeShardedDict selects the genome-dimension
          engine (every device probes its own mask-word slice and
          palette-compacts it; the host sums per-shard popcounts and
          hstacks the decoded byte slices).
        """
        if logfile:
            init_logger(logfile)
        if not self.anchored:
            logger.info(f"Skipping non-anchor genome '{self.name}'")
            return

        from .ops.dictionary import PanKmerDict
        from .ops.lookup import BucketedDict

        if pan_dict is None and sharded is None:
            pan_dict = PanKmerDict.load(self.index.dict_fname)

        os.makedirs(self.prefix, exist_ok=True)
        k = self.index.k
        N = self.ngenomes
        nbytes = self.nbytes
        lowres = self.index.lowres_step

        use_mesh = mesh is not None and sharded is not None
        genome_mesh = False
        # Multi-host sharded drain+write (SURVEY §5.8): each process
        # expands and BGZF-writes only its own devices' bitmap rows as
        # block-aligned piece files; the primary stitches them in position
        # order (io.bgzf.stitch_bgzf_pieces, no recompression) and builds
        # the .gzi.  Control flow stays lockstep because the compact RLE
        # buffers (and all derived histograms) are still decoded by every
        # process.  PANAGRAM_TPU_SHARD_WRITES=0 restores the full-mirror
        # behaviour (every process decodes + writes everything).
        shard_writes = False
        local_devs = None
        proc_id = nprocs = 0
        if use_mesh:
            from .parallel.shard import GenomeShardedDict

            genome_mesh = isinstance(sharded, GenomeShardedDict)
            t1 = bd = None
            if not genome_mesh:
                import jax

                from .parallel.mesh import sharded_writes_enabled

                if sharded_writes_enabled():
                    shard_writes = True
                    nprocs = jax.process_count()
                    proc_id = jax.process_index()
                    local_devs = frozenset(
                        d for d, dev in enumerate(mesh.devices.flat)
                        if dev.process_index == proc_id)
        else:
            # queue the anchor-chunk compile for the EXACT table geometry
            # AND the actual pow2 chunk size before building the layout:
            # the compile runs concurrently with the layout work below
            # instead of serially after it (ops/prewarm.py; no-op when
            # already compiled)
            from .ops.prewarm import prewarm_anchor_programs

            if self.chrs is None:
                self.init_chrs()
            prewarm_anchor_programs(k, N,
                                    self._anchor_chunk(),
                                    [len(pan_dict.keys)])
            # device-side layout: ~3.4x fewer h2d bytes than uploading a
            # host-built padded table (and device_arrays memoizes, so a
            # shared `bucketed` uploads nothing per genome)
            # mixed-space dictionaries are stored globally sorted by mixed
            # value (devdict merge invariant / shard-major gather), so the
            # layout can skip its grouping sort (halved transients);
            # pow2 padding keeps the layout program prewarm-compiled
            is_mixed = getattr(pan_dict, "key_space", "canon") == "mixed"
            if bucketed is not None:
                bd = bucketed
            else:
                from .ops.lookup import pad_pow2

                pk, pm = pad_pow2(pan_dict.keys, pan_dict.masks)
                bd = BucketedDict.build_device(
                    pk, pm, N, k, mixed=is_mixed,
                    count=len(pan_dict.keys), sorted_input=is_mixed)
            (t1,) = bd.device_arrays()

        if self.chrs is None:
            self.init_chrs()

        if self.annotated:
            gene_df = self._init_gff()
            chr_genes = gene_df.index.get_level_values(0).value_counts()
            logger.info("Annotation pre-processed")
        else:
            gene_df = None
            chr_genes = pd.Series([0])
        self.chrs["gene_count"] = chr_genes.reindex(self.chrs.index, fill_value=0)

        if shard_writes:
            from .io.bgzf import BgzfPieceWriter

            writers = {s: BgzfPieceWriter(self._bitmap_piece_fname(s, proc_id))
                       for s in self.steps}
        else:
            writers = {s: BgzfWriter(self.bitmap_gz_fname(s))
                       for s in self.steps}
        bin_rows = []  # (chr_id, start, counts[0..N])
        paircount_sums = np.zeros(N, np.int64)
        # file-global row bases for the sharded piece writer: rows (step 1)
        # and lowres rows written by all previous chromosomes
        chrom_base1 = chrom_base_low = 0

        logger.info("Anchoring Started")

        chunk = self._anchor_chunk()
        buf = np.empty(chunk + k - 1, np.uint8)
        # run-count hint carried across chromosomes AND genomes (shared
        # per index + chunk size): without it every genome's first chunk
        # pays the speculative total//8 prefix transfer — at the
        # 100-genome scale that is ~100 extra speculative reads.  Run
        # counts are structural (haplotype density), so one genome's
        # observed count is the right prior for the next.
        hint_cache = getattr(self.index, "_chunk_hint_state", None)
        if hint_cache is None:
            hint_cache = self.index._chunk_hint_state = {}
        chunk_state = hint_cache.setdefault(chunk, {})
        # wall-time per phase, logged at the end — the kernel work for a
        # 5 Mbp genome is sub-second, so anchor-stage wall is host-side;
        # this shows where (drain = device wait + RLE decode + packing)
        phase = {"encode": 0.0, "drain": 0.0, "write": 0.0, "bins": 0.0}

        for chrom_i, (chrom, seq) in enumerate(self.iter_fasta()):
            t0 = time.perf_counter()
            codes = seq_to_codes(seq)
            phase["encode"] += time.perf_counter() - t0
            nkmers = len(codes) - k + 1
            if nkmers <= 0:
                logger.warning(f"Skipping short sequence {chrom}")
                continue
            binlen = self.bin_bitsum_binlen(nkmers)
            nbins = -(-nkmers // binlen)
            hist = np.zeros((nbins, N + 1), np.int64)
            popc_full = np.empty(nkmers, np.int16) if self.annotated else None

            if genome_mesh:
                results = self._genome_mesh_chunk_results(
                    mesh, sharded, codes, nkmers, chunk)
            elif use_mesh:
                results = self._mesh_chunk_results(
                    mesh, sharded, codes, nkmers, chunk,
                    local_devs=local_devs)
            else:
                results = self._device_chunk_results(
                    codes, nkmers, chunk, buf, t1, bd, state=chunk_state)

            it = iter(results)
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                phase["drain"] += time.perf_counter() - t0
                if item is None:
                    break
                start, m, by, popc_np, chunk_colsums = item

                t0 = time.perf_counter()
                if shard_writes:
                    # `by` is a list of (row_start_in_chunk, rows) pieces
                    # covering only this process's devices
                    for row_start, piece in by:
                        p0 = start + row_start  # chromosome-local position
                        writers[1].write_piece(
                            (chrom_base1 + p0) * nbytes, piece)
                        first = (-p0) % lowres
                        sel = piece[first::lowres]
                        if sel.shape[0]:
                            lr = chrom_base_low + (p0 + lowres - 1) // lowres
                            writers[lowres].write_piece(
                                lr * nbytes, sel.tobytes())
                else:
                    writers[1].write(by)      # buffer protocol: no copy
                    # global-phase lowres downsample (anchor.cpp:169-177)
                    first = (-start) % lowres
                    writers[lowres].write(by[first::lowres].tobytes())
                phase["write"] += time.perf_counter() - t0

                # per-bin occupancy histogram contribution
                t0 = time.perf_counter()
                bins = (start + np.arange(m)) // binlen
                flat = np.bincount(
                    bins * (N + 1) + popc_np, minlength=nbins * (N + 1)
                )
                hist += flat.reshape(nbins, N + 1)

                paircount_sums += chunk_colsums
                if popc_full is not None:
                    popc_full[start : start + m] = popc_np
                phase["bins"] += time.perf_counter() - t0

                self.bitmap_lens[1] += m

            for b in range(nbins):
                bin_rows.append((chrom_i, b * binlen, hist[b]))

            chrom_base1 += nkmers
            chrom_base_low += (nkmers + lowres - 1) // lowres
            logger.info(f"Anchored {chrom}")

            if self.annotated and chrom in chr_genes.index:
                for _, gstart, gend in gene_df.loc[[chrom]].index:
                    # reference uses GFF coords directly as bitsum slices
                    # (index.py:1056-1063), including its bounds checks
                    if gend <= gstart or gstart < 0 or gend > nkmers:
                        logger.warning(
                            f"Skipping gene at {chrom}:{gstart}-{gend}, "
                            "coordinates out-of-bounds"
                        )
                        continue
                    occ = np.bincount(
                        popc_full[gstart:gend], minlength=N + 1
                    ).astype(np.int64)
                    gene_df.loc[(chrom, gstart, gend), list(self.bitsum_index)] += occ
                logger.info(f"Annotated {chrom}")

        for w in writers.values():
            w.close()
        if shard_writes:
            # all processes' piece files must be complete before the
            # primary stitches; sync_global_devices is the same collective
            # fabric the build already rides (NCCL on GPUs, Gloo on the
            # CPU test fixture)
            from jax.experimental import multihost_utils

            from .io.bgzf import stitch_bgzf_pieces

            multihost_utils.sync_global_devices(
                f"panagram_pieces_{self.name}")
            if proc_id == 0:
                for s in self.steps:
                    paths = [self._bitmap_piece_fname(s, p, peer=True)
                             for p in range(nprocs)]
                    stitch_bgzf_pieces(paths, self.bitmap_gz_fname(s),
                                       self.bitmap_gzi_fname(s))
                    for p in paths:
                        os.remove(p)
                        os.remove(p + ".manifest.npy")
        else:
            for s in self.steps:
                writers[s].write_gzi(self.bitmap_gzi_fname(s))

        # total_paircounts.csv (reference index.py:1068-1074)
        tp = pd.DataFrame(
            {
                "count": pd.Series(paircount_sums, index=self.genome_names),
                "frac": paircount_sums / paircount_sums[self.index.samples.index.get_loc(self.name)],
            }
        )
        tp.index.name = "name"
        self.total_paircounts = tp
        tp.to_csv(os.path.join(self.prefix, "total_paircounts.csv"))

        if self.annotated:
            gene_tabix = gene_df.reset_index()[self.gene_tabix_cols]
            write_tabix(
                gene_tabix.itertuples(index=False),
                self.tabix_fname("gene"),
                self.tabix_idx_fname("gene"),
            )
            self.bitsum_genes = gene_df.groupby("chr", sort=False)[
                list(self.bitsum_index)
            ].sum()
            self.bitsum_genes.to_csv(self.chr_genes_fname, sep="\t")

        # bitsum.bins.tsv (reference index.py:1084-1085; anchor.cpp:57-63)
        with open(self.bins_fname, "w") as f:
            f.write("chr\tstart\t" + "\t".join(str(i) for i in range(N + 1)) + "\n")
            for cid, start, counts in bin_rows:
                f.write(f"{cid}\t{start}\t" + "\t".join(str(int(c)) for c in counts) + "\n")

        self.write_chrs()

        if shard_writes and proc_id != 0:
            # the stitched bitmap lives under the primary's prefix; this
            # mirror keeps every derived table (the cross-host identity
            # check) but has no bitmap to re-open
            logger.info("anchor phases: " + " ".join(
                f"{name}={v:.1f}s" for name, v in phase.items()))
            logger.info("non-primary process: bitmap stitched by process "
                        "0; skipping init_read/umaps")
            return

        t0 = time.perf_counter()
        self.init_read()
        try:
            self.write_umaps()
        except Exception as e:  # embeddings are ancillary (reference degrades too)
            logger.warning(f"UMAP embedding failed: {e}")
        phase["finish"] = time.perf_counter() - t0
        logger.info("anchor phases: " + " ".join(
            f"{name}={v:.1f}s" for name, v in phase.items()))

    def run_annotate(self, gff_file=None, logfile=None, nogene=False):
        """(Re-)annotate from an existing bitmap (reference index.py:971-1010)."""
        if logfile:
            init_logger(logfile)
        if gff_file is not None:
            self.gff = gff_file
        self.annotated = True

        gene_df = self._init_gff()
        if nogene:
            return

        for chrom in gene_df.index.unique("chr"):
            if chrom not in self.sizes.index:
                logger.warning(f"Skipping genes at {chrom}, chromosome not found")
                continue
            df = gene_df.loc[chrom]
            st = int(df.index.get_level_values("start").min())
            en = int(min(self.sizes[chrom], df.index.get_level_values("end").max()))

            bitsum = self.query(chrom, st, en).sum(axis=1).to_numpy().astype(np.int64)

            for start, end in df.index:
                if end <= start or start < 0 or end - st > len(bitsum):
                    logger.warning(
                        f"Skipping gene at {chrom}:{start}-{end}, coordinates out-of-bounds"
                    )
                    continue
                occ = np.bincount(bitsum[start - st : end - st], minlength=self.ngenomes + 1)
                gene_df.loc[(chrom, start, end), list(self.bitsum_index)] += occ.astype(np.int64)

        self.bitsum_genes = gene_df.groupby("chr", sort=False)[list(self.bitsum_index)].sum()
        self.bitsum_genes.to_csv(self.chr_genes_fname, sep="\t")

        gene_tabix = gene_df.reset_index()[self.gene_tabix_cols]
        write_tabix(
            gene_tabix.itertuples(index=False),
            self.tabix_fname("gene"),
            self.tabix_idx_fname("gene"),
        )

    # ---------------- embeddings (reference index.py:1099-1167) -------------

    def write_umaps(self):
        from .umap_embed import run_embedding

        genome_paircounts = {}
        chrom_umaps = []
        for chrom in self.chrs.index:
            bitmap = self.query(chrom, step=self.index.lowres_step)
            paircounts = self.index.bitmap_to_paircount_bins(
                bitmap, self.index.conf.chrom_umap.bin_size
            ).T.fillna(0)
            chrom_paircounts = pd.concat({chrom: paircounts}, names=["chrom", "start"])
            chrom_umaps.append(
                run_embedding(chrom_paircounts, self.index.conf.chrom_umap, self.name)
            )
            genome_paircounts[chrom] = self.index.bitmap_to_paircount_bins(
                bitmap, self.index.conf.genome_umap.bin_size
            ).T.fillna(0)

        self.chrom_umaps = pd.concat(chrom_umaps).set_index("chrom")
        self.chrom_umaps.to_csv(self.chrom_umaps_filename)

        self.genome_umap = run_embedding(
            pd.concat(genome_paircounts, names=["chrom", "start"]),
            self.index.conf.genome_umap,
            self.name,
        )
        self.genome_umap.to_csv(self.genome_umap_filename, index=False)

    def close(self):
        if self.bitmaps is not None:
            for f in self.bitmaps.values():
                f.close()
            self.bitmaps = None
