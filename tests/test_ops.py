import numpy as np
import pytest

from panagram_tpu.io.fasta import seq_to_codes
from panagram_tpu.ops import (
    anchor_lookup,
    build_dictionary,
    canonical_kmers,
    distinct_kmers,
    distinct_kmers_chunked,
    genome_column_sums,
    mask_popcount,
    masks_to_bytes,
    occupancy_histogram,
)
from panagram_tpu.ops.ref_impl import (
    anchor_np,
    build_dict_np,
    canonical_kmers_np,
    genome_kmer_set,
    masks_to_bytes_np,
    popcount_np,
)
from tests.conftest import random_seq


def brute_canonical(seq, k):
    """Character-level oracle for the oracle."""
    comp = str.maketrans("ACGT", "TGCA")
    out = []
    valid = []
    for i in range(len(seq) - k + 1):
        w = seq[i : i + k].upper()
        if any(c not in "ACGT" for c in w):
            out.append(0)
            valid.append(False)
            continue
        rc = w.translate(comp)[::-1]
        canon = min(w, rc)  # A<C<G<T lexicographic == 2-bit numeric order
        v = 0
        for c in canon:
            v = (v << 2) | "ACGT".index(c)
        out.append(v)
        valid.append(True)
    return np.array(out, np.uint64), np.array(valid, bool)


@pytest.mark.parametrize("k", [2, 3, 4, 12, 21, 30, 31])
def test_canonical_matches_brute(rng, k):
    seq = random_seq(rng, 300, n_frac=0.05)
    want, wantv = brute_canonical(seq, k)
    got_np, gotv_np = canonical_kmers_np(seq, k)
    assert np.array_equal(want, got_np)
    assert np.array_equal(wantv, gotv_np)

    got, gotv = canonical_kmers(seq_to_codes(seq), k)
    assert np.array_equal(want, got)
    assert np.array_equal(wantv, gotv)


def test_canonical_palindrome():
    # revcomp(ACGT) == ACGT: canonical == forward
    got, valid = canonical_kmers(seq_to_codes("ACGT"), 4)
    want, _ = canonical_kmers_np("ACGT", 4)
    assert np.array_equal(got, want)
    assert valid.all()


@pytest.mark.parametrize("k", [5, 21])
def test_distinct_kmers(rng, k):
    seq = random_seq(rng, 2000, n_frac=0.02)
    want = genome_kmer_set([seq], k)
    got = distinct_kmers(seq_to_codes(seq), k)
    assert np.array_equal(want, got)
    got_chunked = distinct_kmers_chunked([seq_to_codes(seq)], k, chunk=257)
    assert np.array_equal(want, got_chunked)


@pytest.mark.parametrize("n", [0, 1, 2, 5000])
def test_sorted_distinct_matches_unique(rng, n):
    """The count stage's sort + neighbour-compare dedup == np.unique,
    duplicates and the empty/one-element edges included."""
    from panagram_tpu.ops.count import sorted_distinct

    a = rng.integers(0, max(n // 3, 1), n).astype(np.uint64)
    assert np.array_equal(sorted_distinct(a.copy()), np.unique(a))


@pytest.mark.parametrize("ngenomes", [2, 6, 40])
def test_dictionary_and_anchor(rng, ngenomes):
    k = 11
    seqs = [random_seq(rng, 800, n_frac=0.01) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], k) for s in seqs]
    want_keys, want_masks = build_dict_np(sets)

    d = build_dictionary(sets, k)
    assert np.array_equal(d.keys, want_keys)
    assert np.array_equal(d.masks, want_masks)
    assert d.nwords == (ngenomes + 31) // 32

    # anchor genome 0 against the dictionary
    want_rows = anchor_np(seqs[0], k, want_keys, want_masks)
    canon, _ = canonical_kmers(seq_to_codes(seqs[0]), k)
    # device path uses SENTINEL for invalid; rebuild via pack_kmers
    from panagram_tpu.ops.codec import pack_kmers
    import jax.numpy as jnp

    canon_dev, _ = pack_kmers(jnp.asarray(seq_to_codes(seqs[0])), k)
    rows = np.asarray(anchor_lookup(canon_dev, jnp.asarray(d.keys), jnp.asarray(d.masks)))
    assert np.array_equal(rows, want_rows)

    # popcount + bytes
    nbytes = (ngenomes + 7) // 8
    assert np.array_equal(np.asarray(mask_popcount(rows)), popcount_np(want_rows))
    got_bytes = np.asarray(masks_to_bytes(rows))[:, :nbytes]
    assert np.array_equal(got_bytes, masks_to_bytes_np(want_rows, nbytes))

    # per-genome column sums == bit g totals
    colsums = np.asarray(genome_column_sums(rows, ngenomes))
    bits = np.unpackbits(want_rows.astype("<u4").view(np.uint8),
                         axis=1, bitorder="little")[:, :ngenomes]
    assert np.array_equal(colsums, bits.sum(axis=0))

    # anchor genome 0 contains all its own kmers: bit 0 set wherever valid
    _, valid = canonical_kmers_np(seqs[0], k)
    assert np.array_equal(bits[:, 0].astype(bool), valid)


def test_occupancy_histogram(rng):
    ngenomes = 6
    popc = rng.integers(0, ngenomes + 1, size=1000).astype(np.int32)
    binlen = 128
    nbins = -(-1000 // binlen)
    pad = np.full(nbins * binlen, -1, np.int32)
    pad[:1000] = popc
    got = np.asarray(occupancy_histogram(pad, binlen, nbins, ngenomes))
    for b in range(nbins):
        seg = popc[b * binlen : (b + 1) * binlen]
        want = np.bincount(seg, minlength=ngenomes + 1)
        assert np.array_equal(got[b], want)


def test_pairwise_shared(rng):
    k = 9
    seqs = [random_seq(rng, 500) for _ in range(5)]
    sets = [genome_kmer_set([s], k) for s in seqs]
    d = build_dictionary(sets, k)
    got = d.pairwise_shared(block=97)
    for i in range(5):
        for j in range(5):
            want = len(np.intersect1d(sets[i], sets[j]))
            assert got[i, j] == want


def test_pack_kmers_packed_matches_unpacked(rng):
    """The packed-stream codec (windowed build + pair-reverse + the
    ~W revcomp identity) must be bit-identical to pack_kmers for every k
    parity, sub-byte phase, and N placement."""
    import jax.numpy as jnp

    from panagram_tpu.ops.codec import (pack_bases_np, pack_kmers,
                                        pack_kmers_packed)

    for k in (2, 5, 21, 31):
        for L in (k, k + 3, 517, 2048):
            codes = rng.integers(0, 4, L).astype(np.uint8)
            if L > 10:
                bad = rng.choice(L, L // 10, replace=False)
                codes[bad] = 255
            packed, nmask, L2 = pack_bases_np(codes)
            c1, v1 = pack_kmers(jnp.asarray(codes), k)
            c2, v2 = pack_kmers_packed(jnp.asarray(packed),
                                       jnp.asarray(nmask), L2, k)
            assert np.array_equal(np.asarray(v1), np.asarray(v2)), (k, L)
            assert np.array_equal(np.asarray(c1), np.asarray(c2)), (k, L)


def test_counted_kmers_chunked_matches_oracle(rng):
    """Device sort+count FASTQ counting == numpy multiset counting with
    GLOBAL min-count thresholds, including k-mers whose occurrences land
    in different device chunks (tiny chunk forces the tree merge)."""
    from panagram_tpu.ops.count import counted_kmers_chunked
    from panagram_tpu.ops.ref_impl import canonical_kmers_np

    k = 11
    reads = []
    base = rng.integers(0, 4, 200).astype(np.uint8)
    for i in range(6):                      # overlapping coverage
        s = rng.integers(0, len(base) - 60)
        reads.append(base[s : s + 60].copy())
    err = rng.integers(0, 4, 60).astype(np.uint8)
    reads.append(err)                        # singleton-heavy read
    reads.append(rng.integers(0, 4, 5).astype(np.uint8))  # shorter than k

    # numpy oracle: global multiset counts
    allk = []
    for r in reads:
        canon, valid = canonical_kmers_np(r, k)
        allk.append(canon[valid])
    vals, counts = np.unique(np.concatenate(allk), return_counts=True)

    for min_count in (1, 2, 3):
        want = vals[counts >= min_count]
        got = counted_kmers_chunked(iter(reads), k, min_count=min_count,
                                    chunk=128)   # << read total: multi-chunk
        assert np.array_equal(got, want), min_count


def test_counted_kmers_chunked_varied_read_lengths(rng):
    """Regression: after a buffer flush, the separator slot may hold a
    STALE valid base from the previous chunk — windows must never span two
    reads through it (reproduced with varied read lengths + tiny chunk)."""
    from panagram_tpu.ops.count import counted_kmers_chunked
    from panagram_tpu.ops.ref_impl import canonical_kmers_np

    k = 5
    lengths = [30, 10, 10, 10, 10, 7, 25, 10]
    reads = [rng.integers(0, 4, n).astype(np.uint8) for n in lengths]
    allk = []
    for r in reads:
        canon, valid = canonical_kmers_np(r, k)
        allk.append(canon[valid])
    vals, counts = np.unique(np.concatenate(allk), return_counts=True)
    for min_count in (1, 2):
        want = vals[counts >= min_count]
        got = counted_kmers_chunked(iter(reads), k, min_count=min_count,
                                    chunk=32)
        assert np.array_equal(got, want), min_count

    # all-N reads: empty result, no crash (empty-merge guard)
    nreads = [np.full(20, 255, np.uint8) for _ in range(20)]
    got = counted_kmers_chunked(iter(nreads), k, min_count=2, chunk=32)
    assert got.size == 0


def test_counted_kmers_chunked_read_exactly_buffer_sized(rng):
    """Regression (ADVICE r4): a read of length exactly chunk+k-1 fills the
    buffer completely — the separator write one past the end crashed the
    whole counting stage with IndexError."""
    from panagram_tpu.ops.count import counted_kmers_chunked
    from panagram_tpu.ops.ref_impl import canonical_kmers_np

    k = 5
    chunk = 32
    cap = chunk + k - 1
    # exact-cap read alone, and mixed with neighbours that force flushes
    reads = [rng.integers(0, 4, cap).astype(np.uint8),
             rng.integers(0, 4, 10).astype(np.uint8),
             rng.integers(0, 4, cap).astype(np.uint8),
             rng.integers(0, 4, cap + 1).astype(np.uint8)]  # long-read path
    allk = []
    for r in reads:
        canon, valid = canonical_kmers_np(r, k)
        allk.append(canon[valid])
    vals, counts = np.unique(np.concatenate(allk), return_counts=True)
    for min_count in (1, 2):
        want = vals[counts >= min_count]
        got = counted_kmers_chunked(iter(reads), k, min_count=min_count,
                                    chunk=chunk)
        assert np.array_equal(got, want), min_count
