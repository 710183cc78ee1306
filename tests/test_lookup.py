import numpy as np
import pytest

from panagram_tpu.io.fasta import seq_to_codes
from panagram_tpu.ops.codec import pack_bases_np, unpack_bases
from panagram_tpu.ops.dictionary import build_dictionary
from panagram_tpu.ops.lookup import BucketedDict, bucket_query, mix64, mix64_np
from panagram_tpu.ops.ref_impl import (
    anchor_np,
    canonical_kmers_np,
    genome_kmer_set,
    masks_to_bytes_np,
    popcount_np,
)
from tests.conftest import random_seq

K = 13


def test_mix64_invertible_and_consistent(rng):
    import jax.numpy as jnp

    x = rng.integers(0, 1 << 62, 1000, dtype=np.uint64)
    m_np = mix64_np(x)
    m_dev = np.asarray(mix64(jnp.asarray(x)))
    assert np.array_equal(m_np, m_dev)
    assert len(np.unique(m_np)) == len(np.unique(x))
    top = (m_np >> np.uint64(60)).astype(int)
    assert len(np.unique(top)) == 16


def test_pack_unpack_bases(rng):
    import jax.numpy as jnp

    seq = random_seq(rng, 1003, n_frac=0.05)
    codes = seq_to_codes(seq)
    packed, nmask, L = pack_bases_np(codes)
    out = np.asarray(unpack_bases(jnp.asarray(packed), jnp.asarray(nmask), L))
    want = np.where(codes >= 4, 255, codes).astype(np.uint8)
    assert np.array_equal(out, want)


@pytest.mark.parametrize("ngenomes", [3, 40])
def test_bucket_query_matches_oracle(rng, ngenomes):
    import jax.numpy as jnp

    from panagram_tpu.ops.codec import pack_kmers

    seqs = [random_seq(rng, 900, n_frac=0.01) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = build_dictionary(sets, K)
    bd = BucketedDict.build(d.keys, d.masks, ngenomes, K)
    assert bd.stride % 64 == 0

    seq = seqs[0]
    want = anchor_np(seq, K, d.keys, d.masks)

    canon, _ = pack_kmers(jnp.asarray(seq_to_codes(seq)), K)
    (t1,) = bd.device_arrays()
    rows = np.asarray(bucket_query(canon, t1, bd.nbits, bd.cap, bd.nwords))
    assert np.array_equal(rows, want)


@pytest.mark.parametrize("ngenomes", [3, 40])
def test_bucket_query_sorted_matches_gather(rng, ngenomes):
    """bucket_query over both table forms it accepts — the packed-row
    device table (device_arrays) and a plain [B, stride] table — equals
    the numpy oracle for hits, misses and N-window sentinels, at a query
    count that is no power of two.  (The name is the one this test had
    when it compared the since-removed sorted merge probe with this
    gather; it is kept so the test's record stays continuous.)"""
    import jax.numpy as jnp

    from panagram_tpu.ops.codec import pack_kmers

    seqs = [random_seq(rng, 2200, n_frac=0.02) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = build_dictionary(sets, K)
    bd = BucketedDict.build(d.keys, d.masks, ngenomes, K)

    seq = seqs[0] + random_seq(rng, 701, n_frac=0.1)  # extra misses + Ns
    want = anchor_np(seq, K, d.keys, d.masks)
    canon, _ = pack_kmers(jnp.asarray(seq_to_codes(seq)), K)
    assert canon.shape[0] & (canon.shape[0] - 1)      # ragged count
    (packed,) = bd.device_arrays()
    plain = jnp.asarray(bd.table)                     # [B, stride]
    for table in (packed, plain):
        got = np.asarray(
            bucket_query(canon, table, bd.nbits, bd.cap, bd.nwords))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [5, 16, 21, 31])
def test_pack_mix_matches_oracle(rng, k):
    """mix64(pack_kmers_packed) — the probe's input — equals the numpy
    oracle's splitmix64 of the canonical k-mers, with N windows mapped to
    mix64(SENTINEL), across odd/even k and both u32 halves."""
    import jax.numpy as jnp

    from panagram_tpu.ops.codec import SENTINEL, pack_kmers_packed

    L = 16 * 1024 * 3 + 7
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.choice(L, L // 50, replace=False)] = 255
    packed, nmask, L2 = pack_bases_np(codes)
    canon, valid = pack_kmers_packed(jnp.asarray(packed),
                                     jnp.asarray(nmask), L2, k)
    got = np.asarray(mix64(canon))

    want_c, want_v = canonical_kmers_np(codes, k)
    want = mix64_np(np.where(want_v, want_c, SENTINEL))
    assert np.array_equal(np.asarray(valid), want_v)
    assert np.array_equal(got, want)


def test_bucket_build_retries_until_fit(rng):
    """An overloaded initial layout must grow nbits until every bucket
    fits (single-probe guarantee), and all keys stay findable."""
    keys = np.unique(rng.integers(0, 1 << 62, 5000, dtype=np.uint64))
    masks = rng.integers(1, 1 << 31, (len(keys), 1)).astype(np.uint32)

    import jax.numpy as jnp

    old = BucketedDict.MEAN_LOAD
    try:
        BucketedDict.MEAN_LOAD = 2000  # absurd target load -> forces retries
        bd = BucketedDict.build(keys, masks, 32, 21)
    finally:
        BucketedDict.MEAN_LOAD = old
    (t1,) = bd.device_arrays()
    miss = rng.integers(0, 1 << 62, 500, dtype=np.uint64)
    miss = miss[~np.isin(miss, keys)]
    q = np.concatenate([keys, miss])
    rows = np.asarray(bucket_query(jnp.asarray(q), t1, bd.nbits, bd.cap,
                                   bd.nwords))
    assert np.array_equal(rows[: len(keys), 0], masks[:, 0])
    assert (rows[len(keys):] == 0).all()


def test_anchor_chunk_fast(rng):
    import jax.numpy as jnp

    from panagram_tpu.ops.anchor import anchor_chunk_fast

    ngenomes = 6
    seqs = [random_seq(rng, 1500, n_frac=0.02) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = build_dictionary(sets, K)
    bd = BucketedDict.build(d.keys, d.masks, ngenomes, K)
    (t1,) = bd.device_arrays()

    seq = seqs[1]
    codes = seq_to_codes(seq)
    packed, nmask, L = pack_bases_np(codes)
    nbytes = (ngenomes + 7) // 8
    by, popc, colsums = anchor_chunk_fast(
        jnp.asarray(packed), jnp.asarray(nmask), t1,
        L, K, bd.nbits, bd.cap, bd.nwords, nbytes,
    )
    want_rows = anchor_np(seq, K, d.keys, d.masks)
    assert np.array_equal(np.asarray(by), masks_to_bytes_np(want_rows, nbytes))
    assert np.array_equal(np.asarray(popc), popcount_np(want_rows))
    bits = np.unpackbits(want_rows.astype("<u4").view(np.uint8), axis=1,
                         bitorder="little")
    assert np.array_equal(np.asarray(colsums)[:ngenomes],
                          bits[:, :ngenomes].sum(axis=0))


def test_anchor_chunk_rle2(rng):
    import jax.numpy as jnp

    from panagram_tpu.ops.anchor import (
        anchor_chunk_rle2,
        collect_rle2,
        dispatch_rle_prefix,
        pack_bases_combined,
        rle2_colsums,
        unpack_rle2,
    )

    ngenomes = 9
    seqs = [random_seq(rng, 1700, n_frac=0.02) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = build_dictionary(sets, K)
    bd = BucketedDict.build(d.keys, d.masks, ngenomes, K)
    (t1,) = bd.device_arrays()
    nbytes = (ngenomes + 7) // 8

    seq = seqs[0]
    codes = seq_to_codes(seq)
    inbuf, L = pack_bases_combined(codes)
    P = L - K + 1
    out = anchor_chunk_rle2(
        jnp.asarray(inbuf), t1, L, K, bd.nbits, bd.cap,
        bd.nwords, nbytes, P,
    )
    data_rows, count = collect_rle2(dispatch_rle_prefix(out), out)
    assert data_rows is not None and count <= P
    by, popc = unpack_rle2(data_rows, count, P, nbytes)

    want_rows = anchor_np(seq, K, d.keys, d.masks)
    assert np.array_equal(by, masks_to_bytes_np(want_rows, nbytes))
    assert np.array_equal(popc, popcount_np(want_rows))
    bits = np.unpackbits(want_rows.astype("<u4").view(np.uint8), axis=1,
                         bitorder="little")
    assert np.array_equal(rle2_colsums(data_rows, count, P, ngenomes),
                          bits[:, :ngenomes].sum(axis=0))
    # popc-only decode (the multi-host sharded drain's cheap path)
    from panagram_tpu.ops.anchor import rle2_popc

    assert np.array_equal(rle2_popc(data_rows, count, P, nbytes), popc)
    pbuf = np.empty(P + 7, np.int32)
    assert np.array_equal(
        rle2_popc(data_rows, count, P, nbytes, out=pbuf), popc)

    # overflow detection: a capacity smaller than the run count must
    # surface via the header (data_rows None) with the TRUE count intact
    out2 = anchor_chunk_rle2(
        jnp.asarray(inbuf), t1, L, K, bd.nbits, bd.cap,
        bd.nwords, nbytes, 4,
    )
    rows2, count2 = collect_rle2(dispatch_rle_prefix(out2), out2)
    assert rows2 is None and count2 == count


def test_collect_rle2_piecewise(rng):
    """Counts beyond the speculative prefix stream in dynamic-slice pieces;
    the assembled rows must equal a direct full read (exercised with tiny
    prefix/piece sizes via monkeypatching the module constants)."""
    import jax.numpy as jnp

    from panagram_tpu.ops import anchor as A

    ngenomes = 3
    seqs = [random_seq(rng, 3000, n_frac=0.03) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = build_dictionary(sets, K)
    bd = BucketedDict.build(d.keys, d.masks, ngenomes, K)
    (t1,) = bd.device_arrays()
    nbytes = (ngenomes + 7) // 8

    codes = seq_to_codes(seqs[1])
    inbuf, L = A.pack_bases_combined(codes)
    P = L - K + 1
    out = A.anchor_chunk_rle2(
        jnp.asarray(inbuf), t1, L, K, bd.nbits, bd.cap,
        bd.nwords, nbytes, P)
    full = np.asarray(out)
    want_count = int(full[0, :4].copy().view("<u4")[0])
    want_rows = full[1 : 1 + want_count]

    old_piece = A._PIECE
    try:
        A._PIECE = 32
        A._piece_fns.clear()
        # undersized speculative read (hint=0 -> 1 piece): the drain must
        # stream the remainder through the cached slice program
        rows, count = A.collect_rle2(A.dispatch_rle_prefix(out, 0), out)
        assert count == want_count
        assert np.array_equal(rows, want_rows)
        # exact-size speculative read assembled from many async pieces
        rows2, count2 = A.collect_rle2(
            A.dispatch_rle_prefix(out, want_count), out)
        assert count2 == want_count
        assert np.array_equal(rows2, want_rows)
        # caller-buffer reuse
        buf = np.zeros((out.shape[0], out.shape[1]), np.uint8)
        rows3, _ = A.collect_rle2(A.dispatch_rle_prefix(out, 0), out, out=buf)
        assert np.array_equal(rows3, want_rows)
    finally:
        A._PIECE = old_piece
        A._piece_fns.clear()


@pytest.mark.parametrize("ngenomes", [30, 40])
def test_anchor_chunk_rle4(rng, ngenomes):
    """Palette protocol parity vs the oracle (W=1 and W=2), including
    runs longer than 255 positions (continuation rows share a palette
    entry) and N windows."""
    import jax.numpy as jnp

    from panagram_tpu.ops import anchor as A

    seqs = [random_seq(rng, 1700, n_frac=0.02) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = build_dictionary(sets, K)
    bd = BucketedDict.build(d.keys, d.masks, ngenomes, K)
    (t1,) = bd.device_arrays()
    nbytes = (ngenomes + 7) // 8

    # a 700-base poly-A stretch: every window maps to ONE k-mer -> a run
    # far beyond the 255-delta limit
    seq = seqs[0][:400] + "A" * 700 + seqs[0][400:]
    codes = seq_to_codes(seq)
    inbuf, L = A.pack_bases_combined(codes)
    P = L - K + 1
    pal_work = A.pal_work_for(P)
    data, pal = A.anchor_chunk_rle4(
        jnp.asarray(inbuf), t1, L, K, bd.nbits, bd.cap,
        bd.nwords, nbytes, pal_work)
    assert data.shape == (pal_work + 1, 3)
    assert pal.shape == (A.PAL_CAP + 3, A.rle4_pal_bytes(nbytes))
    data_rows, pal_bytes, count, U = A.collect_rle4(
        A.dispatch_rle4_prefix(data, pal), data, pal, pal_work)
    assert data_rows is not None and 0 < U <= count <= P
    by, popc = A.unpack_rle4(data_rows, pal_bytes, count, P, nbytes)
    v3rows = A.rle4_to_v3_rows(data_rows, pal_bytes, count, nbytes)

    want_rows = anchor_np(seq, K, d.keys, d.masks)
    assert np.array_equal(by, masks_to_bytes_np(want_rows, nbytes))
    assert np.array_equal(popc, popcount_np(want_rows))
    bits = np.unpackbits(
        np.ascontiguousarray(want_rows.astype("<u4")).view(np.uint8)
        .reshape(P, 4 * bd.nwords), axis=1, bitorder="little")
    want_cols = bits[:, :ngenomes].sum(axis=0)
    assert np.array_equal(A.rle2_colsums(v3rows, count, P, ngenomes),
                          want_cols)
    assert np.array_equal(
        A.rle4_colsums(data_rows, pal_bytes, count, P, ngenomes), want_cols)
    assert np.array_equal(
        A.rle4_popc(data_rows, pal_bytes, count, P, nbytes), popc)

    # v3 and v4 must describe the same runs (count parity)
    out3 = A.anchor_chunk_rle2(
        jnp.asarray(inbuf), t1, L, K, bd.nbits, bd.cap,
        bd.nwords, nbytes, P)
    rows3, count3 = A.collect_rle2(A.dispatch_rle_prefix(out3), out3)
    assert count3 == count
    assert np.array_equal(v3rows[:, : 1 + nbytes], rows3[:, : 1 + nbytes])

    # run-count overflow past pal_work must surface with the true count
    data2, pal2 = A.anchor_chunk_rle4(
        jnp.asarray(inbuf), t1, L, K, bd.nbits, bd.cap,
        bd.nwords, nbytes, 4)
    r2, p2, count2, _ = A.collect_rle4(
        A.dispatch_rle4_prefix(data2, pal2), data2, pal2, 4)
    assert r2 is None and count2 == count


def test_unpack_rle4_python_fallback(rng, monkeypatch):
    """The pure-Python v4 decode (no native library) must match the
    native expander."""
    from panagram_tpu.ops import anchor as A

    ngenomes = 30
    seqs = [random_seq(rng, 1200, n_frac=0.02) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = build_dictionary(sets, K)
    bd = BucketedDict.build(d.keys, d.masks, ngenomes, K)
    (t1,) = bd.device_arrays()
    nbytes = (ngenomes + 7) // 8

    import jax.numpy as jnp

    codes = seq_to_codes(seqs[0])
    inbuf, L = A.pack_bases_combined(codes)
    P = L - K + 1
    pal_work = A.pal_work_for(P)
    data, pal = A.anchor_chunk_rle4(
        jnp.asarray(inbuf), t1, L, K, bd.nbits, bd.cap,
        bd.nwords, nbytes, pal_work)
    data_rows, pal_bytes, count, U = A.collect_rle4(
        A.dispatch_rle4_prefix(data, pal), data, pal, pal_work)
    by_n, popc_n = A.unpack_rle4(data_rows, pal_bytes, count, P, nbytes)
    monkeypatch.setattr(A, "_rle_expand_pal_native", None)
    monkeypatch.setattr(A, "_rle_expand_native", None)
    by_p, popc_p = A.unpack_rle4(data_rows, pal_bytes, count, P, nbytes)
    assert np.array_equal(by_n, by_p)
    assert np.array_equal(popc_n, popc_p)


def test_collect_rle4_palette_overflow():
    """A palette size beyond the u16 index space must be rejected at
    collect time (the header carries the true U)."""
    import jax.numpy as jnp

    from panagram_tpu.ops import anchor as A

    data = jnp.zeros((64, 3), jnp.uint8)
    hdr = np.zeros((A.PAL_CAP + 3, 4), np.uint8)
    hdr[0, :4] = np.array([10, 0, 0, 0], np.uint8)            # count = 10
    hdr[1, :4] = np.frombuffer(
        np.uint32(A.PAL_CAP + 1).tobytes(), np.uint8)         # U overflow
    pal = jnp.asarray(hdr)
    rows, pb, count, U = A.collect_rle4(
        A.dispatch_rle4_prefix(data, pal), data, pal, 63)
    assert rows is None and count == 10 and U == A.PAL_CAP + 1


def test_stream_anchor_chunks_protocol_parity(rng, monkeypatch):
    """The shared streaming engine must produce byte-identical results
    under both transfer protocols, across chunk boundaries and through
    the dense-fallback path."""
    from panagram_tpu.ops import anchor as A

    ngenomes = 30
    seqs = [random_seq(rng, 2500, n_frac=0.02) for _ in range(ngenomes)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    d = build_dictionary(sets, K)
    bd = BucketedDict.build(d.keys, d.masks, ngenomes, K)
    (t1,) = bd.device_arrays()
    nbytes = (ngenomes + 7) // 8

    codes = seq_to_codes(seqs[0])
    nkmers = len(codes) - K + 1
    chunk = 1 << 10
    want_rows = anchor_np(seqs[0], K, d.keys, d.masks)
    want_by = masks_to_bytes_np(want_rows, nbytes)
    want_popc = popcount_np(want_rows)

    def run(proto, capacity=None):
        monkeypatch.setenv("PANAGRAM_TPU_RLE_PROTO", str(proto))
        buf = np.full(chunk + K - 1, 255, np.uint8)
        bys, popcs = [], []
        colsums = np.zeros(ngenomes, np.int64)
        state = {}
        for start, m, by, popc, cs in A.stream_anchor_chunks(
                codes, nkmers, chunk, buf, t1, bd, nbytes, ngenomes, K,
                state=state, capacity=capacity):
            bys.append(by.copy())
            popcs.append(popc.copy())
            colsums += cs
        return np.concatenate(bys), np.concatenate(popcs), colsums

    for proto in (3, 4):
        by, popc, colsums = run(proto)
        assert np.array_equal(by, want_by), f"proto {proto}"
        assert np.array_equal(popc, want_popc), f"proto {proto}"
        bits = np.unpackbits(want_by, axis=1, bitorder="little")
        assert np.array_equal(colsums, bits[:, :ngenomes].sum(axis=0))
        # tiny capacity: every chunk overflows -> dense fallback, still
        # byte-identical
        by_d, popc_d, colsums_d = run(proto, capacity=8)
        assert np.array_equal(by_d, want_by)
        assert np.array_equal(popc_d, want_popc)
        assert np.array_equal(colsums_d, colsums)


def test_cpu_anchorer_matches_oracle():
    """The C++ baseline anchorer (bench.py's honest CPU stand-in) must be
    byte-exact vs the numpy oracle — a wrong baseline is no baseline."""
    pytest.importorskip("panagram_tpu.native.anchor_cpu",
                        reason="libanchor_cpu.so not built")
    import numpy as np

    from panagram_tpu.io.fasta import seq_to_codes
    from panagram_tpu.native.anchor_cpu import CpuAnchorer
    from panagram_tpu.ops.ref_impl import (
        anchor_np,
        build_dict_np,
        genome_kmer_set,
        masks_to_bytes_np,
        popcount_np,
    )
    from tests.conftest import random_seq

    rng = np.random.default_rng(11)
    K = 21
    seqs = [random_seq(rng, 4000, n_frac=0.01) for _ in range(34)]
    sets = [genome_kmer_set([s], K) for s in seqs]
    keys, masks = build_dict_np(sets)  # 34 genomes -> 2 mask words
    ca = CpuAnchorer(keys, masks)
    nbytes = (34 + 7) // 8
    for seq in seqs[:3]:
        want = anchor_np(seq, K, keys, masks)
        by, popc = ca.anchor(seq_to_codes(seq), K, nbytes, threads=2)
        assert np.array_equal(by, masks_to_bytes_np(want, nbytes))
        assert np.array_equal(popc, popcount_np(want))


def test_hbm_budget_guard(monkeypatch):
    """Over-budget dictionaries fail LOUDLY with an actionable --mesh
    message before any allocation (SURVEY §7.4.2 scale guard); sharding
    the same key count across enough chips passes."""
    import pytest

    from panagram_tpu.ops.lookup import check_hbm_budget, table_geometry

    monkeypatch.setenv("PANAGRAM_TPU_HBM_GB", "16")
    # ~1.3e8 keys at W=1 fit one 16 GB chip; 2e9 cannot
    check_hbm_budget(int(1e8), 1)
    with pytest.raises(RuntimeError, match="--mesh"):
        check_hbm_budget(int(2e9), 1)
    # the suggested fix works: enough shards bring the per-shard table back
    check_hbm_budget(int(2e9), 1, n_shards=32)
    # W=4 (100+ genomes) halves per-chip capacity
    with pytest.raises(RuntimeError, match="mask words"):
        check_hbm_budget(int(5e8), 4)
    nbits, cap, stride = table_geometry(int(1e8), 1)
    assert stride == 64 and cap == 21


def test_query_packed_pallas_path_matches_gather(rng):
    """_query_packed — the XLA codec + one-gather probe every anchor chunk
    kernel runs — equals anchor_np position by position, on a packed-row
    device table with N windows and a ragged position count.  (The name
    is the one this test had when _query_packed also had a Pallas branch,
    since removed; it is kept so the test's record stays continuous.)"""
    import jax.numpy as jnp

    from panagram_tpu.ops import anchor as anchor_mod
    from panagram_tpu.ops.anchor import pack_bases_combined
    from panagram_tpu.ops.lookup import BucketedDict
    from panagram_tpu.ops.ref_impl import build_dict_np, canonical_kmers_np

    k = 17
    glen = 20000
    genome = rng.integers(0, 4, glen, dtype=np.uint8)
    canon_g, valid_g = canonical_kmers_np(genome, k)
    keys, masks = build_dict_np([np.unique(canon_g[valid_g])])
    bd = BucketedDict.build(keys, masks, 1, k)
    (t1,) = bd.device_arrays()

    codes = genome.copy()
    bad = rng.choice(glen, glen // 100, replace=False)
    codes[bad] = 255
    inbuf, L = pack_bases_combined(codes)
    n4 = (L + 3) // 4
    packed = jnp.asarray(inbuf[:n4])
    nmask = jnp.asarray(inbuf[n4:])

    got = np.asarray(anchor_mod._query_packed(
        packed, nmask, L, k, t1, bd.nbits, bd.cap, bd.nwords))
    want = anchor_np(codes, k, keys, masks)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_hbm_limit_without_device_limit(monkeypatch):
    """A device that reports no memory limit (the CPU backend) gets no
    assumed size: no budget, and the guard never fires; the env override
    still sets one."""
    from panagram_tpu.ops import lookup

    monkeypatch.delenv("PANAGRAM_TPU_HBM_GB", raising=False)
    assert lookup.hbm_limit_bytes() is None
    lookup.check_hbm_budget(int(1e12), 4)     # would need ~TBs: no raise
    table, layout = lookup.hbm_need_bytes(int(1e8), 1)
    assert table == (1 << 24) * 64 * 4 and layout > 0
    monkeypatch.setenv("PANAGRAM_TPU_HBM_GB", "0.5")
    assert lookup.hbm_limit_bytes() == 1 << 29
    with pytest.raises(RuntimeError, match="--mesh"):
        lookup.check_hbm_budget(int(1e8), 1)


@pytest.mark.parametrize("ngenomes,pre_sorted", [(1, True), (1, False),
                                                 (100, True)])
def test_layout_rows_big_table_path(rng, monkeypatch, ngenomes, pre_sorted):
    """Tables >= _FLAT_SCATTER_MAX u32 elements scatter through a
    [rows, 128] view (flat int32 indices overflow at exactly 2^31 — the
    1e8-key W=1 geometry).  Lower the threshold so the 2D path runs on a
    tiny table and assert it is bit-identical to the flat path."""
    import jax.numpy as jnp

    from panagram_tpu.ops import lookup
    from panagram_tpu.ops.lookup import layout_rows, mix64_np, table_geometry

    W = (ngenomes + 31) // 32
    keys = np.unique(rng.integers(0, 1 << 62, 3000, dtype=np.uint64))
    m = np.sort(mix64_np(keys))
    D = len(m)
    masks = rng.integers(1, 1 << 32, (D, W), dtype=np.uint32)
    # sentinel padding rows (the builder's fixed-capacity arrays)
    P = 1 << int(np.ceil(np.log2(D + 1)))
    mp = np.full(P, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    mp[:D] = m
    maskp = np.zeros((P, W), np.uint32)
    maskp[:D] = masks

    nbits, cap, stride = table_geometry(D, W)
    args = (jnp.asarray(mp), jnp.asarray(maskp), jnp.zeros((), jnp.int32),
            1 << nbits, cap, stride)
    t_flat, ov_flat = layout_rows(*args, bucket_in_key=True,
                                  pre_sorted=pre_sorted)
    monkeypatch.setattr(lookup, "_FLAT_SCATTER_MAX", 1)
    t_2d, ov_2d = layout_rows(*args, bucket_in_key=True,
                              pre_sorted=pre_sorted)
    assert int(ov_flat) == int(ov_2d) == 0
    assert np.array_equal(np.asarray(t_flat), np.asarray(t_2d))


@pytest.mark.parametrize("ngenomes", [1, 100])
def test_chunked_layout_matches_single_pass(rng, ngenomes):
    """The P-pass chunked device layout (donated table, bucket-range
    passes — the 1e8-key route) is bit-identical to the single-pass
    sorted layout."""
    import jax.numpy as jnp

    from panagram_tpu.ops.lookup import (
        _layout_device_chunked,
        layout_rows,
        mix64_np,
        table_geometry,
    )

    W = (ngenomes + 31) // 32
    keys = np.unique(rng.integers(0, 1 << 62, 4000, dtype=np.uint64))
    m = np.sort(mix64_np(keys))
    D = len(m)
    masks = rng.integers(1, 1 << 32, (D, W), dtype=np.uint32)
    P = 1 << int(np.ceil(np.log2(D + 1)))
    mp = np.full(P, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    mp[:D] = m
    maskp = np.zeros((P, W), np.uint32)
    maskp[:D] = masks

    nbits, cap, stride = table_geometry(D, W)
    t_flat, ov = layout_rows(jnp.asarray(mp), jnp.asarray(maskp),
                             jnp.zeros((), jnp.int32), 1 << nbits, cap,
                             stride, bucket_in_key=True, pre_sorted=True)
    t_chunk, ov_c = _layout_device_chunked(
        jnp.asarray(mp), jnp.asarray(maskp), nbits, cap, stride, D)
    assert int(ov) == int(ov_c) == 0
    # chunked returns the [B*stride/128, 128] form (no eager flatten of a
    # near-HBM table); flat returns 1D — compare as flat
    assert np.array_equal(np.asarray(t_flat),
                          np.asarray(t_chunk).reshape(-1))
