"""Multi-HOST collective build: two processes x 4 virtual CPU devices
joined into ONE 8-device global mesh via jax.distributed (SURVEY §5.8 /
§2.7 P8: dictionaries merged and reductions crossing hosts through the
same shard_map collectives the single-process mesh uses — on CPU they ride
the Gloo backend, on a real slice ICI/DCN).

The single-process 8-device mesh build is already proven byte-identical to
the plain build (tests/test_parallel.py), so asserting the 2-process mesh
build against the PLAIN build closes the chain end-to-end."""

import os
import socket
import subprocess
import sys

from panagram_tpu.io.bgzf import decompress_file
from tests.conftest import random_seq

K = 13


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _subproc_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # each process contributes 4 local virtual devices -> 8 global
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    return env


def _write_pangenome(rng, tmp_path):
    fa_dir = tmp_path / "fa"
    fa_dir.mkdir()
    names = ["g1", "g2", "g3", "g4"]
    for n in names:
        seq = random_seq(rng, 2000, n_frac=0.005)
        (fa_dir / f"{n}.fa").write_text(f">chr1\n{seq}\n")
    # one annotated genome: exercises the gene-histogram path (popc-only
    # decodes must agree across hosts) through the sharded drain
    gff = fa_dir / "g1.gff3"
    gff.write_text(
        "##gff-version 3\n"
        "chr1\tsrc\tgene\t101\t400\t.\t+\t.\tID=gene1;Name=GeneA\n"
        "chr1\tsrc\tgene\t901\t1500\t.\t-\t.\tID=gene2;Name=GeneB\n"
    )
    samples = tmp_path / "samples.tsv"
    samples.write_text(
        "name\tfasta\tgff\n"
        + f"g1\t{fa_dir}/g1.fa\t{gff}\n"
        + "\n".join(f"{n}\t{fa_dir}/{n}.fa\t" for n in names[1:]) + "\n")
    return names, samples


def _run_mesh_2proc(samples, mesh_dir, env, expect_ok=True):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "panagram_tpu", "index", str(samples),
             "-o", str(mesh_dir), "-k", str(K), "--mesh", "8",
             "--num-processes", "2", "--process-id", str(pid),
             "--coordinator", f"127.0.0.1:{port}"],
            env=env, stderr=subprocess.PIPE)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=900) for p in procs]
    rcs = [p.returncode for p in procs]
    if expect_ok:
        assert rcs == [0, 0], [o[1].decode()[-2000:] for o in outs]
    return rcs, [o[1].decode() for o in outs]


def test_two_process_mesh_build_matches_single(rng, tmp_path):
    names, samples = _write_pangenome(rng, tmp_path)

    env = _subproc_env()
    # small chunks: every chunk spans all 8 devices so BOTH processes own
    # bitmap rows of every chunk (C_dev = 256/8 = 32 positions)
    env["PANAGRAM_TPU_CHUNK_LOG2"] = "8"

    # plain single-process reference build
    ref_dir = tmp_path / "single"
    subprocess.check_call(
        [sys.executable, "-m", "panagram_tpu", "index", str(samples),
         "-o", str(ref_dir), "-k", str(K)], env=env)

    # default: per-host sharded drain + piece writes, primary stitches
    mesh_dir = tmp_path / "mesh2p"
    _run_mesh_2proc(samples, mesh_dir, env)

    mirror = tmp_path / "mesh2p.p1"   # process 1's mirror (derived tables)
    for n in names:
        for step in (1, 100):
            want = decompress_file(
                str(ref_dir / "anchor" / n / f"bitmap.{step}.gz"))
            got = decompress_file(
                str(mesh_dir / "anchor" / n / f"bitmap.{step}.gz"))
            assert got == want, (n, step)
            # stitched bitmap lives only under the primary; mirrors keep
            # the derived tables (identity-checked below)
            assert not (mirror / "anchor" / n / f"bitmap.{step}.gz").exists()
        # piece files are cleaned up after the stitch
        assert not list((mesh_dir / "anchor" / n).glob(".bitmap.*.part*"))
        for tsv in ("total_paircounts.csv", "bitsum.bins.tsv", "chrs.tsv"):
            want = (ref_dir / "anchor" / n / tsv).read_text()
            assert (mesh_dir / "anchor" / n / tsv).read_text() == want
            assert (mirror / "anchor" / n / tsv).read_text() == want
    # the annotated genome's gene products (built from the popc-only
    # decodes every host runs) match the single-process build
    for f in ("bitsum.genes.tsv", "anno_types.txt"):
        want = (ref_dir / "anchor" / "g1" / f).read_text()
        assert (mesh_dir / "anchor" / "g1" / f).read_text() == want
        assert (mirror / "anchor" / "g1" / f).read_text() == want
    assert decompress_file(str(mesh_dir / "anchor" / "g1" / "gene.bed.gz")) \
        == decompress_file(str(ref_dir / "anchor" / "g1" / "gene.bed.gz"))
    assert (mesh_dir / "genome_dist.tsv").exists()

    # resume: a rerun over the SAME dirs must skip every stage in
    # lockstep (anchor skip keys off the primary's stitched bitmap) and
    # leave the outputs untouched
    before = (mesh_dir / "anchor" / names[0] / "bitmap.1.gz").stat().st_mtime
    _run_mesh_2proc(samples, mesh_dir, env)
    assert (mesh_dir / "anchor" / names[0]
            / "bitmap.1.gz").stat().st_mtime == before

    # the stitched .gzi drives random access (read API on the index)
    from panagram_tpu.index import Index

    idx = Index(str(mesh_dir))
    bits = idx.query_bitmap(names[0], "chr1", 100, 200, 1)
    assert bits.shape == (100, len(names))
    idx.close()

    # opt-out: full-mirror mode (every process decodes + writes all rows)
    env0 = dict(env)
    env0["PANAGRAM_TPU_SHARD_WRITES"] = "0"
    mesh_dir0 = tmp_path / "mesh2p_mirror"
    _run_mesh_2proc(samples, mesh_dir0, env0)
    mirror0 = tmp_path / "mesh2p_mirror.p1"
    for n in names:
        want = decompress_file(str(ref_dir / "anchor" / n / "bitmap.1.gz"))
        assert decompress_file(
            str(mesh_dir0 / "anchor" / n / "bitmap.1.gz")) == want
        assert decompress_file(
            str(mirror0 / "anchor" / n / "bitmap.1.gz")) == want

    # divergent cached-stage states (here: primary's dict cache deleted,
    # mirror's intact) must fail LOUDLY at the decision point, not die in
    # the collective transport with an opaque size mismatch
    (mesh_dir / "kmc" / "pandict.npz").unlink()
    rcs, errs = _run_mesh_2proc(samples, mesh_dir, env, expect_ok=False)
    assert any(rc != 0 for rc in rcs)
    assert any("desync at 'dict-cache'" in e for e in errs), errs[0][-2000:]


def test_mesh_num_processes_requires_coordinator(tmp_path):
    from panagram_tpu.__main__ import main

    samples = tmp_path / "samples.tsv"
    samples.write_text("name\tfasta\n")
    try:
        main(["index", str(samples), "-o", str(tmp_path / "x"),
              "--mesh", "8", "--num-processes", "2"])
    except SystemExit as e:
        assert "coordinator" in str(e)
    else:
        raise AssertionError("expected SystemExit")
