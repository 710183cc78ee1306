"""Two-process distributed build over a shared directory (the multi-host
'fake backend' test the reference lacks, SURVEY §4 implication c)."""

import os
import subprocess
import sys

import numpy as np

from panagram_tpu.io.bgzf import decompress_file
from tests.conftest import random_seq

K = 13


def test_two_process_build_matches_single(rng, tmp_path):
    fa_dir = tmp_path / "fa"
    fa_dir.mkdir()
    names = ["g1", "g2", "g3", "g4"]
    for n in names:
        seq = random_seq(rng, 2000, n_frac=0.005)
        (fa_dir / f"{n}.fa").write_text(f">chr1\n{seq}\n")
    samples = tmp_path / "samples.tsv"
    samples.write_text("name\tfasta\n" + "\n".join(
        f"{n}\t{fa_dir}/{n}.fa" for n in names) + "\n")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    # single-process reference build
    ref_dir = tmp_path / "single"
    subprocess.check_call(
        [sys.executable, "-m", "panagram_tpu", "index", str(samples),
         "-o", str(ref_dir), "-k", str(K)], env=env)

    # two-process distributed build of the same index
    dist_dir = tmp_path / "dist"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "panagram_tpu", "index", str(samples),
             "-o", str(dist_dir), "-k", str(K),
             "--num-processes", "2", "--process-id", str(pid)],
            env=env)
        for pid in (0, 1)
    ]
    for p in procs:
        assert p.wait(timeout=600) == 0

    for n in names:
        a = decompress_file(str(ref_dir / "anchor" / n / "bitmap.1.gz"))
        b = decompress_file(str(dist_dir / "anchor" / n / "bitmap.1.gz"))
        assert a == b
        assert ((ref_dir / "anchor" / n / "total_paircounts.csv").read_text()
                == (dist_dir / "anchor" / n / "total_paircounts.csv").read_text())
    assert (dist_dir / "genome_dist.tsv").exists()
