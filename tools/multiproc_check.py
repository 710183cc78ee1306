#!/usr/bin/env python
"""Two-process index builds checked byte for byte against a one-process build.

Runs, on chip_smoke.py's founder-structured genomes (cut to --mbp):

  one         python -m panagram_tpu index ... (one process, the reference)
  files       --num-processes 2: the file-coordinated build DAG, one card
              per process (cards 0 and 1)
  mesh        --mesh 4 --num-processes 2 --coordinator localhost:PORT: two
              cards per process (0-1 and 2-3)
  mesh-hosts  --mesh 2, each process shown one card through
              CUDA_VISIBLE_DEVICES (cards 2 and 3) with LOCAL_WORLD_SIZE=1,
              as two hosts of one card each would be

and compares every anchor's decompressed bitmaps, chrs.tsv and
bitsum.bins.tsv with the one-process build.  On a GPU host it samples
nvidia-smi meanwhile and requires every card that a mode should have pinned
to have been used by it (a JAX process reserves most of its card, so two
processes on one card fail).  This parent process never opens a device.

    python tools/multiproc_check.py                      # GPU host, 4 cards
    JAX_PLATFORMS=cpu python tools/multiproc_check.py --mbp 0.05
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# mode -> (extra CLI args, per-process env, cards it must have used)
MODES = {
    "files": ([], [{}, {}], (0, 1)),
    "mesh": (["--mesh", "4"], [{}, {}], (0, 1, 2, 3)),
    "mesh-hosts": (["--mesh", "2"],
                   [{"CUDA_VISIBLE_DEVICES": "2", "LOCAL_WORLD_SIZE": "1"},
                    {"CUDA_VISIBLE_DEVICES": "3", "LOCAL_WORLD_SIZE": "1"}],
                   (2, 3)),
}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class CardSampler:
    """Peak memory.used (MiB) per card while a mode runs, from nvidia-smi;
    empty where there is none (a CPU host)."""

    def __init__(self, path):
        self.path = path
        self.proc = None
        if shutil.which("nvidia-smi") and \
                os.environ.get("JAX_PLATFORMS", "cuda") != "cpu":
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=index,memory.used",
                 "--format=csv,noheader,nounits", "-lms", "250"],
                stdout=open(path, "w"), stderr=subprocess.DEVNULL)

    def stop(self) -> dict[int, int]:
        if self.proc is None:
            return {}
        self.proc.terminate()
        self.proc.wait(timeout=30)
        peak: dict[int, int] = {}
        for line in open(self.path):
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
                i, mib = int(parts[0]), int(parts[1])
                peak[i] = max(peak.get(i, 0), mib)
        return peak


def run_pair(mode, samples, prefix, base_env, work):
    extra, envs, cards = MODES[mode]
    port = free_port()
    sampler = CardSampler(os.path.join(work, f"smi.{mode}.csv"))
    t0 = time.perf_counter()
    procs = []
    for pid, penv in enumerate(envs):
        cmd = [sys.executable, "-m", "panagram_tpu", "index", samples,
               "-o", prefix, "-k", str(chip_smoke.K),
               "--anchor-genomes", *chip_smoke.ANCHORS, *extra,
               "--num-processes", "2", "--process-id", str(pid)]
        if extra:
            cmd += ["--coordinator", f"localhost:{port}"]
        procs.append(subprocess.Popen(
            cmd, env={**base_env, **penv}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=900)[0] for p in procs]
    wall = time.perf_counter() - t0
    peak = sampler.stop()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"{mode}: process {pid} exited {p.returncode}:\n"
                             f"{out[-4000:]}")
    print(f"{mode}: 2 processes in {wall:.1f} s; card peak memory.used "
          f"(MiB) {peak or 'not sampled'}", flush=True)
    if peak:
        idle = [c for c in cards if peak.get(c, 0) < 1024]
        if idle:
            raise SystemExit(f"{mode}: cards {idle} were not used: {peak}")


def same_outputs(ref, other, mode, mirror=False):
    names = ["chrs.tsv", "bitsum.bins.tsv"]
    if not mirror:
        names += ["bitmap.1.gz", "bitmap.100.gz"]
    for a in chip_smoke.ANCHORS:
        for name in names:
            x = open(os.path.join(ref, "anchor", a, name), "rb").read()
            y = open(os.path.join(other, "anchor", a, name), "rb").read()
            if name.endswith(".gz"):
                x, y = gzip.decompress(x), gzip.decompress(y)
            if x != y:
                raise SystemExit(f"{mode}: {other}/anchor/{a}/{name} differs "
                                 "from the one-process build")
    print(f"{mode}: {os.path.basename(other)} equal to the one-process build "
          f"({', '.join(names)})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=float, default=4.0,
                    help="genome length in Mbp (8 genomes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--modes", nargs="*", default=list(MODES),
                    choices=list(MODES))
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".multiproc"))
    args = ap.parse_args()

    # samples.tsv names the FASTAs by this path, read from the index dir
    args.workdir = os.path.abspath(args.workdir)
    shutil.rmtree(args.workdir, ignore_errors=True)
    samples = chip_smoke.make_genomes(args.workdir, args.seed,
                                      int(args.mbp * 1e6))
    env = {**os.environ, "PYTHONPATH": ROOT}
    try:
        ref = os.path.join(args.workdir, "one")
        t0 = time.perf_counter()
        one = subprocess.run(
            [sys.executable, "-m", "panagram_tpu", "index", samples,
             "-o", ref, "-k", str(chip_smoke.K),
             "--anchor-genomes", *chip_smoke.ANCHORS],
            env=env, capture_output=True, text=True)
        if one.returncode != 0:
            raise SystemExit(f"one: exited {one.returncode}:\n"
                             f"{one.stderr[-4000:]}")
        print(f"one: 1 process in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for mode in args.modes:
            prefix = os.path.join(args.workdir, mode)
            run_pair(mode, samples, prefix, env, args.workdir)
            same_outputs(ref, prefix, mode)
            if mode != "files":   # process 1's mirror of the mesh build
                same_outputs(ref, prefix + ".p1", mode, mirror=True)
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
    print("multiproc_check: ok", flush=True)


if __name__ == "__main__":
    main()
