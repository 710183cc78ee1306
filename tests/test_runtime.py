"""Process set-up that runs before any device work: the compile-cache
location, one card per process, and the GPU-only source rules."""

import os
import pathlib
import re

import pytest

from panagram_tpu import cache
from panagram_tpu.parallel import mesh
from panagram_tpu.parallel.mesh import local_cards

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set (and nothing else is set);
    otherwise the cache sits at the fixed, gitignored <checkout>/.jax_cache."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
        return
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    want = str(REPO / ".jax_cache")
    assert cache.compile_cache_dir() == want
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    try:
        assert cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("pid,per,cards,env,want", [
    (1, 1, 4, {}, [1]),                              # one host, 4 cards
    (3, 1, 4, {"LOCAL_WORLD_SIZE": "4"}, [3]),
    (1, 1, 1, {}, [0]),                              # 2 hosts x 1 card
    (5, 1, 4, {}, [1]),                              # 2 hosts x 4 cards
    (5, 1, 4, {"LOCAL_RANK": "2"}, [2]),             # launcher's rank wins
    (1, 8, 8, {}, [0, 1, 2, 3, 4, 5, 6, 7]),         # --mesh 16, 2 hosts
    (1, 2, 4, {}, [2, 3]),                           # --mesh 4, one host
    (1, 1, None, {}, None),                          # CPU backend
    (0, 1, 4, {"LOCAL_WORLD_SIZE": "5"}, "raise"),   # 5 on a 4-card host
    (0, 2, 4, {"LOCAL_WORLD_SIZE": "3"}, "raise"),   # 3 x 2 cards on 4
    (0, 8, 4, {}, "raise"),                          # share above the host
    (0, 1, 2, {"LOCAL_RANK": "2"}, "raise")])
def test_local_cards(pid, per, cards, env, want):
    """Each process owns the block of cards of its slot on its own host;
    more processes on one host than its cards hold is refused up front,
    and a process that will not run on CUDA pins nothing."""
    if want == "raise":
        with pytest.raises(RuntimeError, match="card"):
            local_cards(pid, per, cards, env)
    else:
        assert local_cards(pid, per, cards, env) == want


def test_cpu_platform_pins_nothing(monkeypatch):
    """Under JAX_PLATFORMS=cpu (the test processes' setting) no CUDA card
    count is asked for and no card is pinned, whatever the host holds; an
    uneven mesh share is refused before that."""
    import jax

    assert jax.config.jax_platforms == "cpu"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "64")
    assert mesh.cuda_card_count() is None
    assert mesh.pin_process_cards(3, 2) is None
    assert jax.config._read("jax_cuda_visible_devices") == "all"
    with pytest.raises(ValueError, match="whole multiple"):
        mesh.initialize_distributed(None, 2, 0, mesh_devices=3)


def test_no_tpu_only_code():
    """No Mosaic-TPU import or TPU backend branch is left in the package,
    the tools or the benchmark."""
    files = [*(REPO / "panagram_tpu").rglob("*.py"),
             *(REPO / "tools").rglob("*.py"), REPO / "bench.py"]
    bad = re.compile(r"pallas\.tpu|pallas import tpu|pltpu|"
                     r"""==\s*["']tpu["']|["']tpu["']\s*==""")
    hits = [f"{f.relative_to(REPO)}:{i}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if bad.search(line)]
    assert len(files) > 40 and hits == []
