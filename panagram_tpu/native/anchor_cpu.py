"""ctypes bindings for libanchor_cpu.so — the CPU baseline anchorer.

Importing raises OSError if the library has not been built
(`make -C panagram_tpu/native`); bench.py catches that and falls back to
the (slower) numpy oracle baseline with a warning.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ._build import ensure_built

_DIR = os.path.dirname(os.path.realpath(__file__))
_LIB_PATH = os.path.join(_DIR, "libanchor_cpu.so")

ensure_built(_LIB_PATH)          # fresh checkouts: build before loading
_lib = ctypes.CDLL(_LIB_PATH)    # raises OSError when not built

# stale prebuilt artifact (the .so is gitignored): a library compiled
# before a symbol was added would otherwise raise AttributeError at the
# first binding below — rebuild once and reload, else raise OSError so
# callers degrade to pure Python instead of crashing the import
if not hasattr(_lib, "acpu_rle_expand_pal"):
    import shutil
    import tempfile

    from ._build import rebuild

    rebuild(_LIB_PATH)
    # dlopen caches by pathname — reloading the SAME path returns the old
    # mapping, so load the rebuilt file through a unique temp name (the
    # mapping survives the unlink)
    fd, _tmp = tempfile.mkstemp(prefix="libanchor_cpu_", suffix=".so",
                                dir=_DIR)
    os.close(fd)
    shutil.copy2(_LIB_PATH, _tmp)
    try:
        _lib = ctypes.CDLL(_tmp)
    finally:
        os.unlink(_tmp)
    if not hasattr(_lib, "acpu_rle_expand_pal"):
        raise OSError("libanchor_cpu.so is stale and rebuild failed "
                      "(make -C panagram_tpu/native)")

_lib.acpu_build.restype = ctypes.c_void_p
_lib.acpu_build.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
]
_lib.acpu_free.restype = None
_lib.acpu_free.argtypes = [ctypes.c_void_p]
_lib.acpu_anchor.restype = None
_lib.acpu_anchor.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
]
_lib.acpu_rle_expand.restype = None
_lib.acpu_rle_expand.argtypes = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p,
]
_lib.acpu_rle_expand_pal.restype = None
_lib.acpu_rle_expand_pal.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
]


def rle_expand_pal_native(rows: np.ndarray, pal: np.ndarray, count: int,
                          total: int, nbytes: int, out=None):
    """Decode anchor_chunk_rle4 rows ([delta u8 | idx u16 LE] + palette)
    -> (bytes u8 [total, nbytes], popc i32 [total]); same contract as
    ops.anchor.unpack_rle4's decode."""
    rows = np.ascontiguousarray(rows[:count], np.uint8)
    pal = np.ascontiguousarray(pal, np.uint8)
    # a corrupt/truncated palette header (idx >= palette rows) would make
    # the C expander read out of bounds — cheap two-stage guard: the high
    # index byte bounds the largest possible index (common case: one
    # strided byte max), the precise check only runs when that can exceed
    # the palette
    U = pal.shape[0]
    if count and int(rows[:, 2].max()) * 256 + 255 >= U:
        idx = rows[:, 1].astype(np.int32) | (rows[:, 2].astype(np.int32) << 8)
        if int(idx.max()) >= U:
            raise ValueError(
                f"palette index {int(idx.max())} out of range (U={U})")
    if out is not None:
        out_b, out_p = out
        assert out_b.shape == (total, nbytes) and out_b.dtype == np.uint8
        assert out_p.shape == (total,) and out_p.dtype == np.int32
        assert out_b.flags.c_contiguous and out_p.flags.c_contiguous
    else:
        out_b = np.empty((total, nbytes), np.uint8)
        out_p = np.empty(total, np.int32)
    _lib.acpu_rle_expand_pal(
        rows.ctypes.data_as(ctypes.c_void_p),
        pal.ctypes.data_as(ctypes.c_void_p), pal.shape[1], count, nbytes,
        total, out_b.ctypes.data_as(ctypes.c_void_p),
        out_p.ctypes.data_as(ctypes.c_void_p))
    return out_b, out_p


def rle_expand_native(rows: np.ndarray, count: int, total: int,
                      nbytes: int, out=None):
    """Decode anchor_chunk_rle2 RLE rows -> (bytes u8 [total, nbytes],
    popc i32 [total]); same contract as ops.anchor.unpack_rle2.

    `out=(out_b, out_p)` reuses caller-owned buffers: a fresh ~17 MB
    allocation per chunk pays first-touch page faults, so the streaming
    drains pass persistent buffers."""
    rows = np.ascontiguousarray(rows[:count], np.uint8)
    if out is not None:
        out_b, out_p = out
        assert out_b.shape == (total, nbytes) and out_b.dtype == np.uint8
        assert out_p.shape == (total,) and out_p.dtype == np.int32
        assert out_b.flags.c_contiguous and out_p.flags.c_contiguous
    else:
        out_b = np.empty((total, nbytes), np.uint8)
        out_p = np.empty(total, np.int32)
    _lib.acpu_rle_expand(
        rows.ctypes.data_as(ctypes.c_void_p), count, nbytes, total,
        out_b.ctypes.data_as(ctypes.c_void_p),
        out_p.ctypes.data_as(ctypes.c_void_p))
    return out_b, out_p


class CpuAnchorer:
    """Multithreaded CPU anchoring over an open-addressed hash dictionary.

    keys must be CANONICAL k-mer values (not splitmix-mixed)."""

    def __init__(self, keys: np.ndarray, masks: np.ndarray):
        keys = np.ascontiguousarray(keys, np.uint64)
        masks = np.ascontiguousarray(masks, np.uint32)
        if masks.ndim == 1:
            masks = masks[:, None]
        self.nwords = masks.shape[1]
        if self.nwords > 8:
            raise ValueError("CpuAnchorer supports up to 256 genomes")
        self._h = _lib.acpu_build(
            keys.ctypes.data_as(ctypes.c_void_p),
            masks.ctypes.data_as(ctypes.c_void_p),
            len(keys), self.nwords)

    def anchor(self, codes: np.ndarray, k: int, nbytes: int,
               threads: int | None = None, out=None):
        """codes u8 [L] -> (bytes u8 [P, nbytes], popc i32 [P]).
        `out=(out_b, out_p)` reuses caller buffers (see rle_expand_native)."""
        codes = np.ascontiguousarray(codes, np.uint8)
        P = len(codes) - k + 1
        if P <= 0:
            return (np.zeros((0, nbytes), np.uint8), np.zeros(0, np.int32))
        if out is not None:
            out_b, out_p = out
            assert out_b.shape == (P, nbytes) and out_b.dtype == np.uint8
            assert out_p.shape == (P,) and out_p.dtype == np.int32
            assert out_b.flags.c_contiguous and out_p.flags.c_contiguous
        else:
            out_b = np.empty((P, nbytes), np.uint8)
            out_p = np.empty(P, np.int32)
        _lib.acpu_anchor(
            self._h, codes.ctypes.data_as(ctypes.c_void_p), len(codes), k,
            nbytes, out_b.ctypes.data_as(ctypes.c_void_p),
            out_p.ctypes.data_as(ctypes.c_void_p),
            threads if threads else (os.cpu_count() or 1))
        return out_b, out_p

    def __del__(self):
        try:
            _lib.acpu_free(self._h)
        except Exception:
            pass
