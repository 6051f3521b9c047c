"""Loader for the native C++ runtime (libvtpu).

The native library provides the host-side hot paths that are neither
device-friendly nor fast enough in Python:
  - BGZF block decompression + BAM record decoding (the reference relies
    on pysam/htslib for this; reference: velocyto/counter.py:217-306)
  - the greedy balanced-kNN loop (reference: velocyto/neighbors.py:11-140)
  - the MT19937 neighbor-sampling replay of estimate_transition_prob

The library is never shipped prebuilt: the first use in a checkout
compiles ``vtpu.cpp`` with the Makefile's flags (and again whenever the
source is newer than the library), then loads it through ctypes.  Every
entry point has a pure-Python/numpy fallback, so the package still works
(slower, with a warning) where no C++ toolchain is present.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "vtpu.cpp")
_LIB = None
_TRIED = False
BUILT_HERE = False      # whether this process compiled the library


def _lib_path() -> str:
    return os.path.join(_DIR, "libvtpu.so")


def _is_fresh(path: str) -> bool:
    return (os.path.exists(path)
            and os.path.getmtime(path) >= os.path.getmtime(_SRC))


def _build(path: str) -> None:
    """Compile the library, safe under concurrent first use: one process
    at a time builds (an exclusive lock on a file beside the source),
    into a temporary name in the same directory, and os.replace
    publishes the finished file atomically.  A process that waited on
    the lock finds a fresh library and builds nothing."""
    import fcntl
    global BUILT_HERE
    with open(os.path.join(_DIR, ".libvtpu.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _is_fresh(path):
            return
        tmp = path + ".tmp"
        subprocess.run(["make", "-s", "-C", _DIR,
                        "LIB=" + os.path.basename(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, path)
        BUILT_HERE = True


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not _is_fresh(path):
        try:
            _build(path)
        except (OSError, subprocess.SubprocessError) as exc:
            detail = getattr(exc, "stderr", "") or ""
            warnings.warn(f"libvtpu build failed, using the Python "
                          f"fallbacks: {exc} {detail}".strip())
            return None
    _LIB = ctypes.CDLL(path)
    _configure(_LIB)
    return _LIB


def _configure(lib) -> None:
    from ctypes import c_int64, c_int32, c_int, POINTER, c_double, c_char_p, c_void_p, c_uint8
    lib.vtpu_balance_knn.restype = None
    lib.vtpu_balance_knn.argtypes = [
        POINTER(c_int64),   # dsi (n, sight)
        POINTER(c_double),  # dist (n, sight)
        POINTER(c_int64),   # lsi (n,)
        POINTER(c_int64),   # constraint (n,) or NULL
        c_int64, c_int64,   # n, sight
        c_int64, c_int64,   # maxl, k
        c_int,              # return_distance
        POINTER(c_int64),   # out dsi_new (n, k+1)
        POINTER(c_double),  # out dist_new (n, k+1)
        POINTER(c_int64),   # out l (n,)
    ]
    lib.vtpu_bam_open.restype = c_void_p
    lib.vtpu_bam_open.argtypes = [c_char_p]
    lib.vtpu_bam_close.argtypes = [c_void_p]
    lib.vtpu_bam_close.restype = None
    lib.vtpu_bam_n_refs.argtypes = [c_void_p]
    lib.vtpu_bam_n_refs.restype = c_int64
    lib.vtpu_bam_ref_name.argtypes = [c_void_p, c_int64]
    lib.vtpu_bam_ref_name.restype = c_char_p
    lib.vtpu_bam_read_batch.restype = c_int64
    lib.vtpu_bam_read_batch.argtypes = [
        c_void_p,           # handle
        c_int64,            # max_reads
        c_int64,            # max_segs per read
        c_char_p, c_char_p,  # bc tag (2 chars), umi tag (2 chars)
        POINTER(c_int32),   # out chrom_id (n,)
        POINTER(c_uint8),   # out strand  (n,) 0='+', 1='-'
        POINTER(c_int64),   # out pos     (n,) 1-based
        POINTER(c_int32),   # out n_segs  (n,)
        POINTER(c_int64),   # out seg_start (n, max_segs)
        POINTER(c_int64),   # out seg_end   (n, max_segs)
        POINTER(c_int32),   # out clip5, (n,)
        POINTER(c_int32),   # out clip3  (n,)
        POINTER(c_uint8),   # out ref_skip (n,)
        POINTER(c_uint8),   # out flags_ok (n,) 1 = keep
        c_char_p,           # out bc buffer   (n * 32)
        c_char_p,           # out umi buffer  (n * 32)
        c_int,              # require_unique (NH==1)
        c_char_p,           # aux tag (2 chars) or b""
        c_char_p,           # out aux buffer (n * 32) or None
        c_int32,            # seq prefix length to decode (0 = none)
        c_char_p,           # out seq buffer (n * 32) or None
    ]
    lib.vtpu_bam_sort_by_tag.restype = c_int64
    lib.vtpu_bam_sort_by_tag.argtypes = [
        c_char_p, c_char_p, c_char_p,   # src, dst, tag
        c_int64,                        # mem_limit bytes
        c_int32, c_int32,               # n_threads, compression level
    ]
    lib.vtpu_bam_sort_by_tag_indexed.restype = c_int64
    lib.vtpu_bam_sort_by_tag_indexed.argtypes = [
        c_char_p, c_char_p, c_char_p, c_int64, c_int32, c_int32,
        c_char_p,                       # .vtx cell-index path (or None)
    ]
    lib.vtpu_bam_seek_uncompressed.restype = ctypes.c_int
    lib.vtpu_bam_seek_uncompressed.argtypes = [c_void_p, ctypes.c_uint64]
    lib.vtpu_bam_set_limit.restype = None
    lib.vtpu_bam_set_limit.argtypes = [c_void_p, ctypes.c_uint64]
    if hasattr(lib, "vtpu_bam_record_offsets"):
        lib.vtpu_bam_record_offsets.restype = c_int64
        lib.vtpu_bam_record_offsets.argtypes = [
            c_char_p, ctypes.c_uint64,          # path, stride bytes
            POINTER(ctypes.c_uint64), c_int64,  # out offsets, max_out
            POINTER(c_int64),                   # out n_records
            POINTER(ctypes.c_uint64),           # out end-of-records offset
        ]
    lib.vtpu_factorize_fixed.restype = c_int64
    lib.vtpu_factorize_fixed.argtypes = [
        c_char_p,                       # keys (n * width bytes)
        c_int64, c_int64,               # n, width
        POINTER(c_int64),               # out codes (n,)
        POINTER(c_int64),               # out firsts (n,)
    ]
    lib.vtpu_choice_noreplace_rows.restype = c_int64
    lib.vtpu_choice_noreplace_rows.argtypes = [
        ctypes.c_uint32,                # seed
        c_int64, c_int64, c_int64,      # n_rows, pop, size
        POINTER(ctypes.c_double),       # p (pop,)
        POINTER(c_int64),               # out (n_rows * size,)
    ]
    if hasattr(lib, "vtpu_choice_noreplace_rows2"):
        lib.vtpu_choice_noreplace_rows2.restype = c_int64
        lib.vtpu_choice_noreplace_rows2.argtypes = [
            ctypes.c_uint32,
            c_int64, c_int64, c_int64,
            POINTER(ctypes.c_double),
            POINTER(c_int64),
            POINTER(ctypes.c_uint32),   # out MT19937 state (625,) or None
        ]
    if hasattr(lib, "vtpu_choice_noreplace_resume"):
        lib.vtpu_mt19937_seed.restype = None
        lib.vtpu_mt19937_seed.argtypes = [ctypes.c_uint32,
                                          POINTER(ctypes.c_uint32)]
        lib.vtpu_choice_noreplace_resume.restype = c_int64
        lib.vtpu_choice_noreplace_resume.argtypes = [
            POINTER(ctypes.c_uint32),   # in/out MT19937 state (625,)
            c_int64, c_int64, c_int64,
            POINTER(ctypes.c_double),
            POINTER(c_int64),
        ]


def available() -> bool:
    return _load() is not None


def bam_sort_by_tag(src: str, dst: str, tag: str,
                    mem_limit: int = 4 << 30, n_threads: int = 0,
                    level: int = 1, write_index: bool = True) -> int:
    """Sort a BAM by an aux tag (the `samtools sort -t CB` equivalent).
    External sort with spill runs above mem_limit bytes; BGZF output is
    compressed by a thread pool.  Returns the number of records.

    write_index=True also emits `dst + ".vtx"`: the per-cell
    uncompressed-offset index that lets multi-feeder counting seek each
    feeder straight to its barcode range (see read_tag_index)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libvtpu not available")
    if n_threads <= 0:
        n_threads = max(1, (os.cpu_count() or 2) - 1)
    ix = (dst + ".vtx").encode() if write_index else None
    n = lib.vtpu_bam_sort_by_tag_indexed(src.encode(), dst.encode(),
                                         tag.encode()[:2], mem_limit,
                                         n_threads, level, ix)
    if n < 0:
        raise IOError(f"native BAM sort failed for {src}")
    return int(n)


def read_tag_index(path: str):
    """Parse a `.vtx` cell index: returns (keys list[bytes], offsets
    np.uint64 (n+1,)) where offsets[i] is the uncompressed stream offset
    of the first record with tag value keys[i] and offsets[-1] is the
    end-of-records offset.  Returns None if absent, invalid, or STALE:
    the VTX2 header records the compressed size of the BAM it was
    written with, and a mismatch (e.g. the BAM was re-sorted by a tool
    that writes no index) rejects the index rather than seeking into
    the wrong stream."""
    import os
    import struct
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < 12 or data[:4] != b"VTX2":
        return None
    (bam_size,) = struct.unpack_from("<Q", data, 4)
    bam_path = path[:-4] if path.endswith(".vtx") else None
    try:
        if bam_path is None or os.path.getsize(bam_path) != bam_size:
            return None
    except OSError:
        return None
    keys, offs = [], []
    p = 12
    while p + 12 <= len(data):
        klen, off = struct.unpack_from("<IQ", data, p)
        p += 12
        if klen == 0xFFFFFFFF:          # terminal entry
            offs.append(off)
            return keys, np.asarray(offs, dtype=np.uint64)
        if p + klen > len(data):
            return None
        keys.append(data[p:p + klen])
        p += klen
        offs.append(off)
    return None                          # missing terminal entry


def bam_record_ranges(path: str, n_ranges: int,
                      stride: Optional[int] = None):
    """Split a BAM's record stream into `n_ranges` contiguous
    (ustart, uend) uncompressed ranges at record boundaries, for ranged
    parallel scans of an un-indexed (e.g. position-sorted) BAM.  One
    native pass walks record length prefixes only (inflate-bound, no
    field/tag parse, no python).  Returns a list of ranges covering
    [first record, end-of-records), or None when the native library is
    unavailable or the scan fails."""
    lib = _load()
    if lib is None or not hasattr(lib, "vtpu_bam_record_offsets"):
        return None
    if stride is None:
        # ~8 candidate boundaries per range; the compressed size is a
        # conservative lower bound on the uncompressed span
        try:
            csize = os.path.getsize(path)
        except OSError:
            return None
        stride = max(4096, min(8 << 20, csize // (8 * max(1, n_ranges))))
    max_out = 65536
    out = np.zeros(max_out, dtype=np.uint64)
    n_records = ctypes.c_int64(0)
    u_end = ctypes.c_uint64(0)
    n = lib.vtpu_bam_record_offsets(
        path.encode(), ctypes.c_uint64(stride),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), max_out,
        ctypes.byref(n_records), ctypes.byref(u_end))
    if n <= 0:
        return None
    offs = out[:n].astype(np.int64)
    end = int(u_end.value)
    n_ranges = max(1, min(int(n_ranges), int(n)))
    # choose the recorded boundary closest to each ideal split point
    span = end - int(offs[0])
    cuts = [int(offs[0])]
    for i in range(1, n_ranges):
        target = int(offs[0]) + span * i // n_ranges
        j = int(np.searchsorted(offs, target))
        j = min(max(j, 1), len(offs) - 1)
        cut = int(offs[j])
        if cut <= cuts[-1]:
            continue
        cuts.append(cut)
    cuts.append(end)
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]


def factorize_fixed(arr: np.ndarray
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(uniques, codes) for a fixed-width numpy bytes array (dtype S*),
    exact (open-addressing hash + memcmp), uniques in first-appearance
    order.  Returns None when libvtpu is absent."""
    lib = _load()
    if lib is None:
        return None
    from ctypes import POINTER, c_int64, cast, c_char_p
    arr = np.ascontiguousarray(arr)
    n = len(arr)
    width = arr.dtype.itemsize
    codes = np.empty(n, np.int64)
    firsts = np.empty(n, np.int64)
    k = lib.vtpu_factorize_fixed(
        cast(arr.ctypes.data, c_char_p), n, width,
        codes.ctypes.data_as(POINTER(c_int64)),
        firsts.ctypes.data_as(POINTER(c_int64)))
    return arr[firsts[:k]], codes


def choice_noreplace_rows(seed: int, n_rows: int, pop: int, size: int,
                          p: np.ndarray) -> Optional[Tuple[np.ndarray, int]]:
    """numpy-RandomState-exact weighted sampling without replacement,
    one row per call of np.random.choice(pop, (size,), replace=False,
    p=p) after np.random.seed(seed) — the per-cell neighbor-sampling
    loop of estimate_transition_prob, with the identical MT19937 stream.

    Returns (idx (n_rows, size) int64, n_doubles_consumed) so the caller
    can fast-forward numpy's global stream to the matching position, or
    None when libvtpu is absent / the sampling cannot terminate (the
    python loop then reproduces numpy's own error)."""
    r = choice_noreplace_rows_state(seed, n_rows, pop, size, p)
    if r is None:
        return None
    return r[0], r[1]


def choice_noreplace_rows_state(seed: int, n_rows: int, pop: int, size: int,
                                p: np.ndarray
                                ) -> Optional[Tuple[np.ndarray, int,
                                                    Optional[tuple]]]:
    """choice_noreplace_rows + the final MT19937 state as a numpy
    set_state tuple, so the caller can position the global stream
    directly instead of re-drawing `draws` doubles (~0.4 s at the 20k
    operating point)."""
    lib = _load()
    if lib is None:
        return None
    from ctypes import POINTER, c_int64, c_double, c_uint32
    p = np.ascontiguousarray(p, dtype=np.float64)
    out = np.empty(n_rows * size, np.int64)
    has2 = hasattr(lib, "vtpu_choice_noreplace_rows2")
    state = np.empty(625, np.uint32) if has2 else None
    if has2:
        draws = lib.vtpu_choice_noreplace_rows2(
            seed & 0xFFFFFFFF, n_rows, pop, size,
            p.ctypes.data_as(POINTER(c_double)),
            out.ctypes.data_as(POINTER(c_int64)),
            state.ctypes.data_as(POINTER(c_uint32)))
    else:
        draws = lib.vtpu_choice_noreplace_rows(
            seed & 0xFFFFFFFF, n_rows, pop, size,
            p.ctypes.data_as(POINTER(c_double)),
            out.ctypes.data_as(POINTER(c_int64)))
    if draws < 0:
        return None
    np_state = None
    if has2:
        np_state = ("MT19937", state[:624].copy(), int(state[624]), 0, 0.0)
    return out.reshape(n_rows, size), int(draws), np_state


def choice_noreplace_rows_chunked(seed: int, n_rows: int, pop: int,
                                  size: int, p: np.ndarray,
                                  n_chunks: int = 4, on_chunk=None
                                  ) -> Optional[Tuple[np.ndarray, int,
                                                      tuple]]:
    """choice_noreplace_rows_state, produced in row chunks: after each
    chunk of rows is sampled, ``on_chunk(lo, hi, rows_view)`` fires so
    the caller can start (async) device uploads while the MT19937 replay
    continues -- the sampling and the transfer of its output pipeline
    instead of serializing."""
    lib = _load()
    if lib is None or not hasattr(lib, "vtpu_choice_noreplace_resume"):
        r = choice_noreplace_rows_state(seed, n_rows, pop, size, p)
        if r is None:
            return None
        if on_chunk is not None and n_rows:
            on_chunk(0, n_rows, r[0])
        return r
    from ctypes import POINTER, c_int64, c_double, c_uint32
    p = np.ascontiguousarray(p, dtype=np.float64)
    state = np.empty(625, np.uint32)
    lib.vtpu_mt19937_seed(seed & 0xFFFFFFFF,
                          state.ctypes.data_as(POINTER(c_uint32)))
    out = np.empty((n_rows, size), np.int64)
    draws = 0
    bounds = np.linspace(0, n_rows, max(1, n_chunks) + 1).astype(np.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        d = lib.vtpu_choice_noreplace_resume(
            state.ctypes.data_as(POINTER(c_uint32)), hi - lo, pop, size,
            p.ctypes.data_as(POINTER(c_double)),
            out[lo:].ctypes.data_as(POINTER(c_int64)))
        if d < 0:
            return None
        draws += d
        if on_chunk is not None:
            on_chunk(int(lo), int(hi), out[lo:hi])
    np_state = ("MT19937", state[:624].copy(), int(state[624]), 0, 0.0)
    return out, int(draws), np_state


def balance_knn_loop(dsi: np.ndarray, dist: np.ndarray, lsi: np.ndarray,
                     maxl: int, k: int, return_distance: bool,
                     constraint: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _load()
    from ctypes import POINTER, c_int64, c_double
    n, sight = dsi.shape
    dsi = np.ascontiguousarray(dsi, dtype=np.int64)
    dist = np.ascontiguousarray(dist, dtype=np.float64)
    lsi = np.ascontiguousarray(lsi, dtype=np.int64)
    dsi_new = -1 * np.ones((n, k + 1), np.int64)
    dist_new = np.zeros((n, k + 1), np.float64)
    l = np.zeros(n, np.int64)
    cst_ptr = None
    if constraint is not None:
        constraint = np.ascontiguousarray(constraint, dtype=np.int64)
        cst_ptr = constraint.ctypes.data_as(POINTER(c_int64))
    lib.vtpu_balance_knn(
        dsi.ctypes.data_as(POINTER(c_int64)),
        dist.ctypes.data_as(POINTER(c_double)),
        lsi.ctypes.data_as(POINTER(c_int64)),
        cst_ptr, n, sight, maxl, k, int(return_distance),
        dsi_new.ctypes.data_as(POINTER(c_int64)),
        dist_new.ctypes.data_as(POINTER(c_double)),
        l.ctypes.data_as(POINTER(c_int64)))
    if not return_distance:
        dist_new = np.ones_like(dsi_new, np.float64)
    return dist_new, dsi_new, l
