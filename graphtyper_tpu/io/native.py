"""ctypes bindings to the native host runtime (native/libgt_native.so):
libdeflate-backed BGZF decompression, single-pass BAM decoding into packed
numpy arrays, and fast k-mer packing.

The library is built from the sources in native/ (`make -C native`); when
it is missing, the first `get_lib()` builds it, one process at a time. The
pure-Python implementations remain the fallback when it cannot be built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)
LIB_PATH = os.path.join(NATIVE_DIR, "libgt_native.so")

_LIB = None


def build() -> bool:
    """`make -C native` under an exclusive lock (concurrent processes, such
    as test workers, wait for one build). True when the library exists."""
    import fcntl
    import shutil
    import subprocess

    if not os.path.exists(os.path.join(NATIVE_DIR, "Makefile")) or shutil.which("make") is None:
        return False
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = subprocess.run(
            ["make", "-C", NATIVE_DIR, f"-j{min(8, os.cpu_count() or 1)}"],
            capture_output=True,
            text=True,
        )
    if done.returncode != 0:
        from graphtyper_tpu.utils.log import get_logger

        get_logger().warning("native build failed:\n%s", done.stderr[-4000:])
    return os.path.exists(LIB_PATH)


def native_thread_count() -> int:
    """Worker threads for the native loops: GT_NATIVE_THREADS if it parses
    to a positive int, else min(8, cpu count). Malformed values fall back
    rather than abort (they are a tuning knob, not a correctness input)."""
    raw = os.environ.get("GT_NATIVE_THREADS", "")
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n > 0:
        return n
    return min(8, os.cpu_count() or 1)


def get_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(LIB_PATH) and not build():
        return None
    lib = ctypes.CDLL(LIB_PATH)
    lib.gt_bgzf_decompress.restype = ctypes.c_int64
    lib.gt_bgzf_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    if hasattr(lib, "gt_bgzf_decompress_mt"):
        lib.gt_bgzf_decompress_mt.restype = ctypes.c_int64
        lib.gt_bgzf_decompress_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ]
    lib.gt_bam_scan.restype = ctypes.c_int32
    lib.gt_bam_scan.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int64)] * 5
    lib.gt_bam_fill.restype = ctypes.c_int32
    lib.gt_bam_fill.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 15
    lib.gt_pack_kmers.restype = ctypes.c_int64
    lib.gt_pack_kmers.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def bgzf_decompress(raw: bytes) -> bytes | None:
    """Whole-file BGZF decompression through libdeflate; None -> fall back.
    Blocks inflate in parallel when the file is pure BGZF (the BC extra
    field gives every block's offsets up front); plain-gzip members fall
    back to the serial member walk."""
    lib = get_lib()
    if lib is None:
        return None
    inp = np.frombuffer(raw, dtype=np.uint8)
    size = lib.gt_bgzf_decompress(inp.ctypes.data, len(raw), None, 0)
    if size < 0:
        return None
    out = np.empty(int(size), dtype=np.uint8)
    if hasattr(lib, "gt_bgzf_decompress_mt"):
        got = lib.gt_bgzf_decompress_mt(inp.ctypes.data, len(raw), out.ctypes.data, int(size), 0)
        if got == size:
            return out.tobytes()
        if got != -2:
            return None
    got = lib.gt_bgzf_decompress(inp.ctypes.data, len(raw), out.ctypes.data, int(size))
    if got != size:
        return None
    return out.tobytes()


def decode_bam_arrays(data: bytes):
    """Decode BAM alignment records (after the header) into packed arrays.

    Returns None on failure, else a dict with keys ref_id, pos, flag, mapq,
    mate_ref_id, mate_pos, tlen, qlen, seqs [N, L] codes, quals [N, L],
    cigar_ops/cigar_lens/cigar_offsets, names/name_offsets and header_end.
    """
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    header_end = ctypes.c_int64()
    n_records = ctypes.c_int64()
    max_qlen = ctypes.c_int64()
    total_cigar = ctypes.c_int64()
    total_names = ctypes.c_int64()
    rc = lib.gt_bam_scan(
        buf.ctypes.data, len(data),
        ctypes.byref(header_end), ctypes.byref(n_records), ctypes.byref(max_qlen),
        ctypes.byref(total_cigar), ctypes.byref(total_names),
    )
    if rc != 0:
        return None
    n = int(n_records.value)
    L = max(int(max_qlen.value), 1)
    out = {
        "ref_id": np.empty(n, dtype=np.int32),
        "pos": np.empty(n, dtype=np.int64),
        "flag": np.empty(n, dtype=np.uint16),
        "mapq": np.empty(n, dtype=np.uint8),
        "mate_ref_id": np.empty(n, dtype=np.int32),
        "mate_pos": np.empty(n, dtype=np.int64),
        "tlen": np.empty(n, dtype=np.int32),
        "qlen": np.empty(n, dtype=np.int32),
        "seqs": np.full((n, L), 5, dtype=np.uint8),
        "quals": np.zeros((n, L), dtype=np.uint8),
        "cigar_ops": np.empty(int(total_cigar.value), dtype=np.uint8),
        "cigar_lens": np.empty(int(total_cigar.value), dtype=np.int32),
        "cigar_offsets": np.empty(n + 1, dtype=np.int64),
        "names": np.empty(int(total_names.value), dtype=np.uint8),
        "name_offsets": np.empty(n + 1, dtype=np.int64),
        "header_end": int(header_end.value),
    }
    rc = lib.gt_bam_fill(
        buf.ctypes.data, len(data), int(header_end.value), L,
        out["ref_id"].ctypes.data, out["pos"].ctypes.data, out["flag"].ctypes.data,
        out["mapq"].ctypes.data, out["mate_ref_id"].ctypes.data, out["mate_pos"].ctypes.data,
        out["tlen"].ctypes.data, out["qlen"].ctypes.data,
        out["seqs"].ctypes.data, out["quals"].ctypes.data,
        out["cigar_ops"].ctypes.data, out["cigar_lens"].ctypes.data, out["cigar_offsets"].ctypes.data,
        out["names"].ctypes.data, out["name_offsets"].ctypes.data,
    )
    if rc != 0:
        return None
    return out


def pack_kmers_native(codes: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    n = len(codes)
    if n < 32:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    kmers = np.empty(n - 31, dtype=np.uint64)
    valid = np.empty(n - 31, dtype=np.uint8)
    lib.gt_pack_kmers(codes.ctypes.data, n, kmers.ctypes.data, valid.ctypes.data)
    return kmers, valid.astype(bool)
