"""ctypes bindings for the index-build native library (SA-IS, k-mer scan,
canonical classes, CHD). Copy of rapmap_tpu.native.bindings' build-side
entry points; the FASTQ parser and SAM formatter belong to the CLI slice.

Builds libtqm_native.so with make on first use, into the checkout's
build/native/ (the sources stay read-only in the package). All callers fall
back to numpy paths when the library is unavailable, except the CHD build,
which then returns None (index/chd.py) and leaves the index without the
canonical perfect hash the device engine requires.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("tqm.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_DIR)), "build", "native"
)
_LIB_PATH = os.path.join(_BUILD_DIR, "libtqm_native.so")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

# must equal native/abi.cpp's tqm_abi_version(); a mismatched (stale) .so is
# rebuilt once, and rejected if still stale — calling through a changed
# signature corrupts memory silently, the numpy fallbacks are always safe
ABI_VERSION = 6


def _abi_of(lib: ctypes.CDLL) -> int:
    if not hasattr(lib, "tqm_abi_version"):
        return 0  # pre-stamp builds
    lib.tqm_abi_version.restype = ctypes.c_int32
    lib.tqm_abi_version.argtypes = []
    return int(lib.tqm_abi_version())


def _make() -> None:
    """Build into a per-process temporary name, then rename into place, so
    concurrent first uses (test workers) never load a half-written file.
    Builds with OpenMP, and serially where the compiler has no OpenMP
    runtime (slower; the perfect hash is as valid, not necessarily the same)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        for extra in ([], ["OMPFLAGS="]):
            res = subprocess.run(
                ["make", "-C", _DIR, "-s", "-B", f"LIB={tmp}", *extra],
                capture_output=True, text=True, timeout=300,
            )
            if res.returncode == 0:
                os.replace(tmp, _LIB_PATH)
                return
            log.warning("native build %s failed:\n%s", extra or "with OpenMP",
                        res.stderr[-2000:])
        raise subprocess.SubprocessError("native library build failed")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH):
            try:
                _make()
            except (OSError, subprocess.SubprocessError) as exc:
                log.warning("native build failed: %s", exc)
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as exc:
            log.warning("native load failed: %s", exc)
            return None
        if _abi_of(lib) != ABI_VERSION:
            # stale build: rebuild once, reload, and re-check
            try:
                _make()
                lib = ctypes.CDLL(_LIB_PATH)
            except (OSError, subprocess.SubprocessError) as exc:
                log.warning("native rebuild failed: %s", exc)
                return None
            if _abi_of(lib) != ABI_VERSION:
                log.warning(
                    "libtqm_native.so ABI %s != expected %s; using numpy fallbacks",
                    _abi_of(lib), ABI_VERSION,
                )
                return None
        for nm in ("tqm_sais_u8_i32", "tqm_sais_u8_i64",
                   "tqm_sais2_u8_i32", "tqm_sais2_u8_i64"):
            fn = getattr(lib, nm)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.tqm_chd_build.restype = ctypes.c_int
        lib.tqm_chd_build.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.tqm_canonical_classes.restype = ctypes.c_int64
        lib.tqm_canonical_classes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        for nm in ("tqm_kmer_table_i32", "tqm_kmer_table_i64"):
            fn = getattr(lib, nm)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def suffix_array(text_codes: np.ndarray) -> np.ndarray:
    """SA-IS over int8/uint8 codes; int32 SA below 2^31, else int64 (bigSA)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    t = np.ascontiguousarray(text_codes, dtype=np.uint8)
    n = len(t)
    big = n >= 2**31 - 2
    dt = np.int64 if big else np.int32
    # in-place entry (n+1 scratch slot, result shifted into [0, n)) skips a
    # full result-copy pass — ~20 GB of fresh pages at genome scale
    nm2 = "tqm_sais2_u8_i64" if big else "tqm_sais2_u8_i32"
    sa = np.empty(n + 1, dtype=dt)
    rc = getattr(lib, nm2)(t.ctypes.data, sa.ctypes.data, n)
    if rc == 0:
        return _shrink(sa, n)
    if rc != -3:  # -3 = alphabet headroom missing; fall through to copy
        raise RuntimeError(f"{nm2} failed with code {rc}")
    sa = np.empty(n, dtype=dt)
    fn = lib.tqm_sais_u8_i64 if big else lib.tqm_sais_u8_i32
    rc = fn(t.ctypes.data, sa.ctypes.data, n)
    if rc != 0:
        raise RuntimeError(f"tqm_sais failed with code {rc}")
    return sa


def kmer_table(sa: np.ndarray, packed: np.ndarray, smask: np.ndarray, k: int):
    """SA -> (kmer_hi, kmer_lo, kmer_b, kmer_e) via the native packed-word
    scan; None when the library is missing.

    Slot intervals (kmer_b/e) follow the SA dtype: int64 SA (bigSA regime,
    possibly >= 2^31 slots) -> int64 intervals, else int32.

    packed/smask are pack_text_2bit words; this pads them with 2 sentinel
    words so the 3-word window loads never run off the end."""
    lib = _load()
    if lib is None:
        return None
    sa_c = np.ascontiguousarray(sa)
    big = sa_c.dtype == np.int64
    if not big:
        sa_c = np.ascontiguousarray(sa_c, dtype=np.int32)
    tw = np.concatenate([np.ascontiguousarray(packed, np.uint32), np.zeros(2, np.uint32)])
    sm = np.concatenate(
        [np.ascontiguousarray(smask, np.uint32), np.full(2, 0xFFFFFFFF, np.uint32)]
    )
    n = len(sa_c)
    hi = np.empty(n, np.uint32)
    lo = np.empty(n, np.uint32)
    slot_dt = np.int64 if big else np.int32
    kb = np.empty(n, slot_dt)
    ke = np.empty(n, slot_dt)
    fn = lib.tqm_kmer_table_i64 if big else lib.tqm_kmer_table_i32
    ng = fn(
        sa_c.ctypes.data, n, tw.ctypes.data, sm.ctypes.data, k,
        hi.ctypes.data, lo.ctypes.data, kb.ctypes.data, ke.ctypes.data,
    )
    if ng < 0:
        raise ValueError(f"tqm_kmer_table failed with code {ng}")
    return _shrink(hi, ng), _shrink(lo, ng), _shrink(kb, ng), _shrink(ke, ng)


def _shrink(arr: np.ndarray, n: int) -> np.ndarray:
    """Truncate a freshly-allocated output buffer to n entries IN PLACE
    (realloc) — `arr[:n].copy()` would re-touch the whole array."""
    if n == len(arr):
        return arr
    arr.resize(n, refcheck=False)
    return arr


def canonical_classes(khi: np.ndarray, klo: np.ndarray, k: int):
    """(classes_hi, classes_lo, fwd_row, rc_row) over canonical k-mer classes
    (class = min(kmer, rc)); None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    hi = np.ascontiguousarray(khi, dtype=np.uint32)
    lo = np.ascontiguousarray(klo, dtype=np.uint32)
    n = len(hi)
    chi = np.empty(n, np.uint32)
    clo = np.empty(n, np.uint32)
    fwd = np.empty(n, np.int32)
    rc = np.empty(n, np.int32)
    ng = lib.tqm_canonical_classes(
        hi.ctypes.data, lo.ctypes.data, n, k,
        chi.ctypes.data, clo.ctypes.data, fwd.ctypes.data, rc.ctypes.data,
    )
    if ng < 0:
        raise ValueError(f"tqm_canonical_classes failed with code {ng}")
    return _shrink(chi, ng), _shrink(clo, ng), _shrink(fwd, ng), _shrink(rc, ng)


def chd_build(
    khi: np.ndarray, klo: np.ndarray, m_bits: int, t_bits: int, seed: int,
    maxd: int = 65535, p_bits: int = 0,
):
    """Perfect-hash displacement build over (hi, lo) keys.

    p_bits > 0 partitions buckets and slots into 2^p independent stripes so
    the displacement search threads (the slot formula gains a stripe
    prefix — must match the probe's chd_p_bits).

    Returns (dir int32 (2^m_bits,), perm int32 (2^t_bits,) row index or -1),
    or None if no displacement assignment was found (caller reseeds)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    hi = np.ascontiguousarray(khi, dtype=np.uint32)
    lo = np.ascontiguousarray(klo, dtype=np.uint32)
    dirv = np.empty(1 << m_bits, dtype=np.int32)
    perm = np.empty(1 << t_bits, dtype=np.int32)
    rc = lib.tqm_chd_build(
        hi.ctypes.data, lo.ctypes.data, len(hi),
        m_bits, t_bits, seed & 0xFFFFFFFF, maxd, p_bits,
        dirv.ctypes.data, perm.ctypes.data,
    )
    if rc == -1:
        return None
    if rc != 0:
        raise ValueError(f"tqm_chd_build failed with code {rc}")
    return dirv, perm
