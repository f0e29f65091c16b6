"""ctypes bindings for the native host library (SA-IS, k-mer scan,
canonical classes, CHD, FASTQ parser, SAM formatter). Copy of
rapmap_tpu.native.bindings.

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
# must equal native/abi.cpp's tqm_abi_version(); a mismatched (stale) .so is
# rebuilt once, and rejected if still stale — calling through a changed
# signature corrupts memory silently, the numpy fallbacks are always safe
ABI_VERSION = 8

# the file name carries the ABI version: a process that has loaded a stale
# build gets the same stale handle back from dlopen() of the same path, so a
# rebuild under the old name would never be seen
_LIB_PATH = os.path.join(_BUILD_DIR, f"libtqm_native.abi{ABI_VERSION}.so")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


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
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64,
            ]
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.tqm_sam_se.restype = I64
        lib.tqm_sam_se.argtypes = [
            P, P, I64,          # recs, counts, B
            P, P, P, P, P, P,   # names/off, seqs/off, quals/off
            P, P, I64,          # tnames/off, n_txps
            I32, I32,           # write_unmapped, with_score
            P, I64, P,          # out, out_cap, n_records
        ]
        lib.tqm_sam_pe.restype = I64
        lib.tqm_sam_pe.argtypes = [
            P, P, I64,                 # recs, counts, B
            P, P,                      # names/off
            P, P, P, P, P, P, P, P,    # seqs1/off quals1/off seqs2/off quals2/off
            P, P, I64,                 # tnames/off, n_txps
            I32, I32,                  # write_unmapped, with_score
            P, I64, P,                 # out, out_cap, n_records
        ]
        lib.tqm_fastq_parse.restype = ctypes.c_int64
        lib.tqm_fastq_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
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


def kmer_table(sa: np.ndarray, packed: np.ndarray, smask: np.ndarray, k: int,
               chunk: int = 1 << 22):
    """SA -> (kmer_hi, kmer_lo, kmer_b, kmer_e) via the native packed-word
    scan; None when the library is missing.

    Slot intervals (kmer_b/e) follow the SA dtype: int64 SA (bigSA regime,
    possibly >= 2^31 slots) -> int64 intervals, else int32.

    packed/smask are pack_text_2bit words (words past them read as
    sentinels). The scan goes `chunk` slots at a time, twice: once to count
    the groups, then into outputs of exactly that many rows, so besides its
    results it holds one chunk's keys and flags (9 bytes a slot)."""
    lib = _load()
    if lib is None:
        return None
    sa_c = np.ascontiguousarray(sa)
    big = sa_c.dtype == np.int64
    if not big:
        sa_c = np.ascontiguousarray(sa_c, dtype=np.int32)
    tw = np.ascontiguousarray(packed, np.uint32)
    sm = np.ascontiguousarray(smask, np.uint32)
    if len(tw) != len(sm):
        raise ValueError("packed text and sentinel mask differ in length")
    n = len(sa_c)
    fn = lib.tqm_kmer_table_i64 if big else lib.tqm_kmer_table_i32
    args = (sa_c.ctypes.data, n, tw.ctypes.data, sm.ctypes.data, len(tw), k, int(chunk))
    ng = fn(*args, None, None, None, None, 0)
    if ng < 0:
        raise ValueError(f"tqm_kmer_table failed with code {ng}")
    slot_dt = np.int64 if big else np.int32
    hi, lo = np.empty(ng, np.uint32), np.empty(ng, np.uint32)
    kb, ke = np.empty(ng, slot_dt), np.empty(ng, slot_dt)
    got = fn(*args, hi.ctypes.data, lo.ctypes.data, kb.ctypes.data, ke.ctypes.data, ng)
    if got != ng:
        raise ValueError(f"tqm_kmer_table wrote {got} groups, counted {ng}")
    return hi, lo, kb, ke


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


def fastq_parse(buf: bytes, max_reads: int, pad_len: int):
    """Parse FASTQ bytes -> (codes (R,pad_len) int8, lens, name_off, name_len,
    seq_off, seq_len, qual_off, consumed_bytes). Incomplete tail not consumed."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    codes = np.empty((max_reads, pad_len), dtype=np.int8)
    lens = np.empty(max_reads, dtype=np.int32)
    name_off = np.empty(max_reads, dtype=np.int64)
    name_len = np.empty(max_reads, dtype=np.int32)
    seq_off = np.empty(max_reads, dtype=np.int64)
    seq_len = np.empty(max_reads, dtype=np.int32)
    qual_off = np.empty(max_reads, dtype=np.int64)
    consumed = ctypes.c_int64(0)
    n = lib.tqm_fastq_parse(
        buf, len(buf), max_reads, pad_len,
        codes.ctypes.data, lens.ctypes.data, name_off.ctypes.data,
        name_len.ctypes.data, seq_off.ctypes.data, seq_len.ctypes.data,
        qual_off.ctypes.data, ctypes.byref(consumed),
    )
    if n < 0:
        raise ValueError(f"malformed FASTQ at byte {consumed.value}")
    return codes, lens, name_off, name_len, seq_off, seq_len, qual_off, int(consumed.value), int(n)


def _max_len(off: np.ndarray) -> int:
    return int(np.diff(off).max()) if len(off) > 1 else 0


def _flat(items: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """list of bytes -> (flat uint8 buffer, (n+1,) int64 offsets)."""
    off = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in items], out=off[1:])
    buf = np.frombuffer(b"".join(items), dtype=np.uint8) if items else np.empty(0, np.uint8)
    return buf, off


class SamFormatter:
    """Reusable native SAM renderer; caches the transcript-name buffer and
    grows the output buffer geometrically across batches."""

    def __init__(self, txp_names: list[str]):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._tbuf, self._toff = _flat([n.encode() for n in txp_names])
        self._n_txps = len(txp_names)
        self._out = np.empty(1 << 22, dtype=np.uint8)

    def _call(self, fn, cap_hint: int, write_unmapped: bool, with_score: bool,
              *args) -> bytes:
        if len(self._out) < cap_hint:
            self._out = np.empty(int(cap_hint * 1.5), dtype=np.uint8)
        while True:
            nrec = ctypes.c_int64(0)
            n = fn(*args, self._tbuf.ctypes.data, self._toff.ctypes.data,
                   self._n_txps, 1 if write_unmapped else 0,
                   1 if with_score else 0,
                   self._out.ctypes.data, len(self._out),
                   ctypes.byref(nrec))
            if n == -1:  # buffer too small: grow and retry
                self._out = np.empty(len(self._out) * 2, dtype=np.uint8)
                continue
            if n < 0:
                raise ValueError(f"native SAM formatter failed with code {n}")
            self.last_n_records = int(nrec.value)
            return self._out[:n].tobytes()

    def se(self, names, seqs, quals, recs: np.ndarray, counts: np.ndarray,
           write_unmapped: bool = True, with_score: bool = False) -> bytes:
        B = len(names)
        nbuf, noff = _flat([n.encode() if isinstance(n, str) else n for n in names])
        sbuf, soff = _flat(seqs)
        qbuf, qoff = _flat(quals)
        c = np.ascontiguousarray(counts, dtype=np.int32)
        total = int(c.sum())
        r = np.ascontiguousarray(recs[:total], dtype=np.int32)
        line = (_max_len(noff) + 2 * _max_len(soff)
                + _max_len(self._toff) + 80)
        cap = (total + B) * line
        return self._call(
            self._lib.tqm_sam_se, cap, write_unmapped, with_score,
            r.ctypes.data, c.ctypes.data, B,
            nbuf.ctypes.data, noff.ctypes.data,
            sbuf.ctypes.data, soff.ctypes.data,
            qbuf.ctypes.data, qoff.ctypes.data,
        )

    def pe(self, names, seqs1, quals1, seqs2, quals2,
           recs: np.ndarray, counts: np.ndarray,
           write_unmapped: bool = True, with_score: bool = False) -> bytes:
        B = len(names)
        nbuf, noff = _flat([n.encode() if isinstance(n, str) else n for n in names])
        s1b, s1o = _flat(seqs1)
        q1b, q1o = _flat(quals1)
        s2b, s2o = _flat(seqs2)
        q2b, q2o = _flat(quals2)
        c = np.ascontiguousarray(counts, dtype=np.int32)
        total = int(c.sum())
        r = np.ascontiguousarray(recs[:total], dtype=np.int32)
        if r.shape[1] != (9 if with_score else 7):
            raise ValueError("PE record width does not match with_score")
        line = (_max_len(noff) + 2 * max(_max_len(s1o), _max_len(s2o))
                + _max_len(self._toff) + 80)
        cap = (2 * total + 2 * B) * line
        return self._call(
            self._lib.tqm_sam_pe, cap, write_unmapped, with_score,
            r.ctypes.data, c.ctypes.data, B,
            nbuf.ctypes.data, noff.ctypes.data,
            s1b.ctypes.data, s1o.ctypes.data,
            q1b.ctypes.data, q1o.ctypes.data,
            s2b.ctypes.data, s2o.ctypes.data,
            q2b.ctypes.data, q2o.ctypes.data,
        )
