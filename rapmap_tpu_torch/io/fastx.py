"""FASTA/FASTQ readers and batched read iteration (host pipeline).

Copy of rapmap_tpu.io.fastx. Python implementation of the kseq/FastxParser
role (SURVEY.md §2.1 #15); a C++ fast path lives in rapmap_tpu_torch/native
and is used when built. Gzip transparently supported by magic-byte sniffing.
`batched_read_pairs` is carried for the paired-end engine, which is not
ported yet.
"""

from __future__ import annotations

import gzip
import io
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from rapmap_tpu_torch.index.encode import NCODE, encode_reads


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


def read_fasta(path: str) -> Iterator[tuple[str, bytes]]:
    """Yield (name, raw sequence bytes) per record; name is up to first whitespace."""
    name = None
    chunks: list[bytes] = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name = line[1:].split()[0].decode()
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def read_fastq(path: str) -> Iterator[tuple[str, bytes, bytes]]:
    """Yield (name, seq bytes, qual bytes). Also accepts FASTA (qual = b'I'*len)."""
    with _open(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b"@"
        if first == b">":
            for name, seq in _fasta_records(f):
                yield name, seq, b"I" * len(seq)
            return
        while True:
            h = f.readline()
            if not h:
                return
            h = h.rstrip()
            if not h:
                continue
            seq = f.readline().rstrip()
            f.readline()  # '+'
            qual = f.readline().rstrip()
            yield h[1:].split()[0].decode(), seq, qual


def _fasta_records(f) -> Iterator[tuple[str, bytes]]:
    name, chunks = None, []
    for line in f:
        line = line.rstrip()
        if not line:
            continue
        if line.startswith(b">"):
            if name is not None:
                yield name, b"".join(chunks)
            name, chunks = line[1:].split()[0].decode(), []
        else:
            chunks.append(line)
    if name is not None:
        yield name, b"".join(chunks)


@dataclass
class ReadBatch:
    """Padded, encoded read batch ready for the device engine.

    codes: (B, L) int8 read codes (pad = NCODE); lens: (B,) int32.
    names/seqs/quals retained host-side for SAM emission. For pairs, a second
    batch is carried alongside (see PairBatch).
    """

    codes: np.ndarray
    lens: np.ndarray
    names: list[str]
    seqs: list[bytes]
    quals: list[bytes]

    @property
    def n(self) -> int:
        return len(self.names)


def pack_batch(records: Sequence[tuple[str, bytes, bytes]], pad_len: int, pad_n: int) -> ReadBatch:
    """Encode + pad records to (pad_n, pad_len); extra rows are all-pad."""
    B = pad_n
    codes = np.full((B, pad_len), NCODE, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    names, seqs, quals = [], [], []
    for i, (name, seq, qual) in enumerate(records):
        L = min(len(seq), pad_len)
        codes[i, :L] = encode_reads(np.frombuffer(seq[:L], dtype=np.uint8))
        lens[i] = L
        names.append(name)
        seqs.append(seq[:L])
        quals.append(qual[:L])
    return ReadBatch(codes, lens, names, seqs, quals)


_LEN_BUCKETS = (32, 48, 64, 96, 128, 160, 192, 256, 320, 384, 448, 512, 768, 1023)


def bucket_len(n: int, max_len: int) -> int:
    """Round a batch's max read length up to a small set of pad buckets so the
    engine compiles one program per bucket instead of per exact length."""
    for b in _LEN_BUCKETS:
        if n <= b <= max_len:
            return b
    return min(max_len, _LEN_BUCKETS[-1])


def _read_fastq_multi(paths: str) -> Iterator[tuple[str, bytes, bytes]]:
    """Chain comma-separated FASTQ/FASTA files (reference multi-file surface)."""
    for path in paths.split(","):
        yield from read_fastq(path)


# ---- native C parse fast path (FastxParser role, SURVEY.md §2.1 #15) --------

_STREAM_CHUNK = 8 << 20


def _byte_stream(paths: str) -> Iterator[bytes]:
    """Decompressed bytes of all files, newline-separated at file boundaries
    (concatenated FASTQ is FASTQ, so batches may span files like the Python
    chaining path)."""
    for path in paths.split(","):
        with _open(path) as f:
            tail = b"\n"
            while True:
                d = f.read(_STREAM_CHUNK)
                if not d:
                    break
                tail = d
                yield d
            if not tail.endswith(b"\n"):
                yield b"\n"


def _is_fastq(paths: str) -> bool:
    with _open(paths.split(",")[0]) as f:
        return f.read(1) == b"@"


def _native_batches(path: str, batch_size: int, max_len: int):
    """Yield (codes (batch_size, max_len) int8, lens, names, seqs, quals) with
    parse + encode in C (native/fastx.cpp). Final batch may be short (all-pad
    tail rows)."""
    from rapmap_tpu_torch.index.encode import NCODE
    from rapmap_tpu_torch.native import bindings as nat

    stream = _byte_stream(path)
    buf = b""
    eof = False
    codes = np.full((batch_size, max_len), NCODE, dtype=np.int8)
    lens = np.zeros(batch_size, dtype=np.int32)
    names: list[str] = []
    seqs: list[bytes] = []
    quals: list[bytes] = []
    got = 0
    while True:
        if buf:
            c, l, noff, nlen, soff, slen, qoff, consumed, n = nat.fastq_parse(
                buf, batch_size - got, max_len
            )
            if n:
                codes[got : got + n] = c[:n]
                lens[got : got + n] = l[:n]
                for i in range(n):
                    no, sl = int(noff[i]), int(slen[i])
                    so, qo = int(soff[i]), int(qoff[i])
                    names.append(buf[no : no + int(nlen[i])].decode())
                    seqs.append(buf[so : so + min(sl, max_len)])
                    quals.append(buf[qo : qo + min(sl, max_len)])
                got += n
            buf = buf[consumed:]
        if got == batch_size:
            yield codes, lens, names, seqs, quals
            codes = np.full((batch_size, max_len), NCODE, dtype=np.int8)
            lens = np.zeros(batch_size, dtype=np.int32)
            names, seqs, quals = [], [], []
            got = 0
            continue
        if eof:
            if buf.strip():
                raise ValueError("incomplete FASTQ record at end of input")
            if got:
                yield codes, lens, names, seqs, quals
            return
        nxt = next(stream, None)
        if nxt is None:
            eof = True
        else:
            buf = buf + nxt if buf else nxt


def _use_native(path: str) -> bool:
    if os.environ.get("TQM_NO_NATIVE_PARSE"):
        return False
    try:
        from rapmap_tpu_torch.native import bindings as nat

        return nat.available() and _is_fastq(path)
    except Exception:  # pragma: no cover
        return False


def batched_reads(path: str, batch_size: int, max_len: int) -> Iterator[ReadBatch]:
    if _use_native(path):
        for codes, lens, names, seqs, quals in _native_batches(path, batch_size, max_len):
            L = bucket_len(max((len(s) for s in seqs), default=1), max_len)
            yield ReadBatch(codes[:, :L], lens, names, seqs, quals)
        return
    buf: list[tuple[str, bytes, bytes]] = []
    for rec in _read_fastq_multi(path):
        buf.append(rec)
        if len(buf) == batch_size:
            L = bucket_len(max(len(r[1]) for r in buf), max_len)
            yield pack_batch(buf, L, batch_size)
            buf = []
    if buf:
        L = bucket_len(max(len(r[1]) for r in buf), max_len)
        yield pack_batch(buf, L, batch_size)


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Producer-thread wrapper: parse/pack batches ahead of the consumer so
    host input overlaps device compute (the reference's producer threads +
    bounded queue, upstream:include/FastxParser.hpp; enabled by -t >= 2)."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    DONE = object()

    def run():
        try:
            for x in it:
                q.put(x)
            q.put(DONE)
        except BaseException as exc:  # propagate into the consumer
            q.put(exc)

    t = threading.Thread(target=run, daemon=True, name="tqm-parse")
    t.start()
    while True:
        x = q.get()
        if x is DONE:
            t.join()
            return
        if isinstance(x, BaseException):
            t.join()
            raise x
        yield x


def batched_read_pairs(
    path1: str, path2: str, batch_size: int, max_len: int
) -> Iterator[tuple[ReadBatch, ReadBatch]]:
    if _use_native(path1) and _use_native(path2):
        it1 = _native_batches(path1, batch_size, max_len)
        it2 = _native_batches(path2, batch_size, max_len)
        for b1 in it1:
            b2 = next(it2, None)
            if b2 is None or len(b1[2]) != len(b2[2]):
                raise ValueError("paired FASTQ files have unequal record counts")
            L = bucket_len(
                max(
                    max((len(s) for s in b1[3]), default=1),
                    max((len(s) for s in b2[3]), default=1),
                ),
                max_len,
            )
            yield (
                ReadBatch(b1[0][:, :L], b1[1], b1[2], b1[3], b1[4]),
                ReadBatch(b2[0][:, :L], b2[1], b2[2], b2[3], b2[4]),
            )
        if next(it2, None) is not None:
            raise ValueError("paired FASTQ files have unequal record counts")
        return
    buf1: list[tuple[str, bytes, bytes]] = []
    buf2: list[tuple[str, bytes, bytes]] = []
    it2 = _read_fastq_multi(path2)

    def emit():
        L = bucket_len(
            max(max(len(r[1]) for r in buf1), max(len(r[1]) for r in buf2)), max_len
        )
        return pack_batch(buf1, L, batch_size), pack_batch(buf2, L, batch_size)

    for rec1 in _read_fastq_multi(path1):
        try:
            rec2 = next(it2)
        except StopIteration:
            raise ValueError("paired FASTQ files have unequal record counts")
        buf1.append(rec1)
        buf2.append(rec2)
        if len(buf1) == batch_size:
            yield emit()
            buf1, buf2 = [], []
    if buf1:
        yield emit()
