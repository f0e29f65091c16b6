"""FASTA reader for the index builder (copy of rapmap_tpu.io.fastx's
`read_fasta`; the read-side FASTQ pipeline belongs to the CLI slice).
Gzip transparently supported by magic-byte sniffing."""

from __future__ import annotations

import gzip
import io
from typing import Iterator


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
