"""FASTA/FASTQ reading and query batching.

The reading side of the reference's kseq usage (refbuilder.cpp:105,
compute_ms_pml.cpp:1417-1420) and its Kraken2-style BatchLoader
(src/batch_loader.cpp). Handles plain and gzip files.

Reference quirk preserved for output parity: BatchLoader extracts the read id
as header.substr(1, find_first_of(" \\t\\r", 1)) (batch_loader.cpp:104-106),
which keeps one delimiter character when the header has a description —
replicated verbatim in `batch_loader_id`.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


@dataclass
class SeqRecord:
    name: str      # kseq-style: up to first whitespace
    seq: bytes
    qual: bytes | None = None
    header: str = ""   # full header line without the leading > or @


def read_fastx(path: str) -> Iterator[SeqRecord]:
    """Streams FASTA or FASTQ records (gzip transparent)."""
    with _open(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        line = f.readline()
        while line and not line.strip():
            line = f.readline()
        if not line:
            return
        if line.startswith(b">"):
            header = line[1:].rstrip(b"\r\n")
            chunks = []
            for line in f:
                if line.startswith(b">"):
                    yield _fa_record(header, chunks)
                    header = line[1:].rstrip(b"\r\n")
                    chunks = []
                else:
                    chunks.append(line.strip())
            yield _fa_record(header, chunks)
        elif line.startswith(b"@"):
            while True:
                header = line[1:].rstrip(b"\r\n")
                seq = f.readline().strip()
                f.readline()  # '+'
                qual = f.readline().strip()
                yield SeqRecord(name=header.split()[0].decode() if header else "",
                                seq=bytes(seq), qual=bytes(qual),
                                header=header.decode())
                line = f.readline()
                while line and not line.strip():
                    line = f.readline()
                if not line:
                    return
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {line[:1]!r})")


def _fa_record(header: bytes, chunks) -> SeqRecord:
    return SeqRecord(name=header.split()[0].decode() if header else "",
                     seq=b"".join(chunks), header=header.decode())


def batch_loader_id(header: str) -> str:
    """Read id exactly as BatchLoader computes it (batch_loader.cpp:104-106),
    including its off-by-one keeping the delimiter."""
    line = ">" + header
    idlen = len(line)
    for j in range(1, len(line)):
        if line[j] in " \t\r":
            idlen = j
            break
    return line[1:1 + idlen]


def iter_query_reads(path: str):
    """Yields (id, seq_bytes) for a query file, with BatchLoader id semantics."""
    for rec in read_fastx(path):
        yield batch_loader_id(rec.header), rec.seq


def write_fasta(path: str, records, width: int | None = None) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            s = seq.decode() if isinstance(seq, (bytes, bytearray)) else seq
            if width:
                for i in range(0, len(s), width):
                    f.write(s[i:i + width] + "\n")
            else:
                f.write(s + "\n")


def iter_general_reads(path: str, chunk_bytes: int = 1 << 20):
    """Streams a general-text pattern file, yielding ('read_{i}', bytes) for
    each \\x01-separated record (compute_ms_pml.cpp:1219-1297) without
    loading the file into memory. Reference semantics: a record is emitted
    only at each separator, so any trailing chunk after the final \\x01
    (possibly the whole file, if no separator exists) is never emitted."""
    buf = b""
    idx = 0
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk_bytes)
            if not data:
                break
            buf += data
            parts = buf.split(b"\x01")
            buf = parts.pop()
            for part in parts:
                yield f"read_{idx}", part
                idx += 1


def batch_iter(items, batch_bases: int = 100_000):
    """Groups reads into batches of roughly `batch_bases` total bases —
    the TPU-side analog of BatchLoader's ~1000-base work units
    (batch_loader.cpp:26-76); larger because one batch feeds a whole chip."""
    batch, acc = [], 0
    for item in items:
        batch.append(item)
        acc += len(item[1])
        if acc >= batch_bases:
            yield batch
            batch, acc = [], 0
    if batch:
        yield batch
