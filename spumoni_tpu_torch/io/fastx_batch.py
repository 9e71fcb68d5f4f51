"""Array-native FASTA/FASTQ batch reader.

The role of the reference's threaded BatchLoader (batch_loader.cpp:26-76) at
TPU feed rates: the per-record Python reader (io/fasta.py) tops out around
~100k reads/s — far under the classify kernel — so the production streaming
path parses WHOLE FILE CHUNKS with numpy instead: newline positions via one
vectorized compare, sequence bytes extracted with one boolean gather, record
offsets by a grouped line-length sum. Per-read Python survives only for id
strings (a C-speed slice per record).

A batch is a `PackedReads`: one contiguous uint8 buffer of all sequence
bytes plus an int64 offsets array (offs[i]:offs[i+1] is read i), i.e. the
CSR layout every downstream stage (upper-casing, digestion, bucketed matrix
packing) consumes with whole-array ops.

Read ids preserve BatchLoader's exact semantics including its off-by-one
delimiter quirk (batch_loader.cpp:104-106 — see fasta.batch_loader_id).
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class PackedReads:
    """CSR batch of reads: buf[offs[i]:offs[i+1]] = read i's bytes."""
    ids: list
    buf: np.ndarray    # uint8, concatenated sequence bytes
    offs: np.ndarray   # int64, len(ids)+1, offs[0] == 0

    def __len__(self):
        return len(self.ids)

    @property
    def lens(self) -> np.ndarray:
        return np.diff(self.offs)

    @property
    def total_bases(self) -> int:
        return int(self.offs[-1])


def _fast_id(header: bytes) -> str:
    """BatchLoader id semantics (batch_loader.cpp:104-106): with line =
    '>' + header, idlen = index of the first ' '/'\\t'/'\\r' at j >= 1 (else
    len(line)); id = line[1:1+idlen] — keeps ONE delimiter char when a
    description exists (the reference's off-by-one, preserved for output
    parity; equals fasta.batch_loader_id, tested against it)."""
    line = b">" + header
    n = len(line)
    j = n
    for d in (b" ", b"\t", b"\r"):
        k = line.find(d, 1)
        if k != -1 and k < j:
            j = k
    return line[1:1 + j].decode()


def _parse_chunk(data: np.ndarray, fastq: bool):
    """Parses one chunk of COMPLETE records; returns (ids, buf, offs).

    data must end with a newline-terminated final record. Handles multi-line
    FASTA and 4-line FASTQ; strips '\\r'."""
    nl = np.flatnonzero(data == 10)
    starts = np.concatenate([[0], nl[:-1] + 1]) if len(nl) else \
        np.zeros(0, np.int64)
    ends = nl  # exclusive of the newline
    if len(starts) == 0:
        return [], np.zeros(0, np.uint8), np.zeros(1, np.int64)
    # drop '\r' line terminators
    ends = ends - (data[np.maximum(ends - 1, 0)] == 13)
    first = data[starts]
    nonempty = ends > starts
    if fastq:
        # 4-line records: header '@', seq, '+', qual. Blank lines are not
        # part of the FASTQ spec; filter them defensively first.
        keep = np.flatnonzero(nonempty)
        starts, ends, first = starts[keep], ends[keep], first[keep]
        if len(starts) % 4:
            raise ValueError("truncated FASTQ record")
        h_s, h_e = starts[0::4], ends[0::4]
        s_s, s_e = starts[1::4], ends[1::4]
        if not (first[0::4] == ord("@")).all() or \
           not (first[2::4] == ord("+")).all():
            raise ValueError("malformed FASTQ (expected @/+ line structure)")
        ids = [_fast_id(bytes(data[a + 1:b])) for a, b in zip(h_s, h_e)]
        lens = s_e - s_s
        offs = np.zeros(len(ids) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        # one gather for all sequence bytes
        take = _ranges_mask(len(data), s_s, s_e)
        buf = data[take]
        return ids, buf, offs
    # FASTA: header lines start '>'; a record's sequence is the concatenation
    # of the following non-header lines (stripped)
    is_h = first == ord(">")
    hidx = np.flatnonzero(is_h)
    if len(hidx) == 0:
        raise ValueError("no FASTA records in chunk")
    ids = [_fast_id(bytes(data[starts[i] + 1:ends[i]])) for i in hidx]
    # record id of every line (-1 before the first header)
    rec_of_line = np.cumsum(is_h.astype(np.int64)) - 1
    seq_lines = np.flatnonzero(~is_h & nonempty & (rec_of_line >= 0))
    line_len = ends[seq_lines] - starts[seq_lines]
    lens = np.bincount(rec_of_line[seq_lines], weights=line_len,
                       minlength=len(hidx)).astype(np.int64)
    offs = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    take = _ranges_mask(len(data), starts[seq_lines], ends[seq_lines])
    buf = data[take]
    return ids, buf, offs


def _ranges_mask(n: int, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Boolean mask of length n that is True inside every [start, end)
    range — built with two scatters + a cumsum (no per-range loop).
    The cumsum dtype is EXPLICIT: this numpy's int8 cumsum takes a ~45x
    slower per-element upcast path (12.5 s vs 0.28 s on a 67 MB chunk)."""
    d = np.zeros(n + 1, np.int8)
    np.add.at(d, starts, 1)
    np.add.at(d, ends, -1)
    return np.cumsum(d[:-1], dtype=np.int32).astype(bool)


def _open_raw(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.GzipFile(fileobj=f)
    return f


def iter_packed_batches(path: str, batch_bases: int = 4_000_000,
                        chunk_bytes: int = 1 << 26, upper: bool = False):
    """Streams `PackedReads` batches of roughly batch_bases total sequence
    bytes from a FASTA/FASTQ file (gzip transparent). Record order and id
    semantics match fasta.iter_query_reads + fasta.batch_iter. With
    upper=True sequences are upper-cased during extraction (folded into the
    native parse pass)."""
    f = _open_raw(path)
    try:
        head = f.read(1)
        if not head:
            return
        fastq = head == b"@"
        if head not in (b">", b"@"):
            # skip leading blank lines like the record reader does
            while head in (b"\n", b"\r"):
                head = f.read(1)
            if not head:
                return
            fastq = head == b"@"
            if head not in (b">", b"@"):
                raise ValueError(f"{path}: not FASTA/FASTQ "
                                 f"(starts with {head!r})")
        carry = head
        pending: list[PackedReads] = []
        acc_ids: list = []
        acc_bufs: list = []
        acc_offs = [np.zeros(1, np.int64)]
        acc_bases = 0

        def flush_full():
            nonlocal acc_ids, acc_bufs, acc_bases
            buf = np.concatenate(acc_bufs) if acc_bufs else \
                np.zeros(0, np.uint8)
            offs = np.concatenate(acc_offs)
            out = PackedReads(acc_ids, buf, offs)
            acc_ids, acc_bufs, acc_bases = [], [], 0
            acc_offs.clear()
            acc_offs.append(np.zeros(1, np.int64))
            return out

        while True:
            data = f.read(chunk_bytes)
            last = len(data) < chunk_bytes
            blob = carry + data
            if last and blob and not blob.endswith(b"\n"):
                blob += b"\n"
            if not blob:
                break
            use_native = os.environ.get("SPN_PY_PARSE") != "1"
            if not last:
                # cut at the start of the last (possibly incomplete) record:
                # FASTA -> last '\n>' ; FASTQ -> start of the last full
                # 4-line group (count newlines)
                if not fastq:
                    cut = blob.rfind(b"\n>")
                    if cut == -1:
                        carry = blob
                        continue
                    cut += 1
                else:
                    # count only newlines that terminate NON-EMPTY lines:
                    # the parsers tolerate blank lines ('' / '\r'), so a raw
                    # newline count would desynchronize the 4-line grouping
                    # and cut mid-record
                    barr = np.frombuffer(blob, np.uint8)
                    nl = np.flatnonzero(barr == 10)
                    lstart = np.concatenate([[0], nl[:-1] + 1])
                    llen = nl - lstart
                    blank = (llen == 0) | ((llen == 1)
                                           & (barr[lstart] == 13))
                    nle = nl[~blank]
                    ngroups = len(nle) // 4
                    if ngroups <= 1:
                        carry = blob
                        continue
                    cut = int(nle[4 * (ngroups - 1) - 1]) + 1
                carry = blob[cut:]
                blob = blob[:cut]
            else:
                carry = b""
            arr = np.frombuffer(blob, np.uint8)
            if use_native:
                # one C pass: parse + optional toupper + id ranges
                # (native.fastx_extract); ids sliced zero-copy from `blob`
                from ..native import fastx_extract
                buf, offs, idpos = fastx_extract(arr, fastq, upper)
                ids = [blob[idpos[2 * i]:idpos[2 * i + 1]].decode()
                       for i in range(len(offs) - 1)]
            else:
                ids, buf, offs = _parse_chunk(arr, fastq)
                if upper:
                    buf = _UPPER_LUT[buf]
            # split into batches of ~batch_bases
            i = 0
            while i < len(ids):
                # how many reads fit into the current batch
                room = batch_bases - acc_bases
                j = int(np.searchsorted(offs[i + 1:] - offs[i], room,
                                        side="left")) + i + 1
                j = min(max(j, i + 1), len(ids))
                acc_ids.extend(ids[i:j])
                acc_bufs.append(buf[offs[i]:offs[j]])
                acc_offs.append(offs[i + 1:j + 1] - offs[i]
                                + (acc_offs[-1][-1] - 0))
                acc_bases += int(offs[j] - offs[i])
                if acc_bases >= batch_bases:
                    yield flush_full()
                i = j
            if last:
                break
        if acc_ids:
            yield flush_full()
    finally:
        f.close()


_UPPER_LUT = np.arange(256, dtype=np.uint8)
_UPPER_LUT[ord("a"):ord("z") + 1] = np.arange(ord("A"), ord("Z") + 1,
                                              dtype=np.uint8)


def upper_packed(p: PackedReads) -> PackedReads:
    """Vectorized toupper over the whole batch (one LUT gather) — the
    per-read std::toupper loop of classify_reads_* (compute_ms_pml.cpp:917)."""
    return PackedReads(p.ids, _UPPER_LUT[p.buf], p.offs)


def select_records(p: PackedReads, idx: np.ndarray) -> PackedReads:
    """CSR subset: the records at `idx` (ascending), gathered into a new
    contiguous buffer — vectorized (no per-record Python loop). Backs the
    host-stride sharding of the staged fast path: each host parses the
    chunk and keeps only the records it owns (i % P == p), preserving the
    reference's global read order across the merged shard outputs."""
    idx = np.asarray(idx, dtype=np.int64)
    lens = p.offs[idx + 1] - p.offs[idx]
    offs = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    starts = np.repeat(p.offs[idx], lens)
    pos = (np.arange(offs[-1], dtype=np.int64)
           - np.repeat(offs[:-1], lens) + starts)
    return PackedReads([p.ids[j] for j in idx], p.buf[pos], offs)
