"""Reference preparation: concatenated (digested) reference, reverse
complements, null-read sampling, FASTA document index.

Re-implements src/refbuilder.cpp with matching semantics:
  * the seqtk complement table (refbuilder.cpp:22-31),
  * glibc srand(0)/rand() null-read sampling — 100 reads per record (25 once
    800 collected), random_index = rand() % (len-150), skip reads containing
    'N' in the single-file path but not in the file-list path, stop at 1000,
    whole-sequence fallback for records <= 150 bp (:111-134,246-268),
  * forward + reverse-complement records, upper-cased, optional minimizer
    digestion, and the `.fdi` document index (group_<i>\\t<len>) (:212-217).
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import NULL_READ_CHUNK, NUM_NULL_READS, NULL_READ_BOUND
from ..glibc_rand import GlibcRand
from ..io.fasta import read_fastx
from ..io.minimizers import digest

# seqtk complement table (refbuilder.cpp:22-31), identity outside [64,127]
_COMP = bytearray(range(256))
_fwd = b"ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_rev = b"TVGHEFCDIJMLKNOPQYSAABWXRZ"
for f, r in zip(_fwd, _rev):
    _COMP[f] = r
    _COMP[f + 32] = r + 32  # lowercase block maps to lowercase complements
_COMP = bytes(_COMP)


def reverse_complement(seq: bytes) -> bytes:
    return bytes(seq[::-1]).translate(_COMP)


class NullReadSampler:
    """Null-read extraction state shared across records
    (refbuilder.cpp:111-134)."""

    def __init__(self, rand: GlibcRand, skip_n: bool):
        self.rand = rand
        self.count = 0
        self.skip_n = skip_n
        self.reads: list[bytes] = []

    def extract(self, seq: bytes) -> None:
        if len(seq) > NULL_READ_CHUNK:
            to_grab = 25 if self.count >= NUM_NULL_READS else 100
            go = self.count < NULL_READ_BOUND
            i = 0
            while i < to_grab and go:
                ridx = self.rand.rand() % (len(seq) - NULL_READ_CHUNK)
                grabbed = seq[ridx:ridx + NULL_READ_CHUNK]
                if not self.skip_n or b"N" not in grabbed:
                    self.reads.append(grabbed)
                    self.count += 1
                    go = self.count < NULL_READ_BOUND
                i += 1
        else:
            # short-record fallback (refbuilder.cpp:130-134)
            self.reads.append(seq)
            self.count += 1

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for i, rd in enumerate(self.reads):
                f.write(f">read_{i}\n{rd.decode('latin-1')}\n")


def parse_null_reads(ref_file: str, output_path: str,
                     rand: GlibcRand | None = None) -> str:
    """Single-FASTA null-read extraction (refbuilder.cpp:230-274).

    Note: the reference does NOT upper-case here, and skips reads containing
    (upper-case) 'N'; extraction stops once the bound is reached.
    """
    rand = rand if rand is not None else GlibcRand(0)
    sampler = NullReadSampler(rand, skip_n=True)
    for rec in read_fastx(ref_file):
        if sampler.count >= NULL_READ_BOUND:
            break
        sampler.extract(rec.seq)
    sampler.write(output_path)
    return output_path


def parse_null_reads_from_general_text(ref_file: str, output_path: str,
                                       rand: GlibcRand | None = None) -> str:
    """General-text null chunks (refbuilder.cpp:276-316): 10 random 150-byte
    chunks per 10000-byte batch, concatenated without headers."""
    rand = rand if rand is not None else GlibcRand(0)
    batch_size = 10000
    written = 0
    out = []
    with open(ref_file, "rb") as f:
        while True:
            buf = f.read(batch_size)
            if not buf:
                break
            if len(buf) <= NULL_READ_CHUNK:
                out.append(buf)
                written += 1
            else:
                i = 0
                while i < 10 and written < NULL_READ_BOUND:
                    ridx = rand.rand() % (len(buf) - NULL_READ_CHUNK)
                    out.append(buf[ridx:ridx + NULL_READ_CHUNK])
                    written += 1
                    i += 1
            if written >= NULL_READ_BOUND:
                break
    with open(output_path, "wb") as f:
        for chunk in out:
            f.write(chunk)
    return output_path


def _emit_record(seq: bytes, name: str, use_promotions: bool,
                 use_dna_letters: bool, k: int, w: int, records, text_parts):
    """Digest/forward one sequence into the output reference."""
    if use_promotions:
        d = digest(seq, True, False, k, w)
        text_parts.append(d)   # raw byte stream, no FASTA structure
        return len(d)
    if use_dna_letters:
        d = digest(seq, False, True, k, w)
        records.append((name, d))
        text_parts.append(d)
        return len(d)
    records.append((name, seq))
    text_parts.append(seq)
    return len(seq)


class RefBuildResult:
    def __init__(self, ref_path, text, null_read_path, fdi_path=None,
                 seq_lengths=None):
        self.ref_path = ref_path          # the generated .fa / .bin file
        self.text = text                  # np.uint8 concatenated indexed text
        self.null_read_path = null_read_path
        self.fdi_path = fdi_path
        self.seq_lengths = seq_lengths    # per-document digested lengths


def build_reference(ref_file: str, output_path: str, use_promotions: bool,
                    use_dna_letters: bool, k: int, w: int, use_rev_comp: bool
                    ) -> RefBuildResult:
    """Single-FASTA reference build (refbuilder.cpp:318-394): upper-case,
    forward + reverse complement, optional digestion. Writes the output
    reference file and returns the concatenated text that gets indexed."""
    records, text_parts = [], []
    total = 0
    for rec in read_fastx(ref_file):
        seq = rec.seq.upper()
        total += _emit_record(seq, rec.name, use_promotions, use_dna_letters,
                              k, w, records, text_parts)
        if use_rev_comp:
            rc = reverse_complement(seq)
            total += _emit_record(rc, rec.name + "_rev_comp", use_promotions,
                                  use_dna_letters, k, w, records, text_parts)
    if total == 0:
        raise ValueError("After sequence digestion, there is no sequence left.")
    _write_output(output_path, use_promotions, records, text_parts)
    text = np.frombuffer(b"".join(text_parts), dtype=np.uint8)
    return RefBuildResult(output_path, text, None)


def build_reference_from_filelist(list_file: str, output_path: str,
                                  null_read_path: str, build_doc: bool,
                                  use_promotions: bool, use_dna_letters: bool,
                                  k: int, w: int, use_rev_comp: bool,
                                  rand: GlibcRand | None = None
                                  ) -> RefBuildResult:
    """File-list build with document grouping (refbuilder.cpp:33-218).

    Each line: "<path> [doc_id]"; ids must start at 1 and be non-decreasing,
    increasing by at most 1. Null reads are sampled here with upper-cased
    sequences and WITHOUT the N-filter (refbuilder.cpp:120-121 `if (true)`).
    """
    input_files, document_ids = [], []
    with open(list_file) as f:
        for line in f:
            words = line.split()
            if not words:
                continue
            path = words[0]
            if not os.path.isfile(path):
                raise FileNotFoundError(path)
            if not path.endswith((".fa", ".fasta", ".fna")):
                raise ValueError(f"not a FASTA file: {path}")
            input_files.append(path)
            if build_doc:
                if len(words) < 2:
                    raise ValueError("file-list needs a doc-id column for -d")
                did = int(words[1])
                if not document_ids and did != 1:
                    raise ValueError("first doc id must be 1")
                if document_ids and did not in (document_ids[-1],
                                                document_ids[-1] + 1):
                    raise ValueError("doc ids must stay constant or +1")
                document_ids.append(did)

    rand = rand if rand is not None else GlibcRand(0)
    sampler = NullReadSampler(rand, skip_n=False)

    records, text_parts, seq_lengths = [], [], []
    curr_len = 0
    for idx, path in enumerate(input_files):
        for rec in read_fastx(path):
            seq = rec.seq.upper()
            sampler.extract(seq)
            curr_len += _emit_record(seq, rec.name, use_promotions,
                                     use_dna_letters, k, w, records, text_parts)
            if use_rev_comp:
                rc = reverse_complement(seq)
                curr_len += _emit_record(rc, rec.name + "_rev_comp",
                                         use_promotions, use_dna_letters, k, w,
                                         records, text_parts)
        if build_doc:
            last = idx == len(input_files) - 1
            if last or document_ids[idx] != document_ids[idx + 1]:
                seq_lengths.append(curr_len)
                curr_len = 0
    if build_doc:
        total = sum(seq_lengths)
    else:
        total = curr_len
    if total == 0:
        raise ValueError("After sequence digestion, there is no sequence left.")

    _write_output(output_path, use_promotions, records, text_parts)
    sampler.write(null_read_path)

    fdi_path = None
    if build_doc:
        fdi_path = output_path + ".fdi"
        with open(fdi_path, "w") as f:
            for i, sl in enumerate(seq_lengths):
                f.write(f"group_{i + 1}\t{sl}\n")
    text = np.frombuffer(b"".join(text_parts), dtype=np.uint8)
    return RefBuildResult(output_path, text, null_read_path, fdi_path,
                          seq_lengths if build_doc else None)


def _write_output(output_path, use_promotions, records, text_parts):
    if use_promotions:
        # promoted alphabet is binary — write the raw stream (*.bin)
        with open(output_path, "wb") as f:
            for part in text_parts:
                f.write(part)
    else:
        with open(output_path, "w") as f:
            for name, seq in records:
                f.write(f">{name}\n{seq.decode('latin-1')}\n")


def read_fdi(path: str) -> list[int]:
    """Parses the .fdi document index (doc_array.cpp:110-127)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split("\t")
            if len(parts) >= 2:
                out.append(int(parts[1]))
    return out
