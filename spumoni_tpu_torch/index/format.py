"""Dense HBM-oriented index format.

Instead of the reference's Elias-Fano bitvectors + Huffman-shaped wavelet tree
(ms_rle_string.hpp, thresholds_ds.hpp), the TPU index is a set of flat arrays
grouped by character, so that rank/select/threshold/sample lookups in the
MS/PML recurrence each become one binary search + O(1) gathers:

  F[256]        # chars < c in the BWT
  cnt[256]      # number_of_letter(c)
  char_off[257] # slice of each char's runs in the tables below
  c_start[r]    # run start positions (grouped by char, BWT order inside group)
  c_len[r]      # run lengths
  c_cum[r]      # char occurrences in earlier runs of the same char
  c_thr[r]      # absolute threshold position of the run (0 for first run)
  c_ssamp[r]    # (SA[run_start]-1) mod n   [MS index only]
  c_esamp[r]    # (SA[run_end]-1) mod n     [MS index only]
  c_sdoc[r]     # start doc ids             [doc array only]
  c_edoc[r]     # end doc ids               [doc array only]
  text[n-1]     # the indexed text          [MS index only — replaces the SLP
                #  random-access structure of compute_ms_pml.cpp:769-774; plain
                #  HBM-resident text + gathers beat grammar decompression on TPU]

Serialized as a .npz + JSON manifest; the serialized index is the checkpoint
(mirrors the serialize/load pairs of compute_ms_pml.cpp:192-229,517-562).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass
class DenseIndex:
    n: int                    # BWT length (text + terminator)
    r: int                    # number of runs
    F: np.ndarray             # [256] i64
    cnt: np.ndarray           # [256] i64
    char_off: np.ndarray      # [257] i64
    c_start: np.ndarray       # [r]
    c_len: np.ndarray         # [r]
    c_cum: np.ndarray         # [r]
    c_thr: np.ndarray         # [r]
    c_ssamp: np.ndarray | None = None
    c_esamp: np.ndarray | None = None
    c_sdoc: np.ndarray | None = None
    c_edoc: np.ndarray | None = None
    text: np.ndarray | None = None     # u8 indexed text (for MS extension)
    last_run_sample: int = 0           # raw SA[n-1] (MS seed)
    last_run_edoc: int = 0
    first_run_sdoc: int = 0
    # run-major views kept for the CPU engine / doc-array build
    run_heads: np.ndarray | None = None
    run_starts: np.ndarray | None = None

    @property
    def has_samples(self) -> bool:
        return self.c_ssamp is not None

    @property
    def has_doc(self) -> bool:
        return self.c_sdoc is not None

    def index_stats(self) -> dict:
        """Component sizes in bytes (mirrors *.ms_index_stats.txt /
        *.pml_index_stats.txt of compute_ms_pml.cpp:204-209,532-538)."""
        nb = lambda a: 0 if a is None else a.nbytes
        stats = {
            "bwt size (bytes)": nb(self.c_start) + nb(self.c_len) + nb(self.c_cum)
                                + nb(self.run_heads) + nb(self.run_starts),
            "thresholds size (bytes)": nb(self.c_thr),
            "size of F (bytes)": nb(self.F) + nb(self.cnt) + nb(self.char_off),
            "terminator size (bytes)": 8,
        }
        if self.has_samples:
            stats["suffix array samples size (bytes)"] = (
                nb(self.c_ssamp) + nb(self.c_esamp))
        if self.text is not None:
            stats["text size (bytes)"] = nb(self.text)
        if self.has_doc:
            stats["document array size (bytes)"] = nb(self.c_sdoc) + nb(self.c_edoc)
        return stats


def build_dense_index(raw, text: np.ndarray | None = None,
                      with_samples: bool = False,
                      doc_start: np.ndarray | None = None,
                      doc_end: np.ndarray | None = None) -> DenseIndex:
    """Builds the dense per-character tables from native builder output.

    raw: native.RawIndex (run-major arrays, raw SA samples).
    """
    n, r = raw.n, raw.r
    heads = np.asarray(raw.run_heads, dtype=np.int64)
    starts = np.asarray(raw.run_starts, dtype=np.int64)
    run_len = np.diff(np.concatenate([starts, [n]]))

    order = np.argsort(heads, kind="stable")  # group by char, keep BWT order
    grp = heads[order]
    c_start = starts[order]
    c_len = run_len[order]

    # per-char cumulative occurrence counts
    glob_cum = np.cumsum(c_len) - c_len   # occurrences before idx, globally
    first_of_grp = np.searchsorted(grp, np.arange(256), side="left")
    grp_base = np.zeros(256, dtype=np.int64)
    valid = first_of_grp < r
    grp_base[valid] = glob_cum[first_of_grp[valid]]
    c_cum = glob_cum - grp_base[grp]

    char_off = np.searchsorted(grp, np.arange(257), side="left").astype(np.int64)
    cnt = np.bincount(heads, weights=run_len, minlength=256).astype(np.int64)
    F = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)

    conv = lambda v: np.where(v > 0, v - 1, n - 1).astype(np.int64)
    idx = DenseIndex(
        n=n, r=r, F=F, cnt=cnt, char_off=char_off,
        c_start=c_start, c_len=c_len, c_cum=c_cum,
        c_thr=np.asarray(raw.thresholds, dtype=np.int64)[order],
        run_heads=np.asarray(raw.run_heads, dtype=np.uint8),
        run_starts=starts,
        last_run_sample=int(raw.samples_last[r - 1]),
    )
    if with_samples:
        idx.c_ssamp = conv(np.asarray(raw.samples_start, dtype=np.int64))[order]
        idx.c_esamp = conv(np.asarray(raw.samples_last, dtype=np.int64))[order]
        if text is not None:
            idx.text = np.ascontiguousarray(text, dtype=np.uint8)
    if doc_start is not None and doc_end is not None:
        ds = np.asarray(doc_start, dtype=np.int64)
        de = np.asarray(doc_end, dtype=np.int64)
        idx.c_sdoc = ds[order]
        idx.c_edoc = de[order]
        idx.last_run_edoc = int(de[r - 1])
        idx.first_run_sdoc = int(ds[0])
    return idx


def build_doc_arrays(raw, seq_lengths) -> tuple[np.ndarray, np.ndarray]:
    """Run-boundary document ids (run-major), the DocumentArray of
    src/doc_array.cpp:18-108.

    seq_lengths: total concatenated length per document id (from the .fdi).
    """
    end_pos = np.cumsum(np.asarray(seq_lengths, dtype=np.int64))
    end_pos[-1] += 1  # account for the terminator (doc_array.cpp:43-44)
    n_total = end_pos[-1]
    conv = lambda v: np.where(v > 0, v - 1, n_total - 1)
    # doc id = number of document ends at positions < p (doc_ends_rank)
    rank = lambda p: np.searchsorted(end_pos, p, side="right")
    start_doc = rank(conv(np.asarray(raw.samples_start, dtype=np.int64)))
    end_doc = rank(conv(np.asarray(raw.samples_last, dtype=np.int64)))
    return start_doc.astype(np.int64), end_doc.astype(np.int64)


_ARRAY_FIELDS = ["F", "cnt", "char_off", "c_start", "c_len", "c_cum", "c_thr",
                 "c_ssamp", "c_esamp", "c_sdoc", "c_edoc", "text",
                 "run_heads", "run_starts"]
_SCALAR_FIELDS = ["n", "r", "last_run_sample", "last_run_edoc", "first_run_sdoc"]


def save_dense_index(idx: DenseIndex, path: str) -> None:
    arrays = {f: getattr(idx, f) for f in _ARRAY_FIELDS if getattr(idx, f) is not None}
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    manifest = {f: int(getattr(idx, f)) for f in _SCALAR_FIELDS}
    manifest["format_version"] = 1
    with open(os.path.splitext(path)[0] + ".json"
              if path.endswith(".npz") else path + ".json", "w") as f:
        json.dump(manifest, f, indent=2)


def load_dense_index(path: str) -> DenseIndex:
    base = os.path.splitext(path)[0] if path.endswith((".npz", ".json")) else path
    with open(base + ".json") as f:
        manifest = json.load(f)
    data = np.load(base + ".npz")
    kwargs = {f: data[f] for f in _ARRAY_FIELDS if f in data}
    kwargs.update({f: manifest[f] for f in _SCALAR_FIELDS})
    return DenseIndex(**kwargs)
