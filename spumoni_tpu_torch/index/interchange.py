"""Reference-format index interchange.

The reference's query structures are constructed from five intermediate
files written by pfp_thresholds (SURVEY.md §2.3) and read with fixed binary
layouts:

  <ref>.bwt.heads   one raw byte per BWT run (the run's character);
                    chars <= 1 are coerced to TERMINATOR=1 at LOAD time
                    (include/ms_rle_string.hpp:63-68)
  <ref>.bwt.len     one 5-byte little-endian unsigned run length per run
                    (ms_rle_string.hpp:55-63)
  <ref>.thr_pos     one 5-byte LE absolute threshold position per run
                    (include/thresholds_ds.hpp:393-420)
  <ref>.ssa         per run: (5-byte LE position, 5-byte LE SA[run start]);
  <ref>.esa         per run: (5-byte LE position, 5-byte LE SA[run end]).
                    The reader consumes only the second value of each pair
                    and maps 0 -> n-1, v -> v-1
                    (src/compute_ms_pml.cpp:404-439)

Exporting these lets a reference `spumoni build` resume from our build
products; importing lets a reference-built index run on this framework and
is the byte-level parity bridge (the reference binary itself cannot be
compiled in this environment). See FORMATS.md.
"""

from __future__ import annotations

import os

import numpy as np

from ..native import RawIndex

_B5 = (1 << 40) - 1


def _write_u40(f, values: np.ndarray) -> None:
    """5-byte little-endian unsigned ints (THRBYTES/SSABYTES = 5,
    include/common.hpp:59-60)."""
    v = np.asarray(values, dtype=np.uint64)
    assert (v <= _B5).all(), "value exceeds 5-byte range"
    raw = v.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :5]
    f.write(np.ascontiguousarray(raw).tobytes())


def _read_u40(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % 5:
        raise ValueError(f"{path}: size {raw.size} not a multiple of 5 "
                         f"(SSABYTES/THRBYTES)")
    raw = raw.reshape(-1, 5)
    out = np.zeros((raw.shape[0], 8), dtype=np.uint8)
    out[:, :5] = raw
    return out.view("<u8").reshape(-1).astype(np.int64)


def export_reference_index(raw: RawIndex, prefix: str) -> list[str]:
    """Writes <prefix>.bwt.heads/.bwt.len/.thr_pos/.ssa/.esa from a built
    RawIndex. The .ssa/.esa left values are the run start/end BWT positions
    (informational — the reference reader skips them). Returns the paths."""
    n, r = raw.n, raw.r
    heads = np.asarray(raw.run_heads, dtype=np.uint8)
    starts = np.asarray(raw.run_starts, dtype=np.int64)
    ends = np.concatenate([starts[1:], [n]]) - 1
    paths = []

    p = prefix + ".bwt.heads"
    with open(p, "wb") as f:
        f.write(heads.tobytes())
    paths.append(p)

    p = prefix + ".bwt.len"
    with open(p, "wb") as f:
        _write_u40(f, np.diff(np.concatenate([starts, [n]])))
    paths.append(p)

    p = prefix + ".thr_pos"
    with open(p, "wb") as f:
        _write_u40(f, np.asarray(raw.thresholds, dtype=np.int64))
    paths.append(p)

    for ext, pos, samp in (
            (".ssa", starts, np.asarray(raw.samples_start, np.int64)),
            (".esa", ends, np.asarray(raw.samples_last, np.int64))):
        p = prefix + ext
        pairs = np.empty((r, 2), dtype=np.int64)
        pairs[:, 0] = pos
        pairs[:, 1] = samp
        with open(p, "wb") as f:
            _write_u40(f, pairs.reshape(-1))
        paths.append(p)
    return paths


def read_sdsl_int_vector(f) -> np.ndarray:
    """Reads one serialized sdsl::int_vector<> (dynamic width) from an open
    binary stream: 8-byte LE bit-size, 1-byte width, then ceil(bits/64)
    little-endian u64 words with values packed LSB-first at width-bit
    strides (sdsl-lite int_vector::serialize; the layout the reference's
    my_load/null_stats.load consumes, common.hpp:413-500)."""
    hdr = f.read(9)
    if len(hdr) != 9:
        raise ValueError("truncated sdsl int_vector header")
    bits = int(np.frombuffer(hdr[:8], "<u8")[0])
    width = hdr[8]
    if not 1 <= width <= 64:
        raise ValueError(f"sdsl int_vector width {width} out of range")
    nwords = (bits + 63) // 64
    words = np.frombuffer(f.read(nwords * 8), "<u8")
    if len(words) != nwords:
        raise ValueError("truncated sdsl int_vector data")
    nvals = bits // width
    if nvals == 0:
        return np.zeros(0, dtype=np.int64)
    pos = np.arange(nvals, dtype=np.uint64) * np.uint64(width)
    wi = (pos >> np.uint64(6)).astype(np.int64)
    off = pos & np.uint64(63)
    lo = words[wi] >> off
    # bits spilling into the next word (guard the shift: >> / << by 64 is
    # undefined; spill == 0 there so the value is masked out anyway)
    spill = off + np.uint64(width) > np.uint64(64)
    hi_shift = (np.uint64(64) - off) % np.uint64(64)
    hi = np.where(spill,
                  words[np.minimum(wi + 1, nwords - 1)]
                  << np.where(spill, hi_shift, np.uint64(0)), np.uint64(0))
    mask = (np.uint64(0xFFFFFFFFFFFFFFFF) if width == 64
            else (np.uint64(1) << np.uint64(width)) - np.uint64(1))
    return ((lo | hi) & mask).astype(np.int64)


def write_sdsl_int_vector(f, values: np.ndarray,
                          width: int | None = None) -> None:
    """Writes an sdsl::int_vector<> in the serialized format above. Default
    width = max(bit_length of max value, 1) — the bit_compress convention
    the reference applies before serializing."""
    v = np.asarray(values, dtype=np.uint64)
    if width is None:
        width = max(1, int(v.max()).bit_length()) if v.size else 1
    assert 1 <= width <= 64
    bits = int(v.size) * width
    nwords = (bits + 63) // 64
    words = np.zeros(nwords + 1, dtype=np.uint64)  # +1: spill slack
    pos = np.arange(v.size, dtype=np.uint64) * np.uint64(width)
    wi = (pos >> np.uint64(6)).astype(np.int64)
    off = pos & np.uint64(63)
    mask = (np.uint64(0xFFFFFFFFFFFFFFFF) if width == 64
            else (np.uint64(1) << np.uint64(width)) - np.uint64(1))
    v = v & mask
    np.bitwise_or.at(words, wi, v << off)
    spill = off + np.uint64(width) > np.uint64(64)
    hi_shift = (np.uint64(64) - off) % np.uint64(64)
    if spill.any():
        np.bitwise_or.at(words, wi[spill] + 1,
                         v[spill] >> hi_shift[spill])
    f.write(np.asarray([bits], "<u8").tobytes())
    f.write(bytes([width]))
    f.write(words[:nwords].astype("<u8").tobytes())


def read_reference_nulldb(path: str) -> dict:
    """Reads a reference-serialized empirical null database
    (`.msnulldb`/`.pmlnulldb`): size_t num_values + three doubles
    (ks_stat_threshold, mean_null_stat, percentile_value) + the packed
    null_stats int_vector (src/emp_null_database.cpp:82-141,
    field types include/emp_null_database.hpp:20-25)."""
    with open(path, "rb") as f:
        hdr = np.frombuffer(f.read(32), np.uint8)
        if len(hdr) != 32:
            raise ValueError(f"{path}: truncated null database header")
        num_values = int(hdr[:8].view("<u8")[0])
        ks_thr, mean, pct = hdr[8:].view("<f8")
        stats = read_sdsl_int_vector(f)
    if len(stats) != num_values:
        raise ValueError(f"{path}: header says {num_values} values, "
                         f"int_vector holds {len(stats)}")
    return {"num_values": num_values, "ks_stat_threshold": float(ks_thr),
            "mean_null_stat": float(mean), "percentile_value": float(pct),
            "null_stats": stats}


def write_reference_nulldb(path: str, num_values: int, ks_stat_threshold:
                           float, mean_null_stat: float,
                           percentile_value: float,
                           null_stats: np.ndarray) -> None:
    """Writes the reference's binary null-database format (the inverse of
    read_reference_nulldb) so a reference `spumoni run` can consume indexes
    built here."""
    with open(path, "wb") as f:
        f.write(np.asarray([num_values], "<u8").tobytes())
        f.write(np.asarray([ks_stat_threshold, mean_null_stat,
                            percentile_value], "<f8").tobytes())
        write_sdsl_int_vector(f, null_stats)


def read_reference_doc(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Reads a reference-serialized DocumentArray (`.doc`): size_t
    num_entries + two packed int_vectors start_runs_doc / end_runs_doc
    (src/doc_array.cpp:184-201)."""
    with open(path, "rb") as f:
        hdr = f.read(8)
        if len(hdr) != 8:
            raise ValueError(f"{path}: truncated .doc header")
        num_entries = int(np.frombuffer(hdr, "<u8")[0])
        start = read_sdsl_int_vector(f)
        end = read_sdsl_int_vector(f)
    if len(start) != num_entries or len(end) != num_entries:
        raise ValueError(f"{path}: .doc int_vectors do not hold "
                         f"{num_entries} entries")
    return start, end


def write_reference_doc(path: str, start_runs_doc: np.ndarray,
                        end_runs_doc: np.ndarray) -> None:
    """Writes the reference's `.doc` format (inverse of
    read_reference_doc). Both vectors get the same width, like the
    reference's ceil(log2(#docs)) int_vectors (doc_array.cpp:97-107)."""
    assert len(start_runs_doc) == len(end_runs_doc)
    mx = max(int(np.asarray(start_runs_doc).max(initial=0)),
             int(np.asarray(end_runs_doc).max(initial=0)))
    width = max(1, mx.bit_length())
    with open(path, "wb") as f:
        f.write(np.asarray([len(start_runs_doc)], "<u8").tobytes())
        write_sdsl_int_vector(f, start_runs_doc, width)
        write_sdsl_int_vector(f, end_runs_doc, width)


def import_reference_index(prefix: str, with_samples: bool = True) -> RawIndex:
    """Reads the reference's five intermediate files into a RawIndex
    (raw SA sample values: the v -> v-1 / 0 -> n-1 convention of
    compute_ms_pml.cpp:431-434 is applied downstream by
    index.format.build_dense_index, exactly like the reference loader)."""
    heads = np.fromfile(prefix + ".bwt.heads", dtype=np.uint8)
    # terminator coercion happens at load in the reference
    # (ms_rle_string.hpp:66-68)
    heads = np.where(heads <= 1, 1, heads).astype(np.uint8)
    lens = _read_u40(prefix + ".bwt.len")
    if len(lens) != len(heads):
        raise ValueError(f"{prefix}: .bwt.heads has {len(heads)} runs but "
                         f".bwt.len has {len(lens)}")
    n = int(lens.sum())
    r = len(heads)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    thr = _read_u40(prefix + ".thr_pos")
    if len(thr) != r:
        raise ValueError(f"{prefix}.thr_pos holds {len(thr)} thresholds "
                         f"for {r} runs")
    ss = sl = np.zeros(r, dtype=np.int64)
    if with_samples and os.path.exists(prefix + ".ssa"):
        ssa = _read_u40(prefix + ".ssa").reshape(-1, 2)
        esa = _read_u40(prefix + ".esa").reshape(-1, 2)
        if len(ssa) != r or len(esa) != r:
            raise ValueError(f"{prefix}.ssa/.esa do not hold {r} pairs")
        ss, sl = ssa[:, 1].copy(), esa[:, 1].copy()
    return RawIndex(n, heads, starts, thr, ss, sl)
