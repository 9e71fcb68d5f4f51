"""The value files' batch pass (classify/values_writer.py over
csrc/values_writer.cpp) against the per-read path it replaces in `run`: the
text byte for byte against report.write_values_record, and the bin-max
report lines against binmax.classify and report.report_line; on int32 and
int64 rows cut from two padded matrices, as query_staged hands them over.
"""

import io

import numpy as np
import pytest

from spumoni_tpu_torch.classify import binmax, report
from spumoni_tpu_torch.classify.values_writer import (CHUNK_BYTES, BatchIds,
                                                      ValuesWriter)

INT32_MAX = 2**31 - 1
#: every digit count's edges, and values that print as unsigned 64-bit
EDGES = {np.int32: [0, 9, 10, 99, 100, 101, 999, 1000, 99_999, 100_000,
                    INT32_MAX, -1, -7, -(2**31)],
         np.int64: [0, 9, 10, 99, 100, INT32_MAX, 2**32 - 1, 2**32,
                    10**19 // 10, 2**63 - 1, -1, -(2**31), -(2**63)]}
#: ASCII, non-ASCII, and the delimiter a read id keeps (BatchLoader's
#: off-by-one)
IDS = ["read_0", "réad_ü", "読み取り_2", "r3 ", "r4\t", "x" * 40]


def _lengths(w: int) -> list:
    """Each bin-window corner of width w, and a tail of a few values."""
    return [1, max(w - 1, 1), w, w + 1, max(2 * w - 1, 1), 2 * w, 3 * w + 7]


def _batch(dtype, width, thr, long_len, rng):
    """(ids, rows): the corner lengths twice and one long read, in a
    permuted order, each row the head of a row of one of two padded
    matrices of different widths; values around thr with the edges
    scattered in."""
    lens = _lengths(width) * 2 + [long_len]
    order = rng.permutation(len(lens))
    lens = [lens[i] for i in order]
    group = rng.integers(0, 2, len(lens))
    rows, mats = [], []
    for g in range(2):
        members = np.flatnonzero(group == g)
        wid = max([lens[i] for i in members] + [1]) + 5 + 64 * g
        vals = rng.integers(0, 2 * max(thr, 1) + 2, (len(members), wid))
        edges = np.array(EDGES[dtype], dtype=np.int64)
        hit = rng.random(vals.shape) < 0.2
        vals[hit] = rng.choice(edges, int(hit.sum()))
        mats.append((members, vals.astype(dtype)))
    rows = [None] * len(lens)
    for members, mat in mats:
        for j, i in enumerate(members):
            rows[i] = mat[j, :lens[i]]
    ids = [IDS[i % len(IDS)] + f"_{i}" for i in range(len(lens))]
    return ids, rows


def _per_read(ids, rows, width, thr):
    """The per-read path's value text and report lines."""
    f = io.BytesIO()
    lines = []
    for rid, v in zip(ids, rows):
        report.write_values_record(f, rid, v)
        res = binmax.classify(v, width, thr)
        lines.append(report.report_line(rid, res.status, res.avg_max,
                                        res.bins_above, res.bins_below))
    return f.getvalue(), lines


def _lines(ids, res):
    """The report lines of the pass's (above, below, sum_maxes), as `run`
    writes them."""
    return [report.report_line(
        rid, "FOUND" if a / (a + b) > 0.5 else "NOT_PRESENT", s / (a + b),
        a, b) for rid, a, b, s in zip(ids, *(a.tolist() for a in res))]


# (dtype, bin width, threshold, buffer bytes, the long read's length); a
# buffer under a read's text makes that read straddle several chunks, one
# under an id and a value grows to hold them
CASES = [
    (np.int32, 150, 7, CHUNK_BYTES, 1000),
    (np.int64, 150, 7, CHUNK_BYTES, 1000),
    (np.int32, 1, 1, 64, 300),
    (np.int64, 2, 3, 64, 300),
    (np.int32, 37, 12, 100, 2000),
    (np.int64, 37, 0, 333, 2000),
    (np.int32, 10, INT32_MAX, 23, 500),
    (np.int64, 150, 20, 4096, 20_000),
    (np.int32, 150, 20, 4096, 20_000),
]


@pytest.mark.parametrize(
    "dtype,width,thr,chunk,long_len", CASES,
    ids=[f"{np.dtype(c[0]).name}-w{c[1]}-thr{c[2]}-buf{c[3]}" for c in CASES])
def test_pass_matches_the_per_read_writer(dtype, width, thr, chunk,
                                          long_len):
    rng = np.random.default_rng(width * 1009 + chunk + thr % 997)
    ids, rows = _batch(dtype, width, thr, long_len, rng)
    want_text, want_lines = _per_read(ids, rows, width, thr)
    writer = ValuesWriter(chunk)
    bids = BatchIds(ids)
    assert len(bids) == len(ids)
    for bins in (None, (width, thr)):   # the text alike with and without
        f = io.BytesIO()
        res = writer.write(f, bids, rows, bins)
        assert f.getvalue() == want_text
    assert writer.write(io.BytesIO(), bids, rows) is None
    assert _lines(ids, res) == want_lines
    for v, a, b, s in zip(rows, *(a.tolist() for a in res)):
        ref = binmax.classify(v, width, thr)
        assert (a, b, s) == (ref.bins_above, ref.bins_below,
                             int(ref.bin_maxes.sum()))


@pytest.mark.parametrize("kind", ["mixed", "strided", "unsigned"])
def test_pass_takes_rows_it_must_convert(kind):
    """Rows of two dtypes in one batch, strided rows and unsigned rows go
    through an int64 copy, with the same text."""
    rng = np.random.default_rng(3)
    ids, rows = _batch(np.int32, 20, 5, 90, rng)
    if kind == "mixed":
        rows = [v.astype(np.int64) if i % 2 else v
                for i, v in enumerate(rows)]
    elif kind == "strided":
        rows = [np.repeat(v, 2)[::2] for v in rows]
    else:
        rows = [v.astype(np.uint32) for v in rows]
    want_text, want_lines = _per_read(ids, rows, 20, 5)
    f = io.BytesIO()
    res = ValuesWriter(50).write(f, BatchIds(ids), rows, (20, 5))
    assert f.getvalue() == want_text
    assert _lines(ids, res) == want_lines


def test_rows_and_ids_must_pair():
    with pytest.raises(ValueError, match="2 value rows for 3 read ids"):
        ValuesWriter().write(io.BytesIO(), BatchIds(["a", "b", "c"]),
                             [np.zeros(1, np.int32)] * 2)
    f = io.BytesIO()
    assert ValuesWriter().write(f, BatchIds([]), [], (150, 3))[0].size == 0
    assert f.getvalue() == b""
