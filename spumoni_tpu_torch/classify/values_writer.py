"""The value files of a batch, one native pass per file
(`native.format_records`, csrc/values_writer.cpp): the records that
`report.write_values_record` writes read by read, byte for byte, formatted
into one reused buffer and written to the file a chunk at a time. Over the
lengths the same pass can also give each read's bin-max
(`binmax.classify`'s windows and counts).
"""

from __future__ import annotations

import operator

import numpy as np

from .. import native

#: the buffer a writer formats into and hands to the file a chunk at a time
CHUNK_BYTES = 4 << 20
_MAX_VALUE = 21                  # 20 digits and the space
_LAYOUT = operator.attrgetter("dtype", "strides")
_ADDRESS = operator.attrgetter("ctypes.data")
#: the contiguous rows the pass reads as they are, and their item sizes
_NATIVE = {(np.dtype(np.int32), (4,)): 4, (np.dtype(np.int64), (8,)): 8}


class BatchIds:
    """A batch's read ids as one UTF-8 byte string and int64 offsets: the
    form every value file of the batch reads them in."""

    __slots__ = ("blob", "offs")

    def __init__(self, ids):
        n = len(ids)
        blob = "".join(ids).encode()
        lens = np.fromiter(map(len, ids), np.int64, n)
        if len(blob) != int(lens.sum()):      # non-ASCII: bytes != chars
            parts = [s.encode() for s in ids]
            blob = b"".join(parts)
            lens = np.fromiter(map(len, parts), np.int64, n)
        self.blob = np.frombuffer(blob, np.uint8)
        self.offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=self.offs[1:])

    def __len__(self) -> int:
        return len(self.offs) - 1


class ValuesWriter:
    """Writes a batch's records to a value file in one native pass; owns the
    buffer the pass formats into, reused from file to file and batch to
    batch."""

    def __init__(self, chunk_bytes: int = CHUNK_BYTES):
        self._buf = np.empty(chunk_bytes, np.uint8)

    def write(self, f, ids: BatchIds, rows, bins=None):
        """Writes one record a read to the binary file f: ids[r] and the
        integer values rows[r] (1-D arrays, in the batch's read order).
        With bins = (bin_width, max_value_thr), returns each read's
        (above, below, sum_maxes) as int64 arrays; else None."""
        n = len(ids)
        if len(rows) != n:
            raise ValueError(f"{len(rows)} value rows for {n} read ids")
        layouts = set(map(_LAYOUT, rows))
        itemsize = _NATIVE.get(layouts.pop()) if len(layouts) == 1 else None
        if itemsize is None:                  # mixed, strided or other ints
            rows = [np.ascontiguousarray(v, dtype=np.int64) for v in rows]
            itemsize = 8
        # the pass reads rows by address: `rows` holds them alive
        addrs = np.fromiter(map(_ADDRESS, rows), np.int64, n)
        counts = np.fromiter(map(len, rows), np.int64, n)
        need = (int(np.diff(ids.offs).max()) if n else 0) + 2 + _MAX_VALUE
        if len(self._buf) < need:             # a header and a value fit
            self._buf = np.empty(need, np.uint8)
        res = None if bins is None else tuple(np.zeros(n, np.int64)
                                              for _ in range(3))
        state = np.array([0, -1], np.int64)
        chunk = memoryview(self._buf)
        while state[0] < n:
            m = native.format_records(addrs, counts, itemsize, ids.blob,
                                      ids.offs, self._buf, state, bins, res)
            f.write(chunk[:m])
        return res
