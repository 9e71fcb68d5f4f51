"""The least time the window's scans need on one H100, counted on the work
alone, whatever engine or kernel does it.

For each scanned symbol of each pass (PML 1 pass; MS 2: the backward scan
and the forward extension), 1 byte of read plus one 32-byte index sector,
the least one dependent access fetches; then each output byte once: 16 bytes
a read for a report-only verdict (flag, sum of maxima, bins above, below),
else 4 bytes a value for each value file. Over the data sheet's HBM3
bandwidth of an H100 SXM at its 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SECTOR = 32
VERDICT_BYTES = 16
VALUE_BYTES = 4


def passes(flags) -> int:
    return 2 if "-M" in flags else 1


def value_files(flags) -> int:
    if "--report-only" in flags:
        return 0
    return (2 if "-M" in flags else 1) + ("-d" in flags)


def scan_bytes(flags, symbols: int, reads: int) -> int:
    """Bytes one call moves at least: `symbols` scanned symbols over
    `reads` reads."""
    out = (reads * VERDICT_BYTES if "--report-only" in flags
           else symbols * VALUE_BYTES * value_files(flags))
    return symbols * passes(flags) * (1 + SECTOR) + out


def least_seconds(flags, symbols: int, reads: int) -> float:
    return scan_bytes(flags, symbols, reads) / HBM_BYTES_PER_S
