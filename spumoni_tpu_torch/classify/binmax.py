"""Bin-max read classification (the live classification path of the reference,
src/compute_ms_pml.cpp:969-995,1150-1176).

Split a read's MS/PML values into bin_width windows (the final short remainder
merges into the previous window), take each window's max, compare against
max_value_thr; FOUND iff more than 50% of windows exceed the threshold.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def max_value_threshold(percentile_value: float, use_promotions: bool,
                        use_dna_letters: bool, mode: str) -> int:
    """max(percentile, 3) with the digestion adjustments of
    compute_ms_pml.cpp:871-875 (PML) and :1061-1063 (MS)."""
    thr = max(percentile_value, 3.0)
    if use_dna_letters:
        thr += 1
    elif mode == "pml" and not use_promotions:
        thr += 4  # raw-DNA PML adjustment
    return int(thr)


@dataclass
class BinMaxResult:
    status: str              # "FOUND" | "NOT_PRESENT"
    bins_above: int
    bins_below: int
    bin_maxes: np.ndarray

    @property
    def avg_max(self) -> float:
        return float(self.bin_maxes.sum()) / len(self.bin_maxes)


def classify(lengths: np.ndarray, bin_width: int, max_value_thr: int
             ) -> BinMaxResult:
    lengths = np.asarray(lengths)
    m = len(lengths)
    maxes = []
    above = below = 0
    start = 0
    while start < m:
        end = start + bin_width if start + bin_width < m else m
        if m - end < bin_width:   # avoid a short tail window
            end = m
        mv = int(lengths[start:end].max())
        if mv >= max_value_thr:
            above += 1
        else:
            below += 1
        maxes.append(mv)
        start = end
    found = above / (above + below) > 0.50
    return BinMaxResult("FOUND" if found else "NOT_PRESENT", above, below,
                        np.asarray(maxes, dtype=np.int64))
