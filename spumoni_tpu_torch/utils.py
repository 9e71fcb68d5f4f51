"""Host utilities of the port (the part of spumoni_tpu/utils.py it calls)."""

from __future__ import annotations

import numpy as np


def present_chars(a):
    """Distinct byte values present in `a`, as a small int array.

    Replaces np.unique on read batches: np.unique SORTS its input (~2.8 s
    on a 67 MB [B, L] batch — measured as THE e2e host bottleneck), while a
    histogram is O(n) (~50 ms)."""
    return np.nonzero(np.bincount(a.reshape(-1), minlength=256))[0]
