"""One-sided Kolmogorov-Smirnov test over MS/PML windows.

Re-implements src/ks_test.cpp: per bin_size window of a read's
statistics, compare the empirical CDF against a random window of the null
database and take max(null_cdf - pos_cdf) (one-sided: only right-shifted
positive distributions count, ks_test.cpp:96-101). The random null window uses
the glibc rand() stream (ks_test.cpp:113) for determinism parity.

At query time the reference uses bin-max classification instead (the KS path
is compiled out, compute_ms_pml.cpp:942-967), but the KS machinery is live at
build time for threshold finding (spumoni.cpp:659-666) — both are provided.
"""

from __future__ import annotations

import numpy as np

from ..glibc_rand import GlibcRand


def compute_cdf(sorted_stats: np.ndarray, max_stat: int) -> np.ndarray:
    """CDF over x = 0..max_stat of already-sorted stats (ks_test.cpp:59-78)."""
    total = len(sorted_stats)
    xs = np.arange(max_stat + 1)
    counts = np.searchsorted(sorted_stats, xs, side="right")
    return counts / float(total)


def run_test(pos_stats: np.ndarray, null_stats: np.ndarray) -> float:
    """max(null_cdf - pos_cdf), scanning until either CDF reaches 1
    (ks_test.cpp:80-104). Computed as max(0, max_x(null_cdf - pos_cdf))
    evaluated only at the null values — EXACTLY the reference's scan:
    the reference breaks after computing the x where a CDF first hits 1,
    and past that point the difference can only shrink (q - p <= 0 once
    p = 1; 1 - p is non-increasing once q = 1), while between null-value
    jumps q is constant and p non-decreasing, so the max lands on a null
    value. This replaces an O(max_stat) Python loop per window."""
    pos = np.sort(np.asarray(pos_stats))
    null = np.sort(np.asarray(null_stats))
    q = np.searchsorted(null, null, side="right") / float(len(null))
    p = np.searchsorted(pos, null, side="right") / float(len(pos))
    return float(max(0.0, np.max(q - p)))


def n_windows(m: int, bin_size: int) -> int:
    """Number of rand() draws KSTest.run_kstest consumes for a read of m
    values (one per window) — used to keep a host's glibc stream aligned
    with the global single-process consumption order under host sharding
    and resume (ks_test.cpp:113 draws once per window)."""
    count, start, bs = 0, 0, bin_size
    while start < m:
        end = start + bs if start + bs <= m - bs else m
        if m < bs:
            end = m
        count += 1
        start += end - start
    return count


class KSTest:
    def __init__(self, null_db, bin_size: int, rand: GlibcRand | None = None):
        self.null_db = null_db
        self.bin_size = bin_size
        self.rand = rand if rand is not None else GlibcRand(0)

    def run_kstest(self, pos_stats: np.ndarray) -> list[float]:
        """Windowed KS stats for one read (ks_test.cpp:106-134)."""
        pos_stats = np.asarray(pos_stats)
        nvals = self.null_db.num_values
        bs = self.bin_size
        out = []
        start = 0
        m = len(pos_stats)
        while start < m:
            null_pos = self.rand.rand() % max(1, nvals - 2 * bs)
            if nvals < 2 * bs:
                null_pos = 0
            end = start + bs if start + bs <= m - bs else m
            if m < bs:
                end = m
            region = pos_stats[start:end]
            null_bin = self.null_db.null_stats[null_pos:null_pos + (end - start)]
            out.append(run_test(region, null_bin))
            start += (end - start)
        return out


def find_ks_threshold(query_fn, null_read_path: str, null_db, bin_size: int,
                      use_promotions: bool, use_dna_letters: bool,
                      k: int, w: int, rand: GlibcRand | None = None) -> float:
    """Threshold = mean + 3*stddev of KS stats over the null reads themselves
    (compute_ms_pml.cpp:1549-1604)."""
    from ..io.fasta import read_fastx
    from ..io.minimizers import digest

    sig = KSTest(null_db, bin_size, rand=rand)
    ks_list = []
    reads = []
    for rec in read_fastx(null_read_path):
        rd = rec.seq.upper()[::-1]
        rd = digest(rd, use_promotions, use_dna_letters, k, w)
        if rd:
            reads.append(rd)
    all_lengths = query_fn(reads)
    for lengths in all_lengths:
        ks_list.extend(sig.run_kstest(lengths))
    arr = np.asarray(ks_list)
    if len(arr) == 0:
        return 0.0
    mean = arr.mean()
    std = np.sqrt(np.mean((arr - mean) ** 2))
    return float(mean + 3 * std)


def n_windows_batch(lens: np.ndarray, bin_size: int) -> np.ndarray:
    """Vectorized n_windows over a batch of read lengths (closed form of
    the window loop: windows advance by bin_size and the FINAL window
    absorbs the tail whenever fewer than 2*bin_size values remain)."""
    m = np.asarray(lens, dtype=np.int64)
    return np.maximum(0, -(-(m - 2 * bin_size + 1) // bin_size)) + 1
