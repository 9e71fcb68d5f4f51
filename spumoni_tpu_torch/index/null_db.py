"""Empirical null-statistic database.

Re-implements src/emp_null_database.cpp: query *reversed*
null reads against the freshly built index (a de-facto smoke test of every
build — SURVEY.md §4), store all MS/PML values, the mean, and the
"percentile value" = largest value occurring >= 5 times
(emp_null_database.cpp:61-79). Serialized as JSON+npz (`.pmlnulldb.npz` /
`.msnulldb.npz`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..io.fasta import read_fastx
from ..io.minimizers import digest


def _percentile_value(stats: np.ndarray) -> int:
    """Largest value occurring at least 5 times (emp_null_database.cpp:61-79)."""
    if len(stats) == 0:
        return 0
    vals, counts = np.unique(stats, return_counts=True)
    qual = vals[counts >= 5]
    return int(qual.max()) if len(qual) else 0


class EmpNullDatabase:
    def __init__(self, null_stats: np.ndarray | None = None):
        self.null_stats = (np.asarray(null_stats, dtype=np.int64)
                           if null_stats is not None else np.zeros(0, np.int64))
        self.num_values = len(self.null_stats)
        self.mean_null_stat = (float(self.null_stats.mean())
                               if self.num_values else 0.0)
        self.percentile_value = float(_percentile_value(self.null_stats))
        self.ks_stat_threshold = 0.0

    @classmethod
    def from_null_reads(cls, query_fn, null_read_path: str, use_promotions: bool,
                        use_dna_letters: bool, k: int, w: int,
                        is_general_text: bool = False):
        """query_fn(list[bytes]) -> list[np.ndarray of lengths].

        Reads are upper-cased, REVERSED (the null model,
        compute_ms_pml.cpp:1426), then digested.
        """
        reads = []
        if is_general_text:
            with open(null_read_path, "rb") as f:
                data = f.read()
            reads.append(data[::-1])
        else:
            for rec in read_fastx(null_read_path):
                rd = rec.seq.upper()[::-1]
                rd = digest(rd, use_promotions, use_dna_letters, k, w)
                reads.append(rd)
        reads = [r for r in reads if len(r) > 0]
        lengths = query_fn(reads)
        stats = (np.concatenate(lengths) if lengths
                 else np.zeros(0, dtype=np.int64))
        return cls(stats)

    def save(self, path: str) -> None:
        np.savez(path + ".npz", null_stats=self.null_stats)
        with open(path + ".json", "w") as f:
            json.dump({
                "num_values": int(self.num_values),
                "ks_stat_threshold": float(self.ks_stat_threshold),
                "mean_null_stat": float(self.mean_null_stat),
                "percentile_value": float(self.percentile_value),
            }, f, indent=2)

    @classmethod
    def load(cls, path: str):
        db = cls.__new__(cls)
        with open(path + ".json") as f:
            meta = json.load(f)
        data = np.load(path + ".npz")
        db.null_stats = data["null_stats"]
        db.num_values = meta["num_values"]
        db.ks_stat_threshold = meta["ks_stat_threshold"]
        db.mean_null_stat = meta["mean_null_stat"]
        db.percentile_value = meta["percentile_value"]
        return db

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(path + ".json") and os.path.exists(path + ".npz")
