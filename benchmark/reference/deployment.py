"""What SPUMONI's `build` and `run` give for a pangenome, worked out again
from the strains: the indexed text, the null database's threshold, and for
chosen reads their report lines and value records.

Two builds are covered, as the configurations name them:

* `docs` (`build -i list -M -P -d -n`): each strain file is one document;
  the text is each strain followed by its reverse complement. Null reads:
  glibc rand() from srand(0), 100 reads of 150 bp a strain until 800 are
  drawn, then 25, at most 1,000, rand() % (length - 150) each.
* `digest` (`build -r pangenome.fa -m -P`): the text is the promotion digest
  of each strain and of its reverse complement, one after another; the null
  reads are drawn as above from the FASTA's records and are digested after
  being reversed.

The null database keeps every value of the walks over the reversed null
reads; its percentile value is the largest value seen at least 5 times, and
the threshold is max(percentile, 3), plus 4 for undigested PML.
"""

from __future__ import annotations

import numpy as np

from . import digest as dg
from .index import TextIndex
from .rng import GlibcRand

NULL_LEN = 150
_COMP = np.arange(256, dtype=np.uint8)
_COMP[list(b"ACGT")] = list(b"TGCA")


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(seq, np.uint8)[::-1]]


def null_reads(strains) -> list[np.ndarray]:
    rand = GlibcRand(0)
    out = []
    for seq in strains:
        if len(out) >= 1000:
            break
        if len(seq) <= NULL_LEN:
            out.append(seq)
            continue
        grab = 25 if len(out) >= 800 else 100
        for _ in range(grab):
            if len(out) >= 1000:
                break
            i = rand.rand() % (len(seq) - NULL_LEN)
            out.append(seq[i:i + NULL_LEN])
    return out


class Deployment:
    """The reference for one configuration's pangenome."""

    def __init__(self, strains, build: str, device: str = "cpu"):
        self.build = build
        strains = [np.asarray(s, np.uint8) for s in strains]
        if build == "docs":
            parts = []
            for s in strains:
                parts += [s, reverse_complement(s)]
            self.index = TextIndex(np.concatenate(parts),
                                   doc_lengths=[2 * len(s) for s in strains],
                                   device=device)
        elif build == "digest":
            parts = []
            for s in strains:
                parts += [dg.digest(s), dg.digest(reverse_complement(s))]
            self.index = TextIndex(np.concatenate(parts), device=device)
        else:
            raise ValueError(f"unknown build {build!r}")
        self._nulls = null_reads(strains)
        self._thr = {}

    def symbols(self, read: np.ndarray) -> np.ndarray:
        """What the index is queried with for one read."""
        return dg.digest(read) if self.build == "digest" else read

    def threshold(self, mode: str, down_on_tie: bool = True) -> int:
        key = (mode, down_on_tie)
        if key not in self._thr:
            reads = [self.symbols(r[::-1].copy()) for r in self._nulls]
            reads = [r for r in reads if len(r)]
            vals = np.concatenate(self.values(reads, mode, down_on_tie)[0])
            u, c = np.unique(vals, return_counts=True)
            pct = int(u[c >= 5].max()) if (c >= 5).any() else 0
            thr = max(pct, 3)
            if mode == "pml" and self.build != "digest":
                thr += 4
            self._thr[key] = thr
        return self._thr[key]

    def values(self, syms, mode: str, down_on_tie: bool = True):
        """(lengths, pointers, documents) of each read's symbols; pointers
        and documents are None for PML."""
        if mode == "pml":
            return self.index.pml(syms, down_on_tie), None, None
        ptr, lens, docs = self.index.ms(syms, down_on_tie)
        return lens, ptr, docs


def binmax(lengths: np.ndarray, bin_width: int, thr: int):
    """(found, average bin maximum, bins above, bins below): bins of
    bin_width values, the last short remainder merged into the bin before;
    FOUND when more than half of the bins' maxima reach thr."""
    m = len(lengths)
    nb = max(1, m // bin_width)
    edges = np.minimum(np.arange(nb + 1) * bin_width, m)
    edges[-1] = m
    maxes = np.maximum.reduceat(lengths, edges[:-1]) if m else np.zeros(1)
    above = int((maxes >= thr).sum())
    below = nb - above
    return above / nb > 0.5, float(maxes.sum()) / nb, above, below


def report_header(thr: int) -> str:
    return (f"{'read id:':<30}{'status:':<15}{'avg max-value (thr=':<19}"
            f"{thr:<2}{'):':<5}{'above thr:':<12}{'below thr:':<12}\n")


def report_line(rid: str, lengths: np.ndarray, bin_width: int,
                thr: int) -> str:
    found, avg, above, below = binmax(np.asarray(lengths), bin_width, thr)
    status = "FOUND" if found else "NOT_PRESENT"
    return (f"{rid:<30}{status:<15}{f'{avg:.3g}':<26}{above:<12}"
            f"{below:<12}\n")
