"""The r-index walks of SPUMONI over a plain suffix array.

`TextIndex` holds the text with its sentinel, its suffix array (sorted on
`device`) and its BWT, and answers the walks of SPUMONI's `run` with NumPy
over many reads at once, one read symbol a step from each read's end:

* PML (pseudo-matching lengths): where the BWT symbol at the current row is
  the read's symbol, step to its LF row and add one to the length; otherwise
  set the length to 0 and move to the nearest row above (u) or below (d)
  whose BWT symbol is the read's, then step. MONI's thresholds pick the side:
  the threshold is the leftmost minimum of the LCP array between u and d, so
  the walk goes down exactly when LCP(u, row) <= LCP(row, d). This module
  compares the suffixes themselves instead of building thresholds.
* MS: the same walk; the pointer after each step is the suffix array entry of
  the new row, the document is that of the text position where the walk last
  moved by a threshold, and the lengths come from extending each pointer
  against the text (a pointer that continues its predecessor keeps its
  length minus one).

`down_on_tie=False` reverses the threshold's tie (the rightmost minimum):
the control that breaks the exactness the configurations state.
"""

from __future__ import annotations

import numpy as np

from .suffix_array import suffix_array

_CHUNK = 64


class TextIndex:
    def __init__(self, text: np.ndarray, doc_lengths=None,
                 device: str = "cpu"):
        text = np.asarray(text, np.uint8)
        if len(text) and int(text.min()) < 2:
            raise ValueError("text symbols must be >= 2")
        n = len(text) + 1
        self.n = n
        s = np.zeros(n + _CHUNK, np.uint8)
        s[:n - 1] = text
        self.s = s
        sa = suffix_array(s[:n], device)
        self.sa = sa.astype(np.int32 if n < 2**31 else np.int64)
        bwt = s[(sa - 1) % n]
        bwt[sa == 0] = 1        # the sentinel's symbol in the BWT
        del sa
        counts = np.bincount(bwt, minlength=256)
        self.cnt = counts.astype(np.int64)
        self.off = np.zeros(257, np.int64)
        np.cumsum(counts, out=self.off[1:])
        order = np.argsort(bwt, kind="stable")
        # rows grouped by BWT symbol, in row order: key = symbol * n + row
        self.rows = order.astype(self.sa.dtype)
        self.keys = bwt[order].astype(np.int64) * n + order
        del order
        # row n: where a symbol past every indexed one sends the walk
        self.bwt = np.append(bwt, np.uint8(0))
        self.doc_ends = None
        if doc_lengths is not None:
            ends = np.cumsum(np.asarray(doc_lengths, np.int64))
            ends[-1] += 1
            self.doc_ends = ends

    # -- pieces of a step ---------------------------------------------------
    def doc_of(self, pos: np.ndarray) -> np.ndarray:
        """Document id (from 0) of text positions; SPUMONI stores the
        document of (SA sample - 1) mod n at each run boundary."""
        return np.searchsorted(self.doc_ends, pos, side="right")

    def lcp(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Longest common prefix of the suffixes at text positions a, b
        (a != b; the unique sentinel ends every comparison)."""
        out = np.zeros(len(a), np.int64)
        todo = np.arange(len(a))
        ar = np.arange(_CHUNK)
        s = self.s
        while len(todo):
            x = s[a[todo, None] + out[todo, None] + ar]
            y = s[b[todo, None] + out[todo, None] + ar]
            diff = x != y
            hit = diff.any(axis=1)
            first = diff.argmax(axis=1)
            out[todo] += np.where(hit, first, _CHUNK)
            todo = todo[~hit]
        return out

    def _step(self, row, c, down_on_tie):
        """One backward step of every lane: (new rows, matched, absent)."""
        n = self.n
        idx = np.searchsorted(self.keys, c * n + row)
        matched = self.bwt[row] == c
        absent = self.cnt[c] == 0
        new = idx.copy()
        miss = np.flatnonzero(~matched & ~absent)
        if len(miss):
            cm, im, rm = c[miss], idx[miss], row[miss]
            has_u = im > self.off[cm]
            has_d = im < self.off[cm + 1]
            down = ~has_u
            both = np.flatnonzero(has_u & has_d)
            if len(both):
                here = self.sa[rm[both]].astype(np.int64)
                up_pos = self.sa[self.rows[im[both] - 1]].astype(np.int64)
                dn_pos = self.sa[self.rows[im[both]]].astype(np.int64)
                lu = self.lcp(up_pos, here)
                ld = self.lcp(here, dn_pos)
                down[both] = lu <= ld if down_on_tie else lu < ld
            new[miss] = np.where(down, im, im - 1)
        new[absent] = self.off[c[absent]]
        return new, matched, absent

    # -- walks --------------------------------------------------------------
    def _lanes(self, reads):
        lens = np.array([len(r) for r in reads], np.int64)
        L = int(lens.max(initial=0))
        mat = np.zeros((len(reads), max(L, 1)), np.int64)
        for i, r in enumerate(reads):
            mat[i, :len(r)] = np.asarray(r, np.uint8)
        return lens, L, mat

    def pml(self, reads, down_on_tie=True) -> list[np.ndarray]:
        """Pseudo-matching lengths of each read."""
        lens, L, mat = self._lanes(reads)
        B = len(reads)
        row = np.full(B, self.n - 1, np.int64)
        length = np.zeros(B, np.int64)
        out = np.zeros((B, max(L, 1)), np.int64)
        for t in range(L):
            i = lens - 1 - t
            act = np.flatnonzero(i >= 0)
            ia = i[act]
            new, matched, _ = self._step(row[act], mat[act, ia], down_on_tie)
            row[act] = new
            length[act] = np.where(matched, length[act] + 1, 0)
            out[act, ia] = length[act]
        return [out[b, :lens[b]].copy() for b in range(B)]

    def ms(self, reads, down_on_tie=True):
        """(pointers, lengths, documents or None) of each read."""
        lens, L, mat = self._lanes(reads)
        B = len(reads)
        n = self.n
        row = np.full(B, n - 1, np.int64)
        sample = np.full(B, int(self.sa[n - 1]), np.int64)
        docs = self.doc_ends is not None
        if docs:
            doc = np.full(B, int(self.doc_of(int(self.sa[n - 1]) - 1)))
            absent_doc = int(self.doc_of(n - 2))
            dout = np.zeros((B, max(L, 1)), np.int64)
        ptr = np.zeros((B, max(L, 1)), np.int64)
        for t in range(L):
            i = lens - 1 - t
            act = np.flatnonzero(i >= 0)
            ia = i[act]
            new, matched, absent = self._step(row[act], mat[act, ia],
                                              down_on_tie)
            row[act] = new
            jumped = ~matched & ~absent
            smp = np.where(matched, sample[act] - 1,
                           self.sa[np.minimum(new, n - 1)])
            smp[absent] = 0
            sample[act] = smp
            ptr[act, ia] = smp
            if docs:
                d = doc[act]
                d[jumped] = self.doc_of(smp[jumped])
                d[absent] = absent_doc
                doc[act] = d
                dout[act, ia] = d
        lengths = self._extend(ptr, mat, lens)
        return ([ptr[b, :lens[b]].copy() for b in range(B)],
                [lengths[b, :lens[b]].copy() for b in range(B)],
                [dout[b, :lens[b]].copy() for b in range(B)] if docs
                else None)

    def _extend(self, ptr, mat, lens):
        """MS lengths from the pointers, left to right along each read."""
        B, L = ptr.shape
        tlen = self.n - 1
        out = np.zeros((B, L), np.int64)
        carry = np.zeros(B, np.int64)
        rpad = np.zeros((B, L + _CHUNK), np.int64)
        rpad[:, :L] = mat
        rpad[np.arange(L + _CHUNK)[None, :] >= lens[:, None]] = -1
        ar = np.arange(_CHUNK)
        for i in range(L):
            act = np.flatnonzero(lens > i)
            p = ptr[act, i]
            cont = (p == ptr[act, i - 1] + 1) if i else np.zeros(len(act),
                                                                bool)
            ext = act[~cont & (p >= 0)]
            pe = ptr[ext, i]
            todo = np.arange(len(ext))
            while len(todo):
                lanes = ext[todo]
                l0 = carry[lanes]
                tp = pe[todo, None] + l0[:, None] + ar
                tb = np.where(tp < tlen, self.s[np.minimum(tp, tlen)], -2)
                rb = rpad[lanes[:, None], i + l0[:, None] + ar]
                diff = tb != rb
                hit = diff.any(axis=1)
                carry[lanes] = l0 + np.where(hit, diff.argmax(axis=1),
                                             _CHUNK)
                todo = todo[~hit]
            out[act, i] = carry[act]
            carry[act] = np.maximum(carry[act] - 1, 0)
        return out
