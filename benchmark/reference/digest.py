"""SPUMONI 2's promotion minimizer digest (`-m`, k = 4, w = 11), one
sequence at a time.

Each k-mer of ACGT bases hashes to 8 bits by the cyclic hash
h = XOR_j rotl8(T[base_j], k - 1 - j), with T the first four MT19937(0)
outputs masked to 8 bits (A, C, G, T in that order); a k-mer with any other
byte is invalid. Every window of w bases (w - k + 1 k-mers, all inside the
sequence) emits its least valid hash; a sequence shorter than w but at least
k is one window. Runs of equal emitted values collapse to one, and values
0-2 become 3-5 (reserved symbols of the index).
"""

from __future__ import annotations

import numpy as np

from .rng import mt19937_words

K, W = 4, 11
INVALID = 0xFFFF


def _table() -> np.ndarray:
    tab = np.zeros(256, np.uint16)
    valid = np.zeros(256, bool)
    for base, word in zip(b"ACGT", mt19937_words(0, 4)):
        tab[base] = word & 0xFF
        valid[base] = True
    return tab, valid


_TAB, _VALID = _table()


def _rotl8(x: np.ndarray, r: int) -> np.ndarray:
    r %= 8
    return ((x << r) | (x >> (8 - r))) & 0xFF


def kmer_hashes(seq: np.ndarray, k: int = K) -> np.ndarray:
    """The hash of every k-mer of `seq`, INVALID where a byte is not ACGT."""
    m = len(seq) - k + 1
    if m <= 0:
        return np.zeros(0, np.uint16)
    t = _TAB[seq]
    ok = _VALID[seq]
    h = np.zeros(m, np.uint16)
    valid = np.ones(m, bool)
    for j in range(k):
        h ^= _rotl8(t[j:j + m], k - 1 - j)
        valid &= ok[j:j + m]
    h[~valid] = INVALID
    return h


def digest(seq: np.ndarray, k: int = K, w: int = W) -> np.ndarray:
    """The digested symbols (uint8) of one sequence."""
    h = kmer_hashes(np.asarray(seq, np.uint8), k)
    if len(h) == 0:
        return np.zeros(0, np.uint8)
    per = w - k + 1
    if len(h) <= per:
        mins = h.min(keepdims=True)
    else:
        mins = np.lib.stride_tricks.sliding_window_view(h, per).min(axis=1)
    mins = mins[mins != INVALID]
    if len(mins) == 0:
        return np.zeros(0, np.uint8)
    keep = np.ones(len(mins), bool)
    keep[1:] = mins[1:] != mins[:-1]
    mins = mins[keep]
    return np.where(mins > 2, mins, mins + 3).astype(np.uint8)
