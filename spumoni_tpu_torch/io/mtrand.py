"""Bit-exact Wagner MTRand (MersenneTwister.h) + rollinghashcpp CharacterHash.

The reference's promotion-minimizer digestion hashes k-mers with
rollinghashcpp's CyclicHash (via bonsai's RollingHasher,
src/spumoni.cpp:296), whose per-character table is filled by
`CharacterHash(maxval)` from a Mersenne Twister — Richard J. Wagner's MTRand
class, wrapped as `mersenneRNG`:

    CharacterHash(hashvaluetype maxval) {          // characterhash.h
        mersenneRNG randomgenerator(maxval);       // maxval = 2^wordsize - 1
        for (size_t k = 0; k < nbrofchars; ++k)
            hashvalues[k] = randomgenerator();     // = mtr.randInt(maxval)
    }

This module reproduces that generation chain exactly, in the same spirit as
the bit-exact glibc rand() emulation in glibc_rand.py:

  * MT19937 state initialization with the Knuth multiplier 1812433253
    (MTRand::initialize), the block reload (MTRand::reload — identical
    recurrence to the canonical mt19937ar genrand loop), and the standard
    tempering shifts (11/7&0x9d2c5680/15&0xefc60000/18);
  * MTRand::randInt(n): mask n up to full bits ("used"), draw tempered
    outputs ANDed with the mask until one is <= n. For n = 2^bits - 1 (the
    CharacterHash case) every draw is accepted, so hashvalues[k] is simply
    the k-th tempered output masked to wordsize bits.

Residual uncertainty (documented per PARITY.md): upstream MTRand's
DEFAULT constructor seeds from /dev/urandom (or a time/clock hash) — a
process-random table, under which a build-process index and a run-process
query could never agree, so the deployed digestion must pin a deterministic
seed in bonsai's vendored fork. That pinned seed value is the one thing not
derivable offline; `character_hash_table(seed=...)` takes it as a parameter
and the digestion default uses seed 0 (the natural pinned choice). Every
other step of the chain is exact per the published sources.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_U32 = 0xFFFFFFFF


class MTRand:
    """Wagner's MTRand, integer API only (randInt), bit-exact."""

    def __init__(self, seed: int):
        self._state = [0] * _N
        self._next = 0
        self._left = 0
        self.seed(seed)

    def seed(self, one_seed: int) -> None:
        # MTRand::initialize — Knuth's multiplier recurrence
        s = self._state
        s[0] = one_seed & _U32
        for i in range(1, _N):
            s[i] = (1812433253 * (s[i - 1] ^ (s[i - 1] >> 30)) + i) & _U32
        self._reload()

    def _reload(self) -> None:
        s = self._state
        for i in range(_N):
            y = (s[i] & _UPPER) | (s[(i + 1) % _N] & _LOWER)
            s[i] = s[(i + _M) % _N] ^ (y >> 1) ^ (_MATRIX_A if y & 1 else 0)
        self._next = 0
        self._left = _N

    def rand_int32(self) -> int:
        """MTRand::randInt() — one tempered 32-bit output."""
        if self._left == 0:
            self._reload()
        self._left -= 1
        y = self._state[self._next]
        self._next += 1
        y ^= y >> 11
        y = (y ^ ((y << 7) & 0x9D2C5680)) & _U32
        y = (y ^ ((y << 15) & 0xEFC60000)) & _U32
        return (y ^ (y >> 18)) & _U32

    def rand_int(self, n: int) -> int:
        """MTRand::randInt(n): uniform in [0, n] by masked rejection."""
        used = n
        used |= used >> 1
        used |= used >> 2
        used |= used >> 4
        used |= used >> 8
        used |= used >> 16
        while True:
            i = self.rand_int32() & used
            if i <= n:
                return i


def character_hash_table(wordsize: int = 8, seed: int = 0) -> np.ndarray:
    """The 256-entry CharacterHash table for a `wordsize`-bit CyclicHash:
    hashvalues[k] = mersenneRNG(2^wordsize - 1) drawn 256 times from one
    MTRand stream. For wordsize <= 32 a single generator fills the table
    (characterhash.h's sizeof(hashvaluetype) <= 4 branch)."""
    assert 1 <= wordsize <= 32
    maxval = (1 << wordsize) - 1
    rng = MTRand(seed)
    return np.array([rng.rand_int(maxval) for _ in range(256)],
                    dtype=np.uint32 if wordsize > 16 else
                    (np.uint16 if wordsize > 8 else np.uint8))
