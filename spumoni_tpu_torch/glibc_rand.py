"""Emulation of glibc's rand()/srand() (TYPE_3 additive feedback generator).

The reference seeds srand(0) before null-read sampling
(src/refbuilder.cpp:84,234,284) and consumes rand() both there
(rand() % (len - 150)) and in the KS-test window sampler
(src/ks_test.cpp:113). Reproducing those exact draws is
required for output determinism/parity, so we implement the well-documented
glibc algorithm: a 31-entry additive lagged Fibonacci generator
(x[i] = x[i-3] + x[i-31] mod 2^32, output >> 1) seeded by the Lehmer LCG
16807 * s mod 2147483647, with the first 310 outputs discarded.
glibc maps seed 0 to 1.
"""

from __future__ import annotations


class GlibcRand:
    def __init__(self, seed: int = 0):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed &= 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 34
        # the LCG runs in signed 32-bit via Schrage's method; result is the
        # mathematical 16807*s mod 2147483647 made non-negative
        s = seed
        r[0] = s & 0xFFFFFFFF
        for i in range(1, 31):
            hi, lo = divmod(s, 127773)
            s = 16807 * lo - 2836 * hi
            if s < 0:
                s += 2147483647
            r[i] = s
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._r = r
        self._i3 = 34 - 3   # index of x[i-3] for the next value
        self._i31 = 34 - 31
        for _ in range(310):
            self._next_word()

    def _next_word(self) -> int:
        r = self._r
        val = (r[self._i3] + r[self._i31]) & 0xFFFFFFFF
        r.append(val)
        self._i3 += 1
        self._i31 += 1
        # keep the list from growing unboundedly
        if self._i31 > 4096:
            del r[: self._i31]
            self._i3 -= self._i31
            self._i31 = 0
        return val

    def rand(self) -> int:
        return self._next_word() >> 1

    def advance(self, k: int) -> None:
        """Discards k draws — used to keep a host's stream aligned with the
        global (single-process) rand() consumption order under host sharding
        and resume."""
        for _ in range(k):
            self._next_word()


# Module-level instance mirroring the process-wide srand()/rand() state of the
# reference binary (one state per build/run invocation).
_global = GlibcRand(0)


def srand(seed: int) -> None:
    _global.srand(seed)


def rand() -> int:
    return _global.rand()
