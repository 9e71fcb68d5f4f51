"""The two random streams that SPUMONI's build draws from, written out from
their published algorithms.

* glibc `rand()` after `srand(0)` (the TYPE_3 additive feedback generator:
  r[i] = r[i-3] + r[i-31] mod 2^32, seeded by 16807 * s mod 2^31 - 1, the
  first 310 outputs dropped, each output shifted right by one; seed 0 acts
  as 1). SPUMONI's build samples its null reads with it.
* MT19937 (Matsumoto and Nishimura's recurrence with Knuth's seeding), whose
  first outputs masked to 8 bits fill the table of the 8-bit cyclic hash
  that the promotion minimizers use (rollinghashcpp's CharacterHash).
"""

from __future__ import annotations


class GlibcRand:
    def __init__(self, seed: int = 0):
        seed &= 0xFFFFFFFF
        r = [seed or 1]
        for _ in range(1, 31):
            r.append(16807 * r[-1] % 2147483647)
        for i in range(31, 34):
            r.append(r[i - 31])
        self._r = r
        for _ in range(310):
            self._word()

    def _word(self) -> int:
        r = self._r
        v = (r[-3] + r[-31]) & 0xFFFFFFFF
        r.append(v)
        if len(r) > 4096:
            del r[:-64]
        return v

    def rand(self) -> int:
        return self._word() >> 1


def mt19937_words(seed: int, count: int) -> list[int]:
    """The first `count` tempered 32-bit outputs of MT19937 seeded with
    `seed` by Knuth's recurrence."""
    N, M = 624, 397
    mt = [seed & 0xFFFFFFFF]
    for i in range(1, N):
        mt.append((1812433253 * (mt[-1] ^ (mt[-1] >> 30)) + i) & 0xFFFFFFFF)
    out = []
    idx = N
    while len(out) < count:
        if idx == N:
            for i in range(N):
                y = (mt[i] & 0x80000000) | (mt[(i + 1) % N] & 0x7FFFFFFF)
                mt[i] = mt[(i + M) % N] ^ (y >> 1) ^ (0x9908B0DF if y & 1
                                                      else 0)
            idx = 0
        y = mt[idx]
        idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        out.append(y & 0xFFFFFFFF)
    return out
