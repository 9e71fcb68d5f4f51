"""Suffix array by prefix doubling, in plain PyTorch (on the card where the
benchmark runs, after the window; on the CPU in the tests).

The first round sorts every suffix by its first K symbols, packed into one
int64 key; each later round re-sorts only the suffixes whose rank is still
shared, by (rank of the first h symbols, rank of the next h), doubling h.
A rank is the position in the suffix array where its group starts.
"""

from __future__ import annotations

import numpy as np
import torch


def suffix_array(s: np.ndarray, device: str = "cpu") -> np.ndarray:
    """The suffix array of `s` (uint8), whose last symbol must be a unique
    smallest one (the sentinel). Returns int64 positions."""
    n = len(s)
    if n == 0 or (n > 1 and int(s[-1]) >= int(s[:-1].min())):
        raise ValueError("the text must end with a unique smallest symbol")
    if n >= 2**31:
        raise ValueError("ranks are packed in 31 bits")
    i64 = dict(dtype=torch.int64, device=device)
    text = torch.from_numpy(np.ascontiguousarray(s, np.uint8)).to(device)
    present = torch.bincount(text.long(), minlength=256) > 0
    codes = (torch.cumsum(present.long(), 0) - 1)[text.long()]
    del text
    bits = max(1, int(codes.max()).bit_length())
    K = max(1, 62 // bits)
    key = torch.zeros(n, **i64)
    for j in range(K):
        key <<= bits
        key[:n - j] |= codes[j:]
    del codes
    sa = torch.argsort(key)
    key = key[sa]
    new = torch.ones(n, dtype=torch.bool, device=device)
    torch.ne(key[1:], key[:-1], out=new[1:])
    del key
    rank = torch.empty(n, **i64)
    rank[sa] = torch.cummax(torch.where(new, torch.arange(n, **i64), 0),
                            0).values
    h = K
    while True:
        starts = torch.nonzero(new).flatten()
        sizes = torch.diff(starts, append=torch.tensor([n], **i64))
        big = sizes > 1
        starts, sizes = starts[big], sizes[big]
        total = int(sizes.sum())
        if total == 0:
            return sa.cpu().numpy()
        first = torch.cumsum(sizes, 0) - sizes
        act = (torch.repeat_interleave(starts - first, sizes,
                                       output_size=total)
               + torch.arange(total, **i64))
        pos = sa[act]
        nxt = pos + h
        past = nxt >= n
        second = rank[nxt.clamp_(max=n - 1)] + 1
        second[past] = 0        # past the text's end: below every rank
        comb = torch.repeat_interleave(starts << 32, sizes,
                                       output_size=total) | second
        del nxt, past, second
        o = torch.argsort(comb)
        sa[act] = pos[o]
        comb = comb[o]
        bound = torch.ones(total, dtype=torch.bool, device=device)
        torch.ne(comb[1:], comb[:-1], out=bound[1:])
        del comb, pos, o
        new[act] = bound
        rank[sa[act]] = torch.cummax(torch.where(bound, act, 0), 0).values
        h *= 2
