"""The generator: the same seed gives the same data; every seed gets the
same read lengths and the same share of positives."""

import numpy as np

from benchmark import traffic

CFG = {"strains": 3, "strain_len": 20000, "divergence": 0.01}
FIXED = {"reads": 40, "length": {"kind": "fixed", "bp": 300},
         "error_rate": 0.08}
GAMMA = {"reads": 30, "error_rate": 0.08,
         "length": {"kind": "gamma", "mean": 1500, "sd": 1300, "min": 200,
                    "max": 9000, "length_seed": 3}}


def test_same_seed_same_data():
    a, b = traffic.pangenome(CFG, 2**40 + 7), traffic.pangenome(CFG, 2**40 + 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for cell in (FIXED, GAMMA):
        ia, sa = traffic.reads(cell, a, 2**40 + 7)
        ib, sb = traffic.reads(cell, b, 2**40 + 7)
        assert ia == ib
        assert all(np.array_equal(x, y) for x, y in zip(sa, sb))


def test_seeds_differ_but_keep_the_work():
    a, b = traffic.pangenome(CFG, 1), traffic.pangenome(CFG, 2)
    assert not np.array_equal(a[0], b[0])
    for cell in (FIXED, GAMMA):
        _, sa = traffic.reads(cell, a, 1)
        _, sb = traffic.reads(cell, b, 2)
        assert sorted(map(len, sa)) == sorted(map(len, sb))
        assert [len(s) for s in sa] != [len(s) for s in sb] or \
            cell is FIXED


def test_strains_and_reads_shape():
    st = traffic.pangenome(CFG, 5)
    assert len(st) == 3 and all(len(s) == 20000 for s in st)
    div = np.mean(st[1] != st[0])
    assert 0.003 < div < 0.012          # 1% drawn, 3/4 of them change
    ids, seqs = traffic.reads(FIXED, st, 5)
    assert ids[:2] == ["pos_0", "neg_1"] and len(ids) == 40
    assert all(set(np.unique(s)) <= set(b"ACGT") for s in seqs)
    lens = traffic.read_lengths(GAMMA, 5)
    assert lens.min() >= 200 and lens.max() <= 9000


def test_positives_come_from_the_strains():
    st = traffic.pangenome(CFG, 9)
    cell = dict(FIXED, error_rate=0.0)
    ids, seqs = traffic.reads(cell, st, 9)
    text = b"".join(s.tobytes() + b"N" + traffic._COMP[s[::-1]].tobytes()
                    + b"N" for s in st)
    for rid, s in zip(ids, seqs):
        assert (s.tobytes() in text) == rid.startswith("pos")


def test_error_model():
    src = np.tile(traffic.ACGT, 2500)[None, :]
    rng = np.random.default_rng(0)
    same = traffic._mutate(rng, src, np.array([9000]), 0.0)[0]
    assert np.array_equal(same, src[0, :9000])
    out = traffic._mutate(rng, src, np.array([9000]), 0.08)[0]
    assert len(out) == 9000
    # substitutions and deletions/insertions of about 8% a base: most
    # 4-base windows still read ACGT in order, but not all
    ok = np.mean([out[i:i + 4].tobytes() in b"ACGTACG" for i in
                  range(0, 8996)])
    assert 0.6 < ok < 0.9
