"""time_scan.py's variants: each family's timing-only variants are literal
patches of this tree's kernel sources, so each patch must find its line
there (on the card, --ablate stops at the first that does not); family
grouped's batch is the value cells'."""

import os

import pytest

from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.scripts import time_scan


@pytest.mark.parametrize("family", sorted(
    f for f, fam in time_scan.FAMILIES.items() if fam.variants))
def test_variant_patches_find_their_lines_in_this_tree(family):
    fam = time_scan.FAMILIES[family]
    for label, patches in fam.variants.items():
        for name, old, _ in patches:
            with open(os.path.join(kernels._CSRC, name)) as f:
                assert old in f.read(), f"{family} {label}: {name}"



@pytest.mark.parametrize("cell", ["pml_values_long", "ms_doc_values"])
def test_grouped_lengths_are_the_value_cells(cell):
    """Family grouped times the value cells' batch: its 2,048 read lengths
    are, as a multiset, those of every call of each value cell, 27 length
    buckets of the engine."""
    import json

    import numpy as np

    from benchmark import traffic
    from spumoni_tpu_torch.engine.scan_engine import ScanEngine

    with open(os.path.join("benchmark", "cells", f"{cell}.json")) as f:
        spec = json.load(f)
    got = time_scan.grouped_lengths()
    for seed in (1, 2**31 + 5):
        assert np.array_equal(np.sort(got),
                              np.sort(traffic.read_lengths(spec, seed)))
    assert len(np.unique(ScanEngine._bucket_L(ScanEngine, got))) == 27
    assert got.max() == 95007
