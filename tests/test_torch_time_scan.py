"""time_scan.py's variants: each family's timing-only variants are literal
patches of this tree's kernel sources, so each patch must find its line
there (on the card, --ablate stops at the first that does not)."""

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
