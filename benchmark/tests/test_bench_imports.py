"""The check for JAX and the JAX package compares whole top-level names:
spumoni_tpu_torch is the program, spumoni_tpu the JAX package."""

import os
import shutil

from benchmark import run


def test_top_level_names():
    mods = {"spumoni_tpu_torch": 1, "spumoni_tpu_torch.cli": 1,
            "numpy": 1, "jaxtyping": 1}
    assert run.forbidden_modules(mods) == []
    mods.update({"spumoni_tpu.engine": 1, "jax._src": 1, "jaxlib": 1,
                 "flax": 1})
    assert run.forbidden_modules(mods) == ["flax", "jax._src", "jaxlib",
                                           "spumoni_tpu.engine"]


def test_reference_imports_neither_jax_nor_the_program(tmp_path):
    assert run.reference_imports() == []
    root = tmp_path / "r"
    shutil.copytree(os.path.join(run.ROOT, "benchmark", "reference"),
                    root / "benchmark" / "reference")
    (root / "benchmark" / "reference" / "bad.py").write_text(
        "import numpy\nfrom spumoni_tpu_torch.engine import kernels\n"
        "import spumoni_tpu\n")
    assert run.reference_imports(str(root)) == [
        "bad.py: spumoni_tpu_torch.engine", "bad.py: spumoni_tpu"]
