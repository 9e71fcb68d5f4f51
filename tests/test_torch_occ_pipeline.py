"""End-to-end parity of the port's `run --engine occ` (device='cpu': the
plain PyTorch versions of K9 / K10) with the JAX package's `run --engine
occ` (JAX CPU backend): the three-document -M -P -d index in every run
kind of the layered engine's tests, --resume, a DNA-letter minimizer (-a)
index and general text (-g) over few distinct bytes. Output files are
byte-identical; an index with more than 15 characters (-m) is refused by
both packages alike.
"""

import numpy as np
import pytest

from spumoni_tpu.pipeline import BuildConfig, RunConfig as JaxRunConfig
from spumoni_tpu.pipeline import build
from spumoni_tpu.pipeline import run as jax_run

import spumoni_tpu_torch.pipeline as tpl
from spumoni_tpu_torch.engine.occblock import OccIndex

from test_torch_layered_pipeline import (_LAYERED_RUNS, _resume_both,
                                         _run_both, digested)  # noqa: F401
from test_torch_pipeline import msdoc  # noqa: F401


@pytest.mark.parametrize("run_id", sorted(_LAYERED_RUNS))
def test_occ_runs_match_jax(msdoc, run_id):  # noqa: F811
    """`--engine occ` writes the files of the JAX package's occ engine,
    byte for byte (K10; K9; K9 -> K4 -> K5; K9 -> K4; K9)."""
    want, got = _run_both(msdoc, 13, engine="occ", **_LAYERED_RUNS[run_id])
    assert want and got == want


@pytest.mark.parametrize("run_id", ["M-c-d", "P-c-ks-report"])
def test_occ_resume_continues_the_files(msdoc, run_id):  # noqa: F811
    want, got = _resume_both(msdoc, 13, 4, engine="occ",
                             **_LAYERED_RUNS[run_id])
    assert got == want


def test_occ_engine_is_the_one_asked_for(msdoc):  # noqa: F811
    """make_engine builds an OccIndex with only the tables the run reads."""
    base = msdoc["ref_file"] + ".fa.thrbv."
    dev = tpl.select_devices("cpu")[0]
    pml = tpl.make_engine(base + "spumoni", dev, "pml", False, engine="occ")
    ms = tpl.make_engine(base + "ms", dev, "ms", True, engine="occ")
    assert isinstance(pml.index, OccIndex) and pml.occ
    m = pml.index.meta
    assert (m.has_samples, m.has_doc, pml.index.text) == (False, False, None)
    m = ms.index.meta
    assert m.has_samples and m.has_doc and ms.index.text is not None
    assert m.width == m.T0 + 5 * m.P


@pytest.mark.parametrize("kw", [dict(write_report=True),
                                dict(write_report=True, report_only=True)],
                         ids=["a-P-c", "a-P-c-report-only"])
def test_occ_dna_letter_minimizer_runs_match_jax(digested, kw):  # noqa: F811
    """`run -a --engine occ`: the digested DNA-letter index (sigma <= 15)
    on the occ engine."""
    want, got = _run_both(digested["use_dna_letters"], 11, engine="occ",
                          pml_requested=True, **kw)
    assert ".report" in want and got == want


def test_occ_refuses_a_promoted_minimizer_index(digested):  # noqa: F811
    """A -m index has about 150 characters: both packages raise the same
    ValueError for --engine occ."""
    cfg = dict(digested["use_promotions"], pml_requested=True,
               write_report=True, engine="occ")
    with pytest.raises(ValueError, match="occ engine needs sigma <= 15"):
        jax_run(JaxRunConfig(**cfg))
    with pytest.raises(ValueError, match="occ engine needs sigma <= 15"):
        tpl.run(tpl.RunConfig(device="cpu", **cfg))


@pytest.fixture(scope="module")
def general_small(tmp_path_factory):
    """A general-text index (build -g -M -P) of 20 kB over ten letters, and
    \\x01-separated queries: substrings, a random string, an empty record
    and a record with bytes absent from the text."""
    tmp = tmp_path_factory.mktemp("general_small")
    rng = np.random.default_rng(31)
    data = bytes(rng.integers(97, 107, size=20000).astype(np.uint8))
    ref_path = str(tmp / "corpus.txt")
    with open(ref_path, "wb") as f:
        f.write(data)
    queries = [data[500:800], data[9000:9500],
               bytes(rng.integers(97, 107, size=250).astype(np.uint8)), b"",
               data[3000:3100] + b"ZZ#" + data[7000:7200], data[-120:]]
    pattern_path = str(tmp / "queries.txt")
    with open(pattern_path, "wb") as f:
        f.write(b"\x01".join(queries) + b"\x01")
    build(BuildConfig(ref_file=ref_path, output_prefix=str(tmp / "idx"),
                      ms_index=True, pml_index=True, is_general_text=True,
                      use_minimizers=False))
    return dict(ref_file=ref_path, pattern_file=pattern_path,
                is_general_text=True, min_digest=False)


@pytest.mark.parametrize("mode", ["pml_requested", "ms_requested"])
def test_occ_general_text_runs_match_jax(general_small, mode):
    """`run -g --engine occ` streams the records through the list API."""
    want, got = _run_both(general_small, 6, engine="occ", **{mode: True})
    assert want and got == want
