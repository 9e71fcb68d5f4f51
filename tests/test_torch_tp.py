"""The port's sharded index (`run --tp-devices S`, spumoni_tpu_torch/
parallel/tp.py) against the JAX package's (spumoni_tpu/parallel/tp.py) on
the JAX CPU backend's 8 virtual devices: the cases of tests/test_tp.py, each
held exactly (integer equality) to TpPmlClassifier / TpMsQuery on the same
mesh's model axis, and the CLI runs to the JAX package's run(...,
tp_devices=S) files byte for byte. The port runs the plain versions of
K13-K16 here (CPU tensors).
"""

import os

import numpy as np
import pytest
import torch

from spumoni_tpu.classify import binmax
from spumoni_tpu.engine import blockbits as jbb
from spumoni_tpu.engine import layered as jlay
from spumoni_tpu.engine.scan_engine import ScanEngine as JaxScanEngine
from spumoni_tpu.index import format as jfmt
from spumoni_tpu.native import NativeQueryEngine
from spumoni_tpu.native import build_raw_index as jraw
from spumoni_tpu.parallel.tp import TpMsQuery, TpPmlClassifier, make_tp_mesh
from spumoni_tpu.pipeline import BuildConfig, RunConfig as JaxRunConfig
from spumoni_tpu.pipeline import build, run as jax_run

import spumoni_tpu_torch.pipeline as tpl
from spumoni_tpu_torch.engine import blockbits as tbb
from spumoni_tpu_torch.engine import layered as tlay
from spumoni_tpu_torch.engine.scan_engine import ScanEngine
from spumoni_tpu_torch.index import format as tfmt
from spumoni_tpu_torch.native import build_raw_index as traw
from spumoni_tpu_torch.parallel import tp

from conftest import mutated_substring, rand_dna

_KEYS = ("found", "above", "below", "sum_maxes")


def _dense(text: bytes, ms=False, doc_lens=None):
    """(JAX dense index, port dense index, native engine) of `text`, with
    SA samples and the text for ms, and doc arrays for doc_lens."""
    tarr = np.frombuffer(text, np.uint8)
    out = []
    for raw_fn, fmt in ((jraw, jfmt), (traw, tfmt)):
        raw = raw_fn(tarr)
        kw = {}
        if doc_lens:
            ds, de = fmt.build_doc_arrays(raw, doc_lens)
            kw = dict(doc_start=ds, doc_end=de)
        out.append(fmt.build_dense_index(raw, text=tarr if ms else None,
                                         with_samples=ms, **kw))
    raw = jraw(tarr)
    docs = {}
    if doc_lens:
        docs = dict(zip(("start_doc", "end_doc"),
                        jfmt.build_doc_arrays(raw, doc_lens)))
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last,
                               text=tarr if ms else None, **docs)
    return out[0], out[1], native


def _jax_classifier(jdense, engine, mesh, bin_width=150, thr=5):
    build_fn = jbb.build_blockbits if engine == "bits" else jlay.build_layered
    arrays, meta, host = build_fn(jdense)
    return TpPmlClassifier(arrays, meta, mesh, bin_width=bin_width,
                           max_value_thr=thr, host=host)


def _port_classifier(tdense, engine, S):
    if engine == "bits":
        index, table = tbb.build_blockbits(tdense)
        return ScanEngine(tp.shard_blockbits(index, S), table)
    return ScanEngine(tp.shard_layered(tlay.build_layered(tdense), S))


def _assert_same(got, want, keys=_KEYS):
    for k in keys:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def _assert_native(out, native, reads, bin_width=150, thr=5):
    for i, lengths in enumerate(native.query_pml(reads)):
        ref = binmax.classify(lengths, bin_width, thr)
        assert (ref.status == "FOUND") == bool(out["found"][i]), i
        assert ref.bins_above == out["above"][i], i
        assert ref.bins_below == out["below"][i], i
        assert ref.bin_maxes.sum() == out["sum_maxes"][i], i


def test_tp_classifier_matches_native(rng):
    """Layered fields in 4 shards (a 2 x 4 mesh's model axis): verdicts
    equal JAX's sharded classifier's and the native engine's."""
    text = rand_dna(rng, 6000)
    jdense, tdense, native = _dense(text)
    reads = [mutated_substring(rng, text, 300, err=0.05) for _ in range(9)]
    reads += [rand_dna(rng, 300) for _ in range(8)]
    want = _jax_classifier(jdense, "layered", make_tp_mesh(2, 4)).classify(
        reads)
    got = _port_classifier(tdense, "layered", 4).classify(reads, 150, 5)
    _assert_same(got, want)
    _assert_native(got, native, reads)


def test_tp_matches_replicated_path(rng):
    text = rand_dna(rng, 3000)
    jdense, tdense, _ = _dense(text)
    reads = [mutated_substring(rng, text, 220, err=0.08) for _ in range(16)]
    repl = ScanEngine(tlay.build_layered(tdense)).classify(reads, 100, 4)
    got = _port_classifier(tdense, "layered", 4).classify(reads, 100, 4)
    want = _jax_classifier(jdense, "layered", make_tp_mesh(2, 4), 100,
                           4).classify(reads)
    _assert_same(got, repl)
    _assert_same(got, want)


def test_tp_fields_memory_is_sharded(rng):
    """Each of the 4 shards holds a quarter of the r + 1 field rows,
    zero-padded to a multiple of 4 rows (fewer than the JAX sharded
    table's power-of-two rows)."""
    jdense, tdense, _ = _dense(rand_dna(rng, 3000))
    clf = _jax_classifier(jdense, "layered", make_tp_mesh(2, 4))
    index = tlay.build_layered(tdense)
    sh = tp.shard_layered(index, 4)
    total = sh.fields.shape[0]
    assert total == -(-(sh.meta.r + 1) // 4) * 4
    for shard in sh.fields.shards:
        assert shard.shape[0] == total // 4
    assert torch.equal(torch.cat(sh.fields.shards)[:sh.meta.r + 1],
                       index.fields)
    assert not torch.cat(sh.fields.shards)[sh.meta.r + 1:].any()
    assert total < clf.arrays.fields.shape[0] * clf.meta.group


@pytest.mark.parametrize("engine", ["layered", "bits"])
def test_tp_uneven_row_padding(rng, engine):
    """3 shards divide neither the port's r + 1 layered rows nor, here,
    the block-bits rows: the pad rows are zero (JAX's layered pad rows hold
    start n, zeros; no probe of the port reaches them), the carried-over
    JAX state equals the port's own shards, and the verdicts equal JAX's
    and the native engine's."""
    text = rand_dna(rng, 2400)
    jdense, tdense, native = _dense(text)
    clf = _jax_classifier(jdense, engine, make_tp_mesh(1, 3))
    if engine == "layered":
        index = tlay.build_layered(tdense)
        m = index.meta
        sh = tp.shard_layered(index, 3)
        assert (m.r + 1) % 3 and sh.fields.shape[0] % 3 == 0
        jf = np.asarray(clf.arrays.fields).reshape(-1, clf.meta.width)
        sentinel = np.zeros(m.width, jf.dtype)
        sentinel[tlay.F_START] = m.n
        assert len(jf) > sh.fields.shape[0]   # JAX padded its 2^k rows
        assert (jf[m.r + 1:] == sentinel).all()
        assert not torch.cat(sh.fields.shards)[m.r + 1:].any()
        carried = tp.from_jax(
            {k: (np.asarray(v) if k != "levels" else
                 [np.asarray(lv) for lv in v])
             for k, v in clf.arrays._asdict().items() if v is not None},
            clf.meta._asdict(), 3)
        eng = ScanEngine(sh)
        table = None
    else:
        index, table = tbb.build_blockbits(tdense)
        sh = tp.shard_blockbits(index, 3)
        nb = index.bblocks.shape[0]
        assert nb % 3 and sh.bblocks.shape[0] % 3 == 0
        assert np.array_equal(torch.cat(sh.bblocks.shards).numpy(),
                              np.asarray(clf.arrays.bblocks))
        assert not torch.cat(sh.bblocks.shards)[nb:].any()
        carried, _ = tp.from_jax(
            {k: np.asarray(v) for k, v in clf.arrays._asdict().items()
             if v is not None},
            {**clf.meta._asdict(), "n": int(clf.arrays.n)}, 3,
            vars(clf.host))
        eng = ScanEngine(sh, table)
    for name in ("fields", "bblocks"):
        if hasattr(sh, name):
            for a, b in zip(getattr(sh, name).shards,
                            getattr(carried, name).shards):
                assert torch.equal(a, b), name
    assert carried.meta == sh.meta
    reads = [mutated_substring(rng, text, 180, err=0.05) for _ in range(5)]
    got = eng.classify(reads, 150, 5)
    _assert_same(got, clf.classify(reads))
    _assert_native(got, native, reads)


def test_tp_beyond_single_device_budget(rng):
    """A fields table larger than a budget classifies right while each of
    its 8 shards stays under the budget the whole table busts."""
    text = rand_dna(rng, 300_000)
    jdense, tdense, native = _dense(text)
    index = tlay.build_layered(tdense)
    full_bytes = index.fields.numel() * index.fields.element_size()
    budget = full_bytes // 2
    sh = tp.shard_layered(index, 8)
    per_shard = max(t.numel() * t.element_size() for t in sh.fields.shards)
    assert len(sh.fields.shards) == 8
    assert per_shard <= budget and per_shard * 8 >= full_bytes
    reads = [mutated_substring(rng, text, 400, err=0.05) for _ in range(6)]
    reads += [rand_dna(rng, 400) for _ in range(6)]
    got = ScanEngine(sh).classify(reads, 150, 5)
    want = _jax_classifier(jdense, "layered", make_tp_mesh(1, 8)).classify(
        reads)
    _assert_same(got, want)
    _assert_native(got, native, reads)


def test_tp_blockbits_matches_native(rng):
    """Block-bits rows in 4 shards: each holds padded / 4 rows, and the
    verdicts equal JAX's sharded classifier's and the native engine's."""
    text = rand_dna(rng, 6000)
    jdense, tdense, native = _dense(text)
    eng = _port_classifier(tdense, "bits", 4)
    total = eng.index.bblocks.shape[0]
    for shard in eng.index.bblocks.shards:
        assert shard.shape[0] == total // 4
    reads = [mutated_substring(rng, text, 300, err=0.05) for _ in range(9)]
    reads += [rand_dna(rng, 300) for _ in range(8)]
    got = eng.classify(reads, 150, 5)
    _assert_same(got, _jax_classifier(jdense, "bits",
                                      make_tp_mesh(2, 4)).classify(reads))
    _assert_native(got, native, reads)


def _write_fixture(tmp_path, rng, genome_len, n, m, **build_kw):
    genome_path = str(tmp_path / "g.fa")
    with open(genome_path, "w") as f:
        f.write(">chr\n" + rand_dna(rng, genome_len).decode() + "\n")
    reads_path = str(tmp_path / "reads.fa")
    text = open(genome_path).readlines()[1].strip().encode()
    with open(reads_path, "w") as f:
        for i in range(n):
            f.write(f">pos{i}\n"
                    f"{mutated_substring(rng, text, m, 0.05).decode()}\n")
            f.write(f">neg{i}\n{rand_dna(rng, m).decode()}\n")
        f.write(">quirk\n" + (text[100:160] + b"W" + text[200:260]).decode()
                + "\n")
    build(BuildConfig(ref_file=genome_path, output_prefix=str(tmp_path / "i"),
                      use_minimizers=False, **build_kw))
    return dict(ref_file=str(tmp_path / "i"), pattern_file=reads_path,
                min_digest=False)


def _files(reads_path, exts):
    out = {}
    for ext in exts:
        with open(reads_path + ext, "rb") as f:
            out[ext] = f.read()
        os.remove(reads_path + ext)
    return out


def test_tp_cli_reachable(tmp_path, rng, monkeypatch, capsys):
    """`run --tp-devices 4` with the block-bits and the layered engine
    writes the JAX package's sharded run's report and the replicated
    run's, byte for byte. Under a tiny SPN_HBM_BUDGET_GB with 8 GPUs
    visible (the count stubbed) the JAX package shards on its own; a
    --device cpu run of the port does not (the JAX package's rule for its
    own CPU runs; tests/test_torch_data_parallel.py holds the sizing on
    several cards), and writes the same report."""
    base = dict(_write_fixture(tmp_path, rng, 20000, 6, 300,
                               pml_index=True),
                pml_requested=True, write_report=True, report_only=True)
    reads_path = base["pattern_file"]
    tpl.run(tpl.RunConfig(device="cpu", **base))
    repl = _files(reads_path, (".report",))
    for engine in ("bits", "layered"):
        jax_run(JaxRunConfig(tp_devices=4, engine=engine, **base))
        want = _files(reads_path, (".report",))
        tpl.run(tpl.RunConfig(device="cpu", tp_devices=4, engine=engine,
                              **base))
        assert _files(reads_path, (".report",)) == want == repl, engine
    monkeypatch.setenv("SPN_HBM_BUDGET_GB", "0.000001")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    capsys.readouterr()
    jax_run(JaxRunConfig(**base))
    assert "auto TP" in capsys.readouterr().out
    want = _files(reads_path, (".report",))
    tpl.run(tpl.RunConfig(device="cpu", **base))
    assert "sharded index" not in capsys.readouterr().out
    assert _files(reads_path, (".report",)) == want == repl


@pytest.mark.parametrize("kw", [
    dict(pml_requested=True),
    dict(ms_requested=True, write_report=True, report_only=True),
    dict(pml_requested=True, write_report=True, use_doc=True),
    dict(pml_requested=True, write_report=True, report_only=True,
         engine="occ"),
], ids=["pml-values", "ms-report-only", "pml-doc-values", "occ"])
def test_tp_validation(tmp_path, kw):
    """The JAX package's ValueError for the modes the sharded path does not
    serve, from the port's RunConfig and from run()."""
    pat = str(tmp_path / "p.fa")
    with open(pat, "w") as f:
        f.write(">r\nACGT\n")
    cfg = dict(ref_file="x", pattern_file=pat, min_digest=False,
               tp_devices=4, **kw)
    match = "layered and block-bits" if "engine" in kw else "classify-only"
    with pytest.raises(ValueError, match=match):
        JaxRunConfig(**cfg).validate()
    with pytest.raises(ValueError, match=match):
        tpl.run(tpl.RunConfig(device="cpu", **cfg))


def _ms_setup(text, S, mesh, use_doc=False, doc_lens=None):
    jdense, tdense, native = _dense(text, ms=True, doc_lens=doc_lens)
    arrays, meta, host = jbb.build_blockbits(jdense, want_ms=True,
                                             want_doc=use_doc)

    class _NativeFallback:   # the JAX run's CPU fallback for quirk reads
        def query(self, reads):
            p, l, *_ = native.query_ms([bytes(r) for r in reads])
            return {"pointers": p, "lengths": l}

    jtp = TpMsQuery(arrays, meta, mesh, host, use_doc=use_doc,
                    fallback=_NativeFallback())
    index, table = tbb.build_blockbits(tdense, want_ms=True, want_doc=use_doc)
    eng = ScanEngine(tp.shard_blockbits_ms(index, S), table, mode="ms",
                     use_doc=use_doc)
    return jtp, eng, (index, table), native


def test_tp_ms_matches_native(rng):
    """MS with rows, msrows, jump tables and text in 4 shards each: pointers
    and lengths equal JAX's TpMsQuery's, the native engine's and the port's
    replicated engine's; the carried-over JAX state equals the shards."""
    text = rand_dna(rng, 6000)
    jtp, eng, (index, table), native = _ms_setup(text, 4, make_tp_mesh(2, 4))
    sh = eng.index
    for name in ("bblocks", "msrows", "jump_t", "text"):
        t = getattr(sh, name)
        for shard in t.shards:
            assert shard.shape[0] == t.shape[0] // 4, name
    assert sh.text_bound == jtp.nt == index.text_bound
    carried, _ = tp.from_jax(
        {k: np.asarray(v) for k, v in jtp.arrays._asdict().items()
         if v is not None},
        {**jtp.meta._asdict(), "n": int(jtp.arrays.n)}, 4,
        vars(jtp.host), t512=np.asarray(jtp.t512))
    for name in ("bblocks", "msrows", "jump_t", "text"):
        for a, b in zip(getattr(sh, name).shards,
                        getattr(carried, name).shards):
            assert torch.equal(a, b), name
    reads = [mutated_substring(rng, text, 300, err=0.05) for _ in range(6)]
    reads += [rand_dna(rng, 300) for _ in range(5)]
    reads.append(text[1000:1250])
    got = eng.query(reads)
    want = jtp.query(reads)
    repl = ScanEngine(index, table, mode="ms").query(reads)
    nat_p, nat_l = native.query_ms([bytes(r) for r in reads])[:2]
    for i in range(len(reads)):
        for out in (want, repl, {"pointers": nat_p, "lengths": nat_l}):
            assert np.array_equal(got["pointers"][i], out["pointers"][i]), i
            assert np.array_equal(got["lengths"][i], out["lengths"][i]), i


def test_tp_ms_doc_and_quirk_reads_need_no_fallback(rng):
    """MS + doc ids with jump_d in shards, and a read with bytes absent
    from the index: K16's plain version (the sequential carry) gives the
    native engine's lengths, which JAX gets from its CPU fallback."""
    text = rand_dna(rng, 5000)
    jtp, eng, _, native = _ms_setup(text, 4, make_tp_mesh(2, 4),
                                    use_doc=True,
                                    doc_lens=[2500, len(text) - 2500])
    reads = [mutated_substring(rng, text, 250, err=0.05) for _ in range(4)]
    reads.append(text[200:400] + b"NNN" + text[3000:3100])
    got = eng.query(reads)
    want = jtp.query(reads)
    nat_p, nat_l, nat_d = native.query_ms([bytes(r) for r in reads],
                                          with_docs=True)
    for i in range(len(reads)):
        for k, nat in (("pointers", nat_p), ("lengths", nat_l),
                       ("docs", nat_d)):
            assert np.array_equal(got[k][i], want[k][i]), (k, i)
            assert np.array_equal(got[k][i], nat[i]), (k, i)


def test_tp_ms_cli_reachable(tmp_path, rng):
    """`run -M --tp-devices 4` writes the JAX package's sharded run's files
    and the replicated run's, byte for byte."""
    base = dict(_write_fixture(tmp_path, rng, 15000, 5, 280, ms_index=True),
                ms_requested=True, write_report=True)
    exts = (".lengths", ".pointers", ".report")
    reads_path = base["pattern_file"]
    tpl.run(tpl.RunConfig(device="cpu", **base))
    repl = _files(reads_path, exts)
    jax_run(JaxRunConfig(tp_devices=4, **base))
    want = _files(reads_path, exts)
    tpl.run(tpl.RunConfig(device="cpu", tp_devices=4, **base))
    assert _files(reads_path, exts) == want == repl


#: ROADMAP section C's quirk: a byte past every index character
def _quirk_reads(text):
    return [text[100:160] + b"W" + text[200:260], text[300:500],
            b"W" + text[700:800] + b"WW"]


@pytest.mark.parametrize("engine", ["bits", "layered"])
def test_tp_quirk_read_pml_at_three_shards(engine):
    """The section C read at S = 3 (3,000-base index, seed 5): the port's
    sharded verdicts equal JAX's sharded classifier's."""
    text = np.random.default_rng(5).choice(
        np.frombuffer(b"ACGT", np.uint8), 3000).tobytes()
    jdense, tdense, _ = _dense(text)
    reads = _quirk_reads(text)
    want = _jax_classifier(jdense, engine, make_tp_mesh(1, 3)).classify(
        reads)
    _assert_same(_port_classifier(tdense, engine, 3).classify(reads, 150, 5),
                 want)


@pytest.mark.parametrize("n_text", [3000, 4095])
def test_tp_quirk_read_ms_at_three_shards(n_text):
    """The section C read in -M at S = 3: pointers and lengths equal JAX's
    TpMsQuery's. With n = 4,096 (a multiple of P = 64: the position n falls
    in the first pad row of the 22-row shards) the sharded pointers differ
    from the replicated engine's, in JAX as in the port."""
    text = np.random.default_rng(5).choice(
        np.frombuffer(b"ACGT", np.uint8), n_text).tobytes()
    jdense, tdense, native = _dense(text, ms=True)
    arrays, meta, host = jbb.build_blockbits(jdense, P=64, want_ms=True)

    class _NativeFallback:
        def query(self, reads):
            p, l = native.query_ms([bytes(r) for r in reads])[:2]
            return {"pointers": p, "lengths": l}

    jtp = TpMsQuery(arrays, meta, make_tp_mesh(1, 3), host,
                    fallback=_NativeFallback())
    index, table = tbb.build_blockbits(tdense, P=64, want_ms=True)
    eng = ScanEngine(tp.shard_blockbits_ms(index, 3), table, mode="ms")
    reads = _quirk_reads(text)
    got, want = eng.query(reads), jtp.query(reads)
    repl = ScanEngine(index, table, mode="ms").query(reads)
    jrepl = JaxScanEngine(arrays, meta, mode="ms", host=host).query(reads)
    for i in range(len(reads)):
        for k in ("pointers", "lengths"):
            assert np.array_equal(got[k][i], want[k][i]), (k, i)
            assert np.array_equal(repl[k][i], jrepl[k][i]), (k, i)
        assert np.array_equal(got["lengths"][i], repl["lengths"][i]), i
    same = all(np.array_equal(a, b) for a, b in zip(got["pointers"],
                                                   repl["pointers"]))
    assert same == (index.meta.n % index.meta.P != 0)
