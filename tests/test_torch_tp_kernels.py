"""The sharded-index kernel wrappers K13-K16 (`pml_classify_tp`,
`layered_classify_tp`, `ms_scan_tp`, `ms_extend_tp`) and the shard tables
of spumoni_tpu_torch/parallel/tp.py: CPU tensors take the plain versions,
anything else launches the CUDA kernel or raises, shards are checked, and on
a GPU each kernel equals its plain version and its unsharded twin (K2, K8,
K3, K4) exactly.

This file imports neither JAX nor tests/conftest.py fixtures at the top,
so it also runs on a machine with a GPU and no JAX:
    python -m pytest --noconftest tests/test_torch_tp_kernels.py
There the tests that hold K13's and K14's plain versions to the JAX
package skip: they need JAX and, past one shard, tests/conftest.py's
virtual CPU devices.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import spumoni_tpu_torch.pipeline as tpl
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.blockbits import build_blockbits, ranked_rows
from spumoni_tpu_torch.engine.layered import raw_rows, seeded_layered
from spumoni_tpu_torch.index import format as fmt
from spumoni_tpu_torch.native import build_raw_index
from spumoni_tpu_torch.parallel import tp

from test_torch_kernels import ACGT, needs_cuda


def _ms_index(seed, n, **kw):
    """A two-document MS + doc block-bits index of n seeded bases."""
    text = np.random.default_rng(seed).choice(ACGT, n)
    raw = build_raw_index(text)
    ds, de = fmt.build_doc_arrays(raw, [n // 2, n - n // 2])
    dense = fmt.build_dense_index(raw, text=text, with_samples=True,
                                  doc_start=ds, doc_end=de)
    index, table = build_blockbits(dense, want_ms=True, want_doc=True, **kw)
    return text, index, table


def _reads(text, seed, num=12, m=300):
    """Substrings, random reads, ROADMAP section C's read (a byte past every
    index character) and a read with bytes absent from the index."""
    rng = np.random.default_rng(seed)
    reads = [text[s:s + m].tobytes()
             for s in rng.integers(0, len(text) - m, num // 2)]
    reads += [rng.choice(ACGT, m).tobytes() for _ in range(num // 2)]
    return reads + [text[100:160].tobytes() + b"W" + text[200:260].tobytes(),
                    b"NNN" + text[400:600].tobytes()]


def test_sharded_table_reads_rows_from_their_shard():
    """Rows come from shard r // rows_per_shard; rows past the table are
    zero, and indexes outside the padded rows read 0 (JAX's owner-masked
    read and psum)."""
    table = torch.arange(30, dtype=torch.int32).reshape(10, 3)
    sh = tp.ShardedTable.from_rows(table, 4)
    assert sh.S == 4 and sh.rows_per_shard == 3 and tuple(sh.shape) == (12, 3)
    assert [t.shape[0] for t in sh.shards] == [3, 3, 3, 3]
    idx = torch.tensor([[0, 4], [9, 10], [11, 12], [-1, 5]])
    want = torch.cat([table, torch.zeros((3, 3), dtype=torch.int32)])
    got = sh[idx]
    assert torch.equal(got[:3], want[idx[:3].clamp(0, 12)])
    assert torch.equal(got[3, 0], torch.zeros(3, dtype=torch.int32))
    assert torch.equal(got[3, 1], table[5])
    assert torch.equal(torch.cat(sh.shards)[:10], table)


@pytest.mark.parametrize("S", [0, 17])
def test_shard_counts_out_of_range_raise(S):
    _, index, _ = _ms_index(1, 3000)
    with pytest.raises(ValueError, match="1 to 16"):
        tp.shard_blockbits_ms(index, S)


def test_cpu_tensors_take_the_plain_paths():
    """K13, K15 and K16 on CPU tensors equal their twins K2, K3 and K4 on
    the unsharded index (n % P != 0 here, so the padded clamp never
    differs), K14 equals K8, and no launch is counted."""
    text, index, table = _ms_index(2, 5000, P=64)
    assert index.meta.n % 64
    reads = _reads(text, 3)
    tab, rev, fwd, lens = ranked_rows(table, reads, 512)
    kernels.reset_launch_counts()
    for S in (1, 3, 4):
        sh = tp.shard_blockbits_ms(index, S)
        for a, b in zip(kernels.pml_classify_tp(sh, tab, rev, lens, 7, 150),
                        kernels.pml_classify(index, tab, rev, lens, 7, 150)):
            assert torch.equal(a, b), S
        for mode, doc in (("ms", False), ("ms", True), ("pml", True)):
            got = kernels.ms_scan_tp(sh, tab, rev, lens, mode, doc)
            want = kernels.ms_scan(index, tab, rev, lens, mode, doc)
            assert all(a is b is None or torch.equal(a, b)
                       for a, b in zip(got, want)), (S, mode, doc)
        ptrs = kernels.ms_scan_tp(sh, tab, rev, lens, "ms", False)[0]
        assert torch.equal(
            kernels.ms_extend_tp(sh.text, sh.text_bound, fwd, lens, ptrs),
            kernels.ms_extend(index.text, index.text_bound, fwd, lens, ptrs))
    ltext, lindex, _ = seeded_layered(4, 8000)
    lrev, _, llens = raw_rows(_reads(ltext, 5), 512)
    for S in (1, 3):
        for a, b in zip(
                kernels.layered_classify_tp(tp.shard_layered(lindex, S), lrev,
                                            llens, 7, 150),
                kernels.layered_classify(lindex, lrev, llens, 7, 150)):
            assert torch.equal(a, b), S
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize("wrapper", ["pml_classify_tp", "layered_classify_tp",
                                     "ms_scan_tp", "ms_extend_tp"])
def test_wrappers_raise_for_non_cpu_tensors(wrapper):
    """A tensor that is not on the CPU must launch the kernel or raise: the
    plain version never stands in for it."""
    text, index, table = _ms_index(6, 3000)
    sh = tp.shard_blockbits_ms(index, 3).to("meta")
    tab, rev, fwd, lens = (t.to("meta") for t in ranked_rows(
        table, _reads(text, 7, 4, 100), 256))
    _, lindex, _ = seeded_layered(8, 3000)
    lsh = tp.shard_layered(lindex, 3).to("meta")
    ptrs = torch.zeros(rev.shape, dtype=torch.int32, device="meta")
    kernels.reset_launch_counts()
    call = {
        "pml_classify_tp": lambda: kernels.pml_classify_tp(sh, tab, rev, lens,
                                                           7, 150),
        "layered_classify_tp": lambda: kernels.layered_classify_tp(
            lsh, rev, lens, 7, 150),
        "ms_scan_tp": lambda: kernels.ms_scan_tp(sh, tab, rev, lens, "ms",
                                                 True),
        "ms_extend_tp": lambda: kernels.ms_extend_tp(sh.text, sh.text_bound,
                                                     fwd, lens, ptrs),
    }[wrapper]
    with pytest.raises(ValueError, match="unsupported device"):
        call()
    assert getattr(kernels, wrapper).launches == 0


@pytest.mark.parametrize("bad", ["shard_device", "too_many_shards", "mode",
                                 "no_jump_d", "text_dtype", "bin_width",
                                 "misaligned_shard"])
def test_wrappers_check_their_shards(bad):
    text, index, table = _ms_index(9, 3000)
    sh = tp.shard_blockbits_ms(index, 3)
    tab, rev, fwd, lens = ranked_rows(table, _reads(text, 10, 4, 100), 256)
    with pytest.raises(ValueError) as err:
        if bad == "shard_device":      # one shard elsewhere than the reads
            sh.bblocks.shard1 = sh.bblocks.shard1.to("meta")
            kernels.pml_classify_tp(sh, tab, rev, lens, 7, 150)
        elif bad == "too_many_shards":   # more than a kernel takes
            # a config that passes every other check: -P -c --report-only
            tpl.RunConfig(ref_file="x", pattern_file=__file__,
                          pml_requested=True, write_report=True,
                          report_only=True, min_digest=False,
                          tp_devices=17).validate()
        elif bad == "mode":
            kernels.ms_scan_tp(sh, tab, rev, lens, "pml", False)
        elif bad == "no_jump_d":
            sh.jump_d = None
            kernels.ms_scan_tp(sh, tab, rev, lens, "ms", True)
        elif bad == "text_dtype":
            kernels.ms_extend_tp(sh.bblocks, sh.text_bound, fwd, lens,
                                 torch.zeros(rev.shape, dtype=torch.int32))
        elif bad == "bin_width":
            kernels.layered_classify_tp(
                tp.shard_layered(seeded_layered(11, 3000)[1], 3),
                rev, lens, 7, 0)
        else:  # K14 reads level and field rows as 16-byte vectors
            lsh = tp.shard_layered(seeded_layered(11, 3000)[1], 3)
            tables = kernels.layered_tp_tables(lsh)
            assert [label for label, _ in tables][-3:] == [
                f"fields shard {i}" for i in range(3)]
            kernels._check_aligned("layered_classify_tp", tables)
            t = lsh.fields.shard1
            lsh.fields.shard1 = torch.cat([t.new_zeros(1), t.flatten()])[
                1:].view(t.shape)
            assert lsh.fields.shard1.data_ptr() % 16
            kernels.reset_launch_counts()
            try:
                kernels._check_aligned("layered_classify_tp",
                                       kernels.layered_tp_tables(lsh))
            finally:
                assert kernels.layered_classify_tp.launches == 0
    if bad == "too_many_shards":
        assert "at most 16 shards" in str(err.value)


@pytest.mark.parametrize("S", [1, 3, 4])
def test_ms_scan_tp_on_the_edge_reads_equals_its_twin(S):
    """K15's plain version on K3 / K15's edge reads (the lengths around
    G = 8 and L, the read whose last step jumps, the terminator query,
    section C's read) equals K3's on the unsharded index in every mode."""
    text, index, table = _ms_index(12, 9000, P=64)
    assert index.meta.n % index.meta.P
    sh = tp.shard_blockbits_ms(index, S)
    tab, rev, _, lens = ranked_rows(table, kernels.ms_edge_reads(text, 1021),
                                    1021, "cpu")
    kernels.reset_launch_counts()
    for mode, doc in (("ms", False), ("ms", True), ("pml", True)):
        got = kernels.ms_scan_tp(sh, tab, rev, lens, mode, doc)
        want = kernels.ms_scan(index, tab, rev, lens, mode, doc)
        assert all(a is b is None or torch.equal(a, b)
                   for a, b in zip(got, want)), (S, mode, doc)
    assert kernels.ms_scan_tp.launches == 0


@pytest.mark.parametrize("S", [1, 3, 4])
def test_classify_tp_reference_on_the_edge_reads_equals_jax(S):
    """K13's plain version on S shards equals JAX's TpPmlClassifier on a
    1 x S mesh on K2 / K13's edge reads (kernels.classify_edge_reads: the
    terminator query, the bin-width corners, and section C's W read). n is
    a multiple of P, so at S = 4 the W read reaches position n in a pad
    row."""
    jax = pytest.importorskip("jax")
    cpus = jax.devices("cpu")
    if len(cpus) < S:
        pytest.skip(f"needs {S} JAX CPU devices (tests/conftest.py)")
    from spumoni_tpu.engine import blockbits as jbb
    from spumoni_tpu.parallel import tp as jtp
    from spumoni_tpu.index.format import build_dense_index
    from spumoni_tpu.native import build_raw_index as jraw

    text = np.random.default_rng(12).choice(ACGT, 9215)
    dense = build_dense_index(jraw(text))
    arrays, meta, host = jbb.build_blockbits(dense, P=512, pack=2)
    index, table = build_blockbits(dense, P=512, pack=2)
    assert index.meta.n % 512 == 0
    reads = kernels.classify_edge_reads(text, 1024)
    want = jtp.TpPmlClassifier(arrays, meta, jtp.make_tp_mesh(1, S, cpus),
                               bin_width=150, max_value_thr=7,
                               host=host).classify(reads)
    tab, rev, _, lens = ranked_rows(table, reads, 1024, "cpu")
    got = kernels.pml_classify_tp_reference(tp.shard_blockbits(index, S),
                                            tab, rev, lens, 7, 150)
    assert int(got[0].sum()) > 0
    for key, g in zip(("found", "above", "below", "sum_maxes"), got):
        assert np.array_equal(np.asarray(want[key]), g.numpy()), key


def _layered_pad_row_index():
    """(text, port layered index, JAX arrays / meta / host, native engine)
    of a 4,095-base DNA text (seed 12, no samples: W = 4), whose JAX
    field tables hold pad rows at S = 1, 3 and 4; the W read of
    kernels.classify_edge_reads leaves the BWT (position n), from where
    JAX's probe reads a pad row (start n, zeros) and the port's stops at
    the character's last run."""
    from spumoni_tpu.engine import layered as jlay
    from spumoni_tpu.index.format import build_dense_index
    from spumoni_tpu.native import build_raw_index as jraw
    from spumoni_tpu_torch.engine.layered import build_layered
    from spumoni_tpu_torch.native import NativeQueryEngine

    text = np.random.default_rng(12).choice(ACGT, 4095)
    dense = build_dense_index(jraw(text))
    raw = build_raw_index(text)
    tdense = fmt.build_dense_index(raw)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last)
    return (text, build_layered(tdense), *jlay.build_layered(dense), native)


@pytest.mark.parametrize("S", [1, 3, 4])
def test_layered_classify_tp_reference_on_the_edge_reads_equals_jax(S):
    """K14's plain version on S shards equals JAX's TpPmlClassifier on the
    layered arrays over a 1 x S mesh on kernels.classify_edge_reads (the
    bin-width corners), and on section C's W read, where JAX's probe
    reaches a pad row, the bin-max of the native engine's PML values."""
    jax = pytest.importorskip("jax")
    cpus = jax.devices("cpu")
    if len(cpus) < S:
        pytest.skip(f"needs {S} JAX CPU devices (tests/conftest.py)")
    from spumoni_tpu.parallel import tp as jtp

    from spumoni_tpu_torch.classify import binmax

    text, index, arrays, meta, host, native = _layered_pad_row_index()
    assert index.meta.width == 4
    reads = kernels.classify_edge_reads(text, 1024)
    w = len(kernels.ms_edge_reads(text, 1024)) - 1     # the W read
    assert b"W" in reads[w]
    want = jtp.TpPmlClassifier(arrays, meta, jtp.make_tp_mesh(1, S, cpus),
                               bin_width=150, max_value_thr=7,
                               host=host).classify(reads)
    verdict = binmax.classify(native.query_pml([reads[w]])[0], 150, 7)
    for key, v in (("found", verdict.status == "FOUND"),
                   ("above", verdict.bins_above),
                   ("below", verdict.bins_below),
                   ("sum_maxes", int(verdict.bin_maxes.sum()))):
        want[key] = np.array(want[key])
        want[key][w] = v
    rev, _, lens = raw_rows(reads, 1024)
    sh = tp.shard_layered(index, S)
    assert sh.fields.shape[0] == -(-(index.meta.r + 1) // S) * S
    got = kernels.layered_classify_tp_reference(sh, rev, lens, 7, 150)
    assert int(got[0].sum()) > 0
    for key, g in zip(("found", "above", "below", "sum_maxes"), got):
        assert np.array_equal(np.asarray(want[key]), g.numpy()), key


@pytest.mark.parametrize("S", [1, 3, 4])
def test_ms_extend_tp_reference_on_any_pointers(S):
    """K16's plain version over the text in S shards (tp.shard_text: whole
    512-byte rows, zero past the text) equals K4's on pointer matrices that
    are no MS pointers (kernels.seeded_extend), at int32 and int64."""
    for wide in (False, True):
        text, reads, lens, ptrs = (torch.from_numpy(a) for a in
                                   kernels.seeded_extend(40 + S, 64, wide))
        sh = tp.shard_text(text, S)
        assert sh.rows_per_shard % 512 == 0 and sh.shape[0] >= len(text)
        got = kernels.ms_extend_tp(sh, 4096, reads, lens, ptrs)
        assert torch.equal(got, kernels.ms_extend_reference(
            text, 4096, reads, lens, ptrs)), wide


def test_help_names_occ_and_the_sharded_index():
    """`run --help` lists occ as an engine and says what --tp-devices does:
    neither says "not in the port yet"."""
    out = subprocess.run([sys.executable, "-m", "spumoni_tpu_torch", "run",
                          "--help"], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    flat = " ".join(out.split())
    assert "occ is not in the port yet" not in flat
    tp_help = flat[flat.rindex("--tp-devices TP_DEVICES"):]
    tp_help = tp_help[:tp_help.rindex("--ks-report")]
    assert "not in the port yet" not in tp_help and "shards" in tp_help
    assert "occ (occ-block" in flat


# ---------------------------------------------------------------------------
# on the GPU: kernel == plain version == unsharded twin, exactly
# ---------------------------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("layout", [dict(P=64, pack=2, wide=False),
                                    dict(P=512, pack=2, wide=False),
                                    dict(P=256, pack=4, wide=True)],
                         ids=lambda d: "P{P}-pack{pack}-wide{wide}".format(**d))
def test_block_bits_tp_kernels_on_gpu(layout):
    text, index, table = _ms_index(12, 9000, **layout)
    assert index.meta.n % index.meta.P
    reads = _reads(text, 13, 40, 700)
    shards = {S: tp.shard_blockbits_ms(index, S).to("cuda") for S in (1, 3, 4)}
    index = index.to("cuda")
    tab, rev, fwd, lens = ranked_rows(table, reads, 1024, "cuda")
    kernels.reset_launch_counts()
    for S, sh in shards.items():
        got = kernels.pml_classify_tp(sh, tab, rev, lens, 7, 150)
        for want in (kernels.pml_classify_tp_reference(sh, tab, rev, lens, 7,
                                                       150),
                     kernels.pml_classify(index, tab, rev, lens, 7, 150)):
            assert all(torch.equal(a, b) for a, b in zip(got, want)), S
        for mode, doc in (("ms", False), ("ms", True), ("pml", True)):
            got = kernels.ms_scan_tp(sh, tab, rev, lens, mode, doc)
            for want in (kernels.ms_scan_tp_reference(sh, tab, rev, lens,
                                                      mode, doc),
                         kernels.ms_scan(index, tab, rev, lens, mode, doc)):
                assert all(a is b is None or torch.equal(a, b)
                           for a, b in zip(got, want)), (S, mode, doc)
        ptrs = kernels.ms_scan_tp(sh, tab, rev, lens, "ms", False)[0]
        got = kernels.ms_extend_tp(sh.text, sh.text_bound, fwd, lens, ptrs)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.ms_extend_tp_reference(
            sh.text, sh.text_bound, fwd, lens, ptrs))
        assert torch.equal(got, kernels.ms_extend(index.text, index.text_bound,
                                                  fwd, lens, ptrs))
    assert (kernels.pml_classify_tp.launches, kernels.ms_scan_tp.launches,
            kernels.ms_extend_tp.launches) == (3, 12, 3)
    # K15 on the edge reads (lengths around G = 8), at L = 1,024 and 1,021
    for L in (1024, 1021):
        tab, rev, _, lens = ranked_rows(table, kernels.ms_edge_reads(text, L),
                                        L, "cuda")
        for mode, doc in (("ms", False), ("ms", True), ("pml", True)):
            sh = shards[4]
            got = kernels.ms_scan_tp(sh, tab, rev, lens, mode, doc)
            torch.cuda.synchronize()
            for w in (kernels.ms_scan_tp_reference(sh, tab, rev, lens, mode,
                                                   doc),
                      kernels.ms_scan(index, tab, rev, lens, mode, doc)):
                assert all(a is b is None or torch.equal(a, b)
                           for a, b in zip(got, w)), (L, mode, doc)


@needs_cuda
@pytest.mark.parametrize("S", [1, 3, 4])
def test_pml_classify_tp_on_the_edge_reads_on_gpu(S):
    """K13 on S shards equals its plain version on K2 / K13's edge reads
    (kernels.classify_edge_reads) at L = 1,024 and 1,021, on the main
    path's layout and on a 4-bit wide one; n is a multiple of P, so at S =
    4 the W read reaches a pad row."""
    kernels.reset_launch_counts()
    for layout in (dict(P=512, pack=2, wide=False),
                   dict(P=256, pack=4, wide=True)):
        text, index, table = _ms_index(12, 9215, **layout)
        assert index.meta.n % index.meta.P == 0
        sh = tp.shard_blockbits(index, S).to("cuda")
        for L in (1024, 1021):
            tab, rev, _, lens = ranked_rows(
                table, kernels.classify_edge_reads(text, L), L, "cuda")
            want = kernels.pml_classify_tp_reference(sh, tab, rev, lens, 7,
                                                     150)
            got = kernels.pml_classify_tp(sh, tab, rev, lens, 7, 150)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                (layout, L)
    assert kernels.pml_classify_tp.launches == 4


@needs_cuda
def test_layered_tp_kernel_on_gpu():
    text, index, _ = seeded_layered(14, 20000, docs=True)
    rev, _, lens = raw_rows(_reads(text, 15, 40, 700), 1024, "cuda")
    shards = {S: tp.shard_layered(index, S).to("cuda") for S in (1, 3, 4)}
    index = index.to("cuda")
    kernels.reset_launch_counts()
    for S, sh in shards.items():
        got = kernels.layered_classify_tp(sh, rev, lens, 7, 150)
        torch.cuda.synchronize()
        for want in (kernels.layered_classify_tp_reference(sh, rev, lens, 7,
                                                           150),
                     kernels.layered_classify(index, rev, lens, 7, 150)):
            assert all(torch.equal(a, b) for a, b in zip(got, want)), S
    assert kernels.layered_classify_tp.launches == 3


@needs_cuda
@pytest.mark.parametrize("S", [1, 3, 4])
def test_layered_classify_tp_on_the_edge_reads_on_gpu(S):
    """K14 on S shards equals its plain version and its twin K8 on
    kernels.classify_edge_reads at L = 1,024 and 1,021, at int32 and int64
    positions and field widths 4 and 8: on a 4,095-base index whose W read
    probes a pad row, and on a two-document one with samples."""
    from spumoni_tpu_torch.engine.layered import build_layered

    text = np.random.default_rng(12).choice(ACGT, 4095)
    dense = fmt.build_dense_index(build_raw_index(text))
    cases = [(text, build_layered(dense, dtype=dt)) for dt in (np.int32,
                                                                np.int64)]
    for dt in (np.int32, np.int64):
        dtext, dindex, _ = seeded_layered(16, 9000, docs=True, dtype=dt)
        cases.append((dtext, dindex))
    kernels.reset_launch_counts()
    for text, index in cases:
        sh = tp.shard_layered(index, S).to("cuda")
        index = index.to("cuda")
        for L in (1024, 1021):
            rev, _, lens = raw_rows(kernels.classify_edge_reads(text, L), L,
                                    "cuda")
            got = kernels.layered_classify_tp(sh, rev, lens, 7, 150)
            torch.cuda.synchronize()
            for want in (kernels.layered_classify_tp_reference(sh, rev, lens,
                                                               7, 150),
                         kernels.layered_classify(index, rev, lens, 7, 150)):
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                    index.meta.width, index.meta.wide, L)
    assert kernels.layered_classify_tp.launches == 8


@needs_cuda
@pytest.mark.parametrize("S", [1, 3, 4])
@pytest.mark.parametrize("wide", [False, True])
def test_ms_extend_tp_on_any_pointers_on_gpu(S, wide):
    """K16 equals K4 and its plain version on pointer matrices that are no
    MS pointers (kernels.seeded_extend), at L = 64 and 1,021."""
    for L in (64, 1021):
        text, reads, lens, ptrs = (torch.from_numpy(a) for a in
                                   kernels.seeded_extend(11 + L, L, wide))
        sh = tp.shard_text(text, S)
        want = kernels.ms_extend_tp_reference(sh, 4096, reads, lens, ptrs)
        kernels.reset_launch_counts()
        args = (reads.cuda(), lens.cuda(), ptrs.cuda())
        got = kernels.ms_extend_tp(sh.to("cuda"), 4096, *args)
        twin = kernels.ms_extend(text.cuda(), 4096, *args)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), L
        assert torch.equal(got, twin), L
        assert kernels.ms_extend_tp.launches == 1
