"""One process on several devices: the data-parallel engine
(ScanEngine.to_devices), the sharded index across devices, the automatic
shard count, and the guard every kernel launch runs under.

The data-parallel engine runs here on repeated CPU devices ([cpu, cpu] and
[cpu, cpu, cpu], as the JAX package's tests run its mesh on virtual CPU
devices), with lane counts that no device count divides, and is held to the
single-device port engine and to the JAX engine made data-parallel by
`to_mesh(make_data_mesh(jax.devices()[:k]))` on the same reads (JAX on its
CPU backend). Integers equal exactly (tolerance 0); inputs come from numpy
seeds."""

import ast
import os
import threading
import types

import jax
import numpy as np
import pytest
import torch

from spumoni_tpu.engine import blockbits as jbb
from spumoni_tpu.engine import layered as jl
from spumoni_tpu.engine import occblock as jo
from spumoni_tpu.engine.scan_engine import ScanEngine as JaxScanEngine
from spumoni_tpu.index.format import build_dense_index, build_doc_arrays
from spumoni_tpu.native import build_raw_index
from spumoni_tpu.parallel.mesh import make_data_mesh
from spumoni_tpu.pipeline import RunConfig as JaxRunConfig
from spumoni_tpu.pipeline import _tp_decision as jax_tp_decision

import spumoni_tpu_torch.pipeline as tpl
from spumoni_tpu_torch.engine import blockbits as tbb
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine import layered as tl
from spumoni_tpu_torch.engine import occblock as to
from spumoni_tpu_torch.engine import scan_engine
from spumoni_tpu_torch.engine.scan_engine import ScanEngine
from spumoni_tpu_torch.parallel import tp

from test_torch_ms import _packed_reads
from test_torch_tp import _files, _write_fixture

ACGTN = np.frombuffer(b"ACGTN", np.uint8)
CPU = torch.device("cpu")
_MODES = [("pml", False), ("pml", True), ("ms", False), ("ms", True)]
KERNELS_PY = os.path.join(os.path.dirname(kernels.__file__), "kernels.py")


@pytest.fixture(scope="module")
def dense_index():
    """(text, a two-document DenseIndex with SA samples, doc ids and text);
    the text holds N at 2%."""
    rng = np.random.default_rng(151)
    text = rng.choice(ACGTN, 6000, p=[0.245] * 4 + [0.02])
    raw = build_raw_index(text)
    ds, de = build_doc_arrays(raw, [3000, 3000])
    return text, build_dense_index(raw, text=text, with_samples=True,
                                   doc_start=ds, doc_end=de)


def _reads(text):
    """14 reads in two buckets: 13 of 130-250 bases (the 256 bucket: 13
    lanes, which neither 2 nor 3 devices divide) and one of 100 (fewer
    lanes than devices); mutated substrings and random reads, some with N
    and with bytes absent from the index (2-bit exceptions spread over
    every slice)."""
    rng = np.random.default_rng(152)
    lengths = [int(m) for m in rng.integers(130, 251, 13)] + [100]
    reads = []
    for i, m in enumerate(lengths):
        if i % 4 == 3:
            rd = rng.choice(ACGTN[:4], m)
        else:
            st = int(rng.integers(0, len(text) - m))
            rd = text[st:st + m].copy()
            mut = rng.random(m) < 0.08
            rd[mut] = rng.choice(ACGTN, size=int(mut.sum()))
        if i % 5 == 1:
            rd[m // 2] = ord("X")
        reads.append(rd.tobytes())
    return reads


def _build(kind, dense):
    """(port index, CharTable or None, JAX (arrays, meta, host)) of one
    engine kind, with every table the modes read."""
    if kind == "bits":
        index, table = tbb.build_blockbits(dense, want_ms=True, want_doc=True)
        return index, table, jbb.build_blockbits(dense, want_ms=True,
                                                 want_doc=True)
    if kind == "layered":
        return tl.build_layered(dense), None, jl.build_layered(dense)
    index, table = to.build_occblock(dense, P=128)
    return index, table, jo.build_occblock(dense, P=128)


def _same(got, want, label, keep=None):
    """Equal outputs, read by read; with `keep`, only those reads'."""
    assert set(got) == set(want), label
    for key in want:
        if isinstance(want[key], list):
            assert len(got[key]) == len(want[key]), (label, key)
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                if keep is None or i in keep:
                    assert np.array_equal(g, w), (label, key, i)
        else:
            sel = slice(None) if keep is None else keep
            assert np.array_equal(got[key][sel], want[key][sel]), (label,
                                                                    key)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("kind", ["bits", "layered", "occ"])
def test_to_devices_matches_one_device_and_the_jax_mesh(dense_index, kind,
                                                        k):
    """query_staged (PML, PML + doc, MS, MS + doc) and classify_staged
    (PML, MS) on k repeated CPU devices equal the single-device engine's,
    read by read, and at k = 3 the JAX engine's on a 3-device data mesh
    too (whose compiles take most of this file's time); on the layered
    engine only on the reads without an X, which sorts after every index
    character: there the port follows SPUMONI's query loop and JAX's
    layered step does not (ROADMAP section C)."""
    text, dense = dense_index
    index, table, (arrays, meta, host) = _build(kind, dense)
    reads = _reads(text)
    keep = None
    if kind == "layered":
        keep = [i for i, rd in enumerate(reads) if b"X" not in rd]
        assert 0 < len(keep) < len(reads)
    packed = _packed_reads(reads)
    mesh = make_data_mesh(jax.devices()[:k])

    def jax_engine(**kw):
        return JaxScanEngine(arrays, meta, host=host, **kw).to_mesh(mesh)

    for mode, use_doc in _MODES:
        label = (kind, k, mode, use_doc)
        one = ScanEngine(index, table, mode=mode, use_doc=use_doc)
        many = ScanEngine(index, table, mode=mode,
                          use_doc=use_doc).to_devices([CPU] * k)
        want = one.query(reads)
        _same(many.query(reads), want, label)
        if k == 3:
            jeng = jax_engine(mode=mode, use_doc=use_doc)
            _same(want, jeng.query_staged(jeng.stage(packed)), label, keep)
        if not use_doc:
            want = one.classify(reads, 150, 9)
            _same(many.classify(reads, 150, 9), want, label)
            if k == 3:
                jcls = jax_engine(mode=mode)
                _same(want, jcls.classify_staged(jcls.stage(packed), 150, 9),
                      label, keep)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_stage_cuts_each_group_into_contiguous_parts(dense_index, k):
    """stage on k devices cuts each group's lanes into contiguous slices in
    order, one a device (none where a group has fewer lanes), each part's
    rows, lengths and exceptions those of its lanes in the one-device
    group; every part of a group shares its id."""
    text, dense = dense_index
    index, table = tbb.build_blockbits(dense, want_ms=True, want_doc=True)
    packed = _packed_reads(_reads(text))
    eng = ScanEngine(index, table, mode="ms")
    one = eng.stage(packed)
    parts = ScanEngine(index, table, mode="ms").to_devices(
        [CPU] * k).stage(packed)
    assert all(g["replica"] == 0 for g in one)
    for g in one:
        mine = [p for p in parts if p["L"] == g["L"]]
        assert len({p["group"] for p in mine}) == 1
        replicas = [p["replica"] for p in mine]
        assert replicas == sorted(set(replicas)) and replicas[-1] < k
        assert len(mine) == min(k, len(g["idxs"]))
        assert np.array_equal(np.concatenate([p["idxs"] for p in mine]),
                              g["idxs"])
        sizes = [len(p["idxs"]) for p in mine]
        assert max(sizes) - min(sizes) <= 1
        lo = 0
        for p in mine:
            hi = lo + len(p["idxs"])
            for key in ("rev_p", "fwd_p", "lens_d"):
                assert torch.equal(p[key], g[key][lo:hi]), (key, k)
            assert torch.equal(eng._rev_d(g)[lo:hi], eng._rev_d(p))
            assert torch.equal(eng._fwd_d(g)[lo:hi], eng._fwd_d(p))
            lo = hi
    assert any(g["exc_d"] is not None and len(g["idxs"]) > k for g in one)


def test_exception_rows_follow_their_slice():
    exc = np.array([[0, 5, 78], [3, 1, 88], [4, 0, 78], [6, 2, 78]],
                   np.int32)
    assert scan_engine._exc_rows(exc, 0, 7, 7) is exc
    assert scan_engine._exc_rows(exc, 3, 5, 7).tolist() == [[0, 1, 88],
                                                            [1, 0, 78]]
    assert scan_engine._exc_rows(exc, 1, 3, 7) is None
    assert scan_engine._exc_rows(None, 1, 3, 7) is None
    assert scan_engine._slices(5, 3) == [(0, 1), (1, 3), (3, 5)]
    assert scan_engine._slices(1, 3) == [(0, 0), (0, 0), (0, 1)]


def test_index_copies_leave_the_original(dense_index):
    """to_devices copies the index to each other device and never moves the
    engine's own (nn.Module.to would, in place)."""
    _, dense = dense_index
    index = tl.build_layered(dense)
    before = [t.data_ptr() for t in index.buffers()]
    copy = scan_engine._index_on(index, torch.device("meta"))
    assert all(t.device.type == "meta" for t in copy.buffers())
    assert [t.data_ptr() for t in index.buffers()] == before
    assert all(t.device == CPU for t in index.buffers())
    eng = ScanEngine(index).to_devices([CPU, CPU])
    assert eng._indexes[0] is eng._indexes[1] is index


# ---------------------------------------------------------------------------
# run() on several devices: data parallel, the sharded index across them
# ---------------------------------------------------------------------------

@pytest.fixture
def fixture_run(tmp_path, rng):
    return _write_fixture(tmp_path, rng, 20000, 6, 300, pml_index=True,
                          ms_index=True)


@pytest.mark.parametrize("ndev,S", [(3, 0), (2, 2), (4, 2), (4, 4)])
def test_run_on_several_devices_writes_the_one_device_files(
        fixture_run, monkeypatch, ndev, S):
    """run() with ndev devices (repeated CPUs standing in for the cards),
    data parallel (S = 0) or with S shards placed on each group of S
    devices, writes the one-device run's files (report-only PML, MS values
    and report)."""
    reads_path = fixture_run["pattern_file"]
    runs = ((dict(pml_requested=True, write_report=True, report_only=True),
             (".report",)),
            (dict(ms_requested=True, write_report=True),
             (".report", ".lengths", ".pointers")))
    for kw, exts in runs:
        tpl.run(tpl.RunConfig(device="cpu", **fixture_run, **kw))
        want = _files(reads_path, exts)
        with monkeypatch.context() as m:
            m.setattr(tpl, "select_devices", lambda name: [CPU] * ndev)
            tpl.run(tpl.RunConfig(device="cpu", tp_devices=S, **fixture_run,
                                  **kw))
        assert _files(reads_path, exts) == want, kw


def test_shards_must_divide_the_devices(fixture_run, monkeypatch):
    """With more than one device the shard count divides the device count
    (the JAX package's message); with one, every shard sits on it."""
    monkeypatch.setattr(tpl, "select_devices", lambda name: [CPU] * 3)
    with pytest.raises(ValueError, match="does not divide the 3 available"):
        tpl.run(tpl.RunConfig(device="cpu", tp_devices=2, ms_requested=True,
                              **fixture_run))
    with pytest.raises(ValueError, match="does not divide the 3 available"):
        tpl.run(tpl.RunConfig(device="cpu", tp_devices=4, pml_requested=True,
                              write_report=True, report_only=True,
                              **fixture_run))
    monkeypatch.setattr(tpl, "select_devices", lambda name: [CPU])
    assert tpl.run(tpl.RunConfig(device="cpu", tp_devices=3,
                                 ms_requested=True, **fixture_run)) == 13


def test_place_shards(dense_index):
    """place_shards puts shard i on devices[i % len(devices)] and the
    unsharded layered tables on devices[0]."""
    _, dense = dense_index
    meta = torch.device("meta")
    index, _ = tbb.build_blockbits(dense, want_ms=True, want_doc=True)
    sh = tp.place_shards(tp.shard_blockbits_ms(index, 4), [CPU, meta])
    for table in (sh.bblocks, sh.msrows, sh.jump_t, sh.jump_d, sh.text):
        assert [t.device.type for t in table.shards] == ["cpu", "meta"] * 2
    lay = tp.place_shards(tp.shard_layered(tl.build_layered(dense), 2),
                          [meta, CPU])
    assert lay.charmeta.device == meta
    assert all(lv.device == meta for lv in lay.levels)
    assert [t.device.type for t in lay.fields.shards] == ["meta", "cpu"]


def test_a_sharded_text_past_k16s_limit_is_refused(monkeypatch):
    """A text whose shards would hold 2^36 bytes or more is refused before
    anything is built, naming the limit."""
    class Text:
        def __len__(self):
            return (1 << 36) - 600

    dense = types.SimpleNamespace(has_samples=True, r=10, text=Text())
    monkeypatch.setattr(tpl, "eligible_any", lambda d: True)
    monkeypatch.setattr(tpl, "build_blockbits", None)   # never reached
    with pytest.raises(ValueError, match=r"2\^36"):
        tpl._sharded_index(dense, 4, "x", "ms", False, "auto")
    assert tp.sharded_text_bytes((1 << 36) - 1024, 2) == tp.MAX_SHARDED_TEXT
    assert tp.sharded_text_bytes((1 << 36) - 2048, 2) < tp.MAX_SHARDED_TEXT


# ---------------------------------------------------------------------------
# the automatic shard count
# ---------------------------------------------------------------------------

#: budgets (GB) from above every estimate down to below a sixteenth of it
_BUDGETS = ("1", "5e-5", "2e-5", "1e-5", "5e-6", "2e-6", "5e-7")
_TP_CASES = [
    dict(pml_requested=True, report_only=True, write_report=True),
    dict(pml_requested=True, report_only=True, write_report=True,
         engine="layered"),
    dict(ms_requested=True),
    dict(ms_requested=True, use_doc=True),
    dict(pml_requested=True),                   # no sharded path: 1
    dict(ms_requested=True, tp_devices=-1),     # explicitly off: 1
]


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_tp_decision_sizes_as_jax(dense_index, monkeypatch, ndev):
    """_tp_decision against the JAX package's under SPN_HBM_BUDGET_GB and
    ndev devices (JAX's device list cut to ndev of conftest's 8), in every
    mode the sharded path serves and two it does not."""
    _, dense = dense_index
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:ndev])
    seen = set()
    for budget in _BUDGETS:
        monkeypatch.setenv("SPN_HBM_BUDGET_GB", budget)
        for kw in _TP_CASES:
            cfg = JaxRunConfig(ref_file="x", pattern_file="y",
                               min_digest=False, device="tpu", **kw)
            want = jax_tp_decision(cfg, dense)
            got = tpl._tp_decision(
                dense, mode=cfg.mode, use_doc=cfg.use_doc,
                report_only=cfg.report_only, tp_devices=cfg.tp_devices,
                engine=cfg.engine, ndev=ndev)
            assert got == want, (budget, kw)
            seen.add(got)
    assert seen == {1, 2, 4, 8} & set(range(1, ndev + 1))


def test_tp_decision_on_the_cpu_and_one_card(dense_index, monkeypatch):
    """--device cpu and one card give 1 under any budget, as in the JAX
    package; the explicit count stands."""
    _, dense = dense_index
    monkeypatch.setenv("SPN_HBM_BUDGET_GB", "1e-9")
    kw = dict(mode="ms", use_doc=False, report_only=False, engine="auto")
    assert tpl._tp_decision(dense, tp_devices=0, ndev=1, **kw) == 1
    assert tpl._tp_decision(dense, tp_devices=4, ndev=1, **kw) == 4
    assert tpl._tp_decision(dense, tp_devices=0, ndev=8, **kw) == 8


# ---------------------------------------------------------------------------
# the launch guard
# ---------------------------------------------------------------------------

def _functions(tree):
    return {node.name: node for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef)}


def test_every_entry_point_is_called_through_the_guard():
    """In engine/kernels.py the entry points of LIBRARIES are called in one
    place, `_call` (under torch.cuda.device), every kernel through
    `_launch` (dev's current stream, the count in the wrapper it is
    given), each `spn_*` name of _SIGNATURES launched by a wrapper or,
    for peer access, called by enable_peer_access, and no `spn_*`
    attribute is read anywhere."""
    with open(KERNELS_PY) as f:
        tree = ast.parse(f.read())
    fns = _functions(tree)

    def owner(target):
        return {name for name, fn in fns.items()
                if any(target(node) for node in ast.walk(fn))}

    calls_library = owner(lambda n: isinstance(n, ast.Call)
                          and isinstance(n.func, ast.Name)
                          and n.func.id == "library")
    assert calls_library == {"_call"}
    assert owner(lambda n: isinstance(n, ast.Attribute)
                 and n.attr == "cuda_stream") == {"_launch"}
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                and n.attr.startswith("spn_")]
    guard = fns["_call"]
    assert any(isinstance(n, ast.With) and "torch.cuda.device" in
               ast.unparse(n.items[0].context_expr)
               for n in ast.walk(guard))
    assert owner(lambda n: isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name)
                 and n.func.id == "_call") == {"_launch",
                                               "enable_peer_access"}
    launched, called, counted = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("_launch", "_call"):
            pos = 2
            arg = node.args[pos] if len(node.args) > pos else None
            if isinstance(arg, ast.Constant):
                (launched if node.func.id == "_launch" else
                 called).add(arg.value)
            if node.func.id == "_launch" and node.args:
                counted.add(ast.unparse(node.args[0]))
    entries = {e for sigs in kernels._SIGNATURES.values() for e in sigs}
    assert called == {"spn_enable_peer_access"}
    assert launched == entries - called
    wrappers = {fn.__name__ for fn in kernels._WRAPPERS}
    assert {e[len("spn_"):] for e in launched} == wrappers
    # each launch counts in the wrapper it names, passed explicitly
    assert counted == wrappers


class _FakeDevice:
    """Stands in for torch.cuda.device: records the current device."""
    current = threading.local()

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        self.prev = getattr(self.current, "dev", None)
        self.current.dev = self.dev

    def __exit__(self, *exc):
        self.current.dev = self.prev


def test_launch_sets_the_device_and_counts_under_threads(monkeypatch):
    """_launch runs the entry point with the launch's device current and
    that device's stream last (switching only where another device is
    current), raises on a nonzero return, and counts every launch in the
    wrapper it is given when 8 threads launch at once."""
    seen = []

    class Lib:
        def spn_unpack2(self, *args):
            seen.append((_FakeDevice.current.dev, args))
            return 0

        def spn_unpack4(self, *args):
            return 7

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device", _FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: (
        types.SimpleNamespace(cuda_stream=1000 + dev.index)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    kernels.reset_launch_counts()
    cuda1 = torch.device("cuda", 1)
    kernels._launch(kernels.unpack2, "staging", "spn_unpack2", cuda1, 5, 6)
    assert seen == [(cuda1, (5, 6, 1001))]
    assert getattr(_FakeDevice.current, "dev", None) is None
    # cuda:0 is current: no switch
    kernels._launch(kernels.unpack2, "staging", "spn_unpack2",
                    torch.device("cuda", 0), 7)
    assert seen[1] == (None, (7, 1000))
    with pytest.raises(RuntimeError, match="unpack4: CUDA launch failed"):
        kernels._launch(kernels.unpack4, "staging", "spn_unpack4", cuda1)
    assert kernels.unpack4.launches == 0
    del seen[1]

    def launches():
        for _ in range(500):
            kernels._launch(kernels.unpack2, "staging", "spn_unpack2",
                            torch.device("cuda", 3))

    threads = [threading.Thread(target=launches) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernels.launch_counts()["unpack2"] == 4002
    assert {d for d, _ in seen[1:]} == {torch.device("cuda", 3)}
    kernels.reset_launch_counts()


def test_peer_access(monkeypatch):
    """enable_peer_access asks every ordered pair of cards once and raises
    where one has no peer access; _check_shards takes a shard on a peer
    only after that."""
    calls = []
    monkeypatch.setattr(kernels, "_peers", set())
    monkeypatch.setattr(kernels, "_call", lambda dev, lib, entry, *a: (
        calls.append((dev.index, entry, a)) or 0))
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: (a, b) != (2, 0))
    c = [torch.device("cuda", i) for i in range(3)]
    shard = types.SimpleNamespace(device=c[1], is_contiguous=lambda: True)
    table = types.SimpleNamespace(shards=[shard])
    with pytest.raises(ValueError, match="no peer access"):
        kernels._check_shards("k", [("rows", table)], c[0])
    kernels.enable_peer_access([c[0], c[1], CPU])
    assert sorted(calls) == [(0, "spn_enable_peer_access", (1,)),
                             (1, "spn_enable_peer_access", (0,))]
    kernels._check_shards("k", [("rows", table)], c[0])
    kernels.enable_peer_access(c[:2])
    assert len(calls) == 2                      # granted once
    with pytest.raises(RuntimeError, match="cuda:2 cannot read cuda:0"):
        kernels.enable_peer_access(c)
    with pytest.raises(ValueError, match="reads on cuda:2"):
        kernels._check_shards("k", [("rows", table)], c[2])
