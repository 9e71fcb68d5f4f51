"""Multi-host runs of the port (parallel/distributed.py on torch.distributed
with gloo): host-stride read sharding, per-host shard files and cursors,
process 0's merge, the KS rand() stream under a stride and --resume, and a
real two-process gloo run. Every merged file is held byte for byte to the
port's single-process run and to the JAX package's merged file on the same
inputs (JAX on its CPU backend, device 'tpu': the staged path, as the JAX
package's tests run it). A 2-host run is simulated file by file in one
process as the JAX package's tests do: host 1, then host 0, which merges."""

import json
import os
import socket
import subprocess
import sys

import pytest

from spumoni_tpu.parallel import distributed as jdist
from spumoni_tpu.pipeline import BuildConfig, RunConfig as JaxRunConfig
from spumoni_tpu.pipeline import build, run as jax_run

import spumoni_tpu_torch.pipeline as tpl
from spumoni_tpu_torch.parallel import distributed as dist

from test_pipeline import _write_genome, _write_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OUT = (".pseudo_lengths", ".lengths", ".pointers", ".doc_numbers",
        ".report")


def _build_index(tmp_path, rng, ms=False):
    """A 15,000-base index (-P, or -M -P -d over two documents) and 10
    reads (5 mutated substrings, 5 random); returns the run arguments."""
    seqs = _write_genome(str(tmp_path / "genome.fa"), rng,
                         contigs=(("chr1", 15000),))
    reads_path = str(tmp_path / "reads.fa")
    _write_reads(reads_path, rng, "".join(seqs.values()), n_pos=5, n_neg=5,
                 m=300)
    if ms:
        docs = []
        for i, half in enumerate((seqs["chr1"][:7500], seqs["chr1"][7500:])):
            docs.append(str(tmp_path / f"doc{i}.fa"))
            with open(docs[-1], "w") as f:
                f.write(f">doc{i}\n{half}\n")
        with open(tmp_path / "docs.txt", "w") as f:
            f.write("".join(f"{d} {i + 1}\n" for i, d in enumerate(docs)))
        build(BuildConfig(input_list=str(tmp_path / "docs.txt"),
                          output_prefix=str(tmp_path / "idx"), ms_index=True,
                          pml_index=True, build_doc=True,
                          use_minimizers=False))
    else:
        build(BuildConfig(ref_file=str(tmp_path / "genome.fa"),
                          output_prefix=str(tmp_path / "idx"),
                          pml_index=True, use_minimizers=False))
    return dict(ref_file=str(tmp_path / "idx"), pattern_file=reads_path,
                min_digest=False)


def _take(prefix, exts=_OUT):
    """{ext: bytes} of the output files prefix + ext, which are removed."""
    out = {}
    for ext in exts:
        if os.path.exists(prefix + ext):
            with open(prefix + ext, "rb") as f:
                out[ext] = f.read()
            os.remove(prefix + ext)
    return out


def _hosts(run, cfg, base, P, **kw):
    """Hosts P-1 .. 0 of a P-host run, one after another (host 0 last: it
    merges); returns host 0's count."""
    n = None
    for p in reversed(range(P)):
        n = run(cfg(process_index=p, process_count=P, **base, **kw))
    return n


def _port(**kw):
    return tpl.RunConfig(device="cpu", **kw)


def _jax(**kw):
    return JaxRunConfig(device="tpu", **kw)


def test_host_shard_reads():
    items = list(dist.host_shard_reads(iter("abcdefg"), 1, 3))
    assert items == [(1, "b"), (4, "e")]
    assert list(dist.host_shard_reads(iter("ab"), 0, 1)) == [(0, "a"),
                                                            (1, "b")]
    assert dist.shard_path("x.report", 1, 2) == \
        jdist.shard_path("x.report", 1, 2) == "x.report.shard0001"
    assert dist.shard_path("x.report", 0, 1) == "x.report"


def test_initialize_without_a_process_group(monkeypatch):
    """No environment: one process, no process group, identity counts;
    P > 1 without a coordinator or an id raises (a second process would
    otherwise write the whole file beside the first)."""
    for var in ("SPUMONI_COORDINATOR", "SPUMONI_NUM_PROCESSES",
                "SPUMONI_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert dist.initialize() == (0, 1)
    assert dist.global_found_counts(3, 7) == (3, 7)
    dist.finalize()
    monkeypatch.setenv("SPUMONI_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="SPUMONI_COORDINATOR"):
        dist.initialize()
    monkeypatch.setenv("SPUMONI_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SPUMONI_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="not in"):
        dist.initialize()


_MODES = {
    "pml-report": dict(pml_requested=True, write_report=True),
    "pml-report-only": dict(pml_requested=True, write_report=True,
                            report_only=True),
    "ms-doc-report": dict(ms_requested=True, write_report=True,
                          use_doc=True),
    "pml-doc": dict(pml_requested=True, use_doc=True),
}


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_hosts_merge_to_the_single_process_files(tmp_path, rng, mode, P):
    """P simulated hosts write shard files that process 0 merges into the
    port's single-process files and the JAX package's merged files, byte
    for byte; without a process group a host counts its own records (host
    0: ceil(10 / P)); no shard or cursor file is left."""
    base = _build_index(tmp_path, rng, ms=mode.startswith("ms")
                        or "doc" in mode)
    kw = _MODES[mode]
    prefix = base["pattern_file"]
    assert tpl.run(_port(**base, **kw)) == 10
    single = _take(prefix)
    assert single
    assert _hosts(jax_run, _jax, base, P, **kw) == -(-10 // P)
    want = _take(prefix)
    assert _hosts(tpl.run, _port, base, P, **kw) == -(-10 // P)
    assert _take(prefix) == want == single
    assert not [f for f in os.listdir(tmp_path) if ".shard" in f
                or f.endswith(".cursor")]


def test_two_host_ks_report_header(tmp_path, rng):
    """A 2-host --ks-report run merges with the KS header (not the bin-max
    one) and the rand() draws of the other host's reads skipped: the files
    equal the single-process run's."""
    base = dict(_build_index(tmp_path, rng), pml_requested=True,
                write_report=True, ks_report=True)
    prefix = base["pattern_file"]
    tpl.run(_port(**base))
    single = _take(prefix)
    assert b"avg ks-stat" in single[".report"].splitlines()[0]
    _hosts(jax_run, _jax, base, 2)
    want = _take(prefix)
    _hosts(tpl.run, _port, base, 2)
    assert _take(prefix) == want == single


def test_two_host_general_text(tmp_path, rng):
    """General text (-g) under a 2-host stride merges to the single-process
    files (-P and -M), as the JAX package's does."""
    data = bytes(rng.integers(97, 123, size=20000).astype("uint8"))
    ref_path = str(tmp_path / "corpus.txt")
    with open(ref_path, "wb") as f:
        f.write(data)
    queries = [data[i * 1000:i * 1000 + 250] for i in range(5)]
    queries.append(bytes(rng.integers(97, 123, size=250).astype("uint8")))
    pattern_path = str(tmp_path / "queries.txt")
    with open(pattern_path, "wb") as f:
        f.write(b"\x01".join(queries) + b"\x01")
    build(BuildConfig(ref_file=ref_path, output_prefix=str(tmp_path / "idx"),
                      pml_index=True, ms_index=True, is_general_text=True,
                      use_minimizers=False))
    for flag in ("pml_requested", "ms_requested"):
        base = dict(ref_file=ref_path, pattern_file=pattern_path,
                    is_general_text=True, min_digest=False, batch_bases=600,
                    **{flag: True})
        assert tpl.run(_port(**base)) == 6
        single = _take(pattern_path)
        assert _hosts(jax_run, _jax, base, 2) == 3
        want = _take(pattern_path)
        assert _hosts(tpl.run, _port, base, 2) == 3
        assert _take(pattern_path) == want == single, flag


def test_resume_cursor(tmp_path, rng):
    """One host, --resume after 4 durable reads: the files end as the
    uninterrupted run's, and the cursor is gone."""
    base = dict(_build_index(tmp_path, rng), pml_requested=True)
    prefix = base["pattern_file"]
    tpl.run(_port(**base))
    full = _take(prefix, (".pseudo_lengths",))[".pseudo_lengths"]
    with open(prefix + ".pseudo_lengths", "wb") as f:
        f.write(b"".join(full.splitlines(True)[:8]))
    with open(prefix + ".cursor", "w") as f:
        f.write("4")
    assert tpl.run(_port(resume=True, **base)) == 10
    assert _take(prefix, (".pseudo_lengths",))[".pseudo_lengths"] == full
    assert not os.path.exists(prefix + ".cursor")


def test_staged_stride_resume_cursor(tmp_path, rng):
    """Host 1 of 2 stopped after 2 of its 5 records (its shard file and
    cursor hold them); it resumes, host 0 runs and merges: the files equal
    the JAX package's uninterrupted 2-host run's. The cursor counts owned
    records."""
    base = dict(_build_index(tmp_path, rng), pml_requested=True)
    prefix = base["pattern_file"]
    _hosts(jax_run, _jax, base, 2)
    want = _take(prefix)[".pseudo_lengths"]
    own1 = want.splitlines(True)[2::4]   # host 1's records: 1, 3, 5, ...
    vals1 = want.splitlines(True)[3::4]
    with open(dist.shard_path(prefix + ".pseudo_lengths", 1, 2), "wb") as f:
        f.write(b"".join(h + v for h, v in list(zip(own1, vals1))[:2]))
    with open(dist.shard_path(prefix + ".cursor", 1, 2), "w") as f:
        f.write("2")
    tpl.run(_port(process_index=1, process_count=2, resume=True, **base))
    tpl.run(_port(process_index=0, process_count=2, **base))
    assert _take(prefix)[".pseudo_lengths"] == want


def test_ks_report_stride_and_resume(tmp_path, rng):
    """The KS report under a 2-host stride, then with host 0 resuming after
    2 of its records (tests/test_pipeline.py:434-468): the rand() stream
    stays aligned with the single-process order, so both merged runs write
    the single-process files byte for byte, as the JAX package's do."""
    seqs = _write_genome(str(tmp_path / "genome.fa"), rng)
    prefix = str(tmp_path / "reads.fa")
    _write_reads(prefix, rng, "".join(seqs.values()))
    build(BuildConfig(ref_file=str(tmp_path / "genome.fa"),
                      output_prefix=str(tmp_path / "idx"), pml_index=True,
                      use_minimizers=False))
    base = dict(ref_file=str(tmp_path / "idx"), pattern_file=prefix,
                pml_requested=True, min_digest=False, write_report=True,
                ks_report=True)
    assert tpl.run(_port(**base)) == 12
    single = _take(prefix)
    _hosts(jax_run, _jax, base, 2)
    assert _take(prefix) == single
    _hosts(tpl.run, _port, base, 2)
    assert _take(prefix) == single

    def stopped_host0():
        vals = single[".pseudo_lengths"].splitlines(True)
        lines = single[".report"].splitlines(True)[1:]
        with open(dist.shard_path(prefix + ".pseudo_lengths", 0, 2),
                  "wb") as f:
            f.write(b"".join(vals[0:2] + vals[4:6]))   # records 0 and 2
        with open(dist.shard_path(prefix + ".report", 0, 2), "wb") as f:
            f.write(lines[0] + lines[2])
        with open(dist.shard_path(prefix + ".cursor", 0, 2), "w") as f:
            f.write("2")

    for run, cfg in ((jax_run, _jax), (tpl.run, _port)):
        stopped_host0()
        run(cfg(process_index=1, process_count=2, **base))
        run(cfg(process_index=0, process_count=2, resume=True, **base))
        assert _take(prefix) == single, cfg


_WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
from spumoni_tpu_torch import cli
from spumoni_tpu_torch.engine import kernels
import torch.distributed as tdist
cli.main(sys.argv[2:])
assert not tdist.is_initialized()   # cli.main left the group
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "spumoni_tpu"))
print(json.dumps({"leaked": leaked, "launches": kernels.launch_counts()}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(tmp_path, args, P=2):
    """`python -m spumoni_tpu_torch`'s main in P processes joined by gloo
    on 127.0.0.1 (neither imports jax nor spumoni_tpu); returns each
    worker's last line as JSON."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), REPO, *args],
        env=dict(env, SPUMONI_COORDINATOR=f"127.0.0.1:{port}",
                 SPUMONI_NUM_PROCESSES=str(P), SPUMONI_PROCESS_ID=str(p)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(P)]
    try:
        outs = [proc.communicate(timeout=240)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for p, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"worker {p}:\n{out[-3000:]}"
        assert f"host-stride shard {p}/{P}" in out
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def test_two_process_gloo_run(tmp_path, rng):
    """Two OS processes joined by gloo run `run -P -n -c` and `run -M -n -c
    -d`: process 0's merged files equal the single-process run's and the
    JAX package's merged files, byte for byte; no worker imports jax."""
    base = _build_index(tmp_path, rng, ms=True)
    prefix = base["pattern_file"]
    argv = ["run", "-r", base["ref_file"], "-p", prefix, "-n", "-c",
            "--device", "cpu"]
    for flags, kw in ((["-P"], dict(pml_requested=True)),
                      (["-M", "-d"], dict(ms_requested=True, use_doc=True))):
        kw = dict(base, write_report=True, **kw)
        tpl.run(_port(**kw))
        single = _take(prefix)
        _hosts(jax_run, _jax, kw, 2)
        want = _take(prefix)
        for res in _two_processes(tmp_path, argv + flags):
            assert res["leaked"] == []
            assert set(res["launches"].values()) == {0}   # plain versions
        assert _take(prefix) == want == single, flags
