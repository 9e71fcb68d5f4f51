"""Without a GPU the harness fails and prints no result; it never falls
back to the CPU. Without the program beside it, it fails too."""

import os
import subprocess
import sys

import torch

from benchmark import run


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "pml_report", "--seed", str(2**33 + 1),
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "is_available() is false" in err


def test_too_few_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "pml_report", "--seed", "5",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "needs 1 GPUs" in err


def test_benchmark_alone_fails(tmp_path):
    import shutil
    shutil.copytree(os.path.join(run.ROOT, "benchmark"),
                    tmp_path / "benchmark")
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "pml_report", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
