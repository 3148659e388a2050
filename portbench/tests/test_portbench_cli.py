"""The command refuses to measure without a card, and without the program."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import core


def _run(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_cpu_run_is_refused():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(core.ROOT, "--workload", "ch64.rollout", "--seed", "3", "--seconds", "2",
             "--trace", "0")
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_unknown_workload_is_refused():
    p = _run(core.ROOT, "--workload", "nope", "--seed", "3", "--seconds", "2", "--trace", "0")
    assert p.returncode == 2 and p.stdout.strip() == "" and "no workload" in p.stderr


def test_benchmark_alone_is_refused(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's own files."""
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", "ch64.rollout", "--seed", "3", "--seconds", "2",
             "--trace", "0")
    assert p.returncode != 0
    assert not [line for line in p.stdout.splitlines() if line.startswith("{")]
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["portbench"]
