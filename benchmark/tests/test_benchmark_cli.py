"""The command's refusals: no result without a CUDA card, and none from a
directory that holds only BENCHMARK.json and the benchmark."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pe-train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
