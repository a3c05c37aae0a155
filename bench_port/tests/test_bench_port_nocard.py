"""Without a card the harness fails and prints no result; it never falls
back to the CPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the harness would run")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        "yolo11x_2cam_5mm.objects6", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_outside_a_checkout_no_result(tmp_path):
    """In a folder with only BENCHMARK.json and the benchmark's own files,
    the run fails before any result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        "yolo11x_2cam_5mm.objects6", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
