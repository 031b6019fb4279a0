"""One short run of a cell on the card (skips without one):

    python -m pytest -m cuda benchmarks/tests/test_bench_card.py"""

import json
import subprocess
import sys

import pytest

from bench_small import BENCH, ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "unetdc.segment", "--seed",
                          str(2 ** 31 + 17), "--seconds", "3",
                          "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert list(res)[-1] == "checks"
