"""On the card (``gpu`` tier): each cell's control at the cell's own size
is refused, and the program as configured is not, on three seeds each,
through ``run.py`` itself.  Skips without a CUDA device.

    python -m pytest benchmark/tests/test_bench_gpu.py -q -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

MAN = harness.manifest()
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (gpu tier)")


def _run(cell, seed, control):
    cmd = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
           str(seed), "--seconds", "2", "--trace", "0"]
    p = subprocess.run(cmd + (["--control"] if control else []),
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_control_refused_and_program_correct_on_the_card(cuda, cell, seed):
    ctl = _run(cell, seed, True)
    assert not ctl["correct"], ctl["checks"]
    out = _run(cell, seed, False)
    assert out["correct"], out["checks"]
