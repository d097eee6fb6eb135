"""On the card (marked `gpu`; skipped without one):

    python -m pytest -p no:cacheprovider -m gpu portbench/tests/test_portbench_gpu.py
"""

import json
import subprocess
import sys

import pytest

from portbench import control

from conftest import CHECKOUT

SMALL = (96, 64, 128)
SMALL_GRIDS = {"jacobi2d-16384.loop": (200, 1024)}
ONE_CARD = {"jacobi3d-512.loop": ["cuda:0"], "jacobi3d-2048.mesh-loop": ["cuda:0"] * 4,
            "jacobi2d-16384.loop": ["cuda:0"]}


@pytest.mark.gpu
def test_a_short_run_of_the_one_card_cell(card):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "jacobi3d-512.loop",
                        "--seed", str(2**31 + 29), "--seconds", "2", "--trace", "0"],
                       cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"gcells_per_s", "block_p95_ms", "setup_s"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(ONE_CARD))
@pytest.mark.parametrize("mode,correct", [("program", True), ("control", False),
                                          ("altered", False)])
def test_readings_on_the_card(card, cell, mode, correct):
    got = control.readings(cell, [5, 2**31 + 1], 0.2, mode, grid=SMALL_GRIDS.get(cell, SMALL),
                           devices=ONE_CARD[cell], log=lambda *a: None)
    assert all(g["correct"] is correct for g in got.values()), got
