"""`correct` comes out false when the timed path is broken underneath, and
the control (the reference in bfloat16 in the program's place) fails: the
rest of a run, past the look for a card, at sizes a test run holds."""

import pytest

from portbench import control, harness, loop, run

from conftest import CPU_DEVICES, TINY

BENCH = harness.load_benchmark()
SEEDS = [3, 2**31 + 17]


def _correct(cell, mode, seed):
    got = control.readings(cell, [seed], 0.05, mode, grid=TINY, devices=CPU_DEVICES[cell],
                           log=lambda *a: None)[seed]
    return got


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(CPU_DEVICES))
def test_the_program_is_correct(cell, seed):
    got = _correct(cell, "program", seed)
    assert got["correct"] and set(got["checks"].values()) == {0} and got["widest"] == 0.0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(CPU_DEVICES))
def test_the_control_fails(cell, seed):
    got = _correct(cell, "control", seed)
    cells = TINY[0] * TINY[1] * TINY[2]
    assert not got["correct"]
    # bfloat16 rounds nearly every cell away from the float32 reference
    assert min(got["checks"].values()) > cells // 2


FAULTS = [(c, f) for c in sorted(CPU_DEVICES) for f in ("unchanged", "altered", "half")]
FAULTS.append(("jacobi3d-2048.mesh-loop", "no_exchange"))


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    got = _correct(cell, fault, SEEDS[1])
    assert not got["correct"] and got["checks"]["start"] > 0


def test_the_result_says_not_correct():
    c = loop.Cell(BENCH, "jacobi3d-512.loop", grid=TINY, devices=["cpu"])
    with control.patched("altered", c.reference, 8):
        got = loop.run(c, 11, 0.05, False, 0.0, lambda *a: None)
    out = run.result(BENCH, c, got, False)
    assert out["correct"] is False and out["failed"] == len(out["checks"])
    assert all(v["value"] == 1 and v["limit"] == 0 for v in out["checks"].values())
