"""pytest settings of the benchmark's own tests (run them with
`python -m pytest portbench/tests`); the card's tests are marked `gpu`
and skip, inside a fixture, where torch sees no card."""

import pathlib
import sys

import pytest

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


# tiny grids on the CPU: the program's plain path stands in for its kernels
TINY = (20, 12, 16)
# a rank-2 grid of three chunks of the check's 64 rows, the last one short
TINY_2D = (150, 40)
CPU_DEVICES = {"jacobi3d-512.loop": ["cpu"], "jacobi3d-2048.mesh-loop": ["cpu"] * 4,
               "jacobi2d-16384.loop": ["cpu"]}
GRIDS = {"jacobi2d-16384.loop": TINY_2D}


def tiny(cell: str) -> tuple[int, ...]:
    """The tiny grid a CPU test runs `cell` at."""
    return GRIDS.get(cell, TINY)

