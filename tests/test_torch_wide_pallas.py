"""The uint64 programs of `utils/testing.py::U64_SOURCES` on the port's
plain path against `soda_tpu`'s Pallas kernels in interpret mode, once
per kernel: kernel 1 (u64_3d), kernel 2 (u64_2d), kernel 3 (u64_iter,
four fused sweeps) and kernel 4 (u64_1d, rank 1), on the same numpy
inputs over the whole range [0, 2^64).  The port's kernels equal its
plain path bit for bit on these programs (tests/test_torch_wide.py, on
the CPU through their host emulation; chip_smoke.py phase 18 on the
card).  Compared outside the Pallas kernel's `valid_rim()`, where the
TPU kernels' constant-extent evaluation may differ (docs/SEMANTICS.md);
each takes 5 to 10 s of interpret mode, so they live apart from
tests/test_torch_wide.py.  Tolerance: none, bit for bit.
"""

import numpy as np
import pytest
import torch

from soda_tpu.backend import pallas as pallas_backend
from soda_tpu.frontend import parser as lark_parser
from soda_tpu_torch.backend import eager
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.utils.testing import U64_SOURCES, u64_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("name,grid", [("u64_3d", (6, 9, 40)), ("u64_2d", (16, 40)),
                                       ("u64_iter", (16, 40)), ("u64_1d", (300,))])
def test_uint64_programs_equal_soda_tpu_pallas_kernels(name, grid):
    p, r = parse(U64_SOURCES[name]), lark_parser.parse(U64_SOURCES[name])
    ins, ps = u64_inputs(p, grid, np.random.default_rng(11))
    assert (ins["a"] >= 2**63).any()
    got = to_numpy(p, eager.run(p, ins, ps, device="cpu"))
    ref = pallas_backend.run(r, ins, ps, interpret=True)
    rim = p.valid_rim()
    inner = tuple(slice(rim, n - rim) for n in grid)
    out = p.output_names[0]
    assert got[out].dtype == np.asarray(ref[out]).dtype == np.uint64
    assert np.array_equal(got[out][inner], np.asarray(ref[out])[inner])
