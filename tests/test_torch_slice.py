"""The port's main path as a whole: parse -> plan -> `cuda.run`.

On this CPU-only machine `run(device="cpu")` goes through the same plan,
group chaining and iterate loop as on the card, with every group running
its plain version.  It is held against
- soda_tpu's Pallas path in interpret mode (as the JAX tests run it),
  outside the border-invalid rim: the TPU kernel evaluates intermediate
  stages at constant extent from zero-filled inputs and uses 32-bit
  integer accumulators (docs/SEMANTICS.md), and
- the NumPy oracle on the whole grid.
Gates: `compare_outputs` (integers bit-exact, f32 1e-4, f32 libm 2e-3,
half 2e-2).  The port's functions take programs from the port's parser,
soda_tpu's from the lark parser.  The card contract runs in a subprocess
with `jax`, `lark` and `soda_tpu` blocked.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from soda_tpu.backend import pallas as pallas_backend
from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.utils.testing import compare_outputs, rand_inputs
from soda_tpu_torch.backend import cuda, eager, linebuffer, linebuffer2d
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.cli import sodac
from soda_tpu_torch.frontend.parser import parse, parse_file
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils import report
from soda_tpu_torch.utils.device import NoCudaDevice
from soda_tpu_torch.utils.testing import INT3D_SOURCES, RANK2_CORPUS, RANK3_CORPUS

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SODA = ROOT / "tests" / "soda"
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in RANK3_CORPUS + RANK2_CORPUS}
SOURCES.update(INT3D_SOURCES)
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}


@pytest.mark.parametrize("name", list(RANK3_CORPUS) + list(INT3D_SOURCES))
@pytest.mark.parametrize("shape", [(16, 24, 128), (13, 21, 40)])
def test_run_cpu_matches_pallas_and_oracle(name, shape):
    p = PROGRAMS[name]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(8))
    before = linebuffer.LAUNCHES
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    assert linebuffer.LAUNCHES == before  # the CPU path launches nothing
    gold = numpy_interp.run(REF[name], ins, ps)
    assert compare_outputs(p, got, gold, 0)
    ref = pallas_backend.run(REF[name], ins, ps, interpret=True)
    assert compare_outputs(p, got, ref, p.valid_rim())


@pytest.mark.parametrize("name", ["blur", "sobel2d", "accum64", "smooth_half",
                                  "poisson_f64"])
@pytest.mark.parametrize("shape", [(24, 136), (21, 40)])
def test_rank2_run_cpu_matches_pallas(name, shape):
    p = PROGRAMS[name]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(13))
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    ref = pallas_backend.run(REF[name], ins, ps, interpret=True)
    assert compare_outputs(p, got, ref, p.valid_rim())


@pytest.mark.parametrize("name", RANK2_CORPUS)
def test_rank2_slice_on_the_cpu_path_matches_oracle(name):
    """Every rank-2 program of at most 64 bits through the main path's CPU
    route (plan, groups, chained iterate), on an odd grid, against the
    oracle on the whole grid; the launch counts do not move."""
    p = PROGRAMS[name]
    shape = (19, 45)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(14))
    before = (linebuffer.LAUNCHES, linebuffer2d.LAUNCHES)
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    assert (linebuffer.LAUNCHES, linebuffer2d.LAUNCHES) == before
    gold = numpy_interp.run(REF[name], ins, ps)
    assert compare_outputs(p, got, gold, 0)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = PROGRAMS["jacobi3d"]
    x = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(NoCudaDevice):
        cuda.run(p, {"t0": x}, device="cuda")


def test_device_must_be_explicit():
    """The entry points default to the card: without one they raise
    `NoCudaDevice` and never fall back to the CPU."""
    p = PROGRAMS["blur"]
    x = {"input": np.zeros((8, 16), np.uint16)}
    if torch.cuda.is_available():
        assert cuda.run(p, x)["blur_y"].device.type == "cuda"
        assert eager.run(p, x)["blur_y"].device.type == "cuda"
        return
    with pytest.raises(NoCudaDevice):
        cuda.run(p, x)
    with pytest.raises(NoCudaDevice):
        eager.run(p, x)
    with pytest.raises(NoCudaDevice):
        sodac.main([str(SODA / "blur.soda"), "--grid-shape", "8,16", "--run"])


def test_rank_two_runs_on_the_cpu_path():
    p = parse_file(SODA / "blur.soda")
    ins, ps = rand_inputs(p, (20, 30), np.random.default_rng(9))
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    assert compare_outputs(p, got, numpy_interp.run(REF["blur"], ins, ps), 0)


CONTRACT = r"""
import sys
sys.modules["jax"] = None
sys.modules["lark"] = None
sys.modules["soda_tpu"] = None
import json
import numpy as np
from soda_tpu_torch.backend import cuda
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.frontend.parser import parse_file
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils.testing import CORPUS, compare_outputs, oracle, rand_inputs
res = {}
for name, shape in [("jacobi3d", (9, 14, 40)), ("denoise3d", (8, 12, 40)),
                    ("jacobi2d", (19, 40)), ("heat3d", (9, 14, 40)),
                    ("smooth1d", (300,)), ("blur", (21, 40))]:
    p = parse_file(CORPUS / f"{name}.soda")
    plan(p, shape)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(0))
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    res[name] = bool(compare_outputs(p, got, oracle(p, ins, ps), 0))
# wide integers: uint64 through the kernels' plain versions, 128 bits
# through the plain path's limbs (interp/torch_wide128.py) and the oracle's
from soda_tpu_torch.backend import eager
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.utils.testing import U64_SOURCES, u64_inputs
q = parse(U64_SOURCES["u64_2d"])
q_ins, q_ps = u64_inputs(q, (19, 40), np.random.default_rng(0))
res["u64_2d"] = bool(compare_outputs(q, to_numpy(q, cuda.run(q, q_ins, q_ps, device="cpu")),
                                     oracle(q, q_ins, q_ps), 0))
q = parse_file(CORPUS / "accum128.soda")
q_ins, q_ps = rand_inputs(q, (13, 21), np.random.default_rng(0))
res["accum128"] = bool(compare_outputs(q, to_numpy(q, eager.run(q, q_ins, q_ps, device="cpu")),
                                       oracle(q, q_ins, q_ps), 0))
res["wide_modules"] = sorted(m for m in sys.modules if m.startswith("soda_tpu_torch.")
                             and m.endswith(("wide128", ".dtypes")))
try:
    cuda.run(p, ins, ps, device="cuda")
    res["cuda"] = "ran"
except RuntimeError as e:
    res["cuda"] = type(e).__name__
res["jax_loaded"] = sys.modules.get("jax") is not None
res["lark_loaded"] = sys.modules.get("lark") is not None
res["fused_modules"] = sorted(m for m in sys.modules if m.endswith((".sweeps", ".unroll", ".opcount")))
res["soda_tpu_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] == "soda_tpu"
                                and sys.modules[m] is not None)
print(json.dumps(res))
"""


def test_card_contract_without_jax_and_lark():
    r = subprocess.run([sys.executable, "-c", CONTRACT], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["jacobi3d"] and res["denoise3d"] and res["blur"]
    assert res["jacobi2d"] and res["heat3d"]  # fused cascades, plain versions
    assert res["smooth1d"]  # rank 1: the windows kernel's plain version
    assert res["u64_2d"] and res["accum128"]   # uint64; 128 bits on the limbs
    assert res["wide_modules"] == ["soda_tpu_torch.interp.torch_wide128",
                                   "soda_tpu_torch.interp.wide128",
                                   "soda_tpu_torch.ir.dtypes"]
    assert res["fused_modules"] == ["soda_tpu_torch.backend.sweeps",
                                    "soda_tpu_torch.optimize.unroll",
                                    "soda_tpu_torch.utils.opcount"]
    assert not res["jax_loaded"] and not res["lark_loaded"]
    assert res["soda_tpu_loaded"] == []
    if not torch.cuda.is_available():
        assert res["cuda"] == "NoCudaDevice"


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def test_port_imports_neither_jax_nor_lark_nor_the_tpu_backends():
    """The port, the chip script and the port's scripts import nothing of
    jax, lark or soda_tpu: any module whose first name is one of them."""
    files = [*(ROOT / "soda_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
             *(ROOT / "scripts").glob("torch_*.py")]
    assert {"torch_fuzz_wide.py", "torch_fuzz_mesh.py", "torch_mesh_cards.py",
            "entry.py"} <= {f.name for f in files}
    for f in files:
        for m in _imports(f):
            assert m.split(".")[0] not in ("jax", "lark", "soda_tpu"), (
                f"{f.relative_to(ROOT)} imports {m}")


def test_cli_runs_and_checks_against_the_oracle(capsys):
    rc = sodac.main([str(SODA / "denoise3d.soda"), "--grid-shape", "9,13,40",
                     "--device", "cpu", "--run"])
    out = capsys.readouterr().out
    assert rc == 0 and "OK" in out and "max |diff| vs oracle" in out
    assert "linebuffer3d" in out
    with pytest.raises(SystemExit):
        sodac.main([str(SODA / "denoise3d.soda"), "--grid-shape", "9,x"])


def test_report_bytes_and_rates():
    p = PROGRAMS["jacobi3d"]
    pl = plan(p, (512, 512, 512))
    rep = report.analyze(pl)
    assert rep.ideal_bytes_per_cell == 8.0
    # the plan's bytes: tile and chunk halos, an input's rows copied in
    # whole 16-byte chunks (72 columns a row for a 64-column tile)
    assert rep.plan_bytes_per_cell == pl.groups[0].hbm_bytes_per_call / 512**3
    assert 8.0 < rep.plan_bytes_per_cell < 8.83
    r = report.rates(rep, 1e-3, "not measured")
    assert abs(r["achieved_gbps_at_ideal_bytes"] - 8 * 512**3 / 1e6) < 1e-6
    assert r["share_of_3350_gbps"] == r["achieved_gbps_at_ideal_bytes"] / 3350.0
    assert "V5E" not in open(report.__file__).read()


def test_report_bound_in_ms_for_ranks_two_and_three():
    # jacobi3d 512^3: 8 B/cell; blur 2048x4096 uint16: 4 B/cell
    rep3 = report.analyze(plan(PROGRAMS["jacobi3d"], (512, 512, 512)))
    assert abs(rep3.bound_ms - 8 * 512**3 / 3.35e12 * 1e3) < 1e-12
    assert round(rep3.bound_ms, 4) == 0.3205
    rep2 = report.analyze(plan(PROGRAMS["blur"], (2048, 4096)))
    assert rep2.ideal_bytes_per_cell == 4.0
    assert abs(rep2.bound_ms - 4 * 2048 * 4096 / 3.35e12 * 1e3) < 1e-12
    assert 4.0 < rep2.plan_bytes_per_cell < 4.3
    # rank 1 through the windows kernel: smooth1d 2^28 f32, 8 B/cell
    p1 = parse_file(SODA / "smooth1d.soda")
    rep1 = report.analyze(plan(p1, (2**28,)))
    assert rep1.ideal_bytes_per_cell == 8.0 and rep1.bound_by == "bytes"
    assert abs(rep1.bound_ms - 8 * 2**28 / 3.35e12 * 1e3) < 1e-12
    assert round(rep1.bound_ms, 4) == 0.641
    assert 8.0 < rep1.plan_bytes_per_cell < 8.01


def test_cli_prints_rank2_plans_and_says_why_rank1_has_none(capsys):
    """The CLI prints and runs rank-2 plans and smooth1d's (rank 1, the
    windows kernel); `--block` pins the windows kernel."""
    rc = sodac.main([str(SODA / "blur.soda"), "--grid-shape", "21,40",
                     "--device", "cpu", "--run"])
    out = capsys.readouterr().out
    assert rc == 0 and "OK" in out and "linebuffer2d" in out
    rc = sodac.main([str(SODA / "smooth1d.soda"), "--grid-shape", "300",
                     "--device", "cpu", "--run"])
    out = capsys.readouterr().out
    assert rc == 0 and "OK" in out
    assert "windows" in out and "block=(4096,)" in out and "no CUDA plan" not in out
    rc = sodac.main([str(SODA / "blur.soda"), "--grid-shape", "21,40",
                     "--block", "8,32", "--device", "cpu", "--run"])
    out = capsys.readouterr().out
    assert rc == 0 and "OK" in out and "windows" in out and "block=(8, 32)" in out
    with pytest.raises(SystemExit, match="no CUDA plan"):
        sodac.main([str(SODA / "heat3d.soda"), "--grid-shape", "9,13,40",
                    "--block", "4,8,32", "--sweeps", "2"])
