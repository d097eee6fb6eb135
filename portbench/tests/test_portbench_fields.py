"""Fused sweeps and programs with several inputs: a reference told where
its block lies (`sweep_at`), sweeps counted a call, a roofline's bytes
counted once a call, fixed fields beside the state, and the cell that
fuses its sweeps."""

import json
import math
import shutil

import numpy as np
import pytest
import torch

from portbench import check, control, harness, inputs, loop, run

from conftest import CHECKOUT, TINY, TINY_2D

BENCH = harness.load_benchmark()
PEAK = harness.peak_of("NVIDIA H100 80GB HBM3")


# -- the fused reference ---------------------------------------------------

def _jacobi2d_numpy(x, sweeps):
    """`sweeps` sweeps of programs/jacobi2d.soda over the whole grid, cell
    by cell, a tap outside the grid reading zero at every sweep."""
    n0, n1 = x.shape
    c = np.float32(0.2)
    for _ in range(sweeps):
        out = np.zeros_like(x)

        def at(i, j):
            return x[i, j] if 0 <= i < n0 and 0 <= j < n1 else np.float32(0)

        for i in range(n0):
            for j in range(n1):
                s = np.float32(at(i, j + 1) + at(i + 1, j))
                for t in (at(i, j), at(i, j - 1), at(i - 1, j)):
                    s = np.float32(s + t)
                out[i, j] = np.float32(s * c)
        x = out
    return x


def test_fused_reference_against_a_numpy_loop():
    ref = harness.load_module("reference", "jacobi2d")
    x = torch.rand((13, 9), generator=torch.Generator().manual_seed(5))
    want = _jacobi2d_numpy(x.numpy(), ref.SWEEPS)
    got = check.sweep_in_chunks(ref, x, 4, torch.float32)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def _plain(name, x, iterate, fields=None):
    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.frontend.parser import parse_file

    p = parse_file(harness.program_path(name))
    fn = cuda.build_fn(p, grid_shape=tuple(x.shape), iterate=iterate)
    return fn({p.input_names[0]: x, **(fields or {})}, {})[p.output_names[0]]


def test_fused_reference_equals_the_ports_plain_path_in_every_chunk():
    ref = harness.load_module("reference", "jacobi2d")
    x = torch.rand(TINY_2D, generator=torch.Generator().manual_seed(9))
    y = _plain("jacobi2d", x, 8)
    src = lambda a, b: x[a:b]
    for chunk in (64, 7, 150):
        got = check.compare_sweep(ref, src, lambda a, b: y[a:b], TINY_2D[0], TINY_2D[1:],
                                  chunk, torch.float32, "cpu")
        assert got == {"cells_off": 0, "max_gap": 0.0}


class _NotZeroed:
    """The jacobi2d reference fusing its sweeps without knowing where its
    block lies: the rows outside the grid are zero only before the first
    sweep."""
    HALO = 8

    @staticmethod
    def sweep(block):
        ref = harness.load_module("reference", "jacobi2d")
        for _ in range(ref.SWEEPS):
            block = ref.one_sweep(block)
        return block


@pytest.mark.parametrize("chunk", [64, 16])
def test_a_fused_reference_blind_to_the_edge_fails_on_an_edge_chunk(chunk):
    ref = harness.load_module("reference", "jacobi2d")
    x = torch.rand(TINY_2D, generator=torch.Generator().manual_seed(4))
    y = _plain("jacobi2d", x, 8)
    n0 = TINY_2D[0]

    def rows_off(reference, z, z1):
        block = check.zero_outside(lambda a, b: x[a:b], z - 8, z1 + 8, n0, TINY_2D[1:],
                                   torch.float32, "cpu")
        want = check.reference_sweep(reference, block, z - 8, n0)
        return [z + r for r in (check.bits(want) != check.bits(y[z:z1])).any(dim=1)
                .nonzero().flatten().tolist()]

    chunks = [(z, min(z + chunk, n0)) for z in range(0, n0, chunk)]
    assert all(rows_off(ref, z, z1) == [] for z, z1 in chunks)
    blind = {z: rows_off(_NotZeroed, z, z1) for z, z1 in chunks}
    # wrong at both edges of the grid, within the fused sweeps' reach, and
    # nowhere else: the first and the last chunk
    assert blind[chunks[0][0]] and blind[chunks[-1][0]]
    assert all(r < 8 or r >= n0 - 8 for rows in blind.values() for r in rows)
    assert check.compare_sweep(_NotZeroed, lambda a, b: x[a:b], lambda a, b: y[a:b], n0,
                               TINY_2D[1:], chunk, torch.float32, "cpu")["cells_off"] > 0


# -- sweeps a call, bytes a call -------------------------------------------

def test_the_rate_counts_the_configs_iterate():
    w = harness.Window()
    w.add(0.0, 0.5, 10)
    w.add(0.5, 1.0, 10)
    assert w.calls == 20
    assert w.gcells_per_s(2**28, 8) == pytest.approx(2**28 * 20 * 8 / 1.0 / 1e9)
    assert w.gcells_per_s(2**28, 8) == 8 * w.gcells_per_s(2**28)


def test_the_result_counts_eight_sweeps_a_call():
    c = loop.Cell(BENCH, "jacobi2d-16384.loop", grid=TINY_2D, devices=["cpu"])
    got = loop.run(c, 2**31 + 41, 0.05, False, 0.0, lambda *a: None)
    out = run.result(BENCH, c, got, False)
    w = got["window"]
    assert w.calls == 10 * len(w.blocks_ms)
    assert out["metrics"]["gcells_per_s"]["value"] == pytest.approx(
        math.prod(TINY_2D) * w.calls * 8 / w.seconds / 1e9)


def test_the_bound_counts_bytes_once_a_call():
    count = harness.load_json("roofline", "jacobi2d")
    cells = 16384 ** 2
    bound = harness.bound_ms(count, cells, 8, PEAK)
    assert bound == pytest.approx(0.641, abs=5e-4)     # 8 B a cell at 3.35 TB/s
    ops_ms = 8 * count["float32_ops_per_cell"] * cells / PEAK["float32_ops_per_s"] * 1e3
    assert ops_ms == pytest.approx(0.160, abs=5e-4) and ops_ms < bound
    # the ops bound where bytes once a call are fewer than the sweeps' ops
    many = dict(count, float32_ops_per_cell=500)
    assert harness.bound_ms(many, cells, 8, PEAK) == pytest.approx(
        8 * 500 * cells / PEAK["float32_ops_per_s"] * 1e3)


@pytest.mark.parametrize("cell", ["jacobi3d-512.loop", "jacobi3d-2048.mesh-loop"])
def test_the_one_sweep_cells_read_as_before(cell):
    # the arithmetic of the benchmark before sweeps were counted a call:
    # the bound max(bytes, ops) x sweeps, the rate cells x sweeps / s
    c = loop.Cell(BENCH, cell)
    count, sweeps = c.roofline, c.config["iterate"]
    assert sweeps == 1
    old = max(count["bytes_per_cell"] * c.cells / PEAK["hbm_bytes_per_s"],
              count["float32_ops_per_cell"] * c.cells / PEAK["float32_ops_per_s"]) * sweeps * 1e3
    assert harness.bound_ms(count, c.cells, sweeps, PEAK) == old
    w = harness.Window()
    for k in range(7):
        w.add(0.013 * k, 0.013 * (k + 1) + 1e-4 * k, c.traffic["block_sweeps"])
    assert w.gcells_per_s(c.cells, sweeps) == (
        c.cells * 7 * c.traffic["block_sweeps"] / w.seconds / 1e9)


# -- the fused cell ----------------------------------------------------

def test_the_cascade_roofline_reads_the_per_call_bound():
    t = loop.Trace("jacobi2d-16384.loop", 16384 ** 2, 8,
                   harness.load_json("roofline", "jacobi2d"), PEAK, kernel_ms=0.78)
    read = lambda name: harness.load_module("layers", name).read(t)
    assert read("kernel_ms.cascade") == 0.78
    assert read("cascade2d_roofline") == pytest.approx(100 * 0.6410 / 0.78, rel=1e-3)
    t.kernel_ms = None
    assert read("cascade2d_roofline") is None


# -- a program with a fixed field, added by files alone ---------------------

DENOISE3D_REF = '''"""Plain PyTorch reference of programs/denoise3d.soda (a test's copy):
three stages, the field u and the fixed rhs; the stages grad and w are
zero outside the grid, as every stage is."""

import torch

HALO = 2


def _pad(x):
    return torch.nn.functional.pad(x, (1, 1, 1, 1))


def sweep_at(block, z0, n0, rhs):
    def f(v):
        return torch.tensor(v, dtype=block.dtype, device=block.device)

    u = _pad(block)
    m = block.shape[0] - 2                  # grad and w on rows [1, len - 1)

    def tu(a, b, c, lo, n):
        return u[lo + a:lo + a + n, 1 + b:u.shape[1] - 1 + b, 1 + c:u.shape[2] - 1 + c]

    d2 = tu(0, 0, 1, 1, m) - tu(0, 0, -1, 1, m)
    d1 = tu(0, 1, 0, 1, m) - tu(0, -1, 0, 1, m)
    d0 = tu(1, 0, 0, 1, m) - tu(-1, 0, 0, 1, m)
    grad = torch.sqrt(d2 * d2 + d1 * d1 + d0 * d0 + f(0.0001))
    w = f(1.0) / (f(1.0) + grad)
    lo, hi = max(0, -(z0 + 1)), min(m, n0 - (z0 + 1))
    w[:lo] = 0
    w[max(hi, lo):] = 0
    W = _pad(w)
    n = m - 2                               # unew on rows [2, len - 2)

    def tw(a, b, c):
        return W[1 + a:1 + a + n, 1 + b:W.shape[1] - 1 + b, 1 + c:W.shape[2] - 1 + c]

    def t(a, b, c):
        return tu(a, b, c, 2, n)

    s = (tw(0, 0, 1) * t(0, 0, 1) + tw(0, 0, -1) * t(0, 0, -1) + tw(0, 1, 0) * t(0, 1, 0)
         + tw(0, -1, 0) * t(0, -1, 0) + tw(1, 0, 0) * t(1, 0, 0) + tw(-1, 0, 0) * t(-1, 0, 0))
    sw = tw(0, 0, 1) + tw(0, 0, -1) + tw(0, 1, 0) + tw(0, -1, 0) + tw(1, 0, 0) + tw(-1, 0, 0)
    num = t(0, 0, 0) + f(0.1) * s + f(0.05) * rhs[2:2 + n]
    return num / (f(1.0) + f(0.1) * sw + f(0.05))
'''

# a one-stage program with a fixed field: the mesh's entry runs it (the
# sharded fn differs from the whole grid on a multi-stage program at the
# grid's edge along a sharded dim, which denoise3d is; see PERF.md)
RELAX3D = """kernel: relax3d
burst width: 512
unroll factor: 4

input dram 1 float: u(128, 128, *)
input dram 1 float: rhs(128, 128, *)
output dram 1 float: unew(0, 0, 0) = (u(0, 0, 1) + u(0, 0, -1) + u(0, 1, 0) + u(0, -1, 0) + u(1, 0, 0) + u(-1, 0, 0) - rhs(0, 0, 0)) * 0.166666f
"""

RELAX3D_REF = '''"""Plain PyTorch reference of programs/relax3d.soda (a test's)."""

import torch

HALO = 1


def sweep(block, rhs):
    n = block.shape[0] - 2
    x = torch.nn.functional.pad(block, (1, 1, 1, 1))

    def tap(a, b, c):
        return x[1 + a:1 + a + n, 1 + b:x.shape[1] - 1 + b, 1 + c:x.shape[2] - 1 + c]

    s = tap(0, 0, 1) + tap(0, 0, -1) + tap(0, 1, 0) + tap(0, -1, 0) + tap(1, 0, 0)
    s = s + tap(-1, 0, 0) - rhs[1:1 + n]
    return s * torch.tensor(0.166666, dtype=block.dtype)
'''

# cell -> (program, entry, chips, mesh, CPU devices)
MESH = {"sizes": [2, 2], "axes": ["gz", "gy"], "dims": [0, 1]}
FIELD_CELLS = {"denoise3d-build_fn.loop": ("denoise3d", "build_fn", 1, None, ["cpu"]),
               "relax3d-sharded.loop": ("relax3d", "sharded", 4, MESH, ["cpu"] * 4)}


@pytest.fixture
def denoise3d(tmp_path, monkeypatch):
    """A copy of the benchmark's folder with denoise3d's and relax3d's
    programs, references and counts, a config a cell (u the state, rhs a
    fixed field) and the cells, and none of it in the repository's
    BENCHMARK.json."""
    root = tmp_path / "portbench"
    shutil.copytree(CHECKOUT / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(CHECKOUT / "tests" / "soda" / "denoise3d.soda", root / "programs")
    (root / "programs" / "relax3d.soda").write_text(RELAX3D)
    for name, text in (("denoise3d", DENOISE3D_REF), ("relax3d", RELAX3D_REF)):
        (root / "reference" / f"{name}.py").write_text(text)
        (root / "roofline" / f"{name}.json").write_text(json.dumps(
            {"program": name, "dtype": "float32", "bytes_per_cell": 12,
             "float32_ops_per_cell": 40}))
    bench = json.loads(json.dumps(BENCH))
    dist = {"dist": "uniform", "low": 0, "high": 1, "slab_planes": 8}
    for cell, (program, entry, chips, mesh, _) in FIELD_CELLS.items():
        name = cell.split(".")[0]
        (root / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "program": program, "grid": list(TINY), "dtype": "float32",
             "iterate": 1, "chips": chips, "entry": entry, "mesh": mesh, "inputs": dist,
             "fields": {"rhs": dict(dist, low=-1, slab_planes=5)},
             "reference": program, "roofline": program, "limits": {"cells_off": 0},
             "reduced": []}))
        bench["configs"].append({"name": name, "source": "a test", "reduced": [],
                                 "file": f"portbench/configs/{name}.json", "why": "a test"})
        bench["workloads"].append({"name": cell, "config": name, "traffic": "loop",
                                   "chips": chips, "why": "a test"})
    monkeypatch.setattr(harness, "HERE", root)
    monkeypatch.setattr(harness, "load_benchmark", lambda: bench)
    return bench


def test_the_denoise3d_reference_equals_the_ports_plain_path(denoise3d):
    ref = harness.load_module("reference", "denoise3d")
    g = torch.Generator().manual_seed(2)
    u, rhs = torch.rand(TINY, generator=g), torch.rand(TINY, generator=g)
    y = _plain("denoise3d", u, 1, {"rhs": rhs})
    got = check.compare_sweep(ref, lambda a, b: u[a:b], lambda a, b: y[a:b], TINY[0],
                              TINY[1:], 6, torch.float32, "cpu",
                              {"rhs": lambda a, b: rhs[a:b]})
    assert got == {"cells_off": 0, "max_gap": 0.0}
    # the field matters: another rhs reads off
    other = check.compare_sweep(ref, lambda a, b: u[a:b], lambda a, b: y[a:b], TINY[0],
                                TINY[1:], 6, torch.float32, "cpu",
                                {"rhs": lambda a, b: 0 * rhs[a:b]})
    assert other["cells_off"] > 0


@pytest.mark.parametrize("cell", sorted(FIELD_CELLS))
@pytest.mark.parametrize("mode,correct", [("program", True), ("control", False),
                                          ("altered", False), ("unchanged", False),
                                          ("half", False)])
def test_a_program_with_a_field_runs_from_added_files(denoise3d, cell, mode, correct):
    got = control.readings(cell, [2**31 + 3], 0.05, mode, grid=TINY,
                           devices=FIELD_CELLS[cell][4], log=lambda *a: None)[2**31 + 3]
    assert got["correct"] is correct, got
    if correct:
        assert set(got["checks"].values()) == {0}
    else:
        assert got["checks"]["start"] > 0


def test_fields_are_made_from_the_seed_and_their_name(denoise3d):
    c = loop.Cell(denoise3d, "denoise3d-build_fn.loop", grid=TINY, devices=["cpu"])
    spec = c.fields["rhs"]
    assert spec.low == -1 and spec.slab == 5 and spec.dtype == torch.float32
    s = inputs.field_seed(7, "rhs")
    assert s == inputs.field_seed(7, "rhs") and s not in (7, inputs.field_seed(7, "f"),
                                                          inputs.field_seed(8, "rhs"))
    g = inputs.grid(TINY, s, spec, "cpu")
    assert float(g.min()) >= -1 and float(g.min()) < 0
    assert torch.equal(inputs.planes(TINY, s, 4, 13, spec, "cpu"), g[4:13])


def test_a_config_whose_fields_are_not_the_programs_inputs_is_refused(denoise3d, tmp_path):
    path = harness.HERE / "configs" / "denoise3d-build_fn.json"
    cfg = json.loads(path.read_text())
    cfg["fields"] = {}
    path.write_text(json.dumps(cfg))
    c = loop.Cell(denoise3d, "denoise3d-build_fn.loop", grid=TINY, devices=["cpu"])
    with pytest.raises(ValueError, match="config names fields"):
        loop.run(c, 1, 0.05, False, 0.0, lambda *a: None)
