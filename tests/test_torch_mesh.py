"""The device mesh in the port (`soda_tpu_torch/parallel/mesh.py`), held
against `soda_tpu/parallel/mesh.py` on the 8-device CPU mesh that
`tests/conftest.py` forces; the port's shards are `["cpu"] * n`.

The cases of `tests/test_mesh.py`, on the same inputs (made from a numpy
seed):
- `halo_exchange` equals the reference's under `shard_map`, multi-hop
  halos included, bit for bit;
- `run_sharded` on 1-, 2- and 3-D meshes, `iterate` at cadences 1, 4 and
  automatic, nested and automatic per-axis cadences, uneven grids (pad to
  shard), a grid smaller than the mesh, rank 1, auxiliary inputs,
  multi-output, `half`, int64 (native in the port, plane pairs in the
  reference) and f64.  Tolerance: `compare_outputs` against the reference
  (integers bit for bit) on the whole grid, rim included, for single-stage
  programs (deeper cadences differ from a whole-grid run inside
  `valid_rim()` in both alike), outside the rim for multi-stage ones (the
  reference evaluates their stages in zero halos past the grid's edge);
  bit for bit against the port's own whole-grid `cuda.run(device="cpu")`
  outside the rim, and on the whole grid for single-stage programs at one
  sweep an exchange and for multi-stage programs on one level of exchanges
  over a grid the mesh divides evenly (their edge shards' windows move
  inside the grid);
- the overlap chunk equals the synchronous one bit for bit on every case,
  and the `"eager"` local backend equals `"cuda"` bit for bit;
- two cases against the reference's Pallas local backend in interpret
  mode;
- `choose_exchange_cadence` equals the reference's where the link model
  decides (pathologically slow and fast links) and differs by design at
  the defaults (the H100's rate and links), pinned; the link-model hook
  and its error text; the typed rejections;
- the overlap's short boundary slabs (3 rows at one sweep) plan to kernels
  1 and 2, and the fused cascade, whose host emulation equals the plain
  version bit for bit;
- the bytes exchanged equal `host_tile.model_mesh_exchange`.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from soda_tpu.frontend import parser as lark_parser
from soda_tpu.parallel import mesh as ref_mesh
from soda_tpu_torch.backend import cuda
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.ir.types import UnsupportedTypeError
from soda_tpu_torch.parallel import host_tile, mesh
from soda_tpu_torch.utils.device import NoCudaDevice
from soda_tpu_torch.utils.testing import (U64_SOURCES, build_emulated, compare_outputs,
                                          rand_inputs, u64_inputs)

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
M64 = ("kernel: m64\niterate: 4\ninput int64: a(128, *)\n"
       "output int64: out(0,0) = a(-1,0) + a(1,0) * int64(3)"
       " + (a(0,-1) >> 2) + a(0,1)\n")
MW = ("kernel: mw\niterate: 8\ninput int64: a(128, *)\n"
      "output int64: out(0,0) = a(-1,0) + a(1,0) + a(0,-1) + a(0,1)\n")
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in (
    "jacobi2d", "seidel2d", "jacobi3d", "denoise3d", "blur", "heat3d",
    "residual2d", "denoise2p", "gaussian2d", "poisson_f64", "accum64",
    "jacobi2d_i64", "smooth_half", "smooth1d", "accum128")}
SOURCES.update(m64=M64, mw=MW, u64_2d=U64_SOURCES["u64_2d"])
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}
# the reference's link classes and the port's for the same axes
REF_LINKS = {"dcn": "dcn", "x": "ici"}
PORT_LINKS = {"dcn": mesh.SLOW_LINK, "x": mesh.FAST_LINK}

# name -> (program, grid, run_sharded's arguments); "names" builds a named
# mesh (both packages' make_mesh), "links" the link classes above
CASES = {
    "jacobi2d-8": ("jacobi2d", (64, 96), dict(axis_sizes=[8])),
    "seidel2d-8": ("seidel2d", (64, 96), dict(axis_sizes=[8])),
    "jacobi2d-8-every-sweep": ("jacobi2d", (64, 96), dict(axis_sizes=[8], sweeps_per_exchange=1)),
    "jacobi2d-8-cadence-4": ("jacobi2d", (64, 96), dict(axis_sizes=[8], sweeps_per_exchange=4)),
    "jacobi3d-2x4": ("jacobi3d", (16, 32, 48), dict(axis_sizes=[2, 4], dims=[0, 1])),
    "denoise3d-4": ("denoise3d", (16, 32, 48), dict(axis_sizes=[4], dims=[0])),
    "blur-8": ("blur", (64, 64), dict(axis_sizes=[8])),
    "heat3d-8": ("heat3d", (24, 32, 40), dict(axis_sizes=[8], dims=[0])),
    "residual2d-8": ("residual2d", (64, 96), dict(axis_sizes=[8])),
    "denoise2p-4": ("denoise2p", (64, 128), dict(axis_sizes=[4])),
    "denoise2p-4-cadence-2": ("denoise2p", (64, 128), dict(axis_sizes=[4], sweeps_per_exchange=2)),
    "gaussian2d-multihop": ("gaussian2d", (8, 128), dict(axis_sizes=[8], dims=[0])),
    "jacobi2d-multihop": ("jacobi2d", (32, 128), dict(axis_sizes=[8], dims=[0], iterate=8,
                                                      sweeps_per_exchange=8)),
    "poisson_f64-dcn-2x4": ("poisson_f64", (64, 96), dict(names=("dcn", "x"), axis_sizes=[2, 4])),
    "m64-8": ("m64", (64, 128), dict(axis_sizes=[8])),
    "m64-2x4": ("m64", (64, 128), dict(names=("y", "x"), axis_sizes=[2, 4])),
    "accum64-uneven": ("accum64", (50, 251), dict(axis_sizes=[8])),
    "jacobi2d_i64-4": ("jacobi2d_i64", (64, 96), dict(axis_sizes=[4])),
    "smooth_half-8": ("smooth_half", (64, 96), dict(axis_sizes=[8])),
    "jacobi2d-uneven-every-sweep": ("jacobi2d", (100, 252), dict(axis_sizes=[8],
                                                                 sweeps_per_exchange=1)),
    "jacobi2d-uneven-cadence-2": ("jacobi2d", (100, 251), dict(axis_sizes=[8],
                                                               sweeps_per_exchange=2)),
    "jacobi3d-uneven-4x2": ("jacobi3d", (20, 21, 128), dict(axis_sizes=[4, 2], dims=[0, 1],
                                                             iterate=2, sweeps_per_exchange=1)),
    "jacobi2d-smaller-than-mesh": ("jacobi2d", (5, 128), dict(axis_sizes=[8],
                                                              sweeps_per_exchange=1)),
    "smooth1d-uneven": ("smooth1d", (999,), dict(axis_sizes=[8], dims=[0])),
    "nested-4-2": ("jacobi2d", (64, 96), dict(names=("dcn", "x"), axis_sizes=[2, 4],
                                              sweeps_per_exchange={"dcn": 4, "x": 2})),
    "nested-8-2": ("jacobi2d", (64, 96), dict(names=("dcn", "x"), axis_sizes=[2, 4],
                                              sweeps_per_exchange={"dcn": 8, "x": 2})),
    "nested-aux": ("denoise2p", (64, 64), dict(names=("dcn", "x"), axis_sizes=[2, 2], iterate=4,
                                               sweeps_per_exchange={"dcn": 4, "x": 2})),
    "nested-i64": ("mw", (64, 96), dict(names=("dcn", "x"), axis_sizes=[2, 4],
                                        sweeps_per_exchange={"dcn": 4, "x": 2})),
    "auto-cadence": ("heat3d", (32, 32, 64), dict(names=("dcn", "x"), axis_sizes=[2, 4],
                                                  links=True)),
    "uniform-mapping": ("jacobi2d", (64, 96), dict(names=("dcn", "x"), axis_sizes=[2, 4],
                                                   sweeps_per_exchange={"dcn": 2, "x": 2})),
    "u64_2d-4": ("u64_2d", (64, 96), dict(axis_sizes=[4])),
}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _inputs(name, grid, seed=5):
    return u64_inputs(PROGRAMS[name], grid, np.random.default_rng(seed))


def _port_kwargs(kw):
    kw = dict(kw)
    names, links = kw.pop("names", None), kw.pop("links", False)
    sizes = kw.pop("axis_sizes")
    devices = ["cpu"] * int(np.prod(sizes))
    kw["mesh"] = mesh.make_mesh(sizes, names, devices)
    if links:
        kw["link_classes"] = PORT_LINKS
    return kw


def _ref_kwargs(kw):
    kw = dict(kw)
    names, links = kw.pop("names", None), kw.pop("links", False)
    sizes = kw.pop("axis_sizes")
    kw["mesh"] = ref_mesh.make_mesh(sizes, names)
    if links:
        kw["link_classes"] = REF_LINKS
    return kw


def _port(name, ins, ps, **kw):
    p = PROGRAMS[name]
    return to_numpy(p, mesh.run_sharded(p, ins, ps, **_port_kwargs(kw)))


def _ref(name, ins, ps, **kw):
    outs = ref_mesh.run_sharded(REF[name], ins, ps, **_ref_kwargs(kw))
    return {k: np.asarray(v) for k, v in outs.items()}


def test_make_mesh_takes_named_devices_and_refuses_too_few():
    m = mesh.make_mesh([2, 4], ["dcn", "x"], ["cpu"] * 8)
    assert m.shape == {"dcn": 2, "x": 4} and m.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert mesh.make_mesh([3], devices=["cpu"] * 5).axis_names == ("ax0",)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        mesh.make_mesh([2, 2], devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="name each of the 2 axes once"):
        mesh.make_mesh([2, 2], ["x", "x"], ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            mesh.make_mesh([2])
        with pytest.raises(NoCudaDevice):
            mesh.run_sharded(PROGRAMS["jacobi2d"], {"t0": np.zeros((8, 8), np.float32)},
                             axis_sizes=[2])


@pytest.mark.parametrize("n,shape,dim,lo,hi", [
    (4, (32, 16), 0, 2, 2),
    (8, (16, 6), 0, 5, 3),      # 2-row shards: 3- and 2-hop halos
    (4, (8, 32), 1, 1, 3),
    (8, (8, 40), 0, 0, 4),      # 1-row shards, high side only
])
def test_halo_exchange_equals_the_reference(n, shape, dim, lo, hi):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    spec = PartitionSpec(*[("x" if d == dim else None) for d in range(len(shape))])
    m = ref_mesh.make_mesh([n], ["x"])
    want = np.asarray(jax.jit(jax.shard_map(
        lambda v: ref_mesh.halo_exchange(v, dim, lo, hi, "x"),
        mesh=m, in_specs=spec, out_specs=spec))(x))
    shards = torch.from_numpy(x).chunk(n, dim)
    got = torch.cat(mesh.halo_exchange(shards, dim, lo, hi), dim).numpy()
    assert got.shape == want.shape
    assert np.array_equal(_bits(got), _bits(want))


def _cadence_one(p, kw) -> bool:
    it = kw.get("iterate", max(p.iterate, 1))
    return it == 1 or kw.get("sweeps_per_exchange") == 1


def _exact(p, grid, kw) -> bool:
    """The sharded fn equals the whole-grid run on the whole grid, rim
    included: a single-stage program at one sweep an exchange; a
    multi-stage program on one level of exchanges (its edge shards' windows
    move inside the grid) over a grid the mesh divides evenly."""
    if len(p.stage_order()) == 1:
        return _cadence_one(p, kw)
    cad = kw.get("sweeps_per_exchange")
    one_level = not isinstance(cad, dict) or len(set(cad.values())) == 1
    dims = kw.get("dims", range(len(kw["axis_sizes"])))
    return one_level and all(grid[d] % m == 0 for m, d in zip(kw["axis_sizes"], dims))


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_sharded_equals_the_reference_and_the_whole_grid(case):
    name, grid, kw = CASES[case]
    p, r = PROGRAMS[name], REF[name]
    ins, ps = _inputs(name, grid)
    got = _port(name, ins, ps, **kw)
    rim = p.valid_rim(kw.get("iterate"))
    # the reference (its own local compute: f32/int32, int64 plane pairs), on
    # the whole grid for a single stage: inside the rim both differ from a
    # whole-grid run alike; outside the rim for several, whose stages the
    # reference evaluates in zero halos past the grid's edge
    single = len(p.stage_order()) == 1
    assert compare_outputs(r, got, _ref(name, ins, ps, **kw), 0 if single else rim)
    # the port's whole-grid run: the same arithmetic cell for cell
    whole = to_numpy(p, cuda.run(p, ins, ps, device="cpu", iterate=kw.get("iterate")))
    exact = _exact(p, grid, kw)
    inner = tuple(slice(0, g) if exact else slice(rim, g - rim) for g in grid)
    for k in whole:
        assert got[k].dtype == whole[k].dtype and got[k].shape == grid
        assert np.array_equal(_bits(got[k][inner]), _bits(whole[k][inner])), k
    # the overlap chunk and the plain sweeps as the local backend, bit for bit
    for other in (dict(kw, overlap=True), dict(kw, local_backend="eager")):
        again = _port(name, ins, ps, **other)
        for k in got:
            assert np.array_equal(_bits(again[k]), _bits(got[k])), (other, k)


@pytest.mark.parametrize("name,grid,kw", [
    ("jacobi3d", (16, 32, 128), dict(axis_sizes=[4], dims=[0])),
    ("jacobi2d", (64, 96), dict(axis_sizes=[4], dims=[0], sweeps_per_exchange=2)),
])
def test_equals_the_reference_pallas_local_backend(name, grid, kw):
    ins, ps = _inputs(name, grid, seed=7)
    want = _ref(name, ins, ps, local_backend="pallas", interpret=True, **kw)
    got = _port(name, ins, ps, **kw)
    assert compare_outputs(REF[name], got, want, PROGRAMS[name].valid_rim())


def test_choose_exchange_cadence_where_the_links_decide_and_at_the_defaults():
    p, r = PROGRAMS["jacobi2d"], REF["jacobi2d"]      # iterate 8
    pm = mesh.make_mesh([2, 4], ["dcn", "x"], ["cpu"] * 8)
    rm = ref_mesh.make_mesh([2, 4], ["dcn", "x"])
    saved, ref_saved = dict(mesh.LINK_MODEL), dict(ref_mesh.LINK_MODEL)
    try:
        # a pathologically slow link between hosts, a free one within
        mesh.set_link_model(f"{mesh.SLOW_LINK}=0.01:0.5,{mesh.FAST_LINK}=1e9:0")
        ref_mesh.set_link_model("dcn=0.01:0.5,ici=1e9:0")
        for grid in ((256, 2048), (64, 96)):
            want = ref_mesh.choose_exchange_cadence(r, grid, rm, [0, 1], 8, REF_LINKS)
            got = mesh.choose_exchange_cadence(p, grid, pm, [0, 1], 8, PORT_LINKS)
            assert got == want == {"dcn": 8, "x": 1}
    finally:
        mesh.LINK_MODEL.clear()
        mesh.LINK_MODEL.update(saved)
        ref_mesh.LINK_MODEL.update(ref_saved)
    # the defaults, by design apart: on heat3d 512^3 the port's fast axis
    # exchanges 16 sweeps apart, the TPU model's 2 (the H100's halo
    # recompute is cheap beside a 28 us NVLink exchange, measured by
    # scripts/torch_mesh_cards.py; the v5e's ICI takes 2 us)
    h, rh = PROGRAMS["heat3d"], REF["heat3d"]
    got = mesh.choose_exchange_cadence(h, (512,) * 3, pm, (0, 1), 16, PORT_LINKS)
    want = ref_mesh.choose_exchange_cadence(rh, (512,) * 3, rm, (0, 1), 16, REF_LINKS)
    assert got == {"dcn": 16, "x": 16} and want == {"dcn": 16, "x": 2}


def test_link_model_hook_and_its_error_text():
    p = PROGRAMS["jacobi2d"]
    pm = mesh.make_mesh([2, 4], ["dcn", "x"], ["cpu"] * 8)
    saved = dict(mesh.LINK_MODEL)
    try:
        fast = mesh.choose_exchange_cadence(p, (256, 2048), pm, [0, 1], 8, PORT_LINKS)
        mesh.set_link_model(f"{mesh.SLOW_LINK}=0.01:0.5")
        slow = mesh.choose_exchange_cadence(p, (256, 2048), pm, [0, 1], 8, PORT_LINKS)
        assert slow["dcn"] >= fast["dcn"] and slow["dcn"] == 8
        mesh.set_link_model("custom=3:1e-3")
        assert mesh.LINK_MODEL["custom"] == (3.0, 1e-3)
    finally:
        mesh.LINK_MODEL.clear()
        mesh.LINK_MODEL.update(saved)
    for bad in ("garbage", "nvlink=fast:1", "ib=3"):
        with pytest.raises(ValueError, match="bad --link-model entry .* expected class=GBps"):
            mesh.set_link_model(bad)


def test_the_typed_rejections():
    p = PROGRAMS["jacobi2d"]
    x = {"t0": np.zeros((64, 96), np.float32)}
    cpu8 = ["cpu"] * 8
    m = mesh.make_mesh([2, 4], ["dcn", "x"], cpu8)
    with pytest.raises(ValueError, match="divisor chain"):
        mesh.run_sharded(p, x, mesh=m, iterate=6, sweeps_per_exchange={"dcn": 3, "x": 2})
    with pytest.raises(ValueError, match="must divide iterate 8"):
        mesh.run_sharded(p, x, mesh=m, sweeps_per_exchange={"dcn": 3, "x": 1})
    with pytest.raises(ValueError, match="sweeps_per_exchange 3 must divide iterate 8"):
        mesh.run_sharded(p, x, axis_sizes=[8], devices=cpu8, sweeps_per_exchange=3)
    with pytest.raises(ValueError, match="cannot shard a grid of rank 2"):
        mesh.run_sharded(p, x, axis_sizes=[2, 2, 2], devices=cpu8)
    with pytest.raises(ValueError, match="distinct dims of a grid of rank 2"):
        mesh.run_sharded(p, x, mesh=m, dims=[0, 2])
    with pytest.raises(ValueError, match="local_backend is 'cuda' or 'eager'"):
        mesh.run_sharded(p, x, mesh=m, local_backend="pallas")
    with pytest.raises(UnsupportedTypeError, match="wider than 64 bits.*--backend eager"):
        mesh.build_sharded_fn(PROGRAMS["accum128"], m, grid_shape=(64, 96))


def test_overlap_slabs_plan_and_run_through_the_kernels():
    """The overlap's boundary slabs are 2·lo + hi rows: 3 at one sweep
    (kernels 1 and 2), 24 for jacobi2d's 8 fused sweeps (the cascade).  The
    plans the sharded fn made for them, built as host emulation, equal the
    plain versions bit for bit."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")
    runs = [("jacobi3d", (16, 32, 48), dict(axis_sizes=[2, 2], dims=[0, 1])),
            ("jacobi2d", (64, 96), dict(axis_sizes=[2], dims=[1], sweeps_per_exchange=1)),
            ("jacobi2d", (64, 96), dict(axis_sizes=[4]))]
    kernels = []
    for name, grid, kw in runs:
        p = PROGRAMS[name]
        fn = mesh.build_sharded_fn(p, mesh.make_mesh(kw["axis_sizes"], devices=["cpu"] * 4),
                                   grid_shape=grid, dims=kw["dims"] if "dims" in kw else None,
                                   sweeps_per_exchange=kw.get("sweeps_per_exchange"),
                                   overlap=True)
        ins, ps = _inputs(name, grid, seed=8)
        fn({k: torch.from_numpy(v) for k, v in ins.items()}, {})
        plans = fn.local_plans()
        short = [s for s, _ in plans if min(s) == 3 or s[0] == 24]
        assert short, plans
        for (shape, n), pl in plans.items():
            kernels += [(p, shape, cuda.group_kernel(p, g)) for g in pl.groups]
    build_emulated([k for _, _, k in kernels])
    for p, shape, k in kernels:
        ins, _ = rand_inputs(p, shape, np.random.default_rng(9))
        values = {n: torch.from_numpy(v) for n, v in ins.items()}
        want = k(values, {})
        outs = {o: torch.empty(shape, dtype=want[o].dtype) for o in k.group.outputs}
        k.launch(k.build(emulate=True).lib.soda_launch, values, {}, outs, 0)
        for o in outs:
            assert torch.equal(outs[o], want[o]), (p.name, shape, o)


@pytest.mark.parametrize("name,grid,sizes,dims", [
    ("jacobi2d", (30, 40), [3], [0]),
    ("denoise2p", (30, 45), [3, 3], [0, 1]),
    ("jacobi3d", (12, 18, 20), [3, 3], [1, 2]),
    ("blur", (30, 36), [3, 3], [1, 0]),
])
def test_exchanged_bytes_equal_the_model(name, grid, sizes, dims):
    """One exchange at the cadence of the whole iterate: the shards' bytes
    in all = the model's bytes of a device in the middle x 2 along each line
    of an axis (its two ends receive one side each) x the lines; x 3 for a
    multi-stage program, whose two ends' windows move inside the grid and
    take both sides from their one neighbour."""
    p = PROGRAMS[name]
    nf = max(p.iterate, 1)
    m = mesh.make_mesh(sizes, devices=["cpu"] * int(np.prod(sizes)))
    fn = mesh.build_sharded_fn(p, m, grid_shape=grid, dims=dims, sweeps_per_exchange=nf)
    ins, ps = _inputs(name, grid, seed=10)
    fn({k: torch.from_numpy(v) for k, v in ins.items()}, {})
    per_dev, shard = host_tile.model_mesh_exchange(p, grid, sizes, dims, nf)
    # every axis has 3 shards: each of its lines moves 2 (or 3) x a middle
    # device's
    moved = 2 if len(p.stage_order()) == 1 else 3
    lines = moved * int(np.prod(sizes)) // 3
    assert fn.stats["exchange_bytes"] == per_dev * lines
    creep = p.chain_creep()
    assert shard == tuple(s + (nf * (creep[d][1] - creep[d][0]) if d in dims else 0)
                          for d, s in enumerate(fn.shard_shape))


# denoise3d (three stages, the fixed rhs) on CPU shards: grid, mesh, dims
MULTI_STAGE = [((16, 32, 48), [4], [0]), ((20, 12, 16), [2, 2], [0, 1]),
               ((20, 12, 16), [2], [1])]


def _resident_calls(grid, sizes, dims, calls=3):
    """denoise3d kept on CPU shards for `calls` calls, u fed back and rhs
    fixed, beside the whole-grid plain path: (sharded, whole) a call."""
    from soda_tpu_torch.parallel.sharded import gather_grid, shard_grid

    p = PROGRAMS["denoise3d"]
    g = torch.Generator().manual_seed(2)
    x = {"u": torch.rand(grid, generator=g), "rhs": torch.rand(grid, generator=g)}
    m = mesh.make_mesh(sizes, devices=["cpu"] * int(np.prod(sizes)))
    fn = mesh.build_sharded_fn(p, m, grid_shape=grid, dims=dims)
    whole = cuda.build_fn(p, grid_shape=grid)
    state = {n: shard_grid(t, m, fn.dims) for n, t in x.items()}
    u, out = x["u"], []
    for _ in range(calls):
        state["u"] = fn(state, {})["unew"]
        u = whole({"u": u, "rhs": x["rhs"]}, {})["unew"]
        out.append((gather_grid(state["u"], "cpu"), u))
    return out


@pytest.mark.parametrize("grid,sizes,dims", MULTI_STAGE)
def test_a_multi_stage_program_equals_the_whole_grid_everywhere(grid, sizes, dims):
    """Bit for bit the whole-grid run on the whole grid, its faces along
    the sharded dims included: an edge shard's window lies inside the grid,
    so its intermediate stages are zero outside the grid, as the whole
    grid's are."""
    for got, want in _resident_calls(grid, sizes, dims):
        assert np.array_equal(_bits(got.numpy()), _bits(want.numpy()))


def test_no_buffer_is_read_before_it_is_written(monkeypatch):
    """Every tensor that `torch.empty` or `torch.empty_like` makes while the
    sharded fn is built and called, its buffers included, is NaN until
    written: a read of unwritten memory shows on every run."""
    real_empty, real_like = torch.empty, torch.empty_like

    def poisoned(t):
        return t.fill_(float("nan")) if t.dtype.is_floating_point else t.fill_(-1)

    monkeypatch.setattr(torch, "empty", lambda *a, **k: poisoned(real_empty(*a, **k)))
    monkeypatch.setattr(torch, "empty_like", lambda *a, **k: poisoned(real_like(*a, **k)))
    for got, want in _resident_calls((20, 12, 16), [2, 2], [0, 1]):
        assert not got.isnan().any()
        assert np.array_equal(_bits(got.numpy()), _bits(want.numpy()))
