"""The entry points of the port (`soda_tpu_torch/entry.py`), held
against `__graft_entry__.py` and `soda_tpu` on the CPU.

- `entry(device="cpu")`: its input equals, bit for bit, the array
  `__graft_entry__.entry()` builds (its backend probe replaced by "cpu":
  only the input is taken), and its fn passes `compare_outputs` (f32 1e-4)
  against `soda_tpu.interp.numpy_interp.run` at 128^3;
- without a card, `entry()` and `dryrun_multichip(n)` raise `NoCudaDevice`;
- `dryrun_multichip(n, devices=["cpu"] * n)` for n in 1, 2, 4, 8 (1-D
  meshes at 1 and 2, 2-D at 4 and 8): its own checks pass (bit for bit
  against the port's whole-grid run, the oracle outside `valid_rim(4)`) and
  it reports the reference's shapes;
- n = 4: the same configurations through the port's mesh held against
  `soda_tpu.parallel.mesh` on the 8-device CPU mesh (`build_sharded_fn`
  jitted, as `__graft_entry__.py:128-131` builds it; `run_sharded(jit=True)`
  for jacobi2d_i64), outside `valid_rim(4)`: f32 at the reference's 1e-5,
  int64 bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.parallel import mesh as ref_mesh
from soda_tpu.utils import backend_probe
from soda_tpu.utils.testing import compare_outputs
from soda_tpu_torch import entry
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.parallel import mesh
from soda_tpu_torch.utils.device import NoCudaDevice

torch.set_num_threads(1)


def _ref_program(name):
    return lark_parser.parse_file(entry.SODA / f"{name}.soda")


def test_entry_takes_the_reference_input_and_matches_the_oracle(monkeypatch):
    monkeypatch.setattr(backend_probe, "probe_default_backend", lambda *a, **k: "cpu")
    _, (ref_x,) = __graft_entry__.entry()
    fn, (x,) = entry.entry(device="cpu")
    assert x.device.type == "cpu" and x.dtype == torch.float32
    assert np.array_equal(x.numpy().view(np.uint32), np.asarray(ref_x).view(np.uint32))
    p = _ref_program("jacobi3d")
    got = fn(x)
    assert tuple(got.shape) == entry.ENTRY_GRID
    gold = numpy_interp.run(p, {"t0": x.numpy()}, {})
    assert compare_outputs(p, {"t1": got.numpy()}, gold, 0)


def test_without_a_card_the_entry_points_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        entry.entry()
    with pytest.raises(NoCudaDevice):
        entry.dryrun_multichip(4)


@pytest.mark.parametrize("n,mesh_3d,grid_3d", [
    (1, {"gz": 1}, (11, 16, 128)), (2, {"gz": 2}, (19, 16, 128)),
    (4, {"gz": 2, "gy": 2}, (19, 21, 128)), (8, {"gz": 2, "gy": 4}, (19, 37, 128))])
def test_dryrun_multichip_on_cpu_shards(n, mesh_3d, grid_3d):
    ran = entry.dryrun_multichip(n, devices=["cpu"] * n)
    j, w = ran["jacobi3d"], ran["jacobi2d_i64"]
    assert j["grid"] == grid_3d and j["mesh"] == mesh_3d
    assert w["grid"] == (8 * n + 5, 128) and w["mesh"] == {"gy": n}
    for r in (j, w):
        assert r["devices"] == ["cpu"] * n
        assert r["group_calls"] == n * entry.DRYRUN_ITERATE
        assert (r["exchange_bytes"] > 0) == (n > 1)
        assert sum(r["launches"].values()) == 0     # CPU shards run the plain versions
    assert j["oracle_max_abs_err"] <= entry.ORACLE_TOL


def test_dryrun_configurations_equal_soda_tpu_on_its_cpu_mesh():
    for cfg in entry.dryrun_configs(4):
        p, name, x = cfg["program"], cfg["name"], cfg["x"]
        got = to_numpy(p, mesh.run_sharded(
            p, {"t0": x}, axis_sizes=cfg["sizes"], axis_names=cfg["names"],
            devices=["cpu"] * 4, dims=cfg["dims"], iterate=entry.DRYRUN_ITERATE,
            sweeps_per_exchange=1))["t1"]
        r = _ref_program(name)
        rm = ref_mesh.make_mesh(cfg["sizes"], cfg["names"])
        if name == "jacobi3d":
            fn = jax.jit(ref_mesh.build_sharded_fn(
                r, rm, dims=cfg["dims"], iterate=entry.DRYRUN_ITERATE,
                sweeps_per_exchange=1, grid_shape=cfg["grid"]))
            want = np.asarray(fn({"t0": jnp.asarray(x)}, {})["t1"])
        else:
            want = np.asarray(ref_mesh.run_sharded(
                r, {"t0": x}, mesh=rm, dims=cfg["dims"], iterate=entry.DRYRUN_ITERATE,
                sweeps_per_exchange=1, jit=True)["t1"])
        rim = p.valid_rim(entry.DRYRUN_ITERATE)
        inner = tuple(slice(rim, g - rim) for g in cfg["grid"])
        assert got.shape == want.shape == cfg["grid"]
        if name == "jacobi3d":
            assert np.allclose(got[inner].astype(np.float64), want[inner].astype(np.float64),
                               rtol=entry.ORACLE_TOL, atol=entry.ORACLE_TOL)
        else:
            assert got.dtype == np.int64 and np.array_equal(got[inner], want[inner])
