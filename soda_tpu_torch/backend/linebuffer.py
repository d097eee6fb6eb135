"""The 3-D line-buffer z-march: kernel source, plain version and wrapper.

Replaces `soda_tpu/backend/_linebuffer.py::build_linebuffer_group_fn`:
one fused group of a rank-3 single-sweep program over the whole grid.
`kernel_source` generates the group's CUDA kernel from the IR around the
shared march in `csrc/linebuffer3d.cuh` (see the note there for the design
and what bounds it); `group_plain` is the same group evaluated over full
grids by the plain PyTorch path; `GroupKernel` is the wrapper.

The kernel computes every stage with the oracle's zero-fill semantics: an
input read outside the grid is zero, and so is an intermediate stage's
value there.  It therefore matches the oracle (`interp/numpy_ref.py`) on
the whole grid, for multi-stage groups too.  (The TPU kernel evaluates
stages at constant extent from zero-filled inputs, which differs from the
oracle only inside the rim, `docs/SEMANTICS.md`.)
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch

from ..ir.dtypes import torch_dtype
from ..ir.program import StencilProgram
from ..plan.planner import NTHREADS, GroupPlan
from . import _build
from .cuda_codegen import DeviceGen, ring_var, storage_ctype

# kernel launches made through GroupKernel (the CPU plain path never counts)
LAUNCHES = 0


def _ctype_store(program: StencilProgram, name: str) -> str:
    return storage_ctype(program.tensors[name].type)


def kernel_args(program: StencilProgram, g: GroupPlan) -> tuple[list[str], list[str]]:
    """Declarations and names of a generated kernel's pointer arguments:
    the group's external inputs, params and outputs, in that order (the
    order `GroupKernel.launch` passes them)."""
    args = [f"const {_ctype_store(program, n)}* __restrict__ {n}_g"
            for n in g.external_inputs]
    args += [f"const {storage_ctype(program.params[n].type)}* __restrict__ {n}_p"
             for n in g.params]
    args += [f"{_ctype_store(program, n)}* __restrict__ {n}_g" for n in g.outputs]
    names = ([f"{n}_g" for n in g.external_inputs] + [f"{n}_p" for n in g.params]
             + [f"{n}_g" for n in g.outputs])
    return args, names


def stage_value(gen: DeviceGen, program: StencilProgram, n: str, indent: str,
                renames: Mapping[str, str] | None = None) -> list[str]:
    """Stage `n`'s value at the current cell, stored into `v` in its
    declared type; `renames` rewrites names in the expression."""
    t = program.tensors[n].type
    body, bt = gen.emit(program.tensors[n].expr)
    for a, b in (renames or {}).items():
        body = body.replace(a, b)
    store = gen.cast_to("__v", bt, t)
    return [f"{indent}const {gen.ctype(bt)} __v = {body};",
            f"{indent}v = ({storage_ctype(t)})({store});"]


def entry_points(kernel: str, decl: str, call: str, block: str, grid: str,
                 host_loops: list[str]) -> list[str]:
    """The `__global__` kernel and the C entry `soda_launch` of a generated
    source; under SODA_HOST_EMULATION, `soda_launch` runs `soda_body` for
    every CTA in turn on one thread (`host_loops`)."""
    return ["#ifndef SODA_HOST_EMULATION",
            f'extern "C" __global__ void __launch_bounds__(NT) {kernel}(',
            f"    {decl}) {{",
            "  extern __shared__ __align__(16) unsigned char soda_smem[];",
            f"  soda_body({block}, soda_smem,",
            f"            {call});",
            "}",
            "",
            f'extern "C" int soda_launch({decl}, void* stream) {{',
            "  if (SMEM_BYTES > 48 * 1024) {",
            f"    cudaError_t e = cudaFuncSetAttribute({kernel}, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);",
            "    if (e != cudaSuccess) return (int)e;",
            "  }",
            f"  const dim3 grid({grid});",
            f"  {kernel}<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(",
            f"      {call});",
            "  return (int)cudaGetLastError();",
            "}",
            "#else",
            "#include <vector>",
            f'extern "C" int soda_launch({decl}, void* stream) {{',
            "  (void)stream;",
            "  std::vector<unsigned char> smem(SMEM_BYTES + 16);",
            *host_loops,
            f"      {call});",
            "  return 0;",
            "}",
            "#endif", ""]


def kernel_source(program: StencilProgram, g: GroupPlan) -> str:
    """CUDA C++ for one group under one plan (tile, chunk, rings)."""
    ty, tx = g.tile
    ring_names = [r.name for r in g.rings]
    gen = DeviceGen(program, set(ring_names))
    out_set = set(g.outputs)
    args, names = kernel_args(program, g)
    dims = "int64_t d0, int64_t d1, int64_t d2"

    L = [f"// generated by soda_tpu_torch for kernel `{program.name}`, "
         f"stages {g.stages}",
         '#include "linebuffer3d.cuh"', "",
         "namespace {",
         f"constexpr int TY = {ty}, TX = {tx}, BZ = {g.bz}, NT = {NTHREADS}, "
         f"WARM = {g.warm};",
         f"constexpr size_t SMEM_BYTES = {g.smem_bytes};"]
    for r in g.rings:
        (zlo, zhi), (ylo, _), (xlo, _) = r.span
        L.append(f"// ring {r.name}: span {r.span}")
        L.append(f"constexpr int {r.name}_D = {r.depth}, {r.name}_ZLO = {zlo}, "
                 f"{r.name}_ZHI = {zhi}, {r.name}_YLO = {ylo}, "
                 f"{r.name}_XLO = {xlo}, {r.name}_R = {r.rows}, "
                 f"{r.name}_C = {r.cols}, {r.name}_PS = {r.rows * r.cols};")
        L.append(f"constexpr size_t {r.name}_OFF = {r.offset};")
    L += ["}  // namespace", "",
          "SODA_BODY void soda_body(int bx, int by, int bzi, int tid, int nt, "
          "unsigned char* smem,",
          "                       " + ", ".join(args + [dims]) + ") {"]
    for r in g.rings:
        L.append(f"  {_ctype_store(program, r.name)}* {ring_var(r.name)} = "
                 f"reinterpret_cast<{_ctype_store(program, r.name)}*>"
                 f"(smem + {r.name}_OFF);")
    L += ["  const int64_t y0 = (int64_t)by * TY, x0 = (int64_t)bx * TX;",
          "  const int64_t z0 = (int64_t)bzi * BZ;",
          "  const int64_t zend = z0 + BZ < d0 ? z0 + BZ : d0;",
          "  for (int64_t z = z0 - WARM; z < zend; ++z) {"]
    # 1. the leading plane of every input ring
    for n in g.external_inputs:
        L += [f"    {{  // input {n}",
              f"      const int64_t p = z + {n}_ZHI;",
              f"      if (p >= z0 + {n}_ZLO)",
              f"        soda_load_plane({ring_var(n)} + soda_slot(p, z0 + {n}_ZLO, "
              f"{n}_D) * {n}_PS, {n}_g, p, y0 + {n}_YLO, x0 + {n}_XLO, "
              f"{n}_R, {n}_C, d0, d1, d2, tid, nt);",
              "    }"]
    L.append("    SODA_SYNC();")

    # 2. the leading plane of every ring stage, in topological order
    for n in g.stages:
        if n not in ring_names:
            continue
        st = _ctype_store(program, n)
        L += [f"    {{  // stage {n} (ring)",
              f"      const int64_t p = z + {n}_ZHI;",
              f"      if (p >= z0 + {n}_ZLO) {{",
              f"        {st}* dst = {ring_var(n)} + soda_slot(p, z0 + {n}_ZLO, "
              f"{n}_D) * {n}_PS;",
              f"        for (int i = tid; i < {n}_PS; i += nt) {{",
              f"          const int ly = i / {n}_C + {n}_YLO, "
              f"lx = i % {n}_C + {n}_XLO;",
              "          const int64_t gy = y0 + ly, gx = x0 + lx;",
              f"          {st} v = {st}(0);",
              "          if (p >= 0 && p < d0 && gy >= 0 && gy < d1 && gx >= 0 "
              "&& gx < d2) {"]
        L += stage_value(gen, program, n, "            ")
        if n in out_set:
            L += ["            if (p >= z0 && p < zend && ly >= 0 && ly < TY "
                  "&& lx >= 0 && lx < TX)",
                  f"              {n}_g[(p * d1 + gy) * d2 + gx] = v;"]
        L += ["          }", "          dst[i] = v;", "        }", "      }",
              "    }", "    SODA_SYNC();"]
    # 3. outputs no stage of the group reads: straight to device memory
    direct = [n for n in g.outputs if n not in ring_names]
    if direct:
        L += ["    if (z >= z0) {",
              "      const int64_t p = z;",
              "      for (int i = tid; i < TY * TX; i += nt) {",
              "        const int ly = i / TX, lx = i % TX;",
              "        const int64_t gy = y0 + ly, gx = x0 + lx;",
              "        if (gy < d1 && gx < d2) {"]
        for n in direct:
            L += [f"          {{  // output {n}",
                  f"            {_ctype_store(program, n)} v;"]
            L += stage_value(gen, program, n, "            ")
            L += [f"            {n}_g[(p * d1 + gy) * d2 + gx] = v;",
                  "          }"]
        L += ["        }", "      }", "    }", "    SODA_SYNC();"]
    L += ["  }", "}", ""]

    call = ", ".join(names + ["d0", "d1", "d2"])
    L += entry_points(
        "soda_lb3d_kernel", ", ".join(args + [dims]), call,
        "blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, blockDim.x",
        "(unsigned)((d2 + TX - 1) / TX), (unsigned)((d1 + TY - 1) / TY), "
        "(unsigned)((d0 + BZ - 1) / BZ)",
        ["  for (int bzi = 0; bzi < (int)((d0 + BZ - 1) / BZ); ++bzi)",
         "    for (int by = 0; by < (int)((d1 + TY - 1) / TY); ++by)",
         "      for (int bx = 0; bx < (int)((d2 + TX - 1) / TX); ++bx)",
         "        soda_body(bx, by, bzi, 0, 1, smem.data(),"])
    return "\n".join(L)


def group_plain(program: StencilProgram, g: GroupPlan,
                values: Mapping[str, torch.Tensor],
                params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The group's stages over full grids through the plain PyTorch path
    (`eager.py`): the version the kernel is held against."""
    from .eager import eval_stages

    device = next(iter(values.values())).device
    arrays = {n: values[n] for n in g.external_inputs}
    eval_stages(program, g.stages, arrays, params, device)
    return {o: arrays[o] for o in g.outputs}


class GroupKernel:
    """Wrapper of one group's kernel (kernel 1, rank 3).

    Called on CPU tensors it runs `group_plain`.  Called on CUDA tensors it
    builds the kernel (once), checks every tensor, allocates the outputs
    (unless `out` provides them) and launches on the current stream; it
    never falls back.  `LAUNCHES` counts the launches.

    `linebuffer2d.GroupKernel` (kernel 2, rank 2) is this wrapper with its
    own source, rank and count."""

    rank = 3
    prefix = "lb3d"

    def __init__(self, program: StencilProgram, g: GroupPlan):
        self.program = program
        self.group = g
        self.name = f"{self.prefix}_{program.name}"
        self._source: str | None = None
        self._entry = None          # the loaded C entry, after the first build

    def _generate(self) -> str:
        return kernel_source(self.program, self.group)

    def _count(self) -> None:
        global LAUNCHES
        LAUNCHES += 1

    @property
    def source(self) -> str:
        # generated at first use: the CPU path never needs it
        if self._source is None:
            self._source = self._generate()
        return self._source

    def build(self, emulate: bool = False) -> _build.Built:
        built = _build.build(self.name, self.source, emulate=emulate)
        fn = built.lib.soda_launch
        n_ptr = (len(self.group.external_inputs) + len(self.group.params)
                 + len(self.group.outputs))
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * self.rank
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        if not emulate:
            self._entry = fn
        return built

    def _check(self, name: str, t: torch.Tensor, dtype, shape, device) -> None:
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")

    def launch(self, entry, values, params, outs, stream: int) -> None:
        """Call the C entry (`build().lib.soda_launch`) on tensors already
        checked and allocated."""
        g = self.group
        shape = tuple(values[g.external_inputs[0]].shape)
        ptrs = ([values[n].data_ptr() for n in g.external_inputs]
                + [params[n].data_ptr() for n in g.params]
                + [outs[n].data_ptr() for n in g.outputs])
        rc = entry(*ptrs, *shape, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.prefix} kernel for {self.program.name!r} failed to "
                f"launch: cudaError {rc}")

    def __call__(self, values: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor],
                 out: Mapping[str, torch.Tensor] | None = None
                 ) -> dict[str, torch.Tensor]:
        g, p = self.group, self.program
        operands = [values[n] for n in g.external_inputs] + [params[n] for n in g.params]
        devices = {t.device for t in operands}
        if len(devices) != 1:
            raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
        device = devices.pop()
        if device.type == "cpu":
            return group_plain(p, g, values, params)
        if device.type != "cuda":
            raise ValueError(f"the line-buffer kernel runs on CUDA tensors, got {device}")
        shape = tuple(values[g.external_inputs[0]].shape)
        if len(shape) != self.rank or min(shape) == 0:
            raise ValueError(f"the {self.prefix} kernel takes a non-empty "
                             f"{self.rank}-D grid, got {shape}")
        for n in g.external_inputs:
            self._check(n, values[n], torch_dtype(p.tensors[n].type), shape, device)
        for n in g.params:
            self._check(n, params[n], torch_dtype(p.params[n].type),
                        p.params[n].shape, device)
        outs = {}
        for n in g.outputs:
            dt = torch_dtype(p.tensors[n].type)
            if out is not None and n in out:
                self._check(f"out[{n}]", out[n], dt, shape, device)
                if any(out[n].data_ptr() == t.data_ptr() for t in operands):
                    raise ValueError(f"out[{n}] is also an input of the kernel")
                outs[n] = out[n]
            else:
                outs[n] = torch.empty(shape, dtype=dt, device=device)
        if self._entry is None:
            self.build()
        with torch.cuda.device(device):
            self.launch(self._entry, values, params, outs,
                        torch.cuda.current_stream(device).cuda_stream)
        self._count()
        return outs
