"""The C++ golden runner: the port's second oracle.

The port's copy of `soda_tpu/backend/cpp.py`'s `generate`,
`generate_shared`, `NativeOracle` and `compile_and_run`, on top of the
expression printer the port already copies (`backend/cpp_gen.py::_Gen`).
It generates a standalone C++ program with the DSL's stencil semantics
(zero-fill taps, int64 accumulators, C division, width masking at stores,
float32 literals, per-operation rounding of `half`), compiles it with
g++ and runs it on raw binary tensors: results on the card are checked
against native C++ as well as against the NumPy reference
(`interp/numpy_ref.py`).  Expression evaluation order is the IR's, with
no reassociation.

The generated source is the original's text, character for character,
for every program (`tests/test_torch_copies.py`).  Integers wider than
64 bits are carried as gcc's `__int128` and cross as 16 little-endian
bytes a value, as in the original: `compile_and_run` and `NativeOracle`
take them as object arrays of Python ints or as (..., 2) uint64 words
(`interp/wide128.py::object_to_pairs`), and return object arrays;
`compile_and_run(..., pairs=True)` returns the words instead (no Python
int a cell, for large grids).
"""

from __future__ import annotations

import pathlib
import subprocess
import tempfile
from typing import Mapping

import numpy as np

from ..interp.wide128 import is_wide, object_to_pairs, pairs_to_object
from ..ir.program import StencilProgram
from ..ir.types import ScalarType
from .cpp_gen import _Gen

_HEADER = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

static inline int64_t mask_int(int64_t v, int width, bool is_signed) {
  if (width >= 64) return v;
  uint64_t m = (uint64_t(1) << width) - 1;
  uint64_t u = uint64_t(v) & m;
  if (is_signed) {
    uint64_t sign = uint64_t(1) << (width - 1);
    if (u & sign) return int64_t(u) - (int64_t(1) << width);
  }
  return int64_t(u);
}
// 128-bit carrier variants (gcc native __int128 — quad-limb DSL widths)
static inline __int128 mask_int128(__int128 v, int width, bool is_signed) {
  if (width >= 128) return v;
  unsigned __int128 m = (((unsigned __int128)1) << width) - 1;
  unsigned __int128 u = (unsigned __int128)v & m;
  if (is_signed && ((u >> (width - 1)) & 1)) u |= ~m;
  return (__int128)u;
}
template <typename T> static inline T c_div(T a, T b) { return a / b; }  // C trunc
template <typename T> static inline T c_mod(T a, T b) { return a % b; }
template <typename T> static inline T c_abs(T a) { return a < 0 ? T(-a) : a; }
"""


def _host_array(v, t: ScalarType, shape=None, what: str = "") -> np.ndarray:
    """`v` (`what`, for the error) as a contiguous array in the runner's
    layout: the storage dtype, or 16 bytes a value ((..., 2) uint64 words)
    above 64 bits; its shape checked against `shape` if given."""
    if is_wide(t):
        a = np.asarray(v)
        a = a if a.dtype == np.uint64 else object_to_pairs(a)
        got = a.shape[:-1]
    else:
        a = np.asarray(v, dtype=t.np_dtype())
        got = a.shape
    if shape is not None and tuple(got) != tuple(shape):
        raise ValueError(f"{what} shape {tuple(got)} != {tuple(shape)}")
    return np.ascontiguousarray(a)


def _result(words: np.ndarray, t: ScalarType, pairs: bool) -> np.ndarray:
    """An output in the runner's layout as the caller asked for it."""
    if is_wide(t) and not pairs:
        return pairs_to_object(words, t.is_signed)
    return words


def _out_buffer(t: ScalarType, shape) -> np.ndarray:
    if is_wide(t):
        return np.empty(tuple(shape) + (2,), dtype=np.uint64)
    return np.empty(shape, dtype=t.np_dtype())


def generate(program: StencilProgram, grid_shape: tuple[int, ...],
             iterate: int | None = None) -> str:
    """Generate a standalone C++ golden runner.

    CLI of the generated binary:
        ./golden <in0.bin> [<in1.bin> ...] [<param0.bin> ...] <out0.bin> [...]
    Raw little-endian row-major arrays in declared storage dtypes."""
    it = max(program.iterate if iterate is None else iterate, 1)
    rank = program.rank
    idx = [f"i{d}" for d in range(rank)]
    g = _Gen(program, idx)

    lines = [_HEADER]
    lines.append(f"// generated by soda_tpu for kernel `{program.name}`")
    lines.append("int main(int argc, char** argv) {")
    for d, n in enumerate(grid_shape):
        lines.append(f"  const size_t d{d} = {n};")
    lines.append(f"  const size_t total = {'*'.join(f'd{d}' for d in range(rank))};")

    order = program.stage_order()
    argi = 1
    loads = []
    for n in program.input_names:
        t = program.tensors[n].type
        lines.append(f"  std::vector<{t.cpp_type()}> {n}_a(total);")
        loads.append((n, t, argi))
        argi += 1
    for p in program.params.values():
        cnt = int(np.prod(p.shape)) if p.shape else 1
        lines.append(f"  std::vector<{p.type.cpp_type()}> {p.name}_p({cnt});")
        loads.append((p.name + "_p@", p.type, argi))
        argi += 1
    for n in order:
        t = program.tensors[n].type
        lines.append(f"  std::vector<{t.cpp_type()}> {n}_a(total);")
    out_args = {}
    for n in program.output_names:
        out_args[n] = argi
        argi += 1
    lines.append(f"  if (argc != {argi}) {{ std::fprintf(stderr, \"expected {argi-1} file args\\n\"); return 2; }}")
    for name, t, ai in loads:
        vec = name[:-1] if name.endswith("@") else name + "_a"
        lines.append(f"  {{ FILE* f = std::fopen(argv[{ai}], \"rb\");")
        lines.append(f"    if (!f || std::fread({vec}.data(), sizeof({t.cpp_type()}), {vec}.size(), f) != {vec}.size()) {{ std::fprintf(stderr, \"read %s failed\\n\", argv[{ai}]); return 2; }} std::fclose(f); }}")

    lines.append(f"  for (int sweep = 0; sweep < {it}; ++sweep) {{")
    for n in order:
        t = program.tensors[n].type
        body, bt = g.emit(program.tensors[n].expr)
        loop = "    "
        for d in range(rank):
            lines.append(f"{loop}for (int64_t i{d} = 0; i{d} < (int64_t)d{d}; ++i{d})")
            loop += "  "
        store = g.cast_to(f"__v_{n}", bt, t)
        lin = g._lin([f"i{d}" for d in range(rank)])
        lines.append(f"{loop}{{ {g.ctype(bt)} __v_{n} = {body};")
        lines.append(f"{loop}  {n}_a[{lin}] = ({t.cpp_type()})({store}); }}")
    if it > 1:
        i0, o0 = program.input_names[0], program.output_names[0]
        lines.append(f"    if (sweep + 1 < {it}) {i0}_a = {o0}_a;")
    lines.append("  }")

    for n, ai in out_args.items():
        t = program.tensors[n].type
        lines.append(f"  {{ FILE* f = std::fopen(argv[{ai}], \"wb\");")
        lines.append(f"    std::fwrite({n}_a.data(), sizeof({t.cpp_type()}), {n}_a.size(), f); std::fclose(f); }}")
    lines.append("  return 0;\n}")
    return "\n".join(lines)


_SHARED_TEMPLATE = r"""
// shared-library entry: in-process oracle callable via ctypes
extern "C" int soda_golden_run(%(args)s) {
%(body)s
  return 0;
}
"""


def generate_shared(program: StencilProgram, grid_shape: tuple[int, ...],
                    iterate: int | None = None) -> str:
    """Generate a shared-library variant of the golden runner.

    Exposes `int soda_golden_run(const <t0>* in0, ..., const <p0>* par0,
    ..., <o0>* out0, ...)` operating on caller-owned row-major buffers — the
    in-process native oracle (ctypes binding in NativeOracle), avoiding
    subprocess + file IO per verification."""
    it = max(program.iterate if iterate is None else iterate, 1)
    rank = program.rank
    idx = [f"i{d}" for d in range(rank)]
    g = _Gen(program, idx)
    order = program.stage_order()

    args = []
    for n in program.input_names:
        args.append(f"const {program.tensors[n].type.cpp_type()}* {n}_in")
    for p in program.params.values():
        args.append(f"const {p.type.cpp_type()}* {p.name}_p")
    for n in program.output_names:
        args.append(f"{program.tensors[n].type.cpp_type()}* {n}_out")

    body = []
    for d, n in enumerate(grid_shape):
        body.append(f"  const size_t d{d} = {n};")
    body.append(f"  const size_t total = {'*'.join(f'd{d}' for d in range(rank))};")
    for n in program.input_names:
        t = program.tensors[n].type
        body.append(f"  std::vector<{t.cpp_type()}> {n}_a({n}_in, {n}_in + total);")
    for n in order:
        t = program.tensors[n].type
        body.append(f"  std::vector<{t.cpp_type()}> {n}_a(total);")
    body.append(f"  for (int sweep = 0; sweep < {it}; ++sweep) {{")
    for n in order:
        t = program.tensors[n].type
        expr_code, bt = g.emit(program.tensors[n].expr)
        loop = "    "
        for d in range(rank):
            body.append(f"{loop}for (int64_t i{d} = 0; i{d} < (int64_t)d{d}; ++i{d})")
            loop += "  "
        store = g.cast_to(f"__v_{n}", bt, t)
        lin = g._lin([f"i{d}" for d in range(rank)])
        body.append(f"{loop}{{ {g.ctype(bt)} __v_{n} = {expr_code};")
        body.append(f"{loop}  {n}_a[{lin}] = ({t.cpp_type()})({store}); }}")
    if it > 1:
        i0, o0 = program.input_names[0], program.output_names[0]
        body.append(f"    if (sweep + 1 < {it}) {i0}_a = {o0}_a;")
    body.append("  }")
    for n in program.output_names:
        t = program.tensors[n].type
        body.append(
            f"  std::memcpy({n}_out, {n}_a.data(), total * sizeof({t.cpp_type()}));")

    return _HEADER + _SHARED_TEMPLATE % {
        "args": ", ".join(args), "body": "\n".join(body)}


def _gxx(args: list[str], cwd: pathlib.Path) -> None:
    r = subprocess.run(["g++", "-O2", "-std=c++17", *args], cwd=cwd,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ refused the golden runner:\n{r.stderr}")


class NativeOracle:
    """In-process C++ golden oracle: the runner of `generate_shared`,
    compiled by g++ into a shared library and bound with ctypes (no
    subprocess and no file IO per check).  The library is built in a
    temporary directory (or `workdir`), which is removed once it is
    loaded unless it was given."""

    def __init__(self, program: StencilProgram, grid_shape: tuple[int, ...],
                 iterate: int | None = None,
                 workdir: str | pathlib.Path | None = None):
        import ctypes

        self.program = program
        self.grid_shape = tuple(grid_shape)
        src = generate_shared(program, self.grid_shape, iterate)
        with tempfile.TemporaryDirectory(prefix="soda_oracle_") as tmp:
            d = pathlib.Path(workdir or tmp)
            d.mkdir(parents=True, exist_ok=True)
            (d / "oracle.cpp").write_text(src)
            _gxx(["-shared", "-fPIC", "-o", "oracle.so", "oracle.cpp"], d)
            self._lib = ctypes.CDLL(str(d / "oracle.so"))
        self._fn = self._lib.soda_golden_run
        n_ptr = (len(program.input_names) + len(program.params)
                 + len(program.output_names))
        self._fn.argtypes = [ctypes.c_void_p] * n_ptr
        self._fn.restype = ctypes.c_int

    def run(self, inputs: Mapping[str, np.ndarray],
            params: Mapping[str, np.ndarray] | None = None) -> dict[str, np.ndarray]:
        params = dict(params or {})
        p = self.program
        bufs = [_host_array(inputs[n], p.tensors[n].type, self.grid_shape, f"input {n!r}")
                for n in p.input_names]
        bufs += [_host_array(params[pr.name], pr.type, pr.shape, f"param {pr.name!r}")
                 for pr in p.params.values()]
        outs = {n: _out_buffer(p.tensors[n].type, self.grid_shape)
                for n in p.output_names}
        bufs += outs.values()
        rc = self._fn(*(b.ctypes.data for b in bufs))
        if rc != 0:
            raise RuntimeError(f"native oracle failed rc={rc}")
        return {n: _result(a, p.tensors[n].type, False) for n, a in outs.items()}


def compile_and_run(
    program: StencilProgram,
    inputs: Mapping[str, np.ndarray],
    params: Mapping[str, np.ndarray] | None = None,
    iterate: int | None = None,
    workdir: str | pathlib.Path | None = None,
    pairs: bool = False,
) -> dict[str, np.ndarray]:
    """Generate, g++ -O2 compile, and execute the golden runner, in a
    temporary directory (removed afterwards) unless `workdir` is given;
    returns the outputs in their declared storage dtypes (integers wider
    than 64 bits: object arrays of Python ints, or (..., 2) uint64 words
    with `pairs`)."""
    params = dict(params or {})
    first = program.tensors[program.input_names[0]].type
    grid_shape = _host_array(inputs[program.input_names[0]], first).shape
    grid_shape = tuple(grid_shape[:program.rank])
    src = generate(program, grid_shape, iterate)
    with tempfile.TemporaryDirectory(prefix="soda_golden_") as tmp:
        d = pathlib.Path(workdir or tmp)
        d.mkdir(parents=True, exist_ok=True)
        (d / "golden.cpp").write_text(src)
        _gxx(["-o", "golden", "golden.cpp"], d)

        def tofile(arr, t: ScalarType, name: str) -> str:
            _host_array(arr, t).tofile(d / name)
            return str(d / name)

        args = [str(d / "golden")]
        args += [tofile(inputs[n], program.tensors[n].type, f"in_{n}.bin")
                 for n in program.input_names]
        args += [tofile(params[p.name], p.type, f"par_{p.name}.bin")
                 for p in program.params.values()]
        args += [str(d / f"out_{n}.bin") for n in program.output_names]
        r = subprocess.run(args, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"the golden runner exited {r.returncode}:\n{r.stderr}")
        res = {}
        for n in program.output_names:
            t = program.tensors[n].type
            shape = _out_buffer(t, grid_shape).shape
            words = np.fromfile(d / f"out_{n}.bin", dtype=np.uint64 if is_wide(t)
                                else t.np_dtype()).reshape(shape)
            res[n] = _result(words, t, pairs)
        return res
