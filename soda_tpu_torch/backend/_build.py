"""Build generated CUDA sources into shared libraries and load them.

The counterpart of Mosaic compilation and `soda_tpu`'s `.jax_cache`.  Each
(program, group, plan) gets a generated `.cu` file; it is compiled at first
use with nvcc into a shared library with a plain C interface and loaded
with ctypes.  Outputs live under `build/cuda/` in the checkout (listed in
`.gitignore`), keyed by a hash of the source, the header and the flags, so
a second process reuses them.  The key covers every header in `csrc/`.

`--fmad=false` and no fast-math: docs/SEMANTICS.md promises no
reassociation and no contraction.  The same source also builds with the
host C++ compiler under `-DSODA_HOST_EMULATION` (one thread per CTA), which
the CPU tests use to check the kernel's march without a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "cuda"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O1", "-shared", "-fPIC", "-DSODA_HOST_EMULATION",
              "-x", "c++"]


class BuildError(RuntimeError):
    """The compiler refused a generated source."""


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float          # compile time; 0.0 when the library was cached
    log: str                # compiler output (ptxas register/smem/spill lines), kept beside it


_loaded: dict[pathlib.Path, Built] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise BuildError("nvcc not found: the CUDA path needs the CUDA toolkit")


def _compile(cmd: list[str], src: pathlib.Path, out: pathlib.Path) -> tuple[float, str]:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run(cmd + ["-I", str(CSRC), "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{cmd[0]} failed on {src}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees a whole file
    return seconds, r.stdout + r.stderr


def build(name: str, source: str, *, emulate: bool = False,
          hazard: bool = False) -> Built:
    """Compile `source` (once per content) and load it.

    emulate=False: nvcc for sm_90a (the card).  emulate=True: the host C++
    compiler with -DSODA_HOST_EMULATION (the CPU tests); hazard=True adds
    -DSODA_HAZARD (copies land at issue, a step's stages and a stage's work
    items in reverse order: `csrc/async_copy.cuh` and the marches)."""
    headers = "\0".join(h.read_text() for h in sorted(CSRC.glob("*.cuh")))
    if hazard and not emulate:
        raise ValueError("the hazard emulation is host C++ (emulate=True)")
    cmd = (["g++"] + HOST_FLAGS + (["-DSODA_HAZARD"] if hazard else []) if emulate
           else [nvcc_path()] + NVCC_FLAGS)
    key = hashlib.sha256(
        "\0".join([source, headers, " ".join(cmd[1:])]).encode()).hexdigest()[:16]
    kind = ("hazard" if hazard else "host") if emulate else "sm90a"
    out = BUILD_DIR / f"{name}_{kind}_{key}.so"
    if out in _loaded:
        return _loaded[out]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, log_file = out.with_suffix(".cu"), out.with_suffix(".log")
    seconds, log = 0.0, ""
    if not out.exists():
        src.write_text(source)
        seconds, log = _compile(cmd, src, out)
        log_file.write_text(log)
    elif log_file.exists():
        log = log_file.read_text()   # built by an earlier process
    built = Built(ctypes.CDLL(str(out)), out, seconds, log)
    _loaded[out] = built
    return built
