"""The port's copy of `soda_tpu/ir/program.py`, unchanged: the port imports nothing
of `soda_tpu`.  Class and field names are the original's, so the two IRs print
the same reprs.

Program-level IR: tensors, stages, and the stencil dataflow DAG.

Plays the role of the reference's src/soda/core.py `Stencil` object
(tensors/stages dicts, type inference, offset normalization, the
dataflow graph) — reconstructed per SURVEY.md §2.1/§3(b); the reference
mount is empty, so no file:line cites are possible.

Differences from the reference, by design (TPU-first):
  * No FIFO/module planning here — the reuse-buffer math (window spans,
    halo arithmetic) lives in plan/ as a VMEM tiling planner instead.
  * Offsets are kept relative (not linearized against a tile size): the
    Pallas backend consumes N-D window extents directly.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


from . import expr as ir
from .types import ScalarType, promote


@dataclasses.dataclass(frozen=True)
class Param:
    """A scalar or array parameter (conv weights etc.).

    `dup` is accepted for surface compatibility with the reference DSL
    (replication count for FPGA banking); it does not affect TPU execution.
    """

    name: str
    type: ScalarType
    shape: tuple[int, ...] = ()
    dup: int | None = None
    partition: str | None = None


@dataclasses.dataclass
class Tensor:
    """One tensor in the dataflow DAG.

    `expr is None` for inputs.  For stages (locals/outputs), `expr` is the
    defining expression with all refs normalized so the stage's own anchor
    offset is zero (reference: mutator-based normalization in core.py).
    """

    name: str
    type: ScalarType
    expr: ir.Expr | None = None
    dram: tuple[int, ...] = (1,)
    tile_size: tuple[int | None, ...] | None = None  # inputs only; None = '*'
    is_output: bool = False
    # compiler-generated stage (e.g. a tcse partial sum): exempt from the
    # backend >32-bit rejections — its int64 typing exists only for oracle
    # exactness and the TPU paths compute it at int32, identical to the
    # unrewritten program
    synthetic: bool = False

    @property
    def is_input(self) -> bool:
        return self.expr is None

    def parents(self) -> list[str]:
        if self.expr is None:
            return []
        return ir.get_load_names(self.expr)

    def window(self) -> dict[str, list[tuple[int, ...]]]:
        """Per-parent list of tap offsets."""
        out: dict[str, list[tuple[int, ...]]] = {}
        if self.expr is not None:
            for r in ir.get_load_set(self.expr):
                out.setdefault(r.name, []).append(r.offsets)
        return out


class StencilProgram:
    """The central program object (analog of reference `Stencil`)."""

    def __init__(
        self,
        name: str,
        tensors: Mapping[str, Tensor],
        params: Mapping[str, Param],
        rank: int,
        burst_width: int = 512,
        iterate: int = 1,
        unroll_factor: int = 1,
        border: str = "ignore",
        cluster: str = "none",
    ):
        self.name = name
        self.tensors = dict(tensors)
        self.params = dict(params)
        self.rank = rank
        self.burst_width = burst_width
        self.iterate = iterate
        self.unroll_factor = unroll_factor
        self.border = border
        self.cluster = cluster
        self._validate()

    # ---- structure -------------------------------------------------------

    @property
    def input_names(self) -> list[str]:
        return [n for n, t in self.tensors.items() if t.is_input]

    @property
    def output_names(self) -> list[str]:
        return [n for n, t in self.tensors.items() if t.is_output]

    @property
    def local_names(self) -> list[str]:
        return [n for n, t in self.tensors.items()
                if not t.is_input and not t.is_output]

    def stage_order(self) -> list[str]:
        """Topological order of non-input tensors."""
        order: list[str] = []
        state: dict[str, int] = {}

        def visit(n: str) -> None:
            if state.get(n) == 2:
                return
            if state.get(n) == 1:
                raise ValueError(f"cycle through tensor {n!r}")
            state[n] = 1
            t = self.tensors[n]
            if not t.is_input:
                for p in t.parents():
                    visit(p)
                order.append(n)
            state[n] = 2

        for n in self.output_names:
            visit(n)
        # include locals not feeding any output (dead stages) for parity
        for n in self.tensors:
            visit(n)
        return order

    def consumers(self) -> dict[str, list[str]]:
        cons: dict[str, list[str]] = {n: [] for n in self.tensors}
        for n, t in self.tensors.items():
            for p in set(t.parents()):
                cons[p].append(n)
        return cons

    # ---- halo / window math (SODA reuse-buffer span, N-D form) ------------

    def stage_span(self, name: str) -> tuple[tuple[int, int], ...]:
        """(min,max) tap offset of stage `name` per dim, over all parents."""
        t = self.tensors[name]
        lo = [0] * self.rank
        hi = [0] * self.rank
        for offs in t.window().values():
            for off in offs:
                for d in range(self.rank):
                    lo[d] = min(lo[d], off[d])
                    hi[d] = max(hi[d], off[d])
        return tuple(zip(lo, hi))

    def cumulative_span(self, name: str) -> tuple[tuple[int, int], ...]:
        """Span of `name` relative to the program INPUTS: composition of
        stage windows along all producer paths (SODA's cumulative halo,
        SURVEY.md §3(b): composed offsets add)."""
        memo: dict[str, tuple[tuple[int, int], ...]] = {}

        def rec(n: str) -> tuple[tuple[int, int], ...]:
            if n in memo:
                return memo[n]
            t = self.tensors[n]
            if t.is_input:
                memo[n] = tuple((0, 0) for _ in range(self.rank))
                return memo[n]
            lo = [0] * self.rank
            hi = [0] * self.rank
            for parent, offs in t.window().items():
                pspan = rec(parent)
                for off in offs:
                    for d in range(self.rank):
                        lo[d] = min(lo[d], off[d] + pspan[d][0])
                        hi[d] = max(hi[d], off[d] + pspan[d][1])
            memo[n] = tuple(zip(lo, hi))
            return memo[n]

        return rec(name)

    def chain_creep(self, stages: list[str] | None = None,
                    outputs: list[str] | None = None
                    ) -> tuple[tuple[int, int], ...]:
        """Per-dim NON-CANCELLING (lo, hi) invalid depth of one
        constant-extent zero-fill evaluation of the stage chain.

        Differs from cumulative_span: when every stage is materialized at
        the SAME extent (fused-sweep fori bodies, line-buffer slabs, rim
        slabs, mesh sweeps), opposite-sign offsets along a path do NOT
        cancel — a stage reading its parent at +1 is invalid in the top
        row even if ITS consumer reads it at -2.  creep >= |span| always;
        they differ exactly on mixed-sign chains."""
        stages = self.stage_order() if stages is None else stages
        outputs = self.output_names if outputs is None else outputs
        rank = self.rank
        lo: dict[str, list[int]] = {}
        hi: dict[str, list[int]] = {}
        for st in stages:
            l = [0] * rank
            h = [0] * rank
            for parent, offs in self.tensors[st].window().items():
                pl_ = lo.get(parent, [0] * rank)
                ph = hi.get(parent, [0] * rank)
                for off in offs:
                    for d in range(rank):
                        # a consumer tapping AWAY from the parent's invalid
                        # band escapes it — clamp at 0 per step (exact for
                        # the constant-extent zero-fill evaluation; without
                        # the clamp alternating-sign chains double-count)
                        l[d] = max(l[d], max(0, pl_[d] - off[d]))
                        h[d] = max(h[d], max(0, ph[d] + off[d]))
            lo[st] = l
            hi[st] = h
        out_l = [0] * rank
        out_h = [0] * rank
        for o in outputs:
            for d in range(rank):
                out_l[d] = max(out_l[d], lo.get(o, [0] * rank)[d])
                out_h[d] = max(out_h[d], hi.get(o, [0] * rank)[d])
        return tuple((-l, h) for l, h in zip(out_l, out_h))

    def radius(self) -> int:
        """Max |offset| over all outputs' cumulative spans, one sweep."""
        r = 0
        for n in self.output_names:
            for lo, hi in self.cumulative_span(n):
                r = max(r, -lo, hi)
        return r

    def uses_libm_transcendentals(self) -> bool:
        """True when any stage calls a transcendental whose result is NOT
        IEEE-correctly-rounded (exp/log/trig/pow): C++ libm and numpy may
        then differ by ~1 ulp, so the C++ == NumPy oracle equivalence is
        gated at ulp tolerance instead of bit-exact.  sqrt/rsqrt stay
        bit-exact (IEEE-correct in both)."""
        libm = {"exp", "exp2", "log", "log2", "sin", "cos", "tan",
                "tanh", "pow", "atan", "atan2", "asin", "acos", "sinh",
                "cosh", "log10", "expm1", "log1p", "hypot"}
        for t in self.tensors.values():
            if t.expr is None:
                continue
            for n in ir.walk(t.expr):
                if isinstance(n, ir.Call) and n.fn in libm:
                    return True
        return False

    def max_float_width(self) -> int:
        """Widest float width (16/32/64) among tensors and params; 32 when
        the program is integer-only.  Sets the ulp scale for the libm
        C++ == NumPy oracle gate (see uses_libm_transcendentals)."""
        widths = [t.type.width for t in self.tensors.values()
                  if t.type.is_float]
        widths += [p.type.width for p in self.params.values()
                   if p.type.is_float]
        return max(widths, default=32)

    def valid_rim(self, iterate: int | None = None) -> int:
        """Width of the border-invalid rim (`border: ignore`): cumulative
        radius × number of temporal sweeps."""
        it = self.iterate if iterate is None else iterate
        return self.radius() * max(it, 1)

    # ---- type inference ----------------------------------------------------

    def infer_type(self, e: ir.Expr) -> ScalarType:
        """Result type of an expression under C-like promotion."""
        if isinstance(e, ir.Const):
            if e.type is not None:
                return e.type
            if isinstance(e.value, float):
                return ScalarType("float", 32)
            return ScalarType("int", 32)
        if isinstance(e, ir.Ref):
            return self.tensors[e.name].type
        if isinstance(e, (ir.ParamRef, ir.Var)):
            return self.params[e.name].type
        if isinstance(e, ir.Cast):
            return e.type
        if isinstance(e, ir.UnOp):
            return self.infer_type(e.operand)
        if isinstance(e, ir.Select):
            return promote(self.infer_type(e.on_true), self.infer_type(e.on_false))
        if isinstance(e, ir.BinOp):
            if e.op in ("==", "!=", "<", ">", "<=", ">=", "&&", "||"):
                return ScalarType("int", 32)
            if e.op in ("<<", ">>"):
                return self.infer_type(e.lhs)
            return promote(self.infer_type(e.lhs), self.infer_type(e.rhs))
        if isinstance(e, ir.Call):
            if e.fn in ("sqrt", "rsqrt", "exp", "exp2", "log", "log2", "sin",
                        "cos", "tan", "tanh", "pow", "fmin", "fmax", "fabs",
                        "atan", "atan2", "asin", "acos", "sinh", "cosh",
                        "log10", "expm1", "log1p", "trunc", "copysign",
                        "hypot"):
                ts = [self.infer_type(a) for a in e.args]
                t = ts[0]
                for u in ts[1:]:
                    t = promote(t, u)
                return t if t.is_float else ScalarType("float", 32)
            ts = [self.infer_type(a) for a in e.args]
            t = ts[0]
            for u in ts[1:]:
                t = promote(t, u)
            return t
        raise TypeError(f"cannot type {e!r}")

    # ---- validation --------------------------------------------------------

    def _validate(self) -> None:
        if not self.output_names:
            raise ValueError("program has no output tensor")
        if not self.input_names:
            raise ValueError("program has no input tensor")
        for n, t in self.tensors.items():
            if t.is_input:
                if t.tile_size is not None and len(t.tile_size) != self.rank:
                    raise ValueError(
                        f"input {n!r} tile size rank {len(t.tile_size)} != program rank {self.rank}")
                continue
            for r in ir.get_load_set(t.expr):
                if r.name not in self.tensors:
                    if r.name in self.params:
                        raise ValueError(
                            f"stage {n!r} indexes param {r.name!r} with (...) — use [..] ")
                    raise ValueError(f"stage {n!r} references undefined tensor {r.name!r}")
                if len(r.offsets) != self.rank:
                    raise ValueError(
                        f"stage {n!r}: ref {r} has rank {len(r.offsets)}, expected {self.rank}")
            for v in ir.walk(t.expr):
                if isinstance(v, (ir.ParamRef, ir.Var)) and v.name not in self.params:
                    raise ValueError(f"stage {n!r} references undefined param {v.name!r}")
        self.stage_order()  # raises on cycles
        if self.iterate > 1:
            # feedback pair = FIRST input <- FIRST-declared output; any
            # further inputs are sweep-invariant auxiliaries (a denoise
            # rhs) and any further outputs take their FINAL-sweep values
            # (the reference's replication lowering makes the intermediate
            # sweeps' copies of non-feedback outputs dead stages —
            # docs/SEMANTICS.md "multi-output iterate")
            if len(self.input_names) < 1 or len(self.output_names) < 1:
                raise ValueError(
                    "iterate > 1 requires at least one input (the first is "
                    "the iterated state) and at least one output (the "
                    "first feeds back)")
            i, o = self.input_names[0], self.output_names[0]
            if self.tensors[i].type != self.tensors[o].type:
                raise ValueError(
                    f"iterate > 1 requires matching feedback input/output "
                    f"types ({self.tensors[i].type} vs {self.tensors[o].type})")

    # ---- introspection -----------------------------------------------------

    def describe(self) -> str:
        lines = [f"kernel: {self.name}  rank={self.rank}  iterate={self.iterate} "
                 f"unroll={self.unroll_factor} burst={self.burst_width} border={self.border}"]
        for n in self.input_names:
            t = self.tensors[n]
            ts = ",".join("*" if d is None else str(d) for d in (t.tile_size or ()))
            lines.append(f"  input  {t.type}: {n}({ts}) dram={t.dram}")
        for n in self.stage_order():
            t = self.tensors[n]
            kind = "output" if t.is_output else "local "
            lines.append(f"  {kind} {t.type}: {n} = {t.expr}")
        for p in self.params.values():
            shp = "".join(f"[{d}]" for d in p.shape)
            lines.append(f"  param  {p.type}: {p.name}{shp}")
        return "\n".join(lines)
