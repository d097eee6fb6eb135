"""`.soda` parser without lark: a hand-written lexer and recursive descent.

Counterpart of `soda_tpu/frontend/parser.py` and `grammar.lark`, for
machines without lark.  It accepts the same grammar and builds the same
`StencilProgram` (the shared IR classes):

- statements are newline-separated; `#` starts a comment;
- expressions follow C precedence (ternary, `||`, `&&`, `|`, `^`, `&`,
  equality, relational, shifts, additive, multiplicative, unary);
- `name(a, b, ...)` is resolved after parsing: a tensor Ref when `name`
  is a declared tensor (offsets must fold to integer constants), a math
  Call otherwise (`_resolve`, `_fold_int`, `build_program`);
- syntax errors raise `ValueError` naming the line and column.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Any

from ..ir import expr as ir
from ..ir.program import Param, StencilProgram, Tensor
from ..ir.types import ScalarType

# ---- lexer -------------------------------------------------------------------

_TYPE_RE = re.compile(r"u?int[0-9]+|float(16|32|64)?|double|half")
_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t]+)
  | (?P<comment>\#[^\n]*)
  | (?P<nl>(\r?\n)+)
  | (?P<hex>0[xX][0-9a-fA-F]+)
  | (?P<float>((\d+\.\d*|\.\d+)([eE][+-]?\d+)?|\d+[eE][+-]?\d+)[fF]?|\d+[fF])
  | (?P<int>\d+)
  | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\|\||&&|==|!=|<=|>=|<<|>>|[-+*/%<>!~&|^?:=(),\[\]])
""", re.VERBOSE)


@dataclasses.dataclass
class _Tok:
    kind: str   # 'type' | 'word' | 'int' | 'hex' | 'float' | 'op' | 'nl' | 'eof'
    text: str
    line: int
    col: int


class _SyntaxError(Exception):
    def __init__(self, tok: _Tok):
        super().__init__(tok.text)
        self.tok = tok


def _lex(text: str) -> list[_Tok]:
    toks: list[_Tok] = []
    pos, line, line_start = 0, 1, 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        col = pos - line_start + 1
        if m is None:
            raise _SyntaxError(_Tok("op", text[pos], line, col))
        kind = m.lastgroup
        s = m.group()
        if kind == "nl":
            toks.append(_Tok("nl", s, line, col))
            line += s.count("\n")
            line_start = m.end()
        elif kind == "word":
            toks.append(_Tok("type" if _TYPE_RE.fullmatch(s) else "word",
                             s, line, col))
        elif kind not in ("ws", "comment"):
            toks.append(_Tok(kind, s, line, col))
        pos = m.end()
    toks.append(_Tok("eof", "", -1, -1))
    return toks


# ---- raw statements (as soda_tpu.frontend.parser builds them) ----------------


@dataclasses.dataclass
class _Apply(ir.Expr):
    """Unresolved name(args...) -- becomes Ref or Call during build."""

    name: str
    args: tuple[ir.Expr, ...]

    def children(self):
        return self.args


@dataclasses.dataclass
class RawInput:
    type: ScalarType
    name: str
    tile_size: tuple[int | None, ...]
    dram: tuple[int, ...]


@dataclasses.dataclass
class RawStage:
    kind: str  # 'local' | 'output'
    type: ScalarType
    name: str
    anchor: tuple[int, ...]
    expr: Any
    dram: tuple[int, ...]


@dataclasses.dataclass
class RawParam:
    type: ScalarType
    name: str
    shape: tuple[int, ...]
    dup: int | None
    partition: str | None


@dataclasses.dataclass
class RawProgram:
    name: str | None = None
    burst_width: int = 512
    iterate: int = 1
    unroll_factor: int = 1
    border: str = "ignore"
    cluster: str = "none"
    inputs: list[RawInput] = dataclasses.field(default_factory=list)
    stages: list[RawStage] = dataclasses.field(default_factory=list)
    params: list[RawParam] = dataclasses.field(default_factory=list)


# ---- recursive descent --------------------------------------------------------

# binary levels, loosest first (the grammar's C precedence ladder)
_BINARY_LEVELS = [
    ("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
    ("<", ">", "<=", ">="), ("<<", ">>"), ("+", "-"), ("*", "/", "%"),
]


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    # -- token helpers
    def peek(self, k: int = 0) -> _Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> _Tok:
        tok = self.peek()
        self.i += 1
        return tok

    def at(self, text: str, k: int = 0) -> bool:
        tok = self.peek(k)
        return tok.kind in ("op", "word") and tok.text == text

    def expect(self, text: str) -> _Tok:
        if not self.at(text):
            raise _SyntaxError(self.peek())
        return self.next()

    def expect_kind(self, kind: str) -> _Tok:
        if self.peek().kind != kind:
            raise _SyntaxError(self.peek())
        return self.next()

    def int_tok(self) -> int:
        return int(self.expect_kind("int").text)

    def name(self) -> str:
        # keywords are ordinary words, so a tensor may be named `input`
        return self.expect_kind("word").text

    def type(self) -> ScalarType:
        return ScalarType.parse(self.expect_kind("type").text)

    # -- program
    def program(self) -> RawProgram:
        prog = RawProgram()
        while self.peek().kind == "nl":
            self.next()
        while self.peek().kind != "eof":
            self.statement(prog)
            if self.peek().kind == "eof":
                break
            self.expect_kind("nl")
            while self.peek().kind == "nl":
                self.next()
        return prog

    def statement(self, prog: RawProgram) -> None:
        tok = self.peek()
        kw = tok.text if tok.kind == "word" else None
        if kw == "kernel":
            self.next(); self.expect(":")
            prog.name = self.name()
        elif kw == "burst":
            self.next(); self.expect("width"); self.expect(":")
            prog.burst_width = self.int_tok()
        elif kw == "iterate":
            self.next(); self.expect(":")
            prog.iterate = self.int_tok()
        elif kw == "unroll":
            self.next(); self.expect("factor"); self.expect(":")
            prog.unroll_factor = self.int_tok()
        elif kw == "border":
            self.next(); self.expect(":")
            prog.border = self.name()
        elif kw == "cluster":
            self.next(); self.expect(":")
            prog.cluster = self.name()
        elif kw == "input":
            self.next()
            dram = self.dram_spec() if self.at("dram") else (1,)
            typ = self.type()
            self.expect(":")
            name = self.name()
            self.expect("(")
            tiles = [self.tile_dim()]
            while self.at(","):
                self.next()
                tiles.append(self.tile_dim())
            self.expect(")")
            prog.inputs.append(RawInput(typ, name, tuple(tiles), dram))
        elif kw in ("local", "output"):
            self.next()
            dram = (self.dram_spec() if kw == "output" and self.at("dram")
                    else (1,))
            typ = self.type()
            self.expect(":")
            name = self.name()
            self.expect("(")
            anchor = [self.signed_int()]
            while self.at(","):
                self.next()
                anchor.append(self.signed_int())
            self.expect(")")
            self.expect("=")
            body = self.expr()
            prog.stages.append(RawStage(kw, typ, name, tuple(anchor), body, dram))
        elif kw == "param":
            self.next()
            typ = self.type()
            dup = part = None
            while self.at(","):
                self.next()
                if self.at("dup"):
                    self.next()
                    dup = self.int_tok()
                elif self.at("partition"):
                    self.next()
                    part = self.name()
                    if self.at("factor"):
                        self.next(); self.expect("=")
                        part += f":{self.int_tok()}"
                else:
                    raise _SyntaxError(self.peek())
            self.expect(":")
            name = self.name()
            shape = []
            while self.at("["):
                self.next()
                shape.append(self.int_tok())
                self.expect("]")
            prog.params.append(RawParam(typ, name, tuple(shape), dup, part))
        else:
            raise _SyntaxError(tok)

    def dram_spec(self) -> tuple[int, ...]:
        self.expect("dram")
        vals = [self.int_tok()]
        while self.at(",") and self.peek(1).kind == "int":
            self.next()
            vals.append(self.int_tok())
        return tuple(vals)

    def tile_dim(self) -> int | None:
        if self.at("*"):
            self.next()
            return None
        return self.int_tok()

    def signed_int(self) -> int:
        if self.at("-"):
            self.next()
            return -self.int_tok()
        if self.at("+"):
            self.next()
        return self.int_tok()

    # -- expressions
    def expr(self) -> Any:
        cond = self.binary(0)
        if self.at("?"):
            self.next()
            a = self.expr()
            self.expect(":")
            b = self.expr()
            return ir.Select(cond, a, b)
        return cond

    def binary(self, level: int) -> Any:
        if level == len(_BINARY_LEVELS):
            return self.unary()
        lhs = self.binary(level + 1)
        while self.peek().kind == "op" and self.peek().text in _BINARY_LEVELS[level]:
            op = self.next().text
            lhs = ir.BinOp(op, lhs, self.binary(level + 1))
        return lhs

    def unary(self) -> Any:
        if self.peek().kind == "op" and self.peek().text in ("-", "+", "!", "~"):
            op = self.next().text
            return ir.UnOp(op, self.unary())
        return self.atom()

    def atom(self) -> Any:
        tok = self.peek()
        if self.at("("):
            self.next()
            e = self.expr()
            self.expect(")")
            return e
        if tok.kind == "type":
            self.next()
            self.expect("(")
            e = self.expr()
            self.expect(")")
            return ir.Cast(ScalarType.parse(tok.text), e)
        if tok.kind == "word":
            self.next()
            if self.at("("):
                self.next()
                args = [self.expr()]
                while self.at(","):
                    self.next()
                    args.append(self.expr())
                self.expect(")")
                return _Apply(tok.text, tuple(args))
            if self.at("["):
                idx = []
                while self.at("["):
                    self.next()
                    idx.append(self.expr())
                    self.expect("]")
                return ("param_ref", tok.text, tuple(idx))
            return ("var", tok.text)
        if tok.kind == "int":
            self.next()
            return ir.Const(int(tok.text))
        if tok.kind == "hex":
            self.next()
            return ir.Const(int(tok.text, 16))
        if tok.kind == "float":
            self.next()
            return ir.Const(float(tok.text.rstrip("fF")))
        raise _SyntaxError(tok)


def parse_raw(text: str) -> RawProgram:
    return _Parser(_lex(text)).program()


# ---- build: raw -> StencilProgram ---------------------------------------------


def _fold_int(e: ir.Expr) -> int | None:
    """Fold an expression to an int constant (for ref offsets)."""
    if isinstance(e, ir.Const) and isinstance(e.value, int):
        return e.value
    if isinstance(e, ir.UnOp) and e.op in ("-", "+"):
        v = _fold_int(e.operand)
        if v is not None:
            return -v if e.op == "-" else v
    return None


def _resolve(e: Any, tensor_names: set[str], param_names: set[str]) -> ir.Expr:
    """Resolve _Apply/var/param_ref placeholders into typed IR nodes."""
    if isinstance(e, _Apply):
        args = tuple(_resolve(a, tensor_names, param_names) for a in e.args)
        if e.name in tensor_names:
            offs = tuple(_fold_int(a) for a in args)
            if any(o is None for o in offs):
                raise ValueError(
                    f"tensor ref {e.name}(...) requires integer constant offsets")
            return ir.Ref(e.name, offs)  # type: ignore[arg-type]
        if e.name in ir.MATH_FNS:
            return ir.Call(e.name, args)
        raise ValueError(
            f"{e.name!r} is neither a declared tensor nor a known function "
            f"(known fns: {sorted(ir.MATH_FNS)})")
    if isinstance(e, tuple) and len(e) == 3 and e[0] == "param_ref":
        _, name, idx_exprs = e
        if name not in param_names:
            raise ValueError(f"subscripted name {name!r} is not a declared param")
        idxs = []
        for ie in idx_exprs:
            iv = _fold_int(_resolve(ie, tensor_names, param_names))
            if iv is None:
                raise ValueError(f"param index of {name!r} must be a constant")
            idxs.append(iv)
        return ir.ParamRef(name, tuple(idxs))
    if isinstance(e, tuple) and len(e) == 2 and e[0] == "var":
        if e[1] in param_names:
            return ir.Var(e[1])
        raise ValueError(f"bare identifier {e[1]!r} is not a declared param")
    if isinstance(e, ir.BinOp):
        return ir.BinOp(e.op, _resolve(e.lhs, tensor_names, param_names),
                        _resolve(e.rhs, tensor_names, param_names))
    if isinstance(e, ir.UnOp):
        return ir.UnOp(e.op, _resolve(e.operand, tensor_names, param_names))
    if isinstance(e, ir.Cast):
        return ir.Cast(e.type, _resolve(e.operand, tensor_names, param_names))
    if isinstance(e, ir.Select):
        return ir.Select(_resolve(e.cond, tensor_names, param_names),
                         _resolve(e.on_true, tensor_names, param_names),
                         _resolve(e.on_false, tensor_names, param_names))
    if isinstance(e, ir.Const):
        return e
    raise TypeError(f"unexpected node {e!r}")


def build_program(raw: RawProgram, overrides: dict | None = None) -> StencilProgram:
    """RawProgram -> validated StencilProgram.  `overrides` mirrors the CLI
    precedence over the DSL (--iterate, --tile-size, --dram-*, ...)."""
    ov = overrides or {}
    if raw.name is None:
        raise ValueError("missing `kernel:` statement")
    if not raw.inputs:
        raise ValueError("missing `input` statement")
    rank = len(raw.inputs[0].tile_size)
    tensor_names = {i.name for i in raw.inputs} | {s.name for s in raw.stages}
    param_names = {p.name for p in raw.params}

    tensors: dict[str, Tensor] = {}
    for rinp in raw.inputs:
        tensors[rinp.name] = Tensor(
            name=rinp.name, type=rinp.type, expr=None,
            dram=tuple(ov.get("dram_in", rinp.dram)),
            tile_size=tuple(ov.get("tile_size", rinp.tile_size)))
    for st in raw.stages:
        body = _resolve(st.expr, tensor_names, param_names)
        # normalize: shift refs so the stage's own anchor is zero
        if any(a != 0 for a in st.anchor):
            body = ir.shift(body, tuple(-a for a in st.anchor))
        dram = ov.get("dram_out", st.dram) if st.kind == "output" else st.dram
        tensors[st.name] = Tensor(
            name=st.name, type=st.type, expr=body,
            dram=tuple(dram), is_output=(st.kind == "output"))
    params = {p.name: Param(p.name, p.type, p.shape, p.dup, p.partition)
              for p in raw.params}
    return StencilProgram(
        name=raw.name, tensors=tensors, params=params, rank=rank,
        burst_width=int(ov.get("burst_width", raw.burst_width)),
        iterate=int(ov.get("iterate", raw.iterate)),
        unroll_factor=int(ov.get("unroll_factor", raw.unroll_factor)),
        border=str(ov.get("border", raw.border)),
        cluster=str(ov.get("cluster", raw.cluster)))


def parse(text: str, overrides: dict | None = None) -> StencilProgram:
    """Parse `.soda` source text into a validated StencilProgram."""
    try:
        raw = parse_raw(text)
    except _SyntaxError as e:
        lines = text.splitlines() or [""]
        # end of input carries line = column = -1: point past the last line
        ln = e.tok.line if 0 < e.tok.line <= len(lines) else len(lines)
        col = e.tok.col if e.tok.col > 0 else len(lines[ln - 1]) + 1
        raise ValueError(
            f".soda syntax error at line {ln}, column {col}:\n"
            f"  {lines[ln - 1]}\n  {' ' * max(col - 1, 0)}^") from None
    return build_program(raw, overrides)


def parse_file(path: str | pathlib.Path, overrides: dict | None = None) -> StencilProgram:
    return parse(pathlib.Path(path).read_text(), overrides)
