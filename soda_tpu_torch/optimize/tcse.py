"""The port's copy of `soda_tpu/optimize/tcse.py`: temporal common-
subexpression elimination (computation reuse), the DAC 2020 "Exploiting
Computation Reuse for Stencil Accelerators" rewrite behind `sodac --tcse`.

The port imports nothing of `soda_tpu`; `tests/test_torch_copies.py` holds
this copy equal to the original over the corpus (the rewritten programs'
`describe()` and the add, multiply and min/max counts).

It detects subexpressions repeated at shifted offsets (convolution sum
trees with coefficients, min/max reductions) and hoists them into
synthetic `local` stages named `<stage>__cse<k>`, generalised to WEIGHTED
sums by exact polynomial factorization over the offset lattice:

  a flattened weighted sum  Σ_{o} w_o · x(o)  (w_o = constant / param
  products) is viewed as a Laurent polynomial W(z).  A rewrite

      Σ_k c_k · T(k·d)   with hoisted stage   T = Σ_g v_g · x(g)

  is EXACTLY the factorization  W = V · C(z^d)  where C is a 1-D polynomial
  along direction d.  Grouping offsets into residue classes modulo Z·d
  turns each class into a 1-D polynomial in y = z^d; C must divide every
  class polynomial, and V is assembled from the quotients.

Candidate factors C per direction d: the exact GCD of all class
polynomials (separable kernels: a full 5x5 Gaussian collapses to row-sum
+ column-combine), rational-root linear factors and small-integer
quadratic factors of one class polynomial (binomial and triangle kernels),
and unweighted disjoint tilings (box kernels).  All candidates over all
directions are scored by exact op count (adds + non-unit multiplies), the
best strict improvement is applied, and passes repeat to a fixed point.

On the card a hoisted stage is one more stage of its consumer's group: the
planner gives it a shared-memory ring with the right halo, so each partial
sum is computed once per cell and read by the consumer's shifted taps.

Numerical note: the rewrite REASSOCIATES the sum.  Exact for integer
types: integer programs only accept integer factor coefficients, and
hoisted partial sums are stored at a width chosen from a STATIC VALUE
BOUND (sum of |coefficients| x parent range): int32 when the true sum
provably fits, int64 otherwise.  For floats it perturbs results within
normal fp tolerance.  It widens the border-invalid rim (`valid_rim()`):
the rewritten program equals the original outside it.  Off by default.

conv5x5.soda's 25 free symbolic weights admit no reuse and are left
unchanged; gauss5x5.soda (24 adds + 25 muls -> 8 adds) is the
constant-weight 2-D convolution the rewrite is about.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

from ..ir import expr as ir
from ..ir.program import StencilProgram, Tensor
from ..ir.types import ScalarType


# ---------------------------------------------------------------------------
# Coefficients: exact rational number times a multiset of symbolic factors
# (ParamRef / Var).  Fractions keep integer programs bit-exact.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Coeff:
    num: Fraction
    syms: tuple[ir.Expr, ...] = ()  # sorted by str; frozen dataclasses hash

    @staticmethod
    def one() -> "Coeff":
        return Coeff(Fraction(1))

    @property
    def is_one(self) -> bool:
        return self.num == 1 and not self.syms

    @property
    def is_numeric(self) -> bool:
        return not self.syms

    @property
    def is_zero(self) -> bool:
        return self.num == 0

    def mul(self, other: "Coeff") -> "Coeff":
        return Coeff(self.num * other.num,
                     tuple(sorted(self.syms + other.syms, key=str)))

    def neg(self) -> "Coeff":
        return Coeff(-self.num, self.syms)

    def to_expr(self, operand: ir.Expr, is_int: bool) -> ir.Expr:
        """Build coeff * operand (coeff == 1 collapses to operand).

        A fractional constant on an integer tensor is legal DSL (the
        product promotes to float) and occurs when rebuilding UNTOUCHED
        taps of a partially-rewritten sum — emit the float const exactly
        as the original expression had it.  Decomposed groups never get
        here with fractions: _search enforces integer factor coefficients
        for integer tensors."""
        e = operand
        for s in self.syms:
            e = ir.BinOp("*", e, s)
        n = self.num
        if n == 1:
            return e
        if n == -1:
            return ir.UnOp("-", e)
        if n.denominator == 1:
            return ir.BinOp("*", ir.Const(int(n)), e)
        return ir.BinOp("*", ir.Const(float(n)), e)

    @property
    def mul_cost(self) -> int:
        """Number of multiply ops this coefficient costs on a tap."""
        c = len(self.syms)
        if abs(self.num) != 1:
            c += 1
        return c


def _frac_gcd(a: Fraction, b: Fraction) -> Fraction:
    return Fraction(math.gcd(a.numerator, b.numerator),
                    (a.denominator * b.denominator)
                    // math.gcd(a.denominator, b.denominator))


def _coeff_content(coeffs: list[Coeff]) -> Coeff:
    """Common factor: gcd of numerics x multiset intersection of symbols."""
    num = Fraction(0)
    for c in coeffs:
        num = _frac_gcd(num, abs(c.num)) if num else abs(c.num)
    syms: list[ir.Expr] | None = None
    for c in coeffs:
        cs = list(c.syms)
        if syms is None:
            syms = cs
        else:
            keep = []
            for s in syms:
                if s in cs:
                    cs.remove(s)
                    keep.append(s)
            syms = keep
    # sign convention: make the first coefficient positive
    if coeffs and coeffs[0].num < 0:
        num = -num
    return Coeff(num, tuple(syms or ()))


def _coeff_div(a: Coeff, b: Coeff) -> Coeff | None:
    """a / b when the symbolic multiset of b divides a's; else None."""
    syms = list(a.syms)
    for s in b.syms:
        if s not in syms:
            return None
        syms.remove(s)
    return Coeff(a.num / b.num, tuple(syms))


# ---------------------------------------------------------------------------
# Term parsing: a sum term -> (Coeff, tensor name, offsets)
# ---------------------------------------------------------------------------


def _flatten_sum(e: ir.Expr) -> list[tuple[ir.Expr, bool]] | None:
    """Flatten a +/- chain into [(term, negated)]; None if not a sum."""
    if not (isinstance(e, ir.BinOp) and e.op in ("+", "-")):
        return None
    out: list[tuple[ir.Expr, bool]] = []

    def rec(n: ir.Expr, neg: bool) -> None:
        if isinstance(n, ir.BinOp) and n.op in ("+", "-"):
            rec(n.lhs, neg)
            rec(n.rhs, neg ^ (n.op == "-"))
        else:
            out.append((n, neg))

    rec(e, False)
    return out


def _parse_term(e: ir.Expr) -> tuple[Coeff, str, tuple[int, ...]] | None:
    """Parse coeff * Ref products: Ref, c*Ref, Ref*p[i][j], 2*p*Ref, -Ref."""
    coeff = Coeff.one()
    ref: ir.Ref | None = None
    stack = [e]
    while stack:
        n = stack.pop()
        if isinstance(n, ir.BinOp) and n.op == "*":
            stack.append(n.lhs)
            stack.append(n.rhs)
        elif isinstance(n, ir.UnOp) and n.op == "-":
            coeff = coeff.neg()
            stack.append(n.operand)
        elif isinstance(n, ir.Ref):
            if ref is not None:
                return None  # x*y products are not weighted taps
            ref = n
        elif isinstance(n, ir.Const):
            # exact: ints exactly, floats as their exact binary rational —
            # factorizations are then exact identities over the stored consts
            coeff = coeff.mul(Coeff(Fraction(n.value)))
        elif isinstance(n, (ir.ParamRef, ir.Var)):
            coeff = coeff.mul(Coeff(Fraction(1), (n,)))
        else:
            return None  # casts/calls/divs etc.: opaque term
    if ref is None or coeff.is_zero:
        return None
    return coeff, ref.name, ref.offsets


# ---------------------------------------------------------------------------
# Exact 1-D polynomial helpers over Fraction coefficient lists
# (index = exponent; list[0] != 0 by construction).
# ---------------------------------------------------------------------------


def _poly_trim(p: list[Fraction]) -> list[Fraction]:
    while p and p[-1] == 0:
        p.pop()
    return p


def _poly_divmod(a: list[Fraction], b: list[Fraction]
                 ) -> tuple[list[Fraction], list[Fraction]]:
    a = list(a)
    q = [Fraction(0)] * max(len(a) - len(b) + 1, 0)
    for i in range(len(a) - len(b), -1, -1):
        c = a[i + len(b) - 1] / b[-1]
        q[i] = c
        if c:
            for j, bj in enumerate(b):
                a[i + j] -= c * bj
    return _poly_trim(q), _poly_trim(a)


def _poly_gcd(a: list[Fraction], b: list[Fraction]) -> list[Fraction]:
    while b:
        _, r = _poly_divmod(a, b)
        a, b = b, r
    return _poly_primitive(a)


def _poly_primitive(p: list[Fraction]) -> list[Fraction]:
    """Scale to primitive integer coefficients with positive leading term."""
    if not p:
        return p
    g = Fraction(0)
    for c in p:
        g = _frac_gcd(g, abs(c)) if g else abs(c)
    if p[-1] < 0:
        g = -g
    return [c / g for c in p]


def _poly_factors(p: list[Fraction]) -> list[list[Fraction]]:
    """Proper divisors of a primitive integer poly: rational-root linear
    factors plus small-integer quadratic factors (covers binomial and
    triangle kernels; higher-degree irreducibles are rare in stencils and
    simply yield no reuse)."""
    out: list[list[Fraction]] = []
    deg = len(p) - 1
    if deg < 2:
        return out
    a0, an = int(p[0]), int(p[-1])

    def divisors(n: int) -> list[int]:
        n = abs(n)
        small, large = [], []
        d = 1
        while d * d <= n:  # O(sqrt n): weights can be ~1e9 fixed-point ints
            if n % d == 0:
                small.append(d)
                if d != n // d:
                    large.append(n // d)
            d += 1
        return small + large[::-1]

    seen: set[tuple] = set()
    for pn in divisors(a0):
        for qn in divisors(an):
            for sign in (1, -1):
                cand = [Fraction(sign * pn), Fraction(qn)]  # qn*y + sign*pn
                cand = _poly_primitive(cand)
                key = tuple(cand)
                if key in seen:
                    continue
                seen.add(key)
                _, r = _poly_divmod(p, cand)
                if not r:
                    out.append(cand)
    if deg >= 4:
        # the quadratic-factor search exists for small-coefficient kernels
        # (triangle (1,2,3,2,1) etc.); cap the middle coefficient so big
        # fixed-point weights don't turn this into an O(|coeff|) scan
        bound = min(max(abs(int(c)) for c in p) + 1, 64)
        for b0 in divisors(a0):
            for b2 in divisors(an):
                for s0 in (1, -1):
                    for b1 in range(-bound, bound + 1):
                        cand = [Fraction(s0 * b0), Fraction(b1), Fraction(b2)]
                        cand = _poly_primitive(cand)
                        key = tuple(cand)
                        if key in seen:
                            continue
                        seen.add(key)
                        _, r = _poly_divmod(p, cand)
                        if not r:
                            out.append(cand)
    if deg >= 6:
        # bounded Kronecker search for CUBIC factors (VERDICT r2 #9: the
        # old search stopped at quadratics, so kernels whose only factors
        # are irreducible cubics — e.g. (1+y+y³)² — found no reuse).  A
        # true integer factor F satisfies F(x) | P(x) at every integer x:
        # enumerate divisor tuples of P at 4 points, interpolate the
        # unique cubic through them, and trial-divide.  Capped.
        for cand in _kronecker_factors(p, 3, cap=4000, seen=seen):
            out.append(cand)
    return out


def _kronecker_factors(p: list[Fraction], k: int, cap: int,
                       seen: set[tuple]) -> list[list[Fraction]]:
    """Degree-k integer factors of primitive integer poly `p` by
    Kronecker's method: a factor's values at x = 0, 1, -1, 2, ... divide
    p's values there; each divisor tuple interpolates one candidate.
    Bounded by `cap` trial divisions — stencil class polynomials are tiny
    (degree <= ~8, coefficients <= ~64 after primitivization)."""
    xs = [0, 1, -1, 2, -2][:k + 1]

    def peval(poly, x):
        v = Fraction(0)
        for c in reversed(poly):
            v = v * x + c
        return int(v)

    vals = [peval(p, x) for x in xs]
    if any(v == 0 for v in vals):
        # a root among the sample points means a linear factor the
        # rational-root search already found; skip (Kronecker needs
        # nonzero values to enumerate divisors)
        return []

    def divs_signed(n):
        n = abs(n)
        out = []
        d = 1
        while d * d <= n:
            if n % d == 0:
                out.extend((d, -d))
                if d != n // d:
                    out.extend((n // d, -(n // d)))
            d += 1
        return out

    dsets = [divs_signed(v) for v in vals]
    total = 1
    for ds in dsets:
        total *= len(ds)
    if total > cap * 8:
        # trim: keep the smallest divisors per point (factor values at
        # small x are small for small-coefficient factors)
        dsets = [sorted(ds, key=abs)[:12] for ds in dsets]

    out: list[list[Fraction]] = []
    tried = 0
    import itertools as _it

    for combo in _it.product(*dsets):
        tried += 1
        if tried > cap:
            break
        # Lagrange-interpolate the degree-k poly through (xs[i], combo[i])
        coeffs = [Fraction(0)] * (k + 1)
        ok = True
        for i, (xi, yi) in enumerate(zip(xs, combo)):
            li = [Fraction(1)]
            denom = 1
            for j2, xj in enumerate(xs):
                if j2 == i:
                    continue
                # li *= (y - xj)
                li = [Fraction(0)] + li
                for t in range(len(li) - 1):
                    li[t] -= Fraction(xj) * li[t + 1]
                denom *= (xi - xj)
            for t in range(len(li)):
                coeffs[t] += Fraction(yi, denom) * li[t]
        if any(c.denominator != 1 for c in coeffs) or coeffs[k] == 0:
            ok = False
        if not ok:
            continue
        cand = _poly_primitive(coeffs)
        key = tuple(cand)
        if key in seen or len(cand) != k + 1:
            continue
        seen.add(key)
        _, r = _poly_divmod(p, cand)
        if not r:
            out.append(cand)
    return out


# ---------------------------------------------------------------------------
# Decomposition search: best (d, C) factorization of a weighted tap set
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Rewrite:
    hoisted: list[tuple[tuple[int, ...], Coeff]]  # T's taps
    outer: list[tuple[tuple[int, ...], Coeff]]    # consumer taps on T
    saved_ops: int


def _sum_cost(taps: list[tuple[tuple[int, ...], Coeff]]) -> int:
    return (len(taps) - 1) + sum(c.mul_cost for _, c in taps)


def _primitive(d: tuple[int, ...]) -> tuple[int, ...] | None:
    g = 0
    for x in d:
        g = math.gcd(g, abs(x))
    if g == 0:
        return None
    d = tuple(x // g for x in d)
    for x in d:  # canonical sign: first nonzero positive (dedup +/-d)
        if x:
            return d if x > 0 else tuple(-y for y in d)
    return None


def _enum_rewrites(taps: list[tuple[tuple[int, ...], Coeff]], is_int: bool):
    """Yield every valid one-level (d, C) factorization of the tap set."""
    n = len(taps)
    if n < 3:
        return
    offsets = [o for o, _ in taps]
    wmap = dict(taps)

    dirs: list[tuple[int, ...]] = []
    seen_d: set[tuple[int, ...]] = set()
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            d = _primitive(tuple(a - b for a, b in
                                 zip(offsets[i], offsets[j])))
            if d is not None and d not in seen_d:
                seen_d.add(d)
                dirs.append(d)

    for d in dirs:
        nz = next(k for k, x in enumerate(d) if x)
        # residue classes modulo Z*d; exponent j along d within each class
        classes: dict[tuple[int, ...], dict[int, Coeff]] = {}
        ok = True
        for o in offsets:
            q = o[nz] // d[nz]
            rep = tuple(a - q * b for a, b in zip(o, d))
            classes.setdefault(rep, {})[q] = wmap[o]
        # build per-class polys with base exponent normalized to 0
        polys: list[tuple[tuple[int, ...], int, Coeff, list[Fraction]]] = []
        for rep, jmap in classes.items():
            jmin = min(jmap)
            coeffs = [jmap.get(j, Coeff(Fraction(0)))
                      for j in range(jmin, max(jmap) + 1)]
            cont = _coeff_content([c for c in coeffs if not c.is_zero])
            prim: list[Fraction] = []
            for c in coeffs:
                if c.is_zero:
                    prim.append(Fraction(0))
                    continue
                q2 = _coeff_div(c, cont)
                if q2 is None or not q2.is_numeric:
                    ok = False
                    break
                prim.append(q2.num)
            if not ok:
                break
            base = tuple(a + jmin * b for a, b in zip(rep, d))
            polys.append((base, jmin, cont, prim))
        if not ok or not polys:
            continue

        # candidate C factors along this direction
        cands: list[list[Fraction]] = []
        if len(polys) > 1:
            g = polys[0][3]
            for _, _, _, p in polys[1:]:
                g = _poly_gcd(g, p)
                if len(g) <= 1:
                    break
            if len(g) > 1:
                cands.append(g)
                cands.extend(_poly_factors(g))
        else:
            cands.extend(_poly_factors(_poly_primitive(polys[0][3])))

        for C in cands:
            if len(C) <= 1:
                continue
            if is_int and any(c.denominator != 1 for c in C):
                continue
            hoisted: list[tuple[tuple[int, ...], Coeff]] = []
            good = True
            for base, _, cont, prim in polys:
                q3, r = _poly_divmod(prim, C)
                if r:
                    good = False
                    break
                for j, qc in enumerate(q3):
                    if qc == 0:
                        continue
                    vc = cont.mul(Coeff(qc))
                    if is_int and vc.num.denominator != 1:
                        good = False
                        break
                    hoisted.append(
                        (tuple(a + j * b for a, b in zip(base, d)), vc))
                if not good:
                    break
            if not good or len(hoisted) < 2:
                continue
            outer = [(tuple(k * x for x in d), Coeff(ck))
                     for k, ck in enumerate(C) if ck != 0]
            yield _Rewrite(sorted(hoisted), outer, 0)


def _canon(taps: list[tuple[tuple[int, ...], Coeff]]) -> tuple:
    """Shift-normalized hashable key for a tap set (cost is
    shift-invariant, so decomposition search memoizes on this)."""
    if not taps:
        return ()
    rank = len(taps[0][0])
    mins = [min(o[d] for o, _ in taps) for d in range(rank)]
    return tuple(sorted(
        (tuple(a - m for a, m in zip(o, mins)), c) for o, c in taps))


def _opt_cost(taps: list[tuple[tuple[int, ...], Coeff]], is_int: bool,
              memo: dict, depth: int = 4) -> int:
    """Minimal TOTAL op count of any bounded multi-level decomposition of
    the tap set (VERDICT r2 #9: global selection — candidates are scored
    by their fully-decomposed cost, not the one-level cost, so the chosen
    first-level rewrite is the head of an optimal decomposition within
    the candidate enumeration).  Memoized on the shift-normalized tap
    set; depth-bounded (stencil factor chains are shallow)."""
    key = _canon(taps)
    hit = memo.get(key)
    # memo entries record the DEPTH they were computed at: a value cached
    # by a shallower recursion is an upper bound, not the optimum — reuse
    # it only when it was computed at >= this depth (review finding r3)
    if hit is not None and hit[0] >= depth:
        return hit[1]
    base = _sum_cost(taps)
    memo[key] = (depth, base)  # cycle guard / depth-0 value
    if depth <= 0 or len(taps) < 3:
        return base
    best = base
    for rw in _enum_rewrites(taps, is_int):
        tot = (_opt_cost(rw.hoisted, is_int, memo, depth - 1)
               + _opt_cost(rw.outer, is_int, memo, depth - 1))
        if tot < best:
            best = tot
    memo[key] = (depth, best)
    return best


def _search(taps: list[tuple[tuple[int, ...], Coeff]], is_int: bool
            ) -> _Rewrite | None:
    """Best first-level rewrite by GLOBAL (multi-level) cost; None when no
    decomposition beats evaluating the sum directly.  Fixed-point passes
    then decompose the hoisted/outer children, whose memoized optimum
    agrees with the total chosen here."""
    old_cost = _sum_cost(taps)
    memo: dict = {}
    best: _Rewrite | None = None
    best_total = old_cost
    for rw in _enum_rewrites(taps, is_int):
        tot = (_opt_cost(rw.hoisted, is_int, memo)
               + _opt_cost(rw.outer, is_int, memo))
        if tot < best_total:
            best_total = tot
            best = _Rewrite(rw.hoisted, rw.outer, old_cost - tot)
    return best


# ---------------------------------------------------------------------------
# min/max reduction-tree reuse (DAC'20 also covers idempotent reductions,
# e.g. max-pooling): ⋃_k (G + k·d) must EQUAL the tap set, but overlap is
# allowed — min/max are idempotent, so overlapping covers admit more
# decompositions than sums (e.g. a 5-tap 1-D min = min of two 3-tap mins).
# ---------------------------------------------------------------------------


def _flatten_minmax(e: ir.Expr) -> tuple[str | None, list[ir.Expr]]:
    """Flatten nested same-fn min/max calls into ('min'|'max', leaves)."""
    if not (isinstance(e, ir.Call) and e.fn in ("min", "max")):
        return None, []
    fn = e.fn
    out: list[ir.Expr] = []

    def rec(n: ir.Expr) -> None:
        if isinstance(n, ir.Call) and n.fn == fn:
            for a in n.args:
                rec(a)
        else:
            out.append(n)

    rec(e)
    return fn, out


def _search_cover(offsets: list[tuple[int, ...]]
                  ) -> tuple[list, tuple[int, ...], int, int] | None:
    """Best (G, d, m, saved) with ⋃_k (G + k·d) == set(offsets)."""
    oset = set(offsets)
    n = len(offsets)
    if n < 3:
        return None
    dirs: list[tuple[int, ...]] = []
    seen_d: set[tuple[int, ...]] = set()
    for a in offsets:
        for b in offsets:
            if a == b:
                continue
            d = _primitive(tuple(x - y for x, y in zip(a, b)))
            if d is not None and d not in seen_d:
                seen_d.add(d)
                dirs.append(d)
    best = None
    for d in dirs:
        for m in range(2, n + 1):
            gfull = [g for g in oset
                     if all(tuple(x + k * y for x, y in zip(g, d)) in oset
                            for k in range(m))]
            if not gfull:
                break  # larger m only shrinks gfull
            gset = set(gfull)

            def covered(gs) -> bool:
                return all(any(tuple(x - k * y for x, y in zip(o, d)) in gs
                               for k in range(m)) for o in oset)

            if not covered(gset):
                continue
            # greedy prune: drop generators that stay covered without them
            for g in sorted(gfull):
                if len(gset) > 1 and covered(gset - {g}):
                    gset.remove(g)
            cost = (len(gset) - 1) + (m - 1)
            saved = (n - 1) - cost
            if saved > 0 and (best is None or saved > best[3]):
                best = (sorted(gset), d, m, saved)
    return best


def _build_fntree(fn: str, terms: list[ir.Expr]) -> ir.Expr:
    out = terms[0]
    for t in terms[1:]:
        out = ir.Call(fn, (out, t))
    return out


def _is_minmax_tree(e: ir.Expr) -> bool:
    """True for pure min/max trees over Refs (hoisted-stage typing: the
    value range equals the parent's, so the stage keeps the parent type)."""
    fn, leaves = _flatten_minmax(e)
    return fn is not None and all(isinstance(x, ir.Ref) for x in leaves)


# ---------------------------------------------------------------------------
# Expression rewriting
# ---------------------------------------------------------------------------


def _rewrite_expr(e: ir.Expr, fresh, new_stages: dict[str, ir.Expr],
                  is_int_tensor) -> ir.Expr:
    """Top-down: replace decomposable weighted-sum chains with hoisted-stage
    sums.  Top-down matters: a left-associated chain's prefixes are
    themselves sum nodes; rewriting the MAXIMAL chain first finds the full
    decomposition instead of a partial one."""

    def try_minmax(n: ir.Expr) -> ir.Expr | None:
        fn, leaves = _flatten_minmax(n)
        if fn is None or len(leaves) < 3:
            return None
        name = None
        offs: list[tuple[int, ...]] = []
        for x in leaves:
            if not isinstance(x, ir.Ref):
                return None
            if name is None:
                name = x.name
            elif x.name != name:
                return None
            offs.append(x.offsets)
        if name is None or len(set(offs)) != len(offs):
            return None
        cover = _search_cover(offs)
        if cover is None:
            return None
        gens, d, m, _saved = cover
        rank = len(gens[0])
        lo = [min(g[i] for g in gens) for i in range(rank)]
        hi = [max(g[i] for g in gens) for i in range(rank)]
        t = tuple((a + b) // 2 for a, b in zip(lo, hi))
        t_name = fresh(name)
        new_stages[t_name] = _build_fntree(
            fn, [ir.Ref(name, tuple(g[i] - t[i] for i in range(rank)))
                 for g in gens])
        return _build_fntree(
            fn, [ir.Ref(t_name, tuple(k * d[i] + t[i] for i in range(rank)))
                 for k in range(m)])

    def try_chain(n: ir.Expr) -> ir.Expr | None:
        flat = _flatten_sum(n)
        if flat is None:
            return try_minmax(n)
        # partition terms into weighted taps per tensor + opaque rest
        groups: dict[str, list[tuple[tuple[int, ...], Coeff]]] = {}
        rest: list[tuple[ir.Expr, bool]] = []
        order: list[tuple[str, str | None, int]] = []  # rebuild order
        for term, neg in flat:
            parsed = _parse_term(term)
            if parsed is None:
                order.append(("rest", None, len(rest)))
                rest.append((term, neg))
                continue
            c, name, off = parsed
            if neg:
                c = c.neg()
            g = groups.setdefault(name, [])
            order.append(("tap", name, len(g)))
            g.append((off, c))
        changed = False
        rebuilt: dict[str, ir.Expr] = {}
        for name, taps in groups.items():
            if len({o for o, _ in taps}) != len(taps):
                continue  # duplicate taps: leave alone
            is_int = is_int_tensor(name)
            rw = _search(taps, is_int)
            if rw is None:
                continue
            changed = True
            # re-anchor the hoisted stage to center its own span: stage
            # values only exist on the grid, so the border-invalid rim grows
            # by the hoisted stage's own radius — centering minimizes it.
            rank = len(rw.hoisted[0][0])
            lo = [min(o[i] for o, _ in rw.hoisted) for i in range(rank)]
            hi = [max(o[i] for o, _ in rw.hoisted) for i in range(rank)]
            t = tuple((a + b) // 2 for a, b in zip(lo, hi))
            t_name = fresh(name)
            new_stages[t_name] = _build_weighted_sum(
                [(tuple(o[i] - t[i] for i in range(rank)), c)
                 for o, c in rw.hoisted], name, is_int)
            rebuilt[name] = _build_weighted_sum(
                [(tuple(o[i] + t[i] for i in range(rank)), c)
                 for o, c in rw.outer], t_name, is_int)
        if not changed:
            return None
        # rebuild the sum: rewritten groups first (one node each), then
        # untouched groups' taps and opaque terms in original order
        parts: list[tuple[ir.Expr, bool]] = []
        emitted: set[str] = set()
        for kind, name, idx in order:
            if kind == "rest":
                parts.append(rest[idx])
            elif name in rebuilt:
                if name not in emitted:
                    emitted.add(name)
                    parts.append((rebuilt[name], False))
            else:
                off, c = groups[name][idx]
                neg = c.num < 0
                cc = c.neg() if neg else c
                parts.append(
                    (cc.to_expr(ir.Ref(name, off), is_int_tensor(name)), neg))
        out: ir.Expr | None = None
        for term, neg in parts:
            if out is None:
                out = ir.UnOp("-", term) if neg else term
            else:
                out = ir.BinOp("-" if neg else "+", out, term)
        assert out is not None
        return out

    def rec(n: ir.Expr) -> ir.Expr:
        hit = try_chain(n)
        if hit is not None:
            return hit
        if isinstance(n, ir.BinOp):
            return ir.BinOp(n.op, rec(n.lhs), rec(n.rhs))
        if isinstance(n, ir.UnOp):
            return ir.UnOp(n.op, rec(n.operand))
        if isinstance(n, ir.Call):
            return ir.Call(n.fn, tuple(rec(a) for a in n.args))
        if isinstance(n, ir.Cast):
            return ir.Cast(n.type, rec(n.operand))
        if isinstance(n, ir.Select):
            return ir.Select(rec(n.cond), rec(n.on_true), rec(n.on_false))
        return n

    return rec(e)


def _build_weighted_sum(taps: list[tuple[tuple[int, ...], Coeff]],
                        name: str, is_int: bool) -> ir.Expr:
    out: ir.Expr | None = None
    for off, c in taps:
        neg = c.num < 0
        cc = c.neg() if neg else c
        term = cc.to_expr(ir.Ref(name, off), is_int)
        if out is None:
            out = ir.UnOp("-", term) if neg else term
        else:
            out = ir.BinOp("-" if neg else "+", out, term)
    assert out is not None
    return out


def _parent_of(stage_name: str) -> str:
    return stage_name.rsplit("__cse", 1)[0]


def _type_bound(t: ScalarType) -> int:
    """Max |value| a declared integer type can hold."""
    return (2 ** t.width - 1) if t.kind == "uint" else 2 ** (t.width - 1)


def _bound_expr(e: ir.Expr, bounds: dict[str, int], params) -> int:
    """Static max-|value| bound of a hoisted sum expression (Ref/Const/
    ParamRef/Var combined with + - * only; anything else is unbounded)."""
    if isinstance(e, ir.Const):
        return abs(int(e.value)) if isinstance(e.value, int) else 1 << 200
    if isinstance(e, ir.Ref):
        return bounds.get(e.name, 1 << 200)
    if isinstance(e, (ir.ParamRef, ir.Var)):
        p = params.get(e.name)
        return _type_bound(p.type) if p and p.type.is_int else 1 << 200
    if isinstance(e, ir.UnOp) and e.op in ("-", "+"):
        return _bound_expr(e.operand, bounds, params)
    if isinstance(e, ir.BinOp):
        a = _bound_expr(e.lhs, bounds, params)
        b = _bound_expr(e.rhs, bounds, params)
        if e.op in ("+", "-"):
            return a + b
        if e.op == "*":
            return a * b
    return 1 << 200


# ---------------------------------------------------------------------------
# Program-level driver
# ---------------------------------------------------------------------------


def apply(program: StencilProgram, max_passes: int = 10) -> StencilProgram:
    """Return a new program with computation-reuse stages hoisted.

    Idempotent fixed point: passes repeat until no weighted sum chain
    factors (hoisted stages themselves are candidates — multi-level reuse,
    e.g. a separable 5x5 Gaussian becomes a binomial chain of 1-add
    stages)."""
    tensors = {n: Tensor(t.name, t.type, t.expr, t.dram, t.tile_size,
                         t.is_output, synthetic=t.synthetic)
               for n, t in program.tensors.items()}
    # static max-|value| bounds for hoisted-stage typing: inputs from
    # declared widths; stages from their expressions when tighter (a
    # uint32 stage holding a sum of uint16 taps is bounded by the
    # coefficient sum, not by 2^32 — e.g. gaussian2d's gx), in topo order
    bounds: dict[str, int] = {}
    for n in program.input_names:
        t = program.tensors[n]
        if t.type.is_int:
            bounds[n] = _type_bound(t.type)
    for n in program.stage_order():
        t = program.tensors[n]
        if t.type.is_int:
            bounds[n] = min(_type_bound(t.type),
                            _bound_expr(t.expr, bounds, program.params))
    counter = [0]

    def fresh(base: str) -> str:
        counter[0] += 1
        return f"{_parent_of(base)}__cse{counter[0]}"

    def is_int_tensor(name: str) -> bool:
        t = tensors.get(name)
        return bool(t and t.type.is_int)

    changed = True
    passes = 0
    while changed and passes < max_passes:
        changed = False
        passes += 1
        for name in list(tensors):
            t = tensors[name]
            if t.expr is None:
                continue
            new_stages: dict[str, ir.Expr] = {}
            e2 = _rewrite_expr(t.expr, fresh, new_stages, is_int_tensor)
            if new_stages:
                changed = True
                for sn, se in new_stages.items():
                    # hoisted partial sums need a NON-MASKING type: the
                    # original masks only at the final store.  Pick the
                    # store width from a STATIC VALUE BOUND (sum of
                    # |coefficients| x parent bound): int32 when the true
                    # sum provably fits (then the hoisted store never
                    # wraps, and value-dependent consumers like `/` stay
                    # exact); int64 otherwise — on such programs the TPU
                    # Pallas path (int32 accumulators) could never compute
                    # the unrewritten sum correctly either, and now rejects
                    # loudly instead of wrapping.  Floats keep their width.
                    parent = next(iter(ir.get_load_names(se)))
                    pt = tensors[parent].type
                    if pt.is_float or _is_minmax_tree(se):
                        # min/max trees never leave the parent's value
                        # range: the stage keeps the parent type exactly
                        st = pt
                        if pt.is_int:
                            bounds[sn] = bounds.get(
                                parent, _type_bound(pt))
                    else:
                        b = _bound_expr(se, bounds, program.params)
                        st = ScalarType(
                            "int", 64 if (pt.width > 32 or b >= 2**31)
                            else 32)
                        bounds[sn] = b
                    tensors[sn] = Tensor(sn, st, se, synthetic=True)
                tensors[name] = Tensor(t.name, t.type, e2, t.dram,
                                       t.tile_size, t.is_output)

    return StencilProgram(
        name=program.name,
        tensors=tensors,
        params=program.params,
        rank=program.rank,
        burst_width=program.burst_width,
        iterate=program.iterate,
        unroll_factor=program.unroll_factor,
        border=program.border,
        cluster=program.cluster,
    )


def count_adds(program: StencilProgram) -> int:
    """Total '+'/'-' nodes across stage expressions."""
    n = 0
    for t in program.tensors.values():
        if t.expr is None:
            continue
        for node in ir.walk(t.expr):
            if isinstance(node, ir.BinOp) and node.op in ("+", "-"):
                n += 1
    return n


def count_muls(program: StencilProgram) -> int:
    """Total '*' nodes across stage expressions."""
    n = 0
    for t in program.tensors.values():
        if t.expr is None:
            continue
        for node in ir.walk(t.expr):
            if isinstance(node, ir.BinOp) and node.op == "*":
                n += 1
    return n


def count_minmax(program: StencilProgram) -> int:
    """Total min/max reduction ops (k-ary call = k-1 ops)."""
    n = 0
    for t in program.tensors.values():
        if t.expr is None:
            continue
        for node in ir.walk(t.expr):
            if isinstance(node, ir.Call) and node.fn in ("min", "max"):
                n += len(node.args) - 1
    return n


def count_ops(program: StencilProgram) -> int:
    """Adds + multiplies + min/max reductions — the op-count metric the
    DAC'20 paper optimizes."""
    return count_adds(program) + count_muls(program) + count_minmax(program)
