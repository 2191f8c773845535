"""Discrete search space over plan parameters.

Mirrors the reference's tuning-space setup: Active Harmony sessions bind 24
int variables V00..V23 that are *indices into per-parameter value grids*
(offt-tuning.c:779-786, grids built by params_range_setup,
offt-compute.c:2998-3093). We keep exactly that shape: a SearchSpace is an
ordered list of named dimensions, each with a static tuple of legal values;
points are index vectors; conversion to/from PlanParams is the analogue of
params_convert (offt-tuning.c:80-136).
"""

from __future__ import annotations

import ast
import dataclasses
import itertools
import operator
from typing import Optional, Sequence

from ..kernels import dft
from ..plan.params import (
    ENGINES,
    PlanParams,
    ProblemSpec,
    infeasible_reason,
    p1_candidates,
    pow2_grid,
)

Point = tuple  # index vector, one int per dimension


# ---- safe constraint expressions ------------------------------------------
# The reference pipes constraint text through the Omega calculator
# (plugins/constraint.c) — a restricted arithmetic language. We mirror that
# restriction with an AST whitelist: comparisons / bool ops / arithmetic /
# names / min|max|abs calls only. eval() with empty __builtins__ is NOT a
# sandbox (escapable via attribute chains), so attribute access, subscripts,
# lambdas etc. are rejected outright.

_BIN_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
}
_CMP_OPS = {
    ast.Lt: operator.lt, ast.LtE: operator.le, ast.Gt: operator.gt,
    ast.GtE: operator.ge, ast.Eq: operator.eq, ast.NotEq: operator.ne,
}
_SAFE_FNS = {"min": min, "max": max, "abs": abs}


def _eval_node(node, env: dict):
    if isinstance(node, ast.Expression):
        return _eval_node(node.body, env)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float, bool)):
            return node.value
        raise ValueError(f"constant {node.value!r} not allowed")
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        raise ValueError(f"unknown name {node.id!r}")
    if isinstance(node, ast.BoolOp):
        vals = (_eval_node(v, env) for v in node.values)
        return all(vals) if isinstance(node.op, ast.And) else any(vals)
    if isinstance(node, ast.UnaryOp):
        v = _eval_node(node.operand, env)
        if isinstance(node.op, ast.Not):
            return not v
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return +v
        raise ValueError("unary op not allowed")
    if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
        return _BIN_OPS[type(node.op)](_eval_node(node.left, env),
                                       _eval_node(node.right, env))
    if isinstance(node, ast.Compare):
        left = _eval_node(node.left, env)
        for op, comp in zip(node.ops, node.comparators):
            if type(op) not in _CMP_OPS:
                raise ValueError("comparison op not allowed")
            right = _eval_node(comp, env)
            if not _CMP_OPS[type(op)](left, right):
                return False
            left = right
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in _SAFE_FNS and not node.keywords):
        return _SAFE_FNS[node.func.id](*(_eval_node(a, env)
                                         for a in node.args))
    raise ValueError(f"expression node {type(node).__name__} not allowed")


def eval_constraint(expr: str, env: dict) -> bool:
    """Evaluate a constraint expression over dimension values, whitelisted
    to arithmetic/comparison/min|max|abs — safe for untrusted config text."""
    return bool(_eval_node(ast.parse(expr, mode="eval"), env))


@dataclasses.dataclass(frozen=True)
class Dimension:
    name: str
    values: tuple

    def __len__(self):
        return len(self.values)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    spec: ProblemSpec
    dims: tuple[Dimension, ...]
    # expression constraints over parameter names, e.g. "t1 <= 2 * t2" —
    # the analogue of Active Harmony's Omega constraint plugin
    # (plugins/constraint.c: user constraint text filters candidate points
    # before they reach clients, REJECTing violators back to the strategy)
    constraints: tuple[str, ...] = ()

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(d.name for d in self.dims)

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(len(d) for d in self.dims)

    def size(self) -> int:
        s = 1
        for d in self.dims:
            s *= len(d)
        return s

    def clip(self, point: Sequence[float]) -> Point:
        """Snap a real-valued vector onto the index grid (libvertex
        vertex_regrid analogue, libvertex.c:317-366)."""
        out = []
        for v, d in zip(point, self.dims):
            i = int(round(v))
            out.append(max(0, min(len(d) - 1, i)))
        return tuple(out)

    def to_params(self, point: Point) -> PlanParams:
        kw = {}
        for i, d in zip(point, self.dims):
            kw[d.name] = d.values[int(i)]
        return PlanParams(**kw)

    def from_params(self, params: PlanParams) -> Point:
        out = []
        for d in self.dims:
            v = getattr(params, d.name)
            if v in d.values:
                out.append(d.values.index(v))
            else:  # snap to nearest grid value (grid_value_floor analogue)
                numeric = [x for x in d.values if isinstance(x, int)]
                if numeric and isinstance(v, int):
                    nearest = min(numeric, key=lambda x: abs(x - v))
                    out.append(d.values.index(nearest))
                else:
                    out.append(0)
        return tuple(out)

    def infeasible_reason(self, point: Point) -> Optional[str]:
        params = self.to_params(point)
        reason = infeasible_reason(self.spec, params)
        if reason is not None:
            return reason
        if self.constraints:
            env = {d.name: d.values[int(i)]
                   for i, d in zip(point, self.dims)}
            for expr in self.constraints:
                try:
                    ok = eval_constraint(expr, env)
                except Exception as e:
                    return f"constraint {expr!r} errored: {e!r}"
                if not ok:
                    return f"constraint violated: {expr}"
        return None

    def random_point(self, rng) -> Point:
        return tuple(int(rng.integers(0, len(d))) for d in self.dims)


def _radix_candidates(n: int, limit: int = 12) -> tuple:
    """A few good factorizations of n for the matmul engine: the balanced
    default plus greedy largest-first and some near-balanced alternates.
    Both orders of each 2-factor split are included (stage order changes
    which matmul carries the larger contraction)."""
    if n <= 1:
        return (None,)
    cands = [None, dft.factorize(n)]  # None = library default
    # greedy largest-first (fewest big stages)
    m, greedy = n, []
    while m > 1:
        r = next((d for d in range(min(dft.MAX_RADIX, m), 1, -1) if m % d == 0), m)
        if r > dft.MAX_RADIX:
            return (None,)  # non-smooth: Bluestein path, no choice
        greedy.append(r)
        m //= r
    cands.append(tuple(sorted(greedy, reverse=True)))
    # all 2-factor splits within radix bound, both stage orders
    for a in range(2, int(n ** 0.5) + 1):
        if n % a == 0 and a <= dft.MAX_RADIX and n // a <= dft.MAX_RADIX:
            cands.append((n // a, a))
            if a != n // a:
                cands.append((a, n // a))
    # near-balanced 3-stage splits, small radix first: fewer MACs per
    # element than the 2-stage split at the cost of one more pass
    c = round(n ** (1 / 3))
    for a in sorted({c - 1, c, c + 1, 2, 4, 8}):
        if a < 2 or n % a or a > 32:
            continue
        m = n // a
        for b in range(max(2, round(m ** 0.5) - 2), int(m ** 0.5) + 1):
            if m % b == 0 and b <= 32 and 1 < m // b <= 32:
                cands.append(tuple(sorted((a, b, m // b))))
    uniq = []
    for c in cands:
        if c not in uniq:
            uniq.append(c)
    return tuple(uniq[:limit])


def _split1d_candidates(spec, limit: int = 8) -> tuple:
    """Candidate (n1, n2) matrix views for the distributed long-1-D engine
    (a degenerate (1, 1, N) c2c plan on a mesh, dist/long1d.py). None =
    the auto pick. Only P-divisible pairs are offered: the engine shards
    both matrix axes, and any other pair would silently fall back to the
    degenerate pencil path — a wasted trial measuring another engine."""
    from ..dist.long1d import pick_split

    n = spec.shape[2]
    if spec.real or spec.p <= 1 or pick_split(n, divisor=spec.p) is None:
        return (None,)
    cands = [None]
    for d in range(2, int(n ** 0.5) + 1):
        if n % d:
            continue
        for n1, n2 in ((d, n // d), (n // d, d)):
            sp = pick_split(n, (n1, n2), divisor=spec.p)
            if sp is not None and sp not in cands:
                cands.append(sp)
    # keep the most balanced few
    cands[1:] = sorted(cands[1:], key=lambda s: abs(s[1] - s[0]))[:limit - 1]
    return tuple(cands)


def build_space(
    spec: ProblemSpec,
    fixed_p1: Optional[int] = None,
    include_radix: bool = True,
    max_tile: int = 32,
    constraints: tuple[str, ...] = (),
) -> SearchSpace:
    """The plan search space (SURVEY.md §2c surviving-knob mapping)."""
    nx, ny, nz = spec.shape
    nzf = spec.nz_freq
    p = spec.p
    dims = []
    if p > 1:
        # distributed-only knobs (pipeline chunking, transpose strategy)
        if fixed_p1 is not None:
            dims.append(Dimension("p1", (fixed_p1,)))
        else:
            dims.append(Dimension("p1", tuple(p1_candidates(nx, ny, nz, p))))
        p2_min = max(1, p // max(d for d in p1_candidates(nx, ny, nz, p)))
        m1 = max(1, nx // max(1, min(p1_candidates(nx, ny, nz, p))))
        m3 = max(1, nzf // max(1, p2_min))
        dims.append(Dimension("t1", tuple(pow2_grid(1, min(max_tile, m1)))))
        dims.append(Dimension("t2", tuple(pow2_grid(1, min(max_tile, m3)))))
        # full reference W grid 0..10 (offt.h:78-79); w > t is pruned by
        # the feasibility predicate, so the extra points are free
        dims.append(Dimension("w1", tuple(range(0, 11))))
        dims.append(Dimension("w2", tuple(range(0, 11))))
        dims.append(Dimension("ry", tuple(range(0, 11))))
        dims.append(Dimension("s1", (0, 1)))
        dims.append(Dimension("s2", (0, 1)))
        dims.append(Dimension("v", (0, 1, 2, 3)))
        # device->grid assignment (ROTATE_RANKORDER analogue): mesh as
        # given vs the two explicit orders
        dims.append(Dimension("rankorder", (0, 1, 2)))
    # the local engine: XLA's FFT or the matmul chain, offered on every
    # backend
    dims.append(Dimension("engine", ENGINES))
    if include_radix:
        # matmul-engine radices (infeasible with the XLA engine, so those
        # points are rejected before they are timed)
        dims.append(Dimension("radix_z", _radix_candidates(nz if not spec.real
                                                           else nz // 2)))
        dims.append(Dimension("radix_y", _radix_candidates(ny)))
        dims.append(Dimension("radix_x", _radix_candidates(nx)))
    # (n1, n2) view of the distributed long-1-D engine (dist/long1d.py)
    s1d = _split1d_candidates(spec) if (nx, ny) == (1, 1) else (None,)
    if len(s1d) > 1:
        dims.append(Dimension("split_1d", s1d))
    return SearchSpace(spec=spec, dims=tuple(dims),
                       constraints=tuple(constraints))


def grid_iter(space: SearchSpace):
    """Odometer walk over the whole grid (brute.c:142-157 vertex_incr)."""
    return itertools.product(*(range(len(d)) for d in space.dims))
