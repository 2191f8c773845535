"""Hybrid-random initial simplex generation.

Re-expression of the reference's ``write_initial_simplex``
(/root/reference/offt-tuning.c:426-738): 25 vertices whose coordinates are
drawn uniformly inside heuristic sub-ranges (cache-size and message-size
informed), with forced decomposition coverage — fixed vertices pin P1 to
1, p, and ~sqrt(p) so the simplex always spans slab/pencil extremes
(offt-tuning.c:662-686). Our sub-range heuristics: small-ish pipeline
tiles, low windows, balanced radices preferred; the default heuristic
point is always vertex 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..plan.params import default_params
from .space import Point, SearchSpace


def hybrid_initial_simplex(
    space: SearchSpace,
    size: Optional[int] = None,
    seed: int = 0,
) -> list[Point]:
    """Build an initial simplex of index points for NM/PRO."""
    rng = np.random.default_rng(seed)
    n = len(space.dims)
    size = size or max(n + 1, 4)
    names = space.names
    pts: list[Point] = []

    # vertex 0: the heuristic default (the >=20% baseline)
    spec = space.spec
    fixed_p1 = None
    if "p1" in names and len(space.dims[names.index("p1")]) == 1:
        fixed_p1 = space.dims[names.index("p1")].values[0]
    pts.append(space.from_params(default_params(spec, p1=fixed_p1)))

    # forced P1 coverage (offt-tuning.c:662-686): slab both ways + square
    if "p1" in names and len(space.dims[names.index("p1")]) > 1:
        i_p1 = names.index("p1")
        vals = space.dims[i_p1].values
        root = int(np.sqrt(spec.p))
        targets = [vals[0], vals[-1],
                   min(vals, key=lambda v: abs(v - root))]
        for tgt in targets:
            pt = list(space.random_point(rng))
            pt[i_p1] = vals.index(tgt)
            pts.append(tuple(pt))

    # biased random rest: favour the low half of tile/window grids (the
    # cache-informed sub-ranges of the reference) and any-of for the rest
    low_biased = {"t1", "t2", "w1", "w2"}
    while len(pts) < size:
        pt = []
        for d in space.dims:
            hi = len(d)
            if d.name in low_biased and hi > 2:
                pt.append(int(rng.integers(0, max(hi // 2, 1))))
            else:
                pt.append(int(rng.integers(0, hi)))
        pts.append(tuple(pt))
    # dedupe while preserving order
    seen = set()
    out = []
    for p in pts:
        if p not in seen:
            seen.add(p)
            out.append(p)
    while len(out) < size:
        out.append(space.random_point(rng))
    return out[:size]
