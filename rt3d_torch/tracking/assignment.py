"""Thresholded track-detection matching (port of
`rt3d/tracking/assignment.py`).

Three solvers, as `TrackerConfig.assignment` names them:

* ``greedy``: `solve_matching_greedy` claims, round after round, every
  feasible pair that is both its row's and its column's argmin (lowest
  index on ties), which selects the same pairs as taking the globally
  cheapest pair one at a time. The loop stops when a round claims nothing;
  that test reads one flag back from the device per round.
* ``refined``: greedy, then `min(R, C)` rounds of the best pair swap and the
  best move into a free column (`_refine_matching`), on the device but for
  its 0-dim index tensors, which indexing reads back: 12 a round.
* ``exact``: the shortest-augmenting-path Hungarian method (`hungarian`)
  on the square padded matrix, with the JAX package's f32 potentials. Its
  loops read the device back three times an iteration: an off-line mode.

Every read-back goes through `rt3d_torch.runtime.trace.sync`.

Infeasible entries are those at or above the threshold; unmatched rows and
columns are reported as -1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rt3d_torch.runtime import trace

BIG = 1e3    # finite infeasible cost of the exact solver's padded matrix
_INF = 1e18


def _unmatched(r: int, c: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((r,), -1, dtype=torch.int32, device=dev),
            torch.full((c,), -1, dtype=torch.int32, device=dev))


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost perfect assignment of a square (n, n) matrix: (n,) int32
    column of each row. The potentials are f32, updated in the JAX
    package's order, and ties go to the lowest column."""
    n = cost.shape[0]
    assert cost.shape == (n, n)
    dev = cost.device
    a = F.pad(cost.float(), (1, 0, 1, 0))  # 1-indexed
    u = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    p = torch.zeros(n + 1, dtype=torch.long, device=dev)
    inf = torch.full((), _INF, dtype=torch.float32, device=dev)
    for i in range(1, n + 1):
        minv = torch.full((n + 1,), _INF, dtype=torch.float32, device=dev)
        used = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        way = torch.zeros(n + 1, dtype=torch.long, device=dev)
        # a Python scalar written into a CUDA tensor goes through a blocking copy
        with trace.sync("assignment.exact_start"):
            p[0] = i
        j0 = 0
        while True:
            with trace.sync("assignment.exact_row"):
                i0 = int(p[j0])
            if i0 == 0:
                break
            with trace.sync("assignment.exact_used"):
                used[j0] = True
            cur = a[i0] - u[i0] - v
            upd = ~used & (cur < minv)
            minv = torch.where(upd, cur, minv)
            way = torch.where(upd, j0, way)
            masked = torch.where(used, inf, minv)
            masked[0] = inf
            with trace.sync("assignment.exact_argmin"):
                j1 = int(torch.argmin(masked))
            delta = masked[j1]
            step = torch.where(used, delta, 0.0)
            # p holds the dummy row 0 many times: each column adds its own
            # term, as the JAX package's scatter-add does
            u = u.index_add(0, p, step)
            v = v - step
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
        with trace.sync("assignment.exact_way"):
            way_h = way.tolist()
        with trace.sync("assignment.exact_rows"):
            p_h = p.tolist()
        while j0 != 0:
            j1 = way_h[j0]
            p_h[j0] = p_h[j1]
            j0 = j1
        with trace.sync("assignment.exact_upload"):
            p = torch.tensor(p_h, dtype=torch.long, device=dev)
    row_for_col = p[1:] - 1
    col_for_row = torch.zeros(n, dtype=torch.int32, device=dev)
    col_for_row[row_for_col] = torch.arange(n, dtype=torch.int32, device=dev)
    return col_for_row


def solve_matching_exact(cost: torch.Tensor, thresh: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thresholded rectangular matching by `hungarian` on the square matrix
    padded with `BIG`: the most feasible matches, then the least cost."""
    r, c = cost.shape
    if r == 0 or c == 0:
        return _unmatched(r, c, cost.device)
    s = max(r, c)
    feas = cost < thresh
    padded = torch.full((s, s), BIG, dtype=torch.float32, device=cost.device)
    padded[:r, :c] = torch.where(feas, cost.float(), BIG)
    assigned = hungarian(padded)[:r]
    rows = torch.arange(r, device=cost.device)
    ok = (assigned < c) & feas[rows, torch.clamp(assigned, 0, c - 1).long()]
    col_of_row = torch.where(ok, assigned, -1).to(torch.int32)
    row_of_col = torch.full((c + 1,), -1, dtype=torch.int32, device=cost.device)
    row_of_col[torch.where(ok, assigned, c).long()] = rows.to(torch.int32)
    return col_of_row, row_of_col[:c]


def solve_matching_greedy(cost: torch.Tensor, thresh: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cost (R, C); entries >= thresh are infeasible. Returns
    (col_of_row (R,) int32, row_of_col (C,) int32), -1 where unmatched."""
    r, c = cost.shape
    dev = cost.device
    col_of_row, row_of_col = _unmatched(r, c, dev)
    if r == 0 or c == 0:
        return col_of_row, row_of_col
    big = 1e9
    cm = torch.where(cost < thresh, cost, big)
    rows = torch.arange(r, dtype=torch.int32, device=dev)
    for _ in range(min(r, c)):
        rmin = torch.argmin(cm, dim=1)
        cmin = torch.argmin(cm, dim=0).to(torch.int32)
        mutual = (cm[rows.long(), rmin] < big) & (cmin[rmin] == rows)
        col_of_row = torch.where(mutual, rmin.to(torch.int32), col_of_row)
        # mutual rows claim distinct columns; the rest write the drop slot c
        tgt = torch.where(mutual, rmin, c)
        roc = torch.cat([row_of_col, row_of_col.new_full((1,), -1)])
        row_of_col = roc.scatter(0, tgt, torch.where(mutual, rows, -1))[:c]
        hit = torch.zeros(c + 1, dtype=torch.bool, device=dev).scatter(
            0, tgt, mutual)[:c]
        cm = torch.where(mutual[:, None] | hit[None, :], big, cm)
        with trace.sync("assignment.greedy_round"):
            if not bool(mutual.any()):
                break
    return col_of_row, row_of_col


def _set(x: torch.Tensor, i: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``x.at[i].set(val)`` for a 0-dim index tensor, which indexing reads
    back to the host."""
    y = x.clone()
    with trace.sync("assignment.refine_index"):
        y[i] = val
    return y


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, read back to the host as `_set`'s."""
    with trace.sync("assignment.refine_index"):
        return x[i]


def _refine_matching(cost: torch.Tensor, thresh: float, col_of_row: torch.Tensor,
                     row_of_col: torch.Tensor, rounds: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`rounds` rounds of local improvement, each the best pair swap of two
    matched rows' columns, then the best move of a row into a free feasible
    column (an unmatched row's move extends the matching); a change is
    taken when it lowers the cost by more than 1e-7."""
    r, c = cost.shape
    dev = cost.device
    big = 1e9
    cm = torch.where(cost < thresh, cost.float(), big)
    rows = torch.arange(r, device=dev)
    col_of_row, row_of_col = col_of_row.long(), row_of_col.long()
    for _ in range(rounds):
        # swap
        mcol = torch.clamp(col_of_row, 0, c - 1)
        matched = col_of_row >= 0
        cur = torch.where(matched, cm[rows, mcol], 0.0)
        ci_ck = cm[:, mcol]
        both = matched[:, None] & matched[None, :]
        swap_delta = torch.where(both & (rows[:, None] != rows[None, :]),
                                 ci_ck + ci_ck.T - cur[:, None] - cur[None, :], 0.0)
        flat = torch.argmin(swap_delta)
        si, sk = flat // r, flat % r
        do = _at(swap_delta.reshape(-1), flat) < -1e-7
        ci, ck = _at(col_of_row, si), _at(col_of_row, sk)
        col_sw = _set(_set(col_of_row, si, ck), sk, ci)
        row_sw = _set(_set(row_of_col, torch.clamp(ci, 0, c - 1), sk),
                      torch.clamp(ck, 0, c - 1), si)
        col_of_row = torch.where(do, col_sw, col_of_row)
        row_of_col = torch.where(do, row_sw, row_of_col)
        # move
        mcol = torch.clamp(col_of_row, 0, c - 1)
        matched = col_of_row >= 0
        cur = torch.where(matched, cm[rows, mcol], 0.0)
        free = row_of_col < 0
        move_delta = torch.where(free[None, :], cm, big) - cur[:, None]
        move_delta = torch.where(
            matched[:, None], move_delta,
            torch.where(free[None, :] & (cm < big), cm - big * 0.5, 0.0))
        flat = torch.argmin(move_delta)
        mi, mj = flat // c, flat % c
        do = _at(move_delta.reshape(-1), flat) < -1e-7
        old = _at(col_of_row, mi)
        row_mv = torch.where(old >= 0, _set(row_of_col, torch.clamp(old, 0, c - 1),
                                            rows.new_full((), -1)),
                             row_of_col)
        row_mv = _set(row_mv, mj, mi)
        col_mv = _set(col_of_row, mi, mj)
        col_of_row = torch.where(do, col_mv, col_of_row)
        row_of_col = torch.where(do, row_mv, row_of_col)
    return col_of_row.to(torch.int32), row_of_col.to(torch.int32)


def solve_matching_refined(cost: torch.Tensor, thresh: float,
                           rounds: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy, then `rounds` (default min(R, C)) rounds of `_refine_matching`."""
    col_of_row, row_of_col = solve_matching_greedy(cost, thresh)
    r, c = cost.shape
    if r == 0 or c == 0:
        return col_of_row, row_of_col
    return _refine_matching(cost, thresh, col_of_row, row_of_col,
                            min(r, c) if rounds is None else rounds)


def solve_matching(cost: torch.Tensor, thresh: float, method: str = "greedy"):
    if method == "exact":
        return solve_matching_exact(cost, thresh)
    if method == "greedy":
        return solve_matching_greedy(cost, thresh)
    if method == "refined":
        return solve_matching_refined(cost, thresh)
    raise ValueError(f"unknown assignment method {method!r}; "
                     "expected 'greedy', 'refined', or 'exact'")
