"""Thresholded track-detection matching (port of the greedy solver of
`rt3d/tracking/assignment.py`).

`solve_matching_greedy` claims, round after round, every feasible pair that
is both its row's and its column's argmin (lowest index on ties), which
selects the same pairs as taking the globally cheapest pair one at a time.
The loop stops when a round claims nothing; that test reads one flag back
from the device per round.
"""

from __future__ import annotations

from typing import Tuple

import torch


def solve_matching_greedy(cost: torch.Tensor, thresh: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cost (R, C); entries >= thresh are infeasible. Returns
    (col_of_row (R,) int32, row_of_col (C,) int32), -1 where unmatched."""
    r, c = cost.shape
    dev = cost.device
    col_of_row = torch.full((r,), -1, dtype=torch.int32, device=dev)
    row_of_col = torch.full((c,), -1, dtype=torch.int32, device=dev)
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
        if not bool(mutual.any()):
            break
    return col_of_row, row_of_col


def solve_matching(cost: torch.Tensor, thresh: float, method: str = "greedy"):
    if method == "greedy":
        return solve_matching_greedy(cost, thresh)
    if method in ("refined", "exact"):
        raise NotImplementedError(
            f"assignment {method!r} is ROADMAP item 13; the port has 'greedy'")
    raise ValueError(f"unknown assignment method {method!r}")
