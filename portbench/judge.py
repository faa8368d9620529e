"""The comparison that decides ``correct``.

The program's logits of each judged forward are held against the plain
reference's float32 logits of the same tokens and weights, in blocks of
rows so that no float32 copy of the program's logits is made whole:

* ``logit_err``   — ‖P − R‖ / ‖R‖ over every judged logit (Frobenius
  norms): the error of the forwards as a whole;
* ``row_err_max`` — the largest ‖P_r − R_r‖ / ‖R_r‖ over the judged rows
  (one row a (prompt, position)): an error confined to a few positions or
  prompts.

A number that is not finite reads as ``inf``.  Each number is compared
with its limit in the configuration file: ``correct`` holds when every
number lies at or below its limit.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

__all__ = ["NUMBERS", "Tally", "verdict"]

NUMBERS = ("logit_err", "row_err_max")
_ROWS = 2048


class Tally:
    """Accumulates the numbers over judged forwards."""

    def __init__(self):
        self.diff_sq = 0.0
        self.ref_sq = 0.0
        self.row_max = 0.0
        self.rows = 0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        """``got``: the program's logits (..., V); ``want``: the
        reference's, float32, same shape."""
        if tuple(got.shape) != tuple(want.shape):
            self.diff_sq = math.inf
            self.row_max = math.inf
            return
        g = got.reshape(-1, got.shape[-1])
        w = want.reshape(-1, want.shape[-1])
        for i in range(0, g.shape[0], _ROWS):
            wb = w[i:i + _ROWS].float()
            d = (g[i:i + _ROWS].float() - wb).square().sum(-1).double()
            r = wb.square().sum(-1).double()
            self.diff_sq += float(d.sum())
            self.ref_sq += float(r.sum())
            worst = float((d / r.clamp_min(1e-300)).max().sqrt())
            if not worst <= self.row_max:
                # A row that is not finite reads as inf.
                self.row_max = worst if worst == worst else math.inf
            self.rows += d.numel()

    def numbers(self) -> Dict[str, float]:
        if self.rows == 0:
            return {k: math.inf for k in NUMBERS}
        err = math.sqrt(self.diff_sq / self.ref_sq) if self.ref_sq else math.inf
        out = {"logit_err": err, "row_err_max": self.row_max}
        return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or below its limit (a limit not yet set fails)."""
    return all(limits.get(k) is not None and numbers[k] <= limits[k]
               for k in NUMBERS)


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """One line a number: its name, its reading and its limit."""
    return [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in NUMBERS]
