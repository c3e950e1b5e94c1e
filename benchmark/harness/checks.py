"""The comparisons that decide ``correct``: the numbers the program's run
gave against the plain reference's on the same weights and inputs.

Training (the first three steps, which set-up drives through the window's
own call and feed):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the stepped leaves, the largest gap between the
  program's first-gradient norm (read from AdamW's first moment after step
  1) and the reference's, over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
- ``change_gap``: the same for the norm of each leaf's change after step 3,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (rounding noise that Adam's first steps turn into
  full-size moves).

Serving: ``emb_gap_max``, the largest distance between a served user vector
and the reference's, over the users of the requests sampled for the check.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

NOISE_SHARE = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's is not compared


def leafwise_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: Optional[Iterable[str]] = None) -> float:
    """max over leaves of |prog - ref| / max(ref, median ref); inf when a
    leaf is missing on either side or a number is not finite."""
    names = sorted(ref) if leaves is None else sorted(leaves)
    if set(prog) != set(ref):
        return math.inf
    median = statistics.median(ref[n] for n in ref)
    worst = 0.0
    for n in names:
        p, r = prog[n], ref[n]
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        worst = max(worst, abs(p - r) / max(r, median, 1e-30))
    return worst


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: ``losses``, ``grad_norms`` and ``change_norms`` of the
    first steps."""
    if len(prog["losses"]) != len(ref["losses"]):
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf}
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                   for p, r in zip(prog["losses"], ref["losses"]))
    median = statistics.median(ref["grad_norms"].values())
    moved = [n for n, g in ref["grad_norms"].items() if g >= NOISE_SHARE * median]
    return {
        "loss_gap": loss_gap,
        "grad_gap": leafwise_gap(prog["grad_norms"], ref["grad_norms"]),
        "change_gap": leafwise_gap(prog["change_norms"], ref["change_norms"], moved),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number read, finite and within its limit."""
    return bool(limits) and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim for k, lim in limits.items())


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers.get(k, math.nan), "limit": limits[k]} for k in limits}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> str:
    """The leaf that sets ``leafwise_gap``, for the run's log."""
    median = statistics.median(ref.values())
    common = [n for n in ref if n in prog]
    return max(common, key=lambda n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)) if common else ""
