"""The comparison that decides ``correct``: each number beside its limit.

Numbers (all read so that 0 is agreement):

* ``loss1_gap`` — the first training step's loss, |L_p − L_r| / |L_r|
  (the later steps' gaps are shown beside it: Adam's first steps move
  every weight by about ±lr whatever the gradient's size, so where the two
  gradients differ in sign the two runs part, and those gaps swing from
  seed to seed by more than the control moves them);
* ``grad1_gap`` — the first step's clipped gradient as the optimizer got
  it, by the worst leaf: |‖g_p‖ − ‖g_r‖| / max(‖g_r‖, the median leaf's);
* ``change3_gap`` — the parameters' change after those steps, by the worst
  leaf, likewise; leaves whose reference gradient is under a thousandth of
  the median leaf's (moved by round-off alone under Adam) are left out;
* ``feat0_gap`` / ``featw_gap`` — proxy features of the first refresh
  (from the seeded weights) and of the window's last refresh (from that
  refresh's parameter snapshot), over a seeded sample of documents:
  the largest ‖f_p − f_r‖ / ‖f_r‖;
* ``select_gap`` — the window's last selection: |L(S_p) − L(S_r)| / L(S_r)
  in fp64 on the program's features, S_r the reference's greedy from the
  same warm start;
* ``gamma_gap`` — Σ_j |γ_p − γ_r| / n, γ_r the fp64 cluster sizes of S_p;
* ``install_miss`` — window training rows whose document is not in the
  installed coreset or whose weight is not γ·r/Σγ (exact: limit 0).
"""
from __future__ import annotations

import math
import statistics

__all__ = ["step_gaps", "norm_gap", "moving_leaves", "row_gap", "judge", "format_lines"]


def step_gaps(program: list, reference: list) -> list[float]:
    """|L_p − L_r| / |L_r| for each step."""
    return [abs(p - r) / abs(r) for p, r in zip(program, reference, strict=True)]


def norm_gap(program: dict, reference: dict, keep=None) -> float:
    """Worst leaf's |‖·‖_p − ‖·‖_r| over max(‖·‖_r, the median leaf's)."""
    names = [k for k in reference if keep is None or k in keep]
    med = statistics.median(reference[k] for k in names)
    return max(abs(program[k] - reference[k]) / max(reference[k], med) for k in names)


def moving_leaves(grad1_ref: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(grad1_ref.values())
    return {k for k, v in grad1_ref.items() if v >= 1e-3 * med}


def row_gap(program, reference) -> float:
    """Largest ‖f_p − f_r‖ / ‖f_r‖ over rows (tensors of one shape)."""
    p, r = program.double(), reference.double()
    return float(((p - r).norm(dim=1) / r.norm(dim=1)).max())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell
    compares; a number without a finite value fails.  A limit of null
    leaves the number out (no reading separates it); a number the limits
    file does not name is an error of the cell's files."""
    out, ok = {}, True
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in the cell's limits file")
        if limits[name] is None:
            continue
        limit = float(limits[name])
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def format_lines(checked: dict) -> list[str]:
    return [f"check {name} {v['value']!r} limit {v['limit']!r}" for name, v in checked.items()]
