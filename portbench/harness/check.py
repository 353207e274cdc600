"""The comparison that decides ``correct``.

The program and the plain reference start from the same weights, data
and seed and run two fits each, every step on the cell's own step path,
shuffle and row gather:

  * fit A, one step: one epoch over the train split's first batch;
  * fit B, three steps: one epoch over its first three batches, so the
    three steps train on rows that all differ, gathered at step offsets
    0, 1 and 2 of the epoch's permutation.

Four numbers, each held to its limit (``limits/<workload>.json``):

  * ``loss_gap``: the larger gap between the two sides' train
    loss_total, of fit A's step and of the mean of fit B's three steps
    (the program's history holds an epoch's mean), relative to the
    magnitudes the reference summed into it (``loss_scale``: the
    flagship's ELBO is a sum of pixels' log densities of both signs,
    which can cancel to near 0);
  * ``val_gap``: the same of their val loss_total after fit A's step;
  * ``grad_gap``: the first gradient as the optimizer holds it (fit A's
    first moment, (1 - b1) g), by the worst leaf: the gap between the
    two sides' norms of the leaf over the larger of the reference's norm
    of that leaf and of the median leaf;
  * ``change_gap``: fit B's change of the parameters, by the worst leaf,
    each measured as ``grad_gap``'s leaves, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's (a
    smaller one moves under Adam by round-off alone). A leaf of points
    on the ball is measured point by point, the median point standing
    for the leaf: the first moment of a point is carried to its new
    point by parallel transport, which in f32 leaves an error of ~1e-6
    in each coordinate; where that coordinate's second moment is all
    but zero, Riemannian Adam steps it by up to several learning rates
    on that error, in the program and in the reference alike and
    differently, where float64 takes no such step (PERF.md gives the
    readings). The worst point's gap, the val gap after fit B's three
    steps and a few more are computed beside them, uncompared.

A number that is not finite on the program's side reads infinity.
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss_gap", "val_gap", "grad_gap", "change_gap")
TINY_GRAD = 1e-3  # leaves under this share of the median leaf's gradient move by round-off


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double().cpu()))


def _rel(a: float, b: float, scale: float) -> float:
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / max(abs(b), scale, 1e-30)


def _gap(pn: float, rn: float, scale: float) -> float:
    return math.inf if not math.isfinite(pn) else abs(pn - rn) / max(rn, scale, 1e-30)


def leaf_gaps(prog: dict, ref: dict, names) -> list:
    """|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖) of each leaf of ``names``."""
    rn = {k: _norm(ref[k]) for k in names}
    med = statistics.median(rn.values())
    return [_gap(_norm(prog[k]), rn[k], med) for k in names]


def point_gaps(prog: torch.Tensor, ref: torch.Tensor) -> list:
    """The gap of each point (row) of a leaf on the ball, as ``leaf_gaps``'
    over the points."""
    pn = torch.linalg.vector_norm(prog.detach().double().cpu(), dim=-1).tolist()
    rn = torch.linalg.vector_norm(ref.detach().double().cpu(), dim=-1).tolist()
    med = statistics.median(rn)
    return [_gap(a, b, med) for a, b in zip(pn, rn)]


def numbers(prog: dict, ref: dict, params0: dict, manifold=()) -> dict:
    """The numbers from the two sides' readings of fits A and B (``a``,
    ``b``: each ``loss``, ``val``, ``m1``, ``params``; see
    ``reference._follow.follow``), those compared and those computed
    beside them; ``manifold`` names the leaves of points on the ball."""
    pa, pb, ra, rb = prog["a"], prog["b"], ref["a"], ref["b"]
    if len(pa["loss"]) != 1 or len(pb["loss"]) != 1 or len(pa["val"]) != 1 or len(pb["val"]) != 1:
        return {k: math.inf for k in NUMBERS}
    loss = [_rel(p["loss"][0], r["loss"][0], r["loss_scale"][0])
            for p, r in ((pa, ra), (pb, rb))]
    out = {"loss_gap": max(loss),
           "val_gap": _rel(pa["val"][0]["loss_total"], ra["val"][0]["loss_total"],
                           ra["val"][0]["loss_scale"]),
           "grad_gap": max(leaf_gaps(pa["m1"], ra["m1"], list(ra["m1"]))),
           "val_gap_3": _rel(pb["val"][0]["loss_total"], rb["val"][0]["loss_total"],
                             rb["val"][0]["loss_scale"])}
    g = {k: _norm(v) for k, v in rb["m1"].items()}
    med = statistics.median(g.values())
    moved = [k for k in params0 if g[k] >= TINY_GRAD * med]
    p0 = {k: params0[k].detach().double().cpu() for k in moved}
    dp = {k: pb["params"][k].double().cpu() - p0[k] for k in moved}
    dr = {k: rb["params"][k].double().cpu() - p0[k] for k in moved}
    gaps = dict(zip(moved, leaf_gaps(dp, dr, moved)))
    worst_point = 0.0
    for k in moved:
        if k in manifold:
            points = point_gaps(dp[k], dr[k])
            gaps[k] = statistics.median(points)
            worst_point = max(worst_point, max(points))
    out["change_gap"] = max(gaps.values())
    out["change_gap_worst_point"] = worst_point
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): correct when every number is at
    most its limit."""
    rows = [(k, values[k], float(limits[k])) for k in NUMBERS]
    return all(v <= lim for _, v, lim in rows), rows
