"""The numbers that decide ``correct``: the program's first round against
the plain reference's, from the same seed.

Norm gaps are taken leaf by leaf, as the gap between the two norms (not the
norm of their difference), over the reference's norm of that leaf or its
median leaf's, whichever is larger, and the worst leaf counts:

- ``grad0``   each client's first gradient as the optimizer gets it, every
              parameter leaf whose reference norm is at least a thousandth
              of the median leaf's (a gradient nought to rounding has no
              scale to be judged against);
- ``step3``   each client's change of state (parameters and BatchNorm
              statistics) over the round's first three steps;
- ``loss``    each client's per-epoch sum of batch losses, relative;
- ``delta``   each client's trained delta, every parameter and BatchNorm
              statistic;
- ``server``  the new global model's change, every leaf;
- ``server_rule`` the program's new global model against FedAvg worked
              out in float64 over the deltas the program submitted: the
              norm of their difference, leaf by leaf, over the norm of
              that leaf's change (or the median leaf's, if larger), every
              parameter and BatchNorm statistic. It holds the server rule
              by itself, free of the training's chaos;
- ``eval_loss`` / ``eval_acc``  every battery row the program reported,
              loss relative, accuracy in percentage points, with the
              reference evaluating the models the program produced.

A cell's ``limits/<workload>.json`` gives the limit of each number it
compares; a number above its limit, or one that is not finite, makes the
run not correct. A number the file leaves out is reported and not
compared (PERF.md says why for each).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

NAMES = ("grad0", "step3", "loss", "delta", "server", "server_rule",
         "eval_loss", "eval_acc")


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              skip_small: bool = False) -> float:
    vals = sorted(ref.values())
    med = vals[len(vals) // 2] if vals else 0.0
    worst = 0.0
    for k, r in ref.items():
        if skip_small and r < 1e-3 * med:
            continue
        den = max(r, med)
        p = prog[k]
        if den == 0.0:
            gap = 0.0 if p == 0.0 else math.inf
        else:
            gap = abs(p - r) / den
        if not math.isfinite(p):
            gap = math.inf
        worst = max(worst, gap)
    return worst


def _diff_gap(prog: tuple, ref: tuple, change: tuple) -> float:
    """The worst leaf's norm of (prog - ref) over the norm of its change,
    or the median leaf's change, whichever is larger."""
    diff, den = {}, {}
    for i in range(2):
        for k, r in ref[i].items():
            diff[k] = float((prog[i][k].double() - r).norm())
            den[k] = float(change[i][k].norm())
    vals = sorted(den.values())
    med = vals[len(vals) // 2] if vals else 0.0
    worst = 0.0
    for k, d in diff.items():
        scale = max(den[k], med)
        if not math.isfinite(d):
            return math.inf
        gap = d / scale if scale > 0.0 else (0.0 if d == 0.0 else math.inf)
        worst = max(worst, gap)
    return worst


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _small_grads(ref: dict) -> set:
    """Parameter leaves whose first gradient in the reference is under a
    thousandth of the median leaf's for every valid client: nought to
    rounding, so their change is left out of the change numbers."""
    small = None
    for c, ok in enumerate(ref["valid0"]):
        if not ok:
            continue
        vals = sorted(ref["grad0"][c].values())
        med = vals[len(vals) // 2]
        mine = {k for k, v in ref["grad0"][c].items() if v < 1e-3 * med}
        small = mine if small is None else small & mine
    return small or set()


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog / ref: {"grad0": [per client {leaf: norm} or None],
    "change_k": [per client (params, stats) change after the first steps],
    "losses": [per client [E]], "deltas": [per client (params, stats)],
    "server": (params, stats) change, "battery": {row: (loss, acc)},
    "valid0": [per client bool]}; prog's "new_global" and ref's
    "rule_global" and "rule_change" ((params, stats)) give server_rule,
    which is left out where either side lacks them."""
    out = {n: 0.0 for n in NAMES}
    skip = _small_grads(ref)

    def norms(pair):
        return {k: v for k, v in {**_norms(pair[0]), **_norms(pair[1])
                                  }.items() if k not in skip}
    for c, ok in enumerate(ref["valid0"]):
        if not ok:
            continue
        out["grad0"] = max(out["grad0"], _leaf_gap(
            prog["grad0"][c], ref["grad0"][c], True))
        out["step3"] = max(out["step3"], _leaf_gap(
            norms(prog["change_k"][c]), norms(ref["change_k"][c])))
        for a, b in zip(prog["losses"][c], ref["losses"][c]):
            a, b = float(a), float(b)
            if b != 0.0 or a != 0.0:
                g = abs(a - b) / max(abs(b), 1e-12)
                out["loss"] = max(out["loss"], g if math.isfinite(a)
                                  else math.inf)
    for c in range(len(ref["deltas"])):
        out["delta"] = max(out["delta"], _leaf_gap(
            norms(prog["deltas"][c]), norms(ref["deltas"][c])))
    out["server"] = _leaf_gap(norms(prog["server"]), norms(ref["server"]))
    if "new_global" in prog and "rule_global" in ref:
        out["server_rule"] = _diff_gap(prog["new_global"], ref["rule_global"],
                                       ref["rule_change"])
    else:
        del out["server_rule"]
    for row, (loss_r, acc_r) in ref["battery"].items():
        loss_p, acc_p = prog["battery"][row]
        g = abs(loss_p - loss_r) / max(abs(loss_r), 1e-12)
        out["eval_loss"] = max(out["eval_loss"],
                               g if math.isfinite(loss_p) else math.inf)
        out["eval_acc"] = max(out["eval_acc"], abs(acc_p - acc_r)
                              if math.isfinite(acc_p) else math.inf)
    return out


def loss_by_epoch(prog: dict, ref: dict) -> List[float]:
    """The worst relative gap of the per-epoch loss sums, epoch by epoch:
    how the two trajectories part as the round goes on."""
    out: List[float] = []
    for c, ok in enumerate(ref["valid0"]):
        if not ok:
            continue
        for e, (a, b) in enumerate(zip(prog["losses"][c], ref["losses"][c])):
            a, b = float(a), float(b)
            g = abs(a - b) / max(abs(b), 1e-12) if (a or b) else 0.0
            if e == len(out):
                out.append(0.0)
            out[e] = max(out[e], g)
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> List[list]:
    """[[name, number, limit, within]] for every number the cell
    compares; a number the run could not work out is not within."""
    out = []
    for n in NAMES:
        if n in limits:
            v = nums.get(n, math.inf)
            out.append([n, v, limits[n], bool(math.isfinite(v)
                                              and v <= limits[n])])
    return out
