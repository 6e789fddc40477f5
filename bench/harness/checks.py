"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference once the window has closed and the
program's state is freed.

Serving: a sample of the requests the window served, drawn from the seed
(the one with the most served tokens, and one served across a migration),
run through the reference over each prompt and its served tokens; the
number compared is the widest gap by which a served token's logit lies
below the reference's best at its position.  Training: the first steps
of the worker the window then trained, against the reference's steps
from the same weights and batches: each step's loss (relative gap); the
first clipped gradient, each leaf's norm gap and error (the norm of the
difference over the reference's norm), by the worst, the median and the
least leaf; the parameters' change after the last step by the worst
leaf.  A norm gap is taken against the larger of the leaf's reference
norm and the median leaf's.  A training mix compares only the numbers
its ``limits`` name (a number with no reading of the control or a fault
far enough above its sound readings is not compared, and is printed as a
reading).  Both kinds also count migrations whose restored and replayed
target differed from the source it replaced, and requests or batches not
completed exactly once.
"""
from __future__ import annotations

import gc
import statistics
from typing import Dict, List, Tuple

import torch

from harness.weights import draw_params, draw_row, flat_leaves

Checks = Dict[str, Tuple[float, float]]


def _reference_weights(run: dict, seed: int, device, stacked_leaves: bool,
                       model=None):
    """The reference's own draw of the weights in the layout of ``model``
    (the port's decoder where None): every leaf by its path, stacked (for
    training), or the model's view of them, each stacked leaf's row drawn
    when the reference asks for it (one layer at a time)."""
    if model is None:
        from harness import decoder as model
    lay = model.layout(run)
    if stacked_leaves:
        # in the layout's order, which the reference's sums over leaves take
        flat = flat_leaves(draw_params(run, seed, device, lay))
        return {p: flat[p] for p in lay}

    def get(path: str, g: int) -> torch.Tensor:
        s, sc, _ = lay[path]
        return draw_row(seed, path, g, s, sc, device)

    return model.view(run, get)


def _free(cell) -> None:
    cell.free()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def serve_checks(cell, limits: dict, control: bool = False):
    """-> (checks, the control's checks or None)."""
    from harness.serving import sample_requests

    rids = sample_requests(cell, int(cell.traffic["check"]["sample_requests"]))
    prompts = cell.prompts
    seqs = [prompts[r] + [t for _, t in cell.rec.served[r]] for r in rids]
    first = [len(prompts[r]) for r in rids]
    checks: Checks = {
        "migrations_state_differs": (float(sum(
            m.state_equal is False for m in cell.rec.migrations)), 0.0),
        "requests_not_exactly_once": (float(cell.exactly_once()), 0.0),
    }
    device, model = cell.device, cell.model
    _free(cell)
    if seqs:
        weights = _reference_weights(cell.run, cell.seed, device, False, model)
        gaps = model.token_gaps(weights, seqs, first, cell.run)
        checks["served_logit_gap"] = (max(gaps), limits["served_logit_gap"])
        ctrl = None
        if control:
            cg = model.token_gaps(weights, seqs, first, cell.run, control=True)
            ctrl = {"served_logit_gap": (max(cg), limits["served_logit_gap"])}
    else:
        gaps, ctrl = [], None
    short = max(0, int(limits["min_tokens_judged"]) - len(gaps))
    checks["served_tokens_short"] = (float(short), 0.0)
    return checks, ctrl


def train_checks(cell, limits: dict, control: bool = False):
    """-> (checks, the control's checks or None)."""
    prog = cell.readings
    opt = cell.traffic["optimizer"]
    n = int(cell.traffic["check_steps"])
    checks: Checks = {
        "migrations_state_differs": (float(sum(
            m.state_equal is False for m in cell.rec.migrations)), 0.0),
        "batches_not_exactly_once": (float(cell.exactly_once()), 0.0),
    }
    device, model = cell.device, cell.model
    _free(cell)
    weights = _reference_weights(cell.run, cell.seed, device, True, model)
    batches = [{k: torch.as_tensor(v, device=device)
                for k, v in cell.batches.batch(i).items()} for i in range(n)]
    got = model.train_readings(weights, batches, cell.run, opt)
    del weights
    gaps = train_gaps(prog, got, limits)
    checks.update({k: v for k, v in gaps.items() if k in limits})
    cell.readings_only = {k: v[0] for k, v in gaps.items() if k not in limits}
    ctrl = None
    if control:
        weights = _reference_weights(cell.run, cell.seed, device, True, model)
        low = model.train_readings(weights, batches, cell.run, opt,
                                   control=True)
        del weights
        ctrl = train_gaps(low, got, limits)
    cell.detail = {who: {k: v for k, v in r.items() if k != "grad"}
                   for who, r in (("program", prog), ("reference", got),
                                  ("control", low if control else None))
                   if r is not None}
    cell.detail["grad_error_leaf"] = {
        who: leaf_errors(r["grad"], got["grad"])
        for who, r in (("program", prog), ("control", low if control else None))
        if r is not None}
    return checks, ctrl


def train_gaps(prog: dict, want: dict, limits: dict) -> Checks:
    """The training numbers, each beside its limit (None where the mix
    compares it not): the worst step's loss gap; the first clipped
    gradient's norm gap by the worst leaf and by the median leaf, and its
    error (the norm of the difference over the reference's norm) by the
    worst, the median and the least leaf; the change's norm gap by the
    worst leaf, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], want["loss"]))
    err = list(leaf_errors(prog["grad"], want["grad"]).values())
    grad = _leaf_gaps(prog["grad_norm"], want["grad_norm"],
                      list(want["grad_norm"]))
    med = statistics.median(want["grad_norm"].values())
    moved = [k for k, v in want["grad_norm"].items() if v >= 1e-3 * med]
    change = _leaf_gaps(prog["change_norm"], want["change_norm"], moved)
    out = {"loss_gap": loss, "grad_norm_gap": max(grad),
           "grad_norm_gap_median": statistics.median(grad),
           "grad_error": max(err), "grad_error_median": statistics.median(err),
           "grad_error_min": min(err),
           "change_norm_gap": max(change)}
    return {k: (v, limits.get(k)) for k, v in out.items()}


def leaf_errors(grad, want) -> Dict[str, float]:
    """Each leaf's gradient error: the norm of the difference over the
    reference's norm (leaves whose reference gradient is not zero)."""
    return {k: float((grad[k].to(g.device) - g).norm() / g.norm())
            for k, g in want.items() if float(g.norm()) > 0}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               keys: List[str]) -> List[float]:
    """Each leaf's norm gap against the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(want[k] for k in keys)
    return [abs(got[k] - want[k]) / max(want[k], med) for k in keys]
