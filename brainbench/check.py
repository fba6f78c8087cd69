"""The numbers that decide `correct`, each held to its limit.

Training (the first steps of the one training object, program against
the plain reference on the same inputs):

- `batch_gap`: the synthesized batches, the worst field of the worst
  step, max |program - reference| over max |reference|;
- `loss_gap`: the worst step's |loss - reference loss| / |reference loss|;
- `grad_gap_median`: the first step's gradient as the optimizer got it,
  leaf by leaf |norm - reference norm| over the larger of the reference
  leaf's norm and the median leaf's, the median over the leaves (the
  worst leaf's reading is bf16 noise of the top encoder levels' small
  leaves, which a float32 step does not show: PERF.md);
- `update_gap`, `update_gap_median`: the parameters' change over the
  steps, likewise, by the worst leaf and the median; leaves whose
  reference gradient is under a thousandth of the median leaf's (a bias
  under a normalisation, which Adam moves by round-off) are left out, by
  that rule and not by name.

Serving (sampled requests of the window, program against the reference
on the same file):

- `prep_gap`: the prepared volume, max |program - reference| over max
  |reference|;
- `head_gap`: every served output but the label map, the worst output's
  relative L2 distance;
- `heads_missing`: reference outputs the program did not give;
- `label_miss`: the share of voxels where the written label map differs
  from the reference's.
"""

from __future__ import annotations

import statistics

import torch

SKIP_GRAD_SHARE = 1e-3


def _median(d: dict) -> float:
    return statistics.median(d.values()) if d else 0.0


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """|prog - ref| / max(ref leaf, median ref leaf) of every leaf."""
    names = [n for n in ref if keep is None or n in keep]
    if set(prog) != set(ref):
        return [float("inf")]
    med = _median({n: ref[n] for n in names})
    out = []
    for n in names:
        den = max(ref[n], med)
        out.append(abs(prog[n] - ref[n]) / den if den > 0 else
                   (0.0 if prog[n] == 0 else float("inf")))
    return out


def moved_leaves(ref_grad: dict) -> set:
    """Leaves whose reference gradient is at least SKIP_GRAD_SHARE of the
    median leaf's."""
    med = _median(ref_grad)
    return {n for n, v in ref_grad.items() if v >= SKIP_GRAD_SHARE * med}


def field_gap(a, b) -> float:
    """max |a - b| / max |b| of two tensors (0 for two zero tensors)."""
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    a, b = a.double(), b.double().to(a.device)
    den = float(b.abs().max()) if b.numel() else 0.0
    num = float((a - b).abs().max()) if b.numel() else 0.0
    if not torch.isfinite(torch.tensor(num)):
        return float("inf")
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def batch_gap(prog_batch: dict, ref_batch: dict) -> float:
    """The worst field of two train batches ({'samples', 'targets'})."""
    worst = 0.0
    for part in ("samples", "targets"):
        p, r = prog_batch[part], ref_batch[part]
        if set(p) != set(r):
            return float("inf")
        for k in r:
            worst = max(worst, field_gap(p[k], r[k]))
    return worst


def train_checks(prog, ref, batch_gaps) -> dict:
    """prog, ref: drivers.train.StepRecord of the two sides."""
    loss = max(abs(a - b) / abs(b) if b else float("inf")
               for a, b in zip(prog.losses, ref.losses))
    if len(prog.losses) != len(ref.losses):
        loss = float("inf")
    grad = leaf_gaps(prog.grad_norms, ref.grad_norms)
    upd = leaf_gaps(prog.update_norms, ref.update_norms,
                    moved_leaves(ref.grad_norms))
    return {"batch_gap": max(batch_gaps),
            "loss_gap": loss,
            "grad_gap_median": statistics.median(grad),
            "update_gap": max(upd),
            "update_gap_median": statistics.median(upd)}


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double().to(a.device)
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def serve_checks(requests) -> dict:
    """requests: per sampled request (prepared, outs, label) of the
    program and of the reference, as drivers.serve.compare gives them."""
    prep, head, missing, label = 0.0, 0.0, 0, 0.0
    for r in requests:
        prep = max(prep, r["prep_gap"])
        head = max(head, r["head_gap"])
        missing = max(missing, r["heads_missing"])
        label = max(label, r["label_miss"])
    return {"prep_gap": prep, "head_gap": head, "heads_missing": missing,
            "label_miss": label}


def judge(checks: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit is a fault of the cell's files."""
    unknown = sorted(set(checks) - set(limits))
    if unknown:
        raise KeyError(f"checks without a limit: {unknown}")
    table = {k: {"value": float(v), "limit": float(limits[k])}
             for k, v in checks.items()}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
