#!/usr/bin/env python3
"""Step by step, the 4-shard mesh's dense state on the card against the
same mesh on the CPU (``chip_smoke.py`` phase 4v (b)): the summed dense
gradients, adam's ``mu`` and ``nu`` and the params after each of its 8
steps, and each gradient element's float32 error bound, ``K * 2**-24 *
sum|terms|`` (``row_term_sums``: every row's gradient from
the card's step inputs; K the rows summed plus the widest layer).

Run from the root of a checkout on a machine with one H100:

    python3 mesh_drift.py [--seed 0]

Worlds: "recipe" draws the batches as a script that runs phase 4v alone
does
(``np.random.default_rng(seed)``, one trainer file written first);
"script" as ``chip_smoke.py`` itself does (``default_rng([seed, 83])``).
For each it prints the largest card-to-CPU differences of each step, the
first step whose largest passes float32 noise, and there the gradient's
difference against its bound; then runs ``chip_smoke.check_mesh_dense``
(the re-synced twin) on the world, and again with a fault planted in the
card's step (one shard's dense gradients dropped; the gradients summed
twice), where the check must fail. Writes the whole record as JSON to
``--out`` (``build/mesh_drift.json`` by default).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch
from torch import nn

import chip_smoke as cs
from torch.func import functional_call, grad, vmap
from paddlebox_tpu_torch.parallel import dp_step, plan
from paddlebox_tpu_torch.trainer.train_step import \
    sigmoid_binary_cross_entropy


def draw(mode: str, seed: int):
    """(model, 4v (b)'s batches) as the phase draws them."""
    if mode == "recipe":
        rng = np.random.default_rng(seed)
        os.makedirs(cs.WORK, exist_ok=True)
        cs.write_trainer_file(rng, os.path.join(cs.WORK, "drift.txt"), 0)
    else:
        rng = np.random.default_rng([seed, 83])
    conf, _, _ = cs.train_confs()
    model = cs.random_deepfm(rng, cs.TS * conf.pull_dim)
    cs.make_train_batches(rng, cs.MESH_STEPS)      # (a)'s draw
    return model, cs.split_batches(rng, cs.MESH_B_STEPS, cs.MESH_SHARDS)


def worlds(model):
    card = cs.mesh_world(copy.deepcopy(model), "cuda", cs.MESH_SHARDS,
                         cs.MESH_B_CAPACITY, True)
    cpu = cs.mesh_world(copy.deepcopy(model), "cpu", cs.MESH_SHARDS,
                        cs.MESH_B_CAPACITY, True)
    cs.carry_shards(card[1], cpu[1], cs.MESH_B_CAPACITY)
    return card, cpu


ROW_CHUNK = 128              # rows of a vmapped per-row gradient


def row_term_sums(step, models, embs, inputs) -> list:
    """The terms of each summed dense gradient element, as absolute
    values added up: ``sum over rows |d row loss / d param|``, per param
    (host tensors), from the shards' ``_shard_grads`` arguments (the rows
    pooled again through the step's seqpool)."""
    den = sum(float(inp[4].sum()) for inp in inputs)
    out = None
    for model, emb, (segs, cvm, labels, dense, mask) in zip(models, embs,
                                                            inputs):
        params = {n: p.detach() for n, p in model.named_parameters()}
        if out is None:
            out = {n: torch.zeros_like(p).cpu() for n, p in params.items()}
        with torch.no_grad():
            sparse = step._features(emb.detach(), segs, cvm)

        def row_loss(p, s, d, y, m):
            logit = functional_call(model, p, (s[None], d[None]))[0]
            return sigmoid_binary_cross_entropy(logit, y) * m / max(den, 1.0)

        of_rows = vmap(grad(row_loss), in_dims=(None, 0, 0, 0, 0))
        for lo in range(0, sparse.shape[0], ROW_CHUNK):
            sl = slice(lo, lo + ROW_CHUNK)
            g = of_rows(params, sparse[sl], dense[sl], labels[sl], mask[sl])
            for n in out:
                out[n] += g[n].abs().sum(0).cpu()
    return list(out.values())


def grad_bound(model, batch_rows: int) -> float:
    """K * 2^-24 of a summed dense gradient's float32 error bound, K * u *
    sum|terms|: K the rows summed plus the widest layer the backward
    reduces over (a term's own error)."""
    widest = max(max(p.shape) for p in model.parameters() if p.dim() == 2)
    return (batch_rows + widest) * cs.F32_UNIT


def with_terms(rec: cs.DenseRecorder, z: "PreActs") -> list:
    """Each step's ``row_term_sums`` of the recorded step (its forwards
    kept out of ``z``)."""
    sums, shard_grads = [], rec.step._shard_grads

    def wrapped(models, embs, inputs):
        out = shard_grads(models, embs, inputs)
        z.on = False
        try:
            sums.append(row_term_sums(rec.step, models, embs, inputs))
        finally:
            z.on = True
        return out
    rec.step._shard_grads = wrapped
    return sums


def at(x, j):
    return float(x.reshape(-1)[j])


class PreActs:
    """The MLP's pre-activations of each shard's rows, per step (forward
    hooks on its ``nn.Linear`` layers): where the card and the CPU put a
    ReLU on other sides of 0."""

    def __init__(self, model):
        self.steps, self.on = [[]], True
        layers = [m for m in model.modules() if isinstance(m, nn.Linear)]
        for i, lin in enumerate(layers[:-1]):     # the last has no ReLU
            lin.register_forward_hook(self._hook(i))

    def _hook(self, i):
        def hook(mod, inp, out):
            if self.on:
                self.steps[-1].append((i, out.detach().cpu().clone()))
        return hook

    def next_step(self):
        self.steps.append([])


def flips(a: PreActs, b: PreActs, t: int) -> dict:
    """ReLU derivative flips of step ``t``: (layer, count, the least |z|
    of the card's at a flip)."""
    out = {}
    for (i, za), (_, zb) in zip(a.steps[t], b.steps[t]):
        f = (za > 0) != (zb > 0)
        if bool(f.any()):
            n, m = out.get(i, (0, float("inf")))
            out[i] = (n + int(f.sum()), min(m, float(za[f].abs().min())))
    return out


def trace(mode: str, seed: int) -> dict:
    """The free-running card and CPU worlds of 4v (b), step by step."""
    model, batches = draw(mode, seed)
    card, cpu = worlds(model)
    za, zb = PreActs(card[2][0]), PreActs(cpu[2][0])
    rc = cs.DenseRecorder(card[0])
    rp = cs.DenseRecorder(cpu[0])
    term_sums = with_terms(rc, za)
    for rec, z in ((rc, za), (rp, zb)):
        upd = rec.step.optimizer.update

        def upd_next(model, state, upd=upd, z=z):
            out = upd(model, state)
            z.next_step()
            return out
        rec.step.optimizer.update = upd_next
    cs.mesh_stream(card, batches, chunk=cs.MESH_B_CHUNK)
    cs.mesh_stream(cpu, batches, chunk=cs.MESH_B_CHUNK)
    names = [n for n, _ in model.named_parameters()]
    k = grad_bound(model, cs.TB)
    rows, first = [], None
    for t in range(len(batches)):
        pc, pp = rc.post[t], rp.post[t]
        dp = [(x - y).abs() for x, y in zip(pc["params"], pp["params"])]
        i = int(np.argmax([float(d.max()) for d in dp]))
        j = int(dp[i].argmax())
        gc, gp, terms = rc.grads[t][i], rp.grads[t][i], term_sums[t][i]
        ratios = [((a - b).abs() / (k * s).clamp(min=1e-38))
                  for a, b, s in zip(rc.grads[t], rp.grads[t],
                                     term_sums[t])]
        wi = int(np.argmax([float(r.max()) for r in ratios]))
        wj = int(ratios[wi].argmax())
        sums_exact = all(
            torch.equal(g, cs.shard_order_sum([s[n] for s in
                                               rc.shard_grads[t]]))
            for n, g in enumerate(rc.grads[t]))
        row = {"step": t + 1, "leaf": names[i], "elem": j,
               "dp": at(dp[i], j), "p": at(pc["params"][i], j),
               "g_card": at(gc, j), "g_cpu": at(gp, j),
               "dg": abs(at(gc, j) - at(gp, j)),
               "dg_bound": k * at(terms, j), "sum_terms": at(terms, j),
               "mu_card": at(pc["adam"]["mu"][i], j),
               "mu_cpu": at(pp["adam"]["mu"][i], j),
               "nu_card": at(pc["adam"]["nu"][i], j),
               "nu_cpu": at(pp["adam"]["nu"][i], j),
               "worst_ratio": {"leaf": names[wi], "elem": wj,
                               "ratio": at(ratios[wi], wj),
                               "g_card": at(rc.grads[t][wi], wj),
                               "g_cpu": at(rp.grads[t][wi], wj),
                               "sum_terms": at(term_sums[t][wi], wj)},
               "elements_over_bound": {
                   n: int((r > 1).sum()) for n, r in zip(names, ratios)
                   if bool((r > 1).any())},
               "relu_flips": flips(za, zb, t),
               "card_sum_is_shards_in_order": sums_exact,
               "max_dp_by_leaf": {n: float(d.max())
                                  for n, d in zip(names, dp)}}
        if first is None and row["dp"] > 64 * cs.F32_UNIT * max(
                abs(row["p"]), 1e-3):
            first = row
        rows.append(row)
        print(f"drift {mode} step {t + 1}: {json.dumps(row)}")
    print(f"drift {mode}: first past float32 noise step "
          f"{first and first['step']}")
    return {"mode": mode, "k": k, "steps": rows, "first_past_noise": first}


def planted(kind: str):
    """A fault in the card's step, as (module or class, name, faulty
    version): "drop" loses shard 1's dense gradients before the sum (so
    the sum of what the shards hand over still adds up), "twice" takes the
    shards' sum twice."""
    if kind == "drop":
        honest = dp_step.ShardBodies._shard_grads

        def drop(self, models, embs, inputs):
            losses, preds, dembs, dparams = honest(self, models, embs,
                                                   inputs)
            dparams = [g if d != 1 else [None if x is None else x * 0
                                         for x in g]
                       for d, g in enumerate(dparams)]
            return losses, preds, dembs, dparams
        return dp_step.ShardBodies, "_shard_grads", drop
    honest = plan.reduce_gradients

    def twice(grads, mesh):
        return [None if x is None else x + x for x in honest(grads, mesh)]
    return dp_step, "reduce_gradients", twice


def check(mode: str, seed: int, kind: str = "") -> dict:
    """``chip_smoke.check_mesh_dense`` on the world, a fault planted in the
    card's step where ``kind`` names one."""
    model, batches = draw(mode, seed)
    card, cpu = worlds(model)
    where, name, faulty = planted(kind) if kind else (None, None, None)
    honest = getattr(where, name) if kind else None
    if kind:
        setattr(where, name, faulty)
    rec = cs.DenseRecorder(card[0])
    kinks = cs.KinkAligner().record(card[2][0])
    try:
        losses = cs.mesh_stream(card, batches, chunk=cs.MESH_B_CHUNK)
    finally:
        if kind:
            setattr(where, name, honest)
        rec.detach()
        kinks.remove()
    try:
        res = cs.check_mesh_dense(f"drift {mode} {kind or 'honest'}", card,
                                  cpu, batches, rec, kinks, losses)
        res["failed"] = None
    except RuntimeError as e:
        res = {"failed": str(e)[:600]}
    print(f"drift check {mode} {kind or 'honest'}: {res}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "mesh_drift.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_drift: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_build()
    out = {"trace": [trace(m, args.seed) for m in ("recipe", "script")],
           "checks": {f"{m} {k or 'honest'}": check(m, args.seed, k)
                      for m in ("recipe", "script")
                      for k in ("", "drop", "twice")}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    ok = all((c["failed"] is None) == name.endswith("honest")
             for name, c in out["checks"].items())
    print(cs.card_line())
    print(json.dumps({"mesh_drift_ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
