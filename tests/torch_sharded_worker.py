"""One rank of the sharded-step world of ``test_torch_sharded_step.py``.

Run as ``python tests/torch_sharded_worker.py RANK WORLD STORE CASES OUT``
with ``src`` on ``PYTHONPATH``: it joins a gloo world through the file
store ``STORE``, and for every case of ``CASES`` (a ``torch.save`` list)
places the given params, AdamW state, cache and batches as DTensors on the
case's mesh, runs the port's step functions on them (twice where the case
asks; a train case under its ``remat`` policy, ``"none"`` by default),
and rank 0 saves what came out (gathered to full tensors) and
whether the two runs gave the same bits under ``OUT``.  A world of one rank runs each case on a
1 x 1 mesh and unsharded.  It imports torch and the port only.
"""
import copy
import dataclasses
import os
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.models.config import ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import step as S
from repro_torch.tree import flatten, tree_map


def _full(tree):
    return tree_map(lambda t: (t.full_tensor() if isinstance(t, DTensor)
                               else t).detach().clone(), tree)


def _equal(a, b):
    fa, fb = flatten(a)[0], flatten(b)[0]
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(fa, fb))


def _train(case, cfg, mesh):
    tcfg = S.TrainStepConfig(
        opt=adamw.AdamWConfig(weight_decay=0.01, eps=case["adam_eps"]),
        remat=case.get("remat", "none"), lr_peak=1e-3, warmup_steps=2,
        total_steps=100)
    params = copy.deepcopy(case["params"])
    opt = adamw.adamw_init(params, tcfg.opt)
    batch = dict(case["batch"])
    if mesh is not None:
        B, L = batch["tokens"].shape
        _, p_sh, _, o_sh = S.train_state_shardings(cfg, mesh, tcfg.opt)
        b_sh = S.batch_shardings(cfg, ShapeSpec("t", "train", L, B), mesh)
        params, opt = S.distribute(params, p_sh), S.distribute(opt, o_sh)
        batch = S.distribute(batch, {k: b_sh[k] for k in batch})
    step = S.build_train_step(cfg, tcfg)
    params, opt, m = step(params, opt, batch, torch.tensor(3))
    return {"params": _full(params), "opt": _full(opt),
            "metrics": _full({k: m[k] for k in ("loss", "grad_norm", "lr")})}


def _serve(case, cfg, mesh):
    prompt, steps = dict(case["prompt"]), case["decode"]
    B, L = prompt["tokens"].shape
    cache = T.init_cache(cfg, B, case["max_seq"], device="cpu")
    if mesh is not None:
        _, c_sh = S.cache_shardings(
            cfg, ShapeSpec("c", "decode", case["max_seq"], B), mesh)
        cache = S.distribute(cache, c_sh)
        p_sh = S.batch_shardings(cfg, ShapeSpec("p", "prefill", L, B), mesh)
        d_sh = S.batch_shardings(cfg, ShapeSpec("d", "decode", L, B), mesh)
        prompt = S.distribute(prompt, {k: p_sh[k] for k in prompt})
        steps = [S.distribute(s, {k: d_sh[k] for k in s}) for s in steps]
    params = case["params"]
    if mesh is not None:
        _, p_shard, _, _ = S.train_state_shardings(cfg, mesh,
                                                   adamw.AdamWConfig())
        params = S.distribute(params, p_shard)
    with torch.no_grad():
        logits, cache = S.build_prefill_step(cfg)(params, cache, prompt)
        out = [_full(logits)]
        decode = S.build_decode_step(cfg)
        for s in steps:
            logits, cache = decode(params, cache, s["tokens"],
                                   s["positions"])
            out.append(_full(logits))
    return {"logits": out, "cache": _full(cache)}


def main(rank, world, store, cases_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    cases = torch.load(cases_path, weights_only=False)
    for case in cases:
        cfg = dataclasses.replace(configs.get_smoke(case["arch"]),
                                  **case.get("overrides", {}))
        if world == 1:
            mesh = init_device_mesh("cpu", (1, 1),
                                    mesh_dim_names=("data", "model"))
        else:
            mesh = init_device_mesh("cpu", tuple(case["mesh"]),
                                    mesh_dim_names=tuple(case["names"]))
        run = {"train": _train, "serve": _serve}[case["kind"]]
        first = run(case, cfg, mesh)
        res = {"sharded": first}
        if case.get("repeat", True):
            res["repeat_equal"] = _equal(first, run(case, cfg, mesh))
        if world == 1:
            res["unsharded_equal"] = _equal(first, run(case, cfg, None))
        if rank == 0:
            torch.save(res, os.path.join(out_dir, case["name"] + ".pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, cases_path, out_dir = sys.argv[1:]
    main(int(r), int(w), store, cases_path, out_dir)
