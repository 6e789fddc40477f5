"""Multi-pod dry-run: run every (architecture x input-shape x mesh) cell's
step sharded on a fake process group and report its per-rank costs.

Port of ``repro.launch.dryrun``, with its flags and row keys.  For each
cell:

  * a ``fake`` process group of 256 (16x16) or 512 (2x16x16) ranks and
    the production mesh on it (``launch.mesh``);
  * params, optimizer state, cache and batch as meta tensors
    (``train.step``'s ``*_shardings`` and ``input_specs``), placed as
    DTensors (``train.step.distribute``): nothing is allocated;
  * the port's train, prefill or decode step run on them at full depth
    (no calibration: every layer is counted as it runs), under a
    dispatch mode that counts what rank 0 does on its local shards:
    each op's flops (``torch.utils.flop_counter``'s formulas on the local
    shapes), each op's tensor bytes in and out, and the bytes every
    collective of a redistribution gives back, by kind;
  * argument bytes a rank, summed exactly from the local shard shapes;
  * the three roofline terms, from the H100 SXM5 80GB (700 W) datasheet:
        compute    = flops_per_rank / 989e12   (bf16 dense)
        memory     = bytes_per_rank / 3.35e12  (HBM3)
        collective = coll_bytes_per_rank / 450e9  (NVLink 4, a direction)
    These are datasheet values, not measurements, and every number of a
    row is the port's own count, not XLA's (``cost_source``).

A ``2x16x16`` train cell runs on the same 512 ranks as a 32x16 mesh,
``pod`` and ``data`` taken as one axis (``mesh_run_as``): a 3-D
``DeviceMesh`` stalls DTensor's sharding propagation (over 90 s for one
matmul in torch 2.13).  The rules name ``pod`` only beside ``data``, as
``("pod", "data")``, so where every placed leaf's spec names the two
together in that order or neither (``pod_data_apart``, checked on the
3-D mesh after the divisibility drop), each leaf's local shard is the
3-D mesh's; a collective over the merged axis is one over 32 ranks, where
DTensor on the 3-D mesh would issue one over ``pod`` and one over
``data``.  A cell whose specs name them apart is a FAIL row that says so.
Every OK row says how its mesh ran.

A cell that cannot run on meta tensors or does not finish within
``CELL_SECONDS`` is a FAIL row with its error.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
      --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import signal
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec
from repro_torch.optim import adamw
from repro_torch.sharding.rules import AbstractMesh, AxisRules
from repro_torch.train import step as steplib
from repro_torch.tree import flatten

# H100 SXM5 80GB (700 W) datasheet values, not measurements
PEAK_FLOPS = 989e12      # bf16 dense, per card
HBM_BW = 3.35e12         # bytes/s per card
LINK_BW = 450e9          # bytes/s per NVLink 4 direction
COST_SOURCE = ("repro_torch dry-run: rank 0's local-shard op counts on a "
               "fake process group (flop_counter formulas, tensor bytes "
               "in and out, collective result bytes); not XLA's "
               "cost_analysis; roofline constants from the H100 SXM5 "
               "80GB (700 W) datasheet, not measured")
CELL_SECONDS = 900
MULTI_POD = AbstractMesh(("pod", "data", "model"), (2, 16, 16))
POD_DATA = ("pod", "data")
RUN_AS = {"16x16": "16x16 (data, model)",
          "2x16x16": "2x16x16 (pod, data, model)",
          "32x16": "32x16 (pod*data, model)"}

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def _bytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class LocalCostMode(TorchDispatchMode):
    """Counts the ops this rank runs on plain (local) tensors: flops,
    tensor bytes in and out of every op that is not a view, and the
    result bytes of every functional collective, by kind.  An op on
    DTensors is handed on (``NotImplemented``): DTensor then runs its
    local ops, and those are what is counted.  The fake-tensor runs of
    DTensor's shape propagation (global shapes) are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = collections.Counter()
        self.coll_counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.coll[kind] += sum(_bytes(t) for t in _tensors(out))
                self.coll_counts[kind] += 1
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            self.bytes += sum(_bytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_bytes(t) for t in _tensors(out))
        return out


def opt_config_for(cfg: ModelConfig) -> adamw.AdamWConfig:
    # 400B-class: factored second moment + bf16 first moment (as the
    # reference sizes it)
    if cfg.param_count() > 100e9:
        return adamw.AdamWConfig(factored=True, moment_dtype="bfloat16")
    return adamw.AdamWConfig()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum(_bytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def leaf_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
               rules: AxisRules, tcfg=None) -> Dict[str, Any]:
    """{leaf name: (its shape, its spec on ``mesh``)} of every leaf a cell
    places: the params and the AdamW state (train) or the params and the
    cache, and the batch.  ``rules``' drops are not recorded."""
    rules = AxisRules(rules.rules)
    out = {}

    def add(prefix, shapes, shardings):
        flat, _ = flatten(shapes)
        for i, (t, sh) in enumerate(zip(flat, flatten(shardings)[0])):
            out[f"{prefix}/{i}"] = (tuple(t.shape), tuple(sh.spec))

    add("batch", steplib.input_specs(cfg, shape),
        steplib.batch_shardings(cfg, shape, mesh, rules))
    if shape.kind == "train":
        tcfg = tcfg or steplib.TrainStepConfig(opt=opt_config_for(cfg))
        p, p_sh, o, o_sh = steplib.train_state_shardings(
            cfg, mesh, tcfg.opt, rules, param_dtype=tcfg.param_dtype)
        add("opt", o, o_sh)
    else:
        p, p_axes = steplib.param_shapes_and_axes(cfg)
        p_sh = steplib._shardings_from(mesh, p_axes, p, rules)
        add("cache", *steplib.cache_shardings(cfg, shape, mesh, rules))
    add("params", p, p_sh)
    return out


def _entry_axes(entry):
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def pod_data_apart(specs: Dict[str, Any]) -> list:
    """The leaves of ``leaf_specs`` whose spec names ``pod`` or ``data``
    other than as ``("pod", "data")`` in one entry."""
    bad = []
    for name, (_, spec) in specs.items():
        for entry in spec:
            axes = _entry_axes(entry)
            named = [a for a in axes if a in POD_DATA]
            if named and tuple(named) != POD_DATA:
                bad.append(name)
    return bad


def _run_cell_step(cfg, shape, mesh, rules, tcfg=None):
    """Place the cell's inputs and run its step -> argument bytes a rank
    (the step runs under the caller's cost mode)."""
    D = steplib.distribute
    specs = steplib.input_specs(cfg, shape)
    b_shard = steplib.batch_shardings(cfg, shape, mesh, rules)
    batch = D(specs, {k: b_shard[k] for k in specs})
    if shape.kind == "train":
        tcfg = tcfg or steplib.TrainStepConfig(opt=opt_config_for(cfg))
        p, p_sh, o, o_sh = steplib.train_state_shardings(
            cfg, mesh, tcfg.opt, rules, param_dtype=tcfg.param_dtype)
        params, opt = D(p, p_sh), D(o, o_sh)
        args = _local_bytes((params, opt, batch))
        steplib.build_train_step(cfg, tcfg)(
            params, opt, batch, torch.tensor(1, dtype=torch.int32))
        return args
    p, p_axes = steplib.param_shapes_and_axes(cfg)
    params = D(p, steplib._shardings_from(mesh, p_axes, p, rules))
    c, c_sh = steplib.cache_shardings(cfg, shape, mesh, rules)
    cache = D(c, c_sh)
    args = _local_bytes((params, cache, batch))
    with torch.no_grad():
        if shape.kind == "prefill":
            steplib.build_prefill_step(cfg)(params, cache, batch)
        else:
            steplib.build_decode_step(cfg)(params, cache, batch["tokens"],
                                           batch["positions"])
    return args


class _CellTimeout(Exception):
    pass


def _alarm(signum, frame):
    raise _CellTimeout(f"the cell did not finish in {CELL_SECONDS} s")


def _fake_world(size: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             tcfg: Optional[steplib.TrainStepConfig] = None) -> Dict[str, Any]:
    from repro_torch.launch.mesh import make_production_mesh

    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    t_start = time.time()  # simlint: disable=SIM002
    row: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
    }
    if not cfg.runnable(shape):
        row["status"] = "SKIP"
        row["reason"] = ("long_500k needs sub-quadratic attention; "
                         f"{cfg.name} is full-attention (DESIGN.md §4)")
        return row

    rules = steplib.arch_rules(cfg)
    as_one = multi_pod and shape.kind == "train"
    if as_one:
        apart = pod_data_apart(leaf_specs(cfg, shape, MULTI_POD, rules,
                                          tcfg))
        if apart:
            raise ValueError(
                f"{len(apart)} leaves name pod and data apart (first "
                f"{apart[:3]}): the cell cannot run as 32x16")
    _fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu",
                                pod_data_as_one=as_one)
    chips = mesh.size()
    rules.dropped.clear()
    cost = LocalCostMode()
    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(CELL_SECONDS)
    try:
        with cost:
            arg_bytes = _run_cell_step(cfg, shape, mesh, rules, tcfg)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)

    flops_pd, bytes_pd = float(cost.flops), float(cost.bytes)
    coll = {"bytes_by_kind": {k: cost.coll[k] for k in _KINDS},
            "counts": {k: cost.coll_counts[k] for k in _KINDS},
            "total_bytes": sum(cost.coll.values())}
    coll_pd = float(coll["total_bytes"])
    tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
    # MODEL_FLOPS: 6ND for a train step (fwd+bwd), 2ND forward-only
    model_flops = cfg.model_flops(tokens) * (
        1.0 if shape.kind == "train" else 1.0 / 3.0)
    compute_t = flops_pd / PEAK_FLOPS
    memory_t = bytes_pd / HBM_BW
    coll_t = coll_pd / LINK_BW
    dominant = max((("compute", compute_t), ("memory", memory_t),
                    ("collective", coll_t)), key=lambda kv: kv[1])[0]
    dropped = [(n, d, POD_DATA if as_one and tuple(ax) == ("data",)
                and rules.get(n) == POD_DATA else ax)
               for n, d, ax in rules.dropped]
    row.update({
        "status": "OK",
        "chips": chips,
        "mesh_run_as": RUN_AS["32x16" if as_one else row["mesh"]],
        "cost_source": COST_SOURCE,
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                      "link_bytes_per_s": LINK_BW,
                      "source": "H100 SXM5 80GB (700 W) datasheet"},
        "cost_analysis": {"flops": flops_pd, "bytes_accessed": bytes_pd},
        "memory_analysis": {"argument_bytes": arg_bytes,
                            "temp_bytes": None},  # not measured
        "collectives": coll,
        "roofline": {
            "compute_s": compute_t,
            "memory_s": memory_t,
            "collective_s": coll_t,
            "dominant": dominant,
            "flops_per_chip": flops_pd,
            "bytes_per_chip": bytes_pd,
            "coll_bytes_per_chip": coll_pd,
            "model_flops_global": model_flops,
            "counted_flops_global": flops_pd * chips,
            "useful_flops_ratio": (model_flops / (flops_pd * chips)
                                   if flops_pd else 0.0),
        },
        "dropped_shardings": [list(map(str, d)) for d in dropped[:20]],
        "seconds": round(time.time() - t_start, 1),  # simlint: disable=SIM002
    })
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    archs = (configs.list_archs() if args.arch == "all"
             else args.arch.split(","))
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    failures = 0
    with open(args.out, "a" if args.append else "w") as f:
        for arch in archs:
            for shape in shapes:
                for multi in meshes:
                    label = (f"{arch} x {shape} x "
                             f"{'2x16x16' if multi else '16x16'}")
                    print(f"[dryrun] {label} ...", flush=True)
                    try:
                        row = run_cell(arch, shape, multi)
                    except Exception as e:  # noqa: BLE001
                        row = {"arch": arch, "shape": shape,
                               "mesh": "2x16x16" if multi else "16x16",
                               "status": "FAIL",
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-2000:]}
                        failures += 1
                    rows.append(row)
                    f.write(json.dumps(row) + "\n")
                    f.flush()
                    status, extra = row["status"], ""
                    if status == "OK":
                        r = row["roofline"]
                        extra = (f" dominant={r['dominant']}"
                                 f" compute={r['compute_s']*1e3:.3f}ms"
                                 f" mem={r['memory_s']*1e3:.3f}ms"
                                 f" coll={r['collective_s']*1e3:.3f}ms"
                                 f" useful={r['useful_flops_ratio']:.2f}"
                                 f" ({row['seconds']}s)")
                    print(f"[dryrun] {label}: {status}{extra}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    ok = sum(1 for r in rows if r["status"] == "OK")
    skip = sum(1 for r in rows if r["status"] == "SKIP")
    print(f"[dryrun] done: {ok} OK, {skip} SKIP, {failures} FAIL "
          f"(costs: {COST_SOURCE})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
