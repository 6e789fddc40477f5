"""The port's dry-run (``repro_torch.launch.dryrun``): one cell on a fake
process group of 256 ranks, the reference's SKIP rule, per-rank flops
counted on local shards, the 2x16x16 train cells run as 32x16, and the
flops of each remat policy."""
import json
import os
import subprocess
import sys

import pytest

from repro import configs as jconfigs
from repro_torch.launch import dryrun
from repro_torch.sharding.rules import mesh_axes

# the reference's constants (src/repro/launch/dryrun.py:49-51, TPU v5e);
# its module is not imported here: it sets XLA_FLAGS for 512 host devices
TPU_CONSTANTS = (197e12, 819e9, 50e9)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def test_dryrun_single_cell(tmp_path):
    """The reference test's cell: smollm_360m x decode_32k x 16x16, in a
    subprocess under its own time limit."""
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm_360m", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    row, = [json.loads(line) for line in out.read_text().splitlines()]
    assert row["status"] == "OK", row
    assert row["chips"] == 256
    assert row["memory_analysis"]["argument_bytes"] > 0
    assert row["memory_analysis"]["temp_bytes"] is None
    assert row["collectives"]["total_bytes"] > 0
    assert row["cost_analysis"]["flops"] > 0
    assert "not XLA's" in row["cost_source"]
    assert "datasheet" in row["cost_source"]
    r = row["roofline"]
    assert r["compute_s"] == row["cost_analysis"]["flops"] / 989e12
    assert r["collective_s"] == row["collectives"]["total_bytes"] / 450e9
    assert r["dominant"] in ("compute", "memory", "collective")
    # the H100 datasheet's constants, no TPU constant
    const = row["constants"]
    assert (const["peak_flops"], const["hbm_bytes_per_s"],
            const["link_bytes_per_s"]) == (989e12, 3.35e12, 450e9)
    assert "datasheet" in const["source"]
    for c in TPU_CONSTANTS:
        assert c not in const.values()
        assert c not in (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW)


def test_long_500k_skip_rule_matches_reference():
    """The reference's row (``dryrun.py:236-240`` there) for a
    full-attention arch at long_500k, and an OK-able one is not skipped."""
    row = dryrun.run_cell("codeqwen1_5_7b", "long_500k", False)
    name = jconfigs.get_config("codeqwen1_5_7b").name
    assert row == {"arch": "codeqwen1_5_7b", "shape": "long_500k",
                   "mesh": "16x16", "kind": "decode", "status": "SKIP",
                   "reason": ("long_500k needs sub-quadratic attention; "
                              f"{name} is full-attention (DESIGN.md §4)")}
    assert dryrun.configs.get_config("xlstm_350m").runnable(
        dryrun.SHAPES["long_500k"])


_FLOPS_SCRIPT = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import distribute_tensor, Replicate, Shard
from repro_torch.launch.dryrun import LocalCostMode
from repro_torch.launch.mesh import make_production_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(device_type="cpu")
M, K, N = 128, 960, 2560
x = distribute_tensor(torch.empty(M, K, device="meta"), mesh,
                      [Shard(0), Replicate()])
w = distribute_tensor(torch.empty(K, N, device="meta"), mesh,
                      [Replicate(), Shard(1)])
with LocalCostMode() as cost:
    y = x @ w
assert tuple(y.to_local().shape) == (M // 16, N // 16)
assert cost.flops == 2 * M * K * N // 256, cost.flops
assert sum(cost.coll.values()) == 0
# a contraction over a sharded dim: local product, then an all-reduce
w2 = distribute_tensor(torch.empty(K, N, device="meta"), mesh,
                       [Replicate(), Shard(0)])
x2 = distribute_tensor(torch.empty(M, K, device="meta"), mesh,
                       [Shard(0), Shard(1)])
with LocalCostMode() as cost:
    z = (x2 @ w2).full_tensor()
assert cost.flops == 2 * M * K * N // 256, cost.flops
assert cost.coll["all-reduce"] + cost.coll["all-gather"] > 0
print("ok")
"""


def test_per_rank_flops_are_local_shard_counts():
    """torch's FlopCounterMode over DTensors counts the global product; the
    dry-run's mode counts rank 0's local one: 2 M K N over the shard
    count."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _FLOPS_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr[-3000:]


# ---------------------------------------------------------------------------
# the 2x16x16 train cells, run as 32x16 (pod and data as one axis)
# ---------------------------------------------------------------------------

MERGED = dryrun.AbstractMesh(("data", "model"), (32, 16))


def _local_shape(shape, spec, mesh) -> tuple:
    """A leaf's local shard shape on ``mesh`` under ``spec``."""
    sizes = mesh_axes(mesh)
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        k = 1
        for a in dryrun._entry_axes(entry):
            k *= sizes[a]
        out.append(n // k)
    return tuple(out)


@pytest.mark.parametrize("arch", dryrun.configs.ARCHS)
def test_pod_data_as_one_keeps_every_local_shard(arch):
    """Every leaf a train or decode cell places (params, AdamW state,
    cache, batch), after ``arch_rules`` and the divisibility drop: on the
    3-D mesh its spec names pod and data together or neither, and its
    local shard on the 32x16 mesh is the 3-D mesh's."""
    cfg = dryrun.configs.get_config(arch)
    rules = dryrun.steplib.arch_rules(cfg)
    for shape in ("train_4k", "decode_32k"):
        shape = dryrun.SHAPES[shape]
        three = dryrun.leaf_specs(cfg, shape, dryrun.MULTI_POD, rules)
        two = dryrun.leaf_specs(cfg, shape, MERGED, rules)
        assert not dryrun.pod_data_apart(three)
        assert three.keys() == two.keys()
        named = 0
        for name, (leaf_shape, spec) in three.items():
            named += any("pod" in dryrun._entry_axes(e) for e in spec)
            assert (_local_shape(leaf_shape, spec, dryrun.MULTI_POD)
                    == _local_shape(*two[name], MERGED)), name
        assert named  # the batch at least splits over pod and data


def test_pod_data_apart_finds_a_split_spec():
    specs = {"a": ((4, 4), (("pod", "data"), "model")),
             "b": ((4,), ("data",)), "c": ((4,), (("data", "pod"),)),
             "d": ((4, 4), ("pod", None))}
    assert dryrun.pod_data_apart(specs) == ["b", "c", "d"]


def test_multi_pod_train_cell_runs_as_32x16(tmp_path):
    """paper_consumer's train_4k cell on both meshes, in a subprocess under
    its own time limit: the 2x16x16 row is OK, says it ran as 32x16 and
    counts fewer flops a rank than the 16x16 row (twice the ranks)."""
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "paper_consumer", "--shape", "train_4k", "--mesh", "both",
         "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    single, multi = [json.loads(line) for line in out.read_text().splitlines()]
    assert single["status"] == multi["status"] == "OK", (single, multi)
    assert (single["mesh"], single["mesh_run_as"]) == (
        "16x16", "16x16 (data, model)")
    assert (multi["mesh"], multi["mesh_run_as"]) == (
        "2x16x16", "32x16 (pod*data, model)")
    assert multi["chips"] == 512
    assert 0 < multi["cost_analysis"]["flops"] < single["cost_analysis"]["flops"]


def test_flops_rise_from_none_to_dots_to_full(monkeypatch):
    """granite_moe_1b_a400m's train_4k cell (its config cut to 2 layers,
    for time) on 16x16 under each remat policy: ``full`` less ``none`` is
    the groups' forward product flops, ``dots`` less ``none`` their
    batched products' (the expert einsums, the combine and the flash
    kernel's plain version, which the meta tensors run); neither reruns a
    group's last product (the combine), which only the group's output
    reads."""
    from repro_torch.models import transformer as TT

    import dataclasses

    arch = "granite_moe_1b_a400m"
    cfg = dataclasses.replace(dryrun.configs.get_config(arch), num_layers=2)
    monkeypatch.setattr(dryrun.configs, "get_config", lambda name: cfg)
    modes = []

    class Counting(dryrun.LocalCostMode):
        """Also records each product's flops in the groups' forward."""

        def __init__(self):
            super().__init__()
            self.in_groups = False
            self.products = []
            modes.append(self)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = self.flops
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if self.in_groups and self.flops > before:
                self.products.append((func._overloadpacket.__name__,
                                      self.flops - before))
            return out

    run_groups = TT._run_groups

    def groups(*args, **kwargs):
        modes[-1].in_groups = True
        try:
            return run_groups(*args, **kwargs)
        finally:
            modes[-1].in_groups = False

    monkeypatch.setattr(dryrun, "LocalCostMode", Counting)
    monkeypatch.setattr(TT, "_run_groups", groups)
    flops = {}
    for remat in ("none", "dots", "full"):
        tcfg = dryrun.steplib.TrainStepConfig(
            remat=remat, opt=dryrun.opt_config_for(cfg))
        row = dryrun.run_cell(arch, "train_4k", False, tcfg=tcfg)
        assert row["status"] == "OK"
        flops[remat] = row["cost_analysis"]["flops"]
    assert flops["none"] < flops["dots"] < flops["full"]
    products = modes[0].products
    G = cfg.num_groups
    last_name, last = products[-1]
    assert last_name == "bmm" and len(products) % G == 0
    assert flops["full"] - flops["none"] == (
        sum(f for _, f in products) - G * last)
    assert flops["dots"] - flops["none"] == (
        sum(f for n, f in products if n == "bmm") - G * last)
