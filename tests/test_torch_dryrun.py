"""The port's dry-run (``repro_torch.launch.dryrun``): one cell on a fake
process group of 256 ranks, the reference's SKIP rule, and per-rank flops
counted on local shards."""
import json
import os
import subprocess
import sys

from repro import configs as jconfigs
from repro_torch.launch import dryrun

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
