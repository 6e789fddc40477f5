"""A configuration's model, as the harness loads it: the two configurations
that name none get the port's decoder with the parent tree's bits, layout
and counts; a model module's counts reach ``mfu``; a ``run`` block is
applied whole to the port's ModelConfig."""
from __future__ import annotations

import hashlib

import pytest

from smoke import BENCH, smoke_files, smoke_run

from harness import program
from harness.cell import load_model, reader
from harness.common import cell_files
from harness.record import Record
from harness.weights import draw_params, flat_leaves, stacked_rows
from repro_torch.models.config import BlockKind

SEED = 2 ** 31 + 12345
WORKLOADS = ("glm-longctx-cutoff", "granite-train-statefulset")

# Computed with the tree before configurations could name a model
# (draw_params of harness/weights.py at the smoke sizes, SEED): a sha256 of
# each leaf's path, shape and float32 bytes, in flat_leaves' order.
PARENT_DIGEST = {
    "glm-longctx-cutoff":
        "553ea26537f3051d39d9ae382975ee0e5cd5a8d9011fe7432aeecfb6144fbed4",
    "granite-train-statefulset":
        "89a4af74d03e9caf42e1eaed348092b9802327bd6d55486772eddde9ebd47ae1",
}

# The same tree's layout(run) at the configurations' full sizes.
_G = "groups/b0/"
PARENT_LAYOUT = {
    "glm-longctx-cutoff": {
        "embed/table": ((65536, 4096), 0.02, False),
        "final_norm": ((4096,), 0.0, False),
        "unembed": ((65536, 4096), 0.02, False),
        _G + "norm1": ((4096,), 0.0, True),
        _G + "attn/wq": ((4096, 4096), 0.015625, True),
        _G + "attn/wk": ((4096, 256), 0.015625, True),
        _G + "attn/wv": ((4096, 256), 0.015625, True),
        _G + "attn/wo": ((4096, 4096), 0.015625, True),
        _G + "norm2": ((4096,), 0.0, True),
        _G + "mlp/w_gate": ((4096, 13696), 0.015625, True),
        _G + "mlp/w_up": ((4096, 13696), 0.015625, True),
        _G + "mlp/w_down": ((13696, 4096), 0.008544824087808291, True),
    },
    "granite-train-statefulset": {
        "embed/table": ((51200, 1024), 0.02, False),
        "final_norm": ((1024,), 0.0, False),
        _G + "norm1": ((1024,), 0.0, True),
        _G + "attn/wq": ((1024, 1024), 0.03125, True),
        _G + "attn/wk": ((1024, 512), 0.03125, True),
        _G + "attn/wv": ((1024, 512), 0.03125, True),
        _G + "attn/wo": ((1024, 1024), 0.03125, True),
        _G + "norm2": ((1024,), 0.0, True),
        _G + "moe/router": ((1024, 32), 0.02, True),
        _G + "moe/w_gate": ((32, 1024, 512), 0.03125, True),
        _G + "moe/w_up": ((32, 1024, 512), 0.03125, True),
        _G + "moe/w_down": ((32, 512, 1024), 0.04419417382415922, True),
    },
}

# The same tree's flops.py at the full sizes: serve_token_flops at
# positions 0, 1023 and 4095; train_batch_flops at (8, 128) and (2, 16).
PARENT_COUNTS = {
    "glm-longctx-cutoff": ([11954225152, 12423528448, 13832814592],
                           [36812869337088, 1147935916032]),
    "granite-train-statefulset": ([605100032, 672143360, 873469952],
                                  [1871651536896, 58136788992]),
}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_draw_params_bits_are_the_parents(workload):
    files = smoke_files(workload)
    run = files["config"]["run"]
    lay = load_model(files["config"]).layout(run)
    h = hashlib.sha256()
    for path, t in flat_leaves(draw_params(run, SEED, "cpu", lay)).items():
        h.update(path.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == PARENT_DIGEST[workload]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_layout_is_the_parents(workload):
    config = cell_files(workload)["config"]
    assert "model" not in config
    run = config["run"]
    lay = load_model(config).layout(run)
    assert lay == PARENT_LAYOUT[workload]
    assert {stacked_rows(run, rows) for _, _, rows in lay.values()} == {
        0, run["num_layers"]}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_counts_are_the_parents(workload):
    config = cell_files(workload)["config"]
    model, run = load_model(config), config["run"]
    serve, train = PARENT_COUNTS[workload]
    assert [model.serve_token_flops(run, p) for p in (0, 1023, 4095)] == serve
    assert [model.train_batch_flops(run, b, s)
            for b, s in ((8, 128), (2, 16))] == train


def test_a_stack_of_its_own_depth():
    """A layout entry's rows: a leaf, ``num_layers``, or its own number."""
    run = {"num_layers": 27}
    assert [stacked_rows(run, r) for r in (False, True, 1, 26)] == [0, 27, 1, 26]
    lay = {"a": ((2,), 1.0, 1), "b": ((3,), 1.0, 26), "c": ((4,), 0.0, False)}
    tree = draw_params(run, SEED, "cpu", lay)
    assert [tuple(tree[k].shape) for k in "abc"] == [(1, 2), (26, 3), (4,)]


# moe, d 8, 2 heads of 4 over 1 KV head, 4 experts of width 16, top 2
MOE_RUN = {"family": "moe", "num_layers": 2, "d_model": 8, "num_heads": 2,
           "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 10,
           "num_experts": 4, "num_experts_per_tok": 2}


def test_mfu_counts_with_the_configurations_model():
    """``mfu`` counts what the record's model counts: the shared expert's
    weights on top of the decoder's."""
    model = load_model({"name": "shared", "model": "tests/shared_expert_model.py"})
    # a token multiplies: 2 layers x (attn 8*8*2 + 8*4*2 = 192, router 8*4
    # + 2 experts x 3*8*16 = 800) + head 8*10 = 2064; the shared expert
    # 2 layers x 3*8*16 = 768; attention 2 * 4 * 2 * 4 = 64 flops a key
    served = {5: [(4.0, 7), (5.0, 8)]}
    want = sum(2 * (2064 + 768) + 64 * (pos + 1) for pos in (2, 3))
    for m, per_token in ((model, want), (None, want - 2 * 2 * 768)):
        rec = Record("w", MOE_RUN, {}, 10.0, served=served, prompt_len={5: 3},
                     model=m)
        assert reader("mfu")(rec) == pytest.approx(
            100 * per_token / (10.0 * 989e12))
    assert model.train_batch_flops(MOE_RUN, 2, 3) == \
        load_model({}).train_batch_flops(MOE_RUN, 2, 3) + 6 * 768 * 6


def test_smoke_sizes_come_from_the_files():
    """A file's ``smoke`` block over its model's ``SMOKE``; the table only
    for a file with neither."""
    config = {"name": "x", "model": "tests/shared_expert_model.py",
              "smoke": {"capacity_factor": 4.0, "d_ff": 48}}
    got = smoke_run(config, BENCH)
    assert got["d_ff"] == 48 and got["capacity_factor"] == 4.0
    assert got["d_model"] == 64
    glm = cell_files("glm-longctx-cutoff")["config"]
    assert smoke_run(glm)["d_ff"] == 96


def _config(**run):
    return {"name": "x", "port_arch": "granite_moe_1b_a400m",
            "run": dict(cell_files("granite-train-statefulset")["config"]["run"],
                        **run)}


def test_every_run_key_is_applied():
    cfg = program.model_config(_config(
        shared_expert=True, window=512,
        pattern=[["attn_local", "mlp"], ["attn_global", "moe"]]))
    assert cfg.shared_expert and cfg.window == 512
    assert cfg.pattern == ((BlockKind.ATTN_LOCAL, BlockKind.MLP),
                           (BlockKind.ATTN_GLOBAL, BlockKind.MOE))
    assert cfg.family == "moe" and cfg.num_layers == 16


def test_a_run_key_naming_no_field_raises():
    with pytest.raises(ValueError, match="kv_lora_rank"):
        program.model_config(_config(kv_lora_rank=512))


def test_a_model_outside_bench_or_incomplete_is_refused(tmp_path):
    from harness.common import BenchError

    with pytest.raises(BenchError, match="no file"):
        load_model({"name": "x", "model": "../pyproject.toml"})
    (tmp_path / "half.py").write_text("def layout(run):\n    return {}\n")
    with pytest.raises(BenchError, match="lacks"):
        load_model({"name": "x", "model": "half.py"}, tmp_path)
