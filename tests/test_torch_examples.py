"""The port's examples against the JAX package's, on the CPU.

Each test runs the reference example's ``main()`` here under ``capsys``
and the port's (``examples/torch_*.py``) with ``--device cpu`` through
``tests/torch_example_driver.py`` in a process of its own, which fails if
``jax`` or ``repro`` was loaded there, then compares the printed lines:
control-plane numbers (virtual times, counts, image sizes, verdicts) and
the greedy sample token as strings, the printed losses within
``STEP_TOL``.  The port's weights are the JAX example's own draws
(``init_lm(PRNGKey(0), cfg)``), handed to the port's ``init_lm`` through
``tree_from_jax``: torch cannot reproduce threefry.
"""
import ast
import json
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import split_params
from repro_torch import configs as tconfigs
from torch_example_driver import compare_lines, load_example, run_port

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
# tests/test_torch_train.py's tolerance for a few AdamW steps, applied to
# the losses the examples print (3 decimals)
STEP_TOL = dict(rtol=1e-4, atol=2e-5)
MODEL_EXAMPLES = ("quickstart", "serving_engine_migration",
                  "statefulset_trainer_migration")


def jax_weights(path, configs):
    """Pickles ``[(port config, the JAX package's draw as numpy), ...]``
    for each (port config, JAX config) of ``configs`` -> ``path``."""
    table = []
    for tcfg, jcfg in configs:
        params, _ = split_params(JT.init_lm(jax.random.PRNGKey(0), jcfg))
        table.append((tcfg, jax.tree.map(np.asarray, params)))
    with open(path, "wb") as f:
        pickle.dump(table, f)
    return str(path)


def jax_lines(capsys, name: str) -> str:
    """The reference example's printed lines."""
    mod = load_example(EXAMPLES / f"{name}.py", f"jax_{name}")
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def both(name: str):
    """(port config, JAX config) of ``name``'s smoke and full configs."""
    return [(tconfigs.get_smoke(name), jconfigs.get_smoke(name)),
            (tconfigs.get_config(name), jconfigs.get_config(name))]


def test_quickstart_prints_the_reference_lines(tmp_path, capsys):
    want = jax_lines(capsys, "quickstart")
    got = run_port("torch_quickstart.py", "--device", "cpu",
                   weights=jax_weights(tmp_path / "w.pkl",
                                       both("smollm_360m")[:1]
                                       + both("paper_consumer")[1:]))
    print(got)
    compare_lines(want, got, STEP_TOL)
    assert "sample token" in got
    assert "migration_time=64.82s downtime=1.40s" in got
    assert got.rstrip().endswith("verified bit-exact: True")


def test_serving_engine_prints_the_reference_lines(tmp_path, capsys):
    want = jax_lines(capsys, "serving_engine_migration")
    got = run_port("torch_serving_engine_migration.py", "--device", "cpu",
                   weights=jax_weights(tmp_path / "w.pkl",
                                       both("paper_consumer")[:1]))
    print(got)
    compare_lines(want, got, STEP_TOL)
    assert "migration_time=65.00s downtime=1.40s" in got
    assert "requests served by target engine: 180" in got
    assert "migrated engine state verified: True" in got


def test_trainer_prints_the_reference_lines(tmp_path, capsys):
    want = jax_lines(capsys, "statefulset_trainer_migration")
    got = run_port("torch_statefulset_trainer_migration.py", "--device",
                   "cpu", weights=jax_weights(tmp_path / "w.pkl",
                                              both("smollm_360m")[:1]))
    print(got)
    compare_lines(want, got, STEP_TOL)
    assert "step=74 " in got and "step=417 " in got
    assert "migration_time=61.17s downtime=36.16s" in got
    assert got.rstrip().endswith("matches migrated trainer: True")


def test_rolling_prints_the_reference_lines(capsys):
    want = jax_lines(capsys, "rolling_statefulset_migration")
    got = run_port("torch_rolling_statefulset_migration.py")
    assert got == want
    assert "downtime=37.30s precopy_rounds=3 replayed=125" in got


def test_live_sweep_ms2m_individual_is_the_default_migrate_path(
        tmp_path, monkeypatch, capsys):
    """The live example's ``ms2m_individual`` run at 10 msg/s takes
    ``launch.migrate``'s defaults: the two rows are equal (both
    factories cut to 256 slots, which changes only the image's bytes)."""
    from repro_torch.core import make_torch_worker_factory
    from repro_torch.launch import migrate

    def small(max_seq, device):
        return make_torch_worker_factory(max_seq=256, device=device)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        monkeypatch.setattr(migrate, "make_torch_worker_factory", small)
        capsys.readouterr()
        rc = migrate.main(["--device", "cpu", "--registry",
                           str(tmp_path / "cli")])
        out = capsys.readouterr().out
        live = load_example(EXAMPLES / "torch_live_migration_serving.py",
                            "torch_live_migration_serving")
        monkeypatch.setattr(live, "STRATEGIES", ("ms2m_individual",))
        make, _ = small(2048, "cpu")
        r = live.sweep(make, 10.0, str(tmp_path / "ex"))["ms2m_individual"]
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    assert json.loads(json.dumps(r.row())) == json.loads(
        out[:out.index("\n}") + 2])
    assert r.verified


@pytest.mark.parametrize("name", MODEL_EXAMPLES + ("live_migration_serving",))
def test_example_raises_without_a_card(name, monkeypatch):
    """``--device cuda`` (the default) with no card raises at once; the
    examples never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load_example(EXAMPLES / f"torch_{name}.py", f"torch_{name}")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main([])


def test_examples_import_only_torch_the_port_and_the_standard_library():
    import sys

    for path in sorted(EXAMPLES.glob("torch_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert (top in ("torch", "repro_torch")
                        or top in sys.stdlib_module_names), (path.name, name)
