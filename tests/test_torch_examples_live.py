"""The port's live-migration example against the JAX package's, on the CPU.

``examples/live_migration_serving.py``'s ``main()`` runs here under
``capsys``; ``examples/torch_live_migration_serving.py`` runs with
``--device cpu`` through ``tests/torch_example_driver.py`` in a process of
its own, which fails if ``jax`` or ``repro`` was loaded there.  Two cuts,
the same in both packages: consumers of ``MAX_SEQ`` = 256 slots instead of
2048 (the image lines shrink with the cache; the virtual timelines do
not change), and ``measure_replay_speedup``, a wall-clock ratio, replaced
by the constant ``SPEEDUP`` (the JAX example's reading on an 8-core CPU).
Every printed line must then be equal as a string: the four strategies at
λ = 10, and ``ms2m_cutoff`` at λ = 16 paper-faithful (the cutoff fires)
and with batched replay (``replay_chunked``).
"""
import pickle
from pathlib import Path

import jax
import numpy as np

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import split_params
from repro_torch import configs as tconfigs
from torch_example_driver import load_example, run_port

REPO = Path(__file__).resolve().parents[1]
MAX_SEQ = 256
SPEEDUP = 14.2


def test_live_migration_prints_the_reference_lines(tmp_path, capsys,
                                                   monkeypatch):
    mod = load_example(REPO / "examples" / "live_migration_serving.py",
                       "jax_live_migration_serving")
    factory = mod.make_jax_worker_factory
    monkeypatch.setattr(mod, "make_jax_worker_factory",
                        lambda max_seq: factory(max_seq=MAX_SEQ))
    monkeypatch.setattr(mod, "measure_replay_speedup",
                        lambda *a, **k: SPEEDUP)
    capsys.readouterr()
    mod.main()
    want = capsys.readouterr().out

    params, _ = split_params(JT.init_lm(
        jax.random.PRNGKey(0), jconfigs.get_config("paper_consumer")))
    weights = tmp_path / "w.pkl"
    with open(weights, "wb") as f:
        pickle.dump([(tconfigs.get_config("paper_consumer"),
                      jax.tree.map(np.asarray, params))], f)
    got = run_port("torch_live_migration_serving.py", "--device", "cpu",
                   weights=str(weights), max_seq=MAX_SEQ, speedup=SPEEDUP)
    print(got)
    assert got == want
    lines = got.splitlines()
    assert f"speedup: {SPEEDUP:.1f}x" in lines[0]
    assert sum("verified=True" in line for line in lines) == 6
    assert any(line.startswith("  paper-faithful") and "cutoff_fired=True"
               in line for line in lines)
    assert any(line.startswith("  stop_and_copy") for line in lines)
