"""End-to-end migration experiments: the port against the JAX package.

The control plane is a copy, so with the cheap ``HashConsumer`` the
experiment rows must be identical.  With the real (smoke-size) model
consumer the virtual timeline depends only on chunk byte counts, so the
rows must match too, and both must verify the migrated state.  The port
must also run without JAX in the process.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import run_migration_experiment as jax_experiment
from repro.core.consumer import StatefulConsumer as JConsumer
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core import available_strategies
from repro_torch.core import run_migration_experiment as torch_experiment
from repro_torch.core.consumer import StatefulConsumer as TConsumer

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("topology", ["flat", "two_zone", "edge_wan"])
@pytest.mark.parametrize("strategy", available_strategies())
def test_hash_consumer_rows_identical(tmp_path, strategy, topology, seed):
    kw = dict(seed=seed, topology=topology, t_migrate=8.0)
    want = jax_experiment(strategy, 10.0, registry_root=str(tmp_path / "j"),
                          **kw).row()
    got = torch_experiment(strategy, 10.0, registry_root=str(tmp_path / "t"),
                           **kw).row()
    assert got == want
    assert got["verified"] is True


def test_hash_consumer_rows_identical_under_faults(tmp_path):
    from repro.cluster import parse_fault as jparse
    from repro.core import MigrationPolicy as JPolicy
    from repro_torch.cluster import parse_fault as tparse
    from repro_torch.core import MigrationPolicy as TPolicy

    # the outage covers the first image push: attempt 1 rolls back
    spec = "registry_outage@phase:checkpoint,duration=12"
    kw = dict(seed=5, allow_failure=True)
    want = jax_experiment("ms2m_individual", 6.0,
                          registry_root=str(tmp_path / "j"),
                          faults=[jparse(spec)],
                          policy=JPolicy(max_attempts=3, retry_backoff_s=1.0),
                          **kw).row()
    got = torch_experiment("ms2m_individual", 6.0,
                           registry_root=str(tmp_path / "t"),
                           faults=[tparse(spec)],
                           policy=TPolicy(max_attempts=3, retry_backoff_s=1.0),
                           **kw).row()
    assert got == want
    assert got["attempts"] >= 2 and got["verified"] is True


@pytest.mark.parametrize("strategy,precopy", [("ms2m_individual", False),
                                              ("ms2m_cutoff", True)])
def test_model_consumer_rows_match_and_verify(tmp_path, strategy, precopy):
    jcfg = jconfigs.get_smoke("paper_consumer")
    tcfg = tconfigs.get_smoke("paper_consumer")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(seed=0, t_migrate=5.0, settle_time=2.0, precopy=precopy)
    want = jax_experiment(strategy, 4.0, registry_root=str(tmp_path / "j"),
                          worker_factory=lambda: JConsumer(jcfg, jparams, 128),
                          **kw).row()
    got = torch_experiment(strategy, 4.0, registry_root=str(tmp_path / "t"),
                           worker_factory=lambda: TConsumer(tcfg, tparams, 128),
                           **kw).row()
    assert want["state_verified"] is True and got["state_verified"] is True
    assert got["replayed"] > 0
    # the state fields (image byte counts) match as well: the two caches
    # have the same leaves, byte for byte in size
    assert got == want


def test_port_runs_without_jax(tmp_path):
    """``import repro_torch`` and a CLI run load neither JAX nor repro."""
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.launch import migrate\n"
        f"rc = migrate.main(['--hash-consumer', '--registry', {str(tmp_path)!r}])\n"
        "assert rc == 0, rc\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "rc = migrate.main(['--workload', 'serving'])\n"
        "assert rc == 2, rc\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert "not ported yet" in out.stderr


def test_no_port_file_imports_jax_or_repro():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders


def test_simlint_clean_on_port():
    out = subprocess.run([sys.executable, "-m", "tools.simlint", str(PORT)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
