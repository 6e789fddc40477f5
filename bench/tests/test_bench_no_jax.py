"""Nothing the benchmark runs loads JAX, the JAX package or the tools
around it: a fresh process imports the harness for every cell, drives
one small run of each on the CPU and reads every metric, then lists the
top-level names of its loaded modules, compared whole."""
from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest

from smoke import (BENCH, run_answers_for_its_own_imports,  # noqa: F401
                   smoke_files)

from harness.cell import execute
from harness.common import FORBIDDEN, BenchError, forbidden_loaded

PROBE = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/tests", sys.argv[1], sys.argv[1] + "/../src"]
from smoke import smoke_files, SECONDS
from harness.cell import execute, reader
from harness.common import benchmark_spec
import harness.serving, harness.training, harness.checks, reference.model
spec = benchmark_spec()
for m in spec["end_to_end"] + spec["per_layer"]:
    reader(m["name"])
for w in spec["workloads"]:
    assert execute(smoke_files(w["name"]), 11, SECONDS, False, "cpu")["correct"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_whole_names_are_compared():
    assert forbidden_loaded(["repro_torch.models", "reproducible", "jaxtyping",
                             "benchmarks_x"]) == []
    assert forbidden_loaded(["repro.core", "jax", "chip_smoke",
                             "benchmarks.serving_handoff"]) == [
        "benchmarks.serving_handoff", "chip_smoke", "jax", "repro.core"]


def test_no_cell_loads_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, "-c", PROBE, str(BENCH)],
                       capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = json.loads(p.stdout.strip().splitlines()[-1])
    assert "repro_torch" in loaded and "harness" in loaded
    assert not set(loaded) & set(FORBIDDEN), sorted(set(loaded) & set(FORBIDDEN))


def test_a_run_that_loads_the_jax_package_gives_no_result(monkeypatch):
    """In the test process too (``smoke.run_answers_for_its_own_imports``),
    a module of the JAX package that the run itself loads refuses it."""
    from harness.serving import ServeCell

    window = ServeCell.window

    def loading(self):
        window(self)
        monkeypatch.setitem(sys.modules, "repro._bench_probe",
                            types.ModuleType("repro._bench_probe"))

    monkeypatch.setattr(ServeCell, "window", loading)
    with pytest.raises(BenchError, match="repro._bench_probe"):
        execute(smoke_files("glm-longctx-cutoff"), 5, 1.0, False, "cpu")
