"""Paths, guards and the names the harness shares.

Nothing here imports the program: ``run.py`` sets the caches' directories
and checks for the card before the first import of ``repro_torch``.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path
from typing import Dict, Iterable, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# whole top-level module names that no process of the benchmark may load:
# the JAX package and JAX itself, and the repository's tools around them
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a forbidden import, a
    cell the files do not describe)."""


def forbidden_loaded(modules: Iterable[str] = ()) -> List[str]:
    """The loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN`` (``repro_torch`` is not ``repro``)."""
    names = modules or list(sys.modules)
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def cache_dirs(root: Path = ROOT) -> Dict[str, str]:
    """Fixed directories inside the checkout for every build and kernel
    cache (the program builds its CUDA library into ``build/`` itself)."""
    build = root / "build"
    return {"TRITON_CACHE_DIR": str(build / "triton"),
            "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "CUDA_CACHE_PATH": str(build / "nv_compute_cache")}


def set_cache_env(root: Path = ROOT) -> None:
    for k, v in cache_dirs(root).items():
        os.environ[k] = v
        os.makedirs(v, exist_ok=True)
    # a library that could pull in JAX by itself is told not to
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json``, with its configuration
    and traffic files read and the metrics it reports under each kind."""
    spec = benchmark_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json; "
                         f"have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[cell["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return {"cell": cell, "config": config, "traffic": traffic, "root": root,
            "end_to_end": mine(spec["end_to_end"]),
            "per_layer": mine(spec["per_layer"]),
            "chips": int(cell["chips"])}


def mix(*parts) -> int:
    """A 63-bit seed from the run's seed and names: any seed up to a
    little over 2**31 and beyond maps to its own streams."""
    h = hashlib.sha256("/".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)
