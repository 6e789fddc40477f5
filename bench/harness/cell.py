"""One run of one cell: set-up, the window, the readers, the comparison.

``execute`` is the run without the look for a card, so that the tests
drive it on the CPU at small sizes; ``run.py`` looks for the card first.
"""
from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from harness.common import BENCH, BenchError, forbidden_loaded


def reader(name: str, bench: Path = BENCH) -> Callable:
    """The ``read(record)`` function of metric ``name`` from its own file,
    ``bench/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        raise BenchError(f"metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_model(config: dict, bench: Path = BENCH):
    """The model that ``config`` runs: the module its ``model`` key names
    (a path under ``bench/``), or the port's decoder
    (``harness/decoder.py``, which lists what a model gives) where it
    names none."""
    from harness import decoder

    if "model" not in config:
        return decoder
    path = (bench / config["model"]).resolve()
    if bench.resolve() not in path.parents or not path.is_file():
        raise BenchError(f"{config['name']}: model {config['model']!r} is no "
                         f"file under {bench}")
    spec = importlib.util.spec_from_file_location(
        f"bench_model_{config['name']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [n for n in decoder.__all__ if not hasattr(mod, n)]
    if missing:
        raise BenchError(f"{config['name']}: model {path} lacks {missing}")
    return mod


def make_cell(files: dict, seed: int, seconds: float, trace: bool, device):
    kind = files["traffic"]["kind"]
    if kind == "serve":
        from harness.serving import ServeCell as Cell
    elif kind == "train":
        from harness.training import TrainCell as Cell
    else:
        raise BenchError(f"traffic kind {kind!r}")
    model = load_model(files["config"], files["root"] / "bench")
    return Cell(files["config"], files["traffic"], seed, seconds, trace,
                device, files["cell"]["name"], model)


def execute(files: dict, seed: int, seconds: float, trace: bool, device,
            t_start: Optional[float] = None, control: bool = False,
            keep: bool = False) -> dict:
    """-> the result line's fields (``control``: the control's checks too,
    under ``control``; ``keep``: the compared readings, under ``detail``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = make_cell(files, seed, seconds, trace, device)
    cell.setup()
    rec = cell.rec
    rec.setup_s = time.perf_counter() - t_start
    cell.window()
    cell.close()
    import json

    from harness.record import summary

    print("bench: window " + json.dumps(summary(rec)), file=sys.stderr)
    found = forbidden_loaded()
    if found:
        raise BenchError(f"modules of JAX or the JAX package loaded: {found}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    metrics = files["per_layer"] if trace else files["end_to_end"]
    values: Dict[str, dict] = {}
    for m in metrics:
        v = reader(m["name"], files["root"] / "bench")(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    from harness import checks as chk

    limits = files["traffic"]["limits"]
    judge = chk.serve_checks if files["traffic"]["kind"] == "serve" \
        else chk.train_checks
    checks, ctrl = judge(cell, limits, control)
    for k, v in getattr(cell, "readings_only", {}).items():
        print(f"bench: reading {k} {v!r} (not compared)", file=sys.stderr)
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": rec.attempted,
        "failed": int(checks.get("requests_not_exactly_once",
                                 checks.get("batches_not_exactly_once"))[0]),
        "metrics": values,
        "device": device_info(device, files["chips"], peak, rec.trace),
    }
    if trace and rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    if keep:
        result["detail"] = getattr(cell, "detail", None)
    if ctrl is not None:
        result["control"] = {k: {"value": v, "limit": lim}
                             for k, (v, lim) in ctrl.items()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    found = forbidden_loaded()
    if found:
        raise BenchError(f"modules of JAX or the JAX package loaded: {found}")
    return result


def device_info(device, chips: int, peak: int, trace: Optional[dict]) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": chips, "memory_peak_bytes": int(peak)}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def print_checks(result: dict, stream=sys.stderr) -> None:
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=stream)
