"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 bench/control.py --workload <name> --seeds 1,2,3 --seconds 51 \
        [--control-seeds 1,2,3]

With ``--fault`` a fault of ``faults.py`` is planted in the timed path of
every run.  One process runs the cell once per seed (a window of ``--seconds`` at the
cell's own load, then the comparison), and prints per seed one JSON line
with every number compared: the program's readings give each limit's
lower end.  For the seeds of ``--control-seeds`` it also reads the
control, the reference computed in fp8 in the program's place against
the float32 reference, which gives the upper end.  The benchmark's own
runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default="",
                    help="plant one of faults.FAULTS in the timed path")
    args = ap.parse_args(argv)

    from harness.common import cell_files, set_cache_env

    set_cache_env()
    files = cell_files(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: torch finds no CUDA card", file=sys.stderr)
        return 3
    import contextlib

    from faults import FAULTS
    from harness.cell import execute

    controls = {int(s) for s in args.control_seeds.split(",") if s}
    t0 = T_START
    for s in (int(s) for s in args.seeds.split(",")):
        with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            r = execute(files, s, args.seconds, False, "cuda", t_start=t0,
                        control=s in controls, keep=True)
        row = {"seed": s, "correct": r["correct"],
               "checks": {k: v["value"] for k, v in r["checks"].items()},
               "control": {k: v["value"] for k, v in r.get("control", {}).items()},
               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "detail": r.get("detail")}
        print(json.dumps(row), flush=True)
        gc.collect()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
