"""Run one cell of the benchmark on this machine's card and print its line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up draws the weights on the card from
the seed and warms up every shape the cell's traffic uses; the window then
runs for ``--seconds``; the plain reference judges what it produced.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and ``checks``, each number compared beside its limit);
the same checks are the last lines of standard error.  Without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded, the run prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.common import BenchError, cell_files, set_cache_env

    set_cache_env()
    files = cell_files(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("bench: torch finds no CUDA card; no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < files["chips"]:
        print(f"bench: the cell asks for {files['chips']} cards, torch finds "
              f"{torch.cuda.device_count()}; no result", file=sys.stderr)
        return 3
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from harness.cell import execute, print_checks

    try:
        result = execute(files, args.seed, args.seconds, bool(args.trace),
                         "cuda", t_start=T_START)
    except BenchError as e:
        print(f"bench: {e}; no result", file=sys.stderr)
        return 4
    print_checks(result)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failure: no result, non-zero
        traceback.print_exc()
        sys.exit(1)
