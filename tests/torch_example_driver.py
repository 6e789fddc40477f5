"""Runs one of the port's examples (``examples/torch_*.py``) through its
``main`` in a process of its own, then checks that neither ``jax`` nor
``repro`` was loaded.  Imports torch, numpy and the port only.

  python tests/torch_example_driver.py EXAMPLE [--weights FILE]
      [--max-seq N] [--speedup X] [-- ARGS...]

``--weights`` names a pickle of ``[(port ModelConfig, numpy tree), ...]``:
``repro_torch.models.transformer.init_lm`` is replaced by a lookup that
hands the tree of an equal config to ``tree_from_jax`` (the examples draw
every weight through ``init_lm``; the tests hand in the JAX package's
draws this way).  ``--max-seq`` makes the example's
``make_torch_worker_factory`` build consumers of that ``max_seq`` and
``--speedup`` replaces its ``measure_replay_speedup`` by that constant
(the live example's cuts).  ``ARGS`` go to ``main``.

The tests import ``run_port`` (this driver in a subprocess) and
``compare_lines`` (the printed lines against the reference's) from here.
"""
import argparse
import importlib.util
import os
import pickle
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a printed loss: "loss 7.641" or "loss=6.324"
LOSS = re.compile(r"(loss[ =])(-?[0-9.]+|nan)")


def load_example(path, name):
    """The example file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_port(example, *args, weights=None, max_seq=None, speedup=None,
             timeout=600) -> str:
    """``example`` run through this driver in a process of its own (one
    torch thread) -> its standard output; fails if the run fails or loaded
    ``jax`` or ``repro``."""
    cmd = [sys.executable, os.path.abspath(__file__), example]
    for flag, value in (("--weights", weights), ("--max-seq", max_seq),
                        ("--speedup", speedup)):
        if value is not None:
            cmd += [flag, str(value)]
    if args:
        cmd += ["--", *args]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def compare_lines(want: str, got: str, tol: dict) -> None:
    """The port's printed lines against the reference's: every line equal
    as a string once its printed losses are taken out, and those losses
    equal within ``tol`` (``np.testing.assert_allclose``'s keywords)."""
    want, got = want.splitlines(), got.splitlines()
    assert len(got) == len(want), (got, want)
    for w, g in zip(want, got):
        assert LOSS.sub(r"\1?", g) == LOSS.sub(r"\1?", w), (g, w)
        np.testing.assert_allclose(
            [float(x) for _, x in LOSS.findall(g)],
            [float(x) for _, x in LOSS.findall(w)], err_msg=g, **tol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("example")
    ap.add_argument("--weights")
    ap.add_argument("--max-seq", type=int)
    ap.add_argument("--speedup", type=float)
    ap.add_argument("args", nargs="*")
    args = ap.parse_args(argv)

    from repro_torch.convert import tree_from_jax
    from repro_torch.models import transformer as T

    mod = load_example(os.path.join(REPO, "examples", args.example),
                       "example")
    if args.weights:
        with open(args.weights, "rb") as f:
            table = pickle.load(f)

        def init_lm(cfg, seed=0, device="cuda"):
            assert seed == 0, seed
            for known, tree in table:
                if known == cfg:
                    return tree_from_jax(tree, device)
            raise KeyError(f"no weights handed in for {cfg}")

        T.init_lm = init_lm
    if args.max_seq:
        factory = mod.make_torch_worker_factory
        mod.make_torch_worker_factory = (
            lambda max_seq, device: factory(max_seq=args.max_seq,
                                            device=device))
    if args.speedup:
        mod.measure_replay_speedup = lambda *a, **k: args.speedup
    mod.main(args.args) if args.args else mod.main()
    sys.stdout.flush()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        print(f"loaded: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
