"""The model of a configuration file that names none: the port's decoder
(GQA attention with RoPE, then a SwiGLU MLP or a softmax top-k MoE, the
same layer stacked ``num_layers`` deep), as ``harness/weights.py`` lays
out its weights, ``reference/model.py`` computes it and
``harness/flops.py`` counts it.

A configuration file brings a model of its own with a ``model`` key: a
path under ``bench/`` (``"model": "models/<config name>.py"``) to a
module that gives the names this one gives (``SMOKE`` may be left out):

* ``layout(run)``: path -> (shape of one row, scale, rows), the params
  tree drawn for the program; rows False for one leaf, True for a stack
  of ``num_layers``, or a number (a stack of its own depth).
* ``view(run, get)``: the reference's weights, from ``get(path, row)``
  (row -1 for a leaf that is not stacked); ``token_gaps`` takes them.
* ``token_gaps(weights, seqs, first, run, control=False)`` and
  ``train_readings(weights, batches, run, opt, control=False)``: the
  plain reference's readings (``checks.py`` says what they are), in
  float32 with TF32 off, or with ``control`` in the precision below the
  one the configuration computes in.  ``train_readings`` takes every
  leaf by its path, stacked, and updates them in place.
* ``serve_token_flops(run, position)``, ``train_batch_flops(run, batch,
  seq)``: the model FLOPs that ``mfu`` counts.
* ``SMOKE``: sizes of the ``run`` block for the CPU tests (a ``smoke``
  block in the configuration file takes precedence).

The module imports nothing of the program, nor JAX, nor the JAX package.
"""
from __future__ import annotations

from harness.flops import serve_token_flops, train_batch_flops
from harness.weights import layout
from reference import model as ref

__all__ = ["layout", "view", "token_gaps", "train_readings",
           "serve_token_flops", "train_batch_flops"]


def view(run: dict, get):
    return ref.groups_view(layout(run), get)


def token_gaps(weights, seqs, first, run: dict, control: bool = False):
    top, layer = weights
    return ref.token_gaps(top, layer, seqs, first, run,
                          control=ref.FP8 if control else None)


def train_readings(weights, batches, run: dict, opt: dict,
                   control: bool = False) -> dict:
    return ref.train_readings(weights, batches, run, opt,
                              ref.FP8 if control else ref.F32, view=view)
