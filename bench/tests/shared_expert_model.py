"""A model of its own, for the harness's tests: the port's MoE decoder with
a shared expert (``"shared_expert": true`` in the ``run`` block), a SwiGLU
MLP of width ``d_ff`` over every token beside the routed experts, whose
output the layer adds to theirs, as ``repro_torch.models.moe`` does.  A
test copies it into a checkout's ``bench/models/`` and names it in a
configuration file's ``model`` key."""
from __future__ import annotations

from harness import decoder, flops
from reference import model as ref

SHARED = "groups/b0/moe/shared/"
SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=32, vocab_size=300, num_experts=4,
             num_experts_per_tok=2, dtype="float32")


def layout(run: dict):
    d, ff = run["d_model"], run["d_ff"]
    out = decoder.layout(run)
    out.update({SHARED + "w_gate": ((d, ff), d ** -0.5, True),
                SHARED + "w_up": ((d, ff), d ** -0.5, True),
                SHARED + "w_down": ((ff, d), ff ** -0.5, True)})
    return out


def view(run: dict, get):
    return ref.groups_view(layout(run), get)


def shared(W, h, prec):
    return ref.mlp({f"mlp/{k}": W[f"moe/shared/{k}"]
                    for k in ("w_gate", "w_up", "w_down")}, h, prec)


def block(W, x, positions, run: dict, prec):
    eps = run["norm_eps"]
    x = x + ref.attn_block(W, ref.rms_norm(x, W["norm1"], eps), positions,
                           run, prec)
    h = ref.rms_norm(x, W["norm2"], eps)
    y, aux = ref.moe(W, h, run, prec)
    y = y + shared(W, h, prec)  # the shared expert
    return x + y, aux


def token_gaps(weights, seqs, first, run: dict, control: bool = False):
    top, layer = weights
    return ref.token_gaps(top, layer, seqs, first, run,
                          control=ref.FP8 if control else None, block=block)


def train_readings(weights, batches, run: dict, opt: dict,
                   control: bool = False) -> dict:
    return ref.train_readings(weights, batches, run, opt,
                              ref.FP8 if control else ref.F32, view=view,
                              block=block)


def _shared_params(run: dict) -> int:
    return run["num_layers"] * 3 * run["d_model"] * run["d_ff"]


def serve_token_flops(run: dict, position: int) -> int:
    return flops.serve_token_flops(run, position) + 2 * _shared_params(run)


def train_batch_flops(run: dict, batch: int, seq: int) -> int:
    return (flops.train_batch_flops(run, batch, seq)
            + 6 * _shared_params(run) * batch * seq)
