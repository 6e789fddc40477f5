"""Plain float32 forward, loss, gradients and AdamW of the benchmark's models.

The decoder the port runs for chatglm3-6b (dense: GQA attention with RoPE
over part of each head, a SwiGLU MLP) and granite-3.0-1b-a400m (MoE: top-k
softmax routing over the experts, a capacity per expert and batch row,
each token's kept experts summed by their normalized gates, a
load-balancing auxiliary loss), written from the models' published
descriptions and the departures that the configuration files list: the
embedding rows scaled by sqrt(d_model), RMSNorm as ``x * rsqrt(mean(x^2) +
eps) * (1 + scale)``, no bias anywhere, and logits over the vocabulary
padded to a multiple of 2048.

Every product goes through ``mm`` under a ``Precision``: float32 with TF32
off (the reference), or its operands rounded to fp8 e4m3 and their
gradients to fp8 e5m2, with a scale per tensor (the control: the next
precision below the bf16 the configuration computes in).  A dimension is
never cut.

A configuration's own model (``harness/decoder.py`` says how one is named)
may reuse these pieces: ``hidden``, ``loss``, ``token_gaps`` and
``train_readings`` take its own ``block`` (one layer) and weight view.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP8_MAX = 448.0         # largest finite float8_e4m3fn
FP8_E5M2_MAX = 57344.0  # largest finite float8_e5m2


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "float32"

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product in this precision (a float32 tensor)."""
        if self.name == "float32":
            return x
        if self.name == "fp8":
            return _Fp8.apply(x)
        raise ValueError(f"precision {self.name!r}")


F32 = Precision("float32")
FP8 = Precision("fp8")


def _round_fp8(x, dtype, top: float):
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """An operand rounded to fp8 e4m3, one scale per tensor (its absolute
    maximum over 448); its gradient rounded to fp8 e5m2 the same way (the
    usual split of fp8 training: e4m3 forward, e5m2 backward)."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, FP8_E5M2_MAX)


def mm(a, b, prec: Precision = F32):
    return prec.round(a) @ prec.round(b)


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, positions, theta: float, fraction: float):
    """x [B,S,H,D]; positions [B,S]: the first ``fraction`` of each head
    rotated as two halves (rotate-half), the rest passed through."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    freqs = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                          device=x.device) / rot))
    ang = positions.float()[..., None] * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = torch.chunk(x[..., :rot], 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]],
                     dim=-1)


def attention(q, k, v, prec: Precision = F32):
    """Causal GQA attention: q [B,S,H,D], k/v [B,S,Hkv,D] -> [B,S,H*D],
    one row of the batch at a time (the scores of a long row are large)."""
    return torch.cat([_attention_row(q[b:b + 1], k[b:b + 1], v[b:b + 1], prec)
                      for b in range(q.shape[0])])


def _attention_row(q, k, v, prec: Precision):
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = float(torch.tensor(1.0) / torch.tensor(float(D)).sqrt())
    qg = (q * scale).reshape(B, S, Hkv, g, D).permute(0, 2, 3, 1, 4)
    kk = k.permute(0, 2, 1, 3)[:, :, None]          # [B,Hkv,1,S,D]
    vv = v.permute(0, 2, 1, 3)[:, :, None]
    s = mm(qg, kk.transpose(-1, -2), prec)          # [B,Hkv,g,S,S]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = mm(p, vv, prec)                             # [B,Hkv,g,S,D]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H * D)


def attn_block(W: Dict[str, torch.Tensor], h, positions, run: dict,
               prec: Precision):
    B, S, _ = h.shape
    H, Hkv, D = run["num_heads"], run["num_kv_heads"], run["head_dim"]
    q = mm(h, W["attn/wq"], prec).reshape(B, S, H, D)
    k = mm(h, W["attn/wk"], prec).reshape(B, S, Hkv, D)
    v = mm(h, W["attn/wv"], prec).reshape(B, S, Hkv, D)
    q = rope(q, positions, run["rope_theta"], run["rope_fraction"])
    k = rope(k, positions, run["rope_theta"], run["rope_fraction"])
    return mm(attention(q, k, v, prec), W["attn/wo"], prec)


def mlp(W, h, prec: Precision):
    gate = torch.nn.functional.silu(mm(h, W["mlp/w_gate"], prec))
    return mm(gate * mm(h, W["mlp/w_up"], prec), W["mlp/w_down"], prec)


def expert_capacity(run: dict, tokens: int) -> int:
    cap = int(tokens * run["num_experts_per_tok"] * run["capacity_factor"]
              / run["num_experts"])
    return max(8, -(-cap // 8) * 8)


def route(logits, run: dict):
    """Router logits [B,S,E] (float32) -> (combine weights [B,S,E]: each
    kept pick's normalized gate, 0 elsewhere; aux loss).

    Top-k by a stable descending sort (equal probabilities in expert
    order).  Per batch row, an expert keeps its first C entries in
    token-major order (entry t*K + k), C the capacity; a dropped entry
    adds nothing (the token keeps its residual)."""
    B, S, E = logits.shape
    K = run["num_experts_per_tok"]
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = vals[..., :K], ids[..., :K]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    C = expert_capacity(run, S)
    onehot = torch.nn.functional.one_hot(ids, E).reshape(B, S * K, E)
    rank = (onehot.cumsum(dim=1) - 1) * onehot        # rank among e's entries
    kept = ((rank < C) & (onehot > 0)).any(-1).reshape(B, S, K)
    comb = torch.zeros(B, S, E, dtype=logits.dtype, device=logits.device)
    comb = comb.scatter_add(-1, ids, torch.where(kept, w, torch.zeros_like(w)))
    top1 = torch.nn.functional.one_hot(ids[..., 0], E).float()
    aux = E * torch.mean(top1.reshape(-1, E).mean(0) * probs.reshape(-1, E).mean(0))
    aux = aux + 1e-3 * torch.mean(torch.logsumexp(logits, -1) ** 2)
    return comb, aux


def moe(W, h, run: dict, prec: Precision):
    """Every expert over every token, each output weighted by the token's
    combine weight for it (0 where it was not picked or was dropped)."""
    comb, aux = route(mm(h, W["moe/router"], prec), run)
    out = torch.zeros_like(h)
    for e in range(run["num_experts"]):
        gate = torch.nn.functional.silu(mm(h, W["moe/w_gate"][e], prec))
        y = mm(gate * mm(h, W["moe/w_up"][e], prec), W["moe/w_down"][e], prec)
        out = out + comb[..., e:e + 1] * y
    return out, aux


def block(W, x, positions, run: dict, prec: Precision):
    """One decoder layer -> (x, the layer's aux loss or 0)."""
    eps = run["norm_eps"]
    x = x + attn_block(W, rms_norm(x, W["norm1"], eps), positions, run, prec)
    h = rms_norm(x, W["norm2"], eps)
    if run["family"] == "moe":
        y, aux = moe(W, h, run, prec)
        return x + y, aux
    return x + mlp(W, h, prec), x.new_zeros(())


def embed(table, tokens, run: dict):
    return table[tokens] * math.sqrt(run["d_model"])


def head(table, x, run: dict, prec: Precision):
    return mm(x, table.transpose(0, 1), prec)


LayerFn = Callable[[int], Dict[str, torch.Tensor]]
GROUP = "groups/b0/"


def groups_view(paths: Iterable[str], get: Callable[[str, int], torch.Tensor]):
    """The decoder's weights as ``hidden`` takes them, from the program's
    tree: (the leaves outside the layer group, a function of the layer
    giving its group leaves by their path inside the group).  ``get(path,
    g)`` is a leaf (g -1) or layer g's row of a stacked leaf."""
    paths = list(paths)
    top = {p: get(p, -1) for p in paths if not p.startswith(GROUP)}

    def layer(g: int) -> Dict[str, torch.Tensor]:
        return {p[len(GROUP):]: get(p, g) for p in paths if p.startswith(GROUP)}

    return top, layer


def hidden(top: Dict[str, torch.Tensor], layer: LayerFn, tokens, run: dict,
           prec: Precision = F32, block=block):
    """tokens [B,S] -> (final normed hidden [B,S,D], summed aux loss),
    taking each layer's weights from ``layer(g)`` in turn through
    ``block`` (a model of its own may pass its own layer)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = embed(top["embed/table"], tokens, run)
    aux = x.new_zeros(())
    for g in range(run["num_layers"]):
        x, a = block(layer(g), x, positions, run, prec)
        aux = aux + a
    return rms_norm(x, top["final_norm"], run["norm_eps"]), aux


def head_table(top: Dict[str, torch.Tensor]):
    return top["unembed"] if "unembed" in top else top["embed/table"]


def loss(top, layer: LayerFn, batch, run: dict, prec: Precision = F32,
         block=block):
    """Next-token cross-entropy over the padded vocabulary plus the router's
    aux loss times ``router_aux_coef``."""
    x, aux = hidden(top, layer, batch["tokens"], run, prec, block)
    logits = head(head_table(top), x, run, prec)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    return -ll.mean() + run.get("router_aux_coef", 0.0) * aux


# ---------------------------------------------------------------------------
# AdamW with global-norm clipping and linear warm-up
# ---------------------------------------------------------------------------

def lr_at(step: int, opt: dict) -> float:
    if step < opt["warmup_steps"]:
        return opt["lr_peak"] * min(1.0, (step + 1) / max(1, opt["warmup_steps"]))
    t = min(1.0, max(0.0, (step - opt["warmup_steps"])
                     / max(1, opt["total_steps"] - opt["warmup_steps"])))
    return opt["lr_peak"] * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


@torch.no_grad()
def adamw(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          state: dict, step: int, opt: dict) -> Dict[str, torch.Tensor]:
    """One AdamW step in place; returns the clipped gradients."""
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
    state["count"] += 1
    b1, b2, lr = opt["b1"], opt["b2"], lr_at(step, opt)
    b1c, b2c = 1 - b1 ** state["count"], 1 - b2 ** state["count"]
    clipped = {}
    for k, p in params.items():
        g = grads[k] * scale
        clipped[k] = g
        m = state["m"].setdefault(k, torch.zeros_like(p))
        v = state["v"].setdefault(k, torch.zeros_like(p))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        upd = (m / b1c) / (torch.sqrt(v / b2c) + opt["eps"])
        p.sub_(lr * (upd + opt["weight_decay"] * p))
    return clipped


def train_readings(weights: Dict[str, torch.Tensor], batches: List[dict],
                   run: dict, opt: dict, prec: Precision = F32, view=None,
                   block=block) -> dict:
    """Run len(batches) steps from ``weights`` (path -> float32 tensor, a
    stacked leaf with its layers on the leading axis; updated in place),
    seen through ``view(run, get)`` (``groups_view`` where None).
    -> each step's loss, the first step's clipped gradient (``grad``) and
    its norm per leaf, and each leaf's change norm after the last step."""
    start = {k: w.detach().clone() for k, w in weights.items()}
    state: dict = {"count": 0, "m": {}, "v": {}}
    losses, gnorms, first = [], None, None
    for step, batch in enumerate(batches):
        leaves = {k: w.detach().requires_grad_() for k, w in weights.items()}

        def get(path, g, leaves=leaves):
            return leaves[path] if g < 0 else leaves[path][g]

        top, layer = (view(run, get) if view is not None
                      else groups_view(leaves, get))
        value = loss(top, layer, batch, run, prec, block)
        # a leaf the model never reads has the gradient 0
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
            leaves.values(), torch.autograd.grad(value, list(leaves.values()),
                                                 allow_unused=True))]
        losses.append(float(value.detach()))
        clipped = adamw(weights, dict(zip(leaves, grads)), state, step, opt)
        if gnorms is None:
            gnorms = {k: float(g.norm()) for k, g in clipped.items()}
            first = clipped
        del leaves, grads, clipped, value
    change = {k: float((weights[k] - start[k]).norm()) for k in weights}
    return {"loss": losses, "grad_norm": gnorms, "change_norm": change,
            "grad": first}


def token_gaps(top, layer: LayerFn, seqs: List[List[int]],
               first: List[int], run: dict, prec: Precision = F32,
               control: Optional[Precision] = None,
               block=block) -> List[float]:
    """For each sequence (prompt + served tokens), the gap of every served
    token (positions ``first[i]`` onward) below the reference's best logit
    at its position.  With ``control``, the gap under the reference of the
    token that the control precision puts first instead."""
    n = max(len(s) for s in seqs)
    dev = top["embed/table"].device
    tokens = torch.zeros(len(seqs), n, dtype=torch.long, device=dev)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = torch.tensor(s, dtype=torch.long)
    inputs = tokens[:, :-1]
    with torch.no_grad():
        ref = _served_logits(top, layer, inputs, first, seqs, run, F32, block)
        ctrl = (None if control is None else
                _served_logits(top, layer, inputs, first, seqs, run, control,
                               block))
    gaps = []
    for i, s in enumerate(seqs):
        for j, pos in enumerate(range(first[i] - 1, len(s) - 1)):
            row = ref[i][j]
            tok = (int(ctrl[i][j].argmax()) if ctrl is not None
                   else int(tokens[i, pos + 1]))
            gaps.append(float(row.max() - row[tok]))
    return gaps


def _served_logits(top, layer, inputs, first, seqs, run, prec, block):
    """The logits at the positions that served a token, a row each."""
    x, _ = hidden(top, layer, inputs, run, prec, block)
    table = head_table(top)
    return [head(table, x[i, first[i] - 1:len(s) - 1], run, prec)
            for i, s in enumerate(seqs)]
