"""Plain float32 reference of LTHM with LFM2-8B-A1B's hybrid block as the
query tower's backbone (``transformer_config.backbone: lfm2_moe``).

Written from the published equations (``transformers``' ``Lfm2RMSNorm``,
``Lfm2ShortConv.slow_forward``, ``Lfm2Attention``, ``Lfm2MLP``,
``Lfm2DecoderLayer`` and ``Lfm2Model``'s ``embedding_norm``; the routed MoE
from ``lfm2_moe``'s config keys) with plain torch operations, in float32
and with TF32 off. It imports no JAX, nothing of the JAX package and no
kernel or module of the port; the LTHM parts around the backbone (the
product tower, the logQ state, the contrastive loss and AdamW) come from
the benchmark's plain LTHM reference, ``benchmark/reference/lthm.py``, which
imports nothing of the program either. Weights are a dict under the port's
state-dict names.

The routed MoE is a loop over the experts: each expert's rows are picked
with ``index_select``, run through its SwiGLU and added back under their
weights with ``index_add_``.

Departures from the published model:

- the towers replace the vocabulary: LTHM's product tower embeds the
  history's items (no token embedding) and its contrastive heads take the
  place of the LM head;
- LTHM's learned position embedding (``wpe``) is kept beside RoPE, which
  reads positions 0..T-1 of the stack's input (the CLS column, then the
  events);
- ``expert_bias`` is part of the weights (drawn from a seed in the
  benchmark) and is never updated: no load-balancing update runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import lthm as base

Weights = Dict[str, torch.Tensor]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def short_conv(x: torch.Tensor, w: Weights, pre: str, taps: int) -> torch.Tensor:
    """``Lfm2ShortConv.slow_forward`` without a cache: B, C, u from
    ``in_proj``, ``conv1d(B u)`` cut to T, times C, ``out_proj``."""
    t = x.shape[1]
    bcx = (x @ w[pre + "in_proj.weight"].t()).transpose(-1, -2)
    b, c, u = bcx.chunk(3, dim=-2)
    conv = F.conv1d(b * u, w[pre + "weight"], padding=taps - 1, groups=u.shape[1])[..., :t]
    return (c * conv).transpose(-1, -2) @ w[pre + "out_proj.weight"].t()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def rope(t: int, hd: int, theta: float, device):
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.int64, device=device).float() / hd))
    freqs = torch.arange(t, device=device).float()[:, None] * inv_freq[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def attention(x: torch.Tensor, w: Weights, pre: str, tc: dict) -> torch.Tensor:
    """``Lfm2Attention``: per-head RMSNorm on q and k, RoPE, the KV heads
    repeated to the query heads (``repeat_kv``), causal softmax."""
    bsz, t, d = x.shape
    nh, nkv = tc["num_attention_heads"], tc["num_key_value_heads"]
    hd, eps = d // nh, tc["norm_eps"]
    q = rms_norm((x @ w[pre + "q_proj.weight"].t()).view(bsz, t, nh, hd), w[pre + "q_layernorm.weight"], eps)
    k = rms_norm((x @ w[pre + "k_proj.weight"].t()).view(bsz, t, nkv, hd), w[pre + "k_layernorm.weight"], eps)
    v = (x @ w[pre + "v_proj.weight"].t()).view(bsz, t, nkv, hd)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    cos, sin = rope(t, hd, tc["rope_theta"], x.device)
    q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
    k, v = (z[:, :, None].expand(bsz, nkv, nh // nkv, t, hd).reshape(bsz, nh, t, hd) for z in (k, v))
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=x.device).tril(), float("-inf"))
    y = torch.softmax(s, dim=-1) @ v
    return y.transpose(1, 2).reshape(bsz, t, d) @ w[pre + "out_proj.weight"].t()


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1.t()) * (x @ w3.t())) @ w2.t()


def routed_moe(x: torch.Tensor, w: Weights, pre: str, tc: dict, record: Optional[List] = None) -> torch.Tensor:
    """x (N, d): sigmoid scores, the top k of score + expert_bias, weights
    the chosen scores over their sum + 1e-6 times the scale; each expert's
    SwiGLU on its rows, added back under their weights. ``record`` gets the
    chosen experts (N, k)."""
    e, k, hidden = tc["num_experts"], tc["num_experts_per_tok"], tc["moe_intermediate_size"]
    scores = torch.sigmoid(x @ w[pre + "gate"].t())
    choice = torch.topk(scores + w[pre + "expert_bias"], k, dim=-1).indices
    weights = scores.gather(1, choice)
    if tc["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    weights = weights * tc["routed_scaling_factor"]
    if record is not None:
        record.append(choice)
    out = torch.zeros_like(x)
    for expert in range(e):
        tok, slot = torch.nonzero(choice == expert, as_tuple=True)
        if tok.numel() == 0:
            continue
        w13 = w[pre + "w13"][expert]
        ye = swiglu(x.index_select(0, tok), w13[:hidden], w13[hidden:], w[pre + "w2"][expert])
        out = out.index_add(0, tok, ye * weights[tok, slot][:, None])
    return out


def block(x: torch.Tensor, w: Weights, i: int, tc: dict, record: Optional[List] = None) -> torch.Tensor:
    """``Lfm2DecoderLayer``: the mixer on the operator norm, the
    feed-forward on the FFN norm, each added to the stream."""
    pre, eps = f"query_tower.transformer.block_{i}.", tc["norm_eps"]
    h = rms_norm(x, w[pre + "operator_norm.weight"], eps)
    if tc["layer_types"][i] == "full_attention":
        h = attention(h, w, pre + "self_attn.", tc)
    else:
        h = short_conv(h, w, pre + "conv.", tc["conv_L_cache"])
    x = x + h
    h = rms_norm(x, w[pre + "ffn_norm.weight"], eps)
    ff = pre + "feed_forward."
    if i < tc["num_dense_layers"]:
        h = swiglu(h, w[ff + "w1.weight"], w[ff + "w3.weight"], w[ff + "w2.weight"])
    else:
        h = routed_moe(h.reshape(-1, h.shape[-1]), w, ff, tc, record).view(h.shape)
    return x + h


def backbone(x: torch.Tensor, w: Weights, tc: dict, record: Optional[List] = None) -> torch.Tensor:
    for i in range(len(tc["layer_types"])):
        x = block(x, w, i, tc, record)
    return rms_norm(x, w["query_tower.transformer.embedding_norm.weight"], tc["norm_eps"])


def encode(cfg: dict, w: Weights, batch: Dict[str, torch.Tensor], record: Optional[List] = None):
    """The LTHM forward around the backbone, as ``base.encode`` has it."""
    prec = base.Precision("f32")
    ids = batch["product_ids"].to(torch.int64)
    emb, prod, mask = base.product_tower(cfg, w, ids, prec)
    labels, stamps = batch["labels"].to(torch.int64), batch["timestamps"].to(torch.int64)
    inp, target, mask, labels, stamps, ids = (torch.flip(t, dims=(1,)) for t in (emb, prod, mask, labels, stamps, ids))
    b, s_all = mask.shape
    cw = min(cfg["context_width"], s_all)
    inp, target, mask, labels, stamps, ids = (t[:, -cw:] for t in (inp, target, mask, labels, stamps, ids))
    q = "query_tower."
    x = (inp @ w[q + "inp_proj.weight"].t() + w[q + "inp_proj.bias"]
         + w[q + "action_embedding.embedding"][labels.remainder(4)]
         + w[q + "time_hod.embedding"][torch.remainder(stamps // 3600, 24)]
         + w[q + "time_how.embedding"][torch.remainder(stamps // 3600, 24 * 7)]
         + w[q + "time_dow.embedding"][torch.remainder(stamps // 86400, 7)])
    x = torch.where(mask[..., None], w[q + "pad"], x)
    x = torch.cat([x.new_zeros((b, 1, x.shape[-1])), x], dim=1)
    x = x + w[q + "wpe.embedding"][cw - torch.arange(cw + 1, device=x.device)][None]
    x = backbone(x, w, cfg["transformer_config"], record)
    outcomes = torch.cat([labels, labels.new_zeros((b, 1))], dim=-1)
    x = x + w[q + "outcome_conditioning.embedding"][outcomes.remainder(4)]
    y = (x @ w[q + "emb_heads.weight"].t()).reshape(b, cw + 1, len(cfg["lookahead"]), -1)
    return {"current_token_emb": target, "next_token_emb": y, "current_token_mask": mask, "current_token_ids": ids}


def user_embeddings(cfg: dict, w: Weights, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    with torch.no_grad(), base.exact_f32():
        return base.l2n(encode(cfg, w, batch)["next_token_emb"][:, -1, 0, :])


def trainable(w: Weights) -> List[str]:
    """The stepped leaves: all but the frozen table, the LSH projections
    and the expert biases."""
    return [k for k in w if k != "product_emb_module.embedding" and not k.endswith((".projection_mat", "expert_bias"))]


def train(cfg: dict, w: Weights, batches: Sequence[Dict[str, torch.Tensor]], offsets: Sequence[Sequence[int]]) -> dict:
    """One AdamW step a batch from ``w`` (left as it is), the lookahead
    offsets given: each step's loss, each leaf's first gradient norm and
    its change after the last step."""
    names = trainable(w)
    params = {k: w[k].detach().clone().requires_grad_(True) for k in names}
    weights = dict(w, **params)
    opt = base.AdamW(float(cfg["lr"]), tuple(cfg["betas"]), float(cfg["weight_decay"]))
    logq = base.LogQ(cfg, w["product_emb_module.embedding"].device)
    losses, grad_norms = [], {}
    with base.exact_f32():
        for step, (batch, offs) in enumerate(zip(batches, offsets)):
            for p in params.values():
                p.grad = None
            loss = base.contrastive_loss(cfg, encode(cfg, weights, batch), logq, float(step), offs,
                                         base.Precision("f32"))
            loss.backward()
            losses.append(loss.item())
            if step == 0:
                grad_norms = {k: (p.grad.norm().item() if p.grad is not None else 0.0) for k, p in params.items()}
            opt.step(params)
    change = {k: (params[k].detach() - w[k]).norm().item() for k in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def leaf_count(tc: dict) -> int:
    """The backbone's trainable parameters (a sizing aid)."""
    d, e, f, ff = tc["hidden_size"], tc["num_experts"], tc["moe_intermediate_size"], tc["intermediate_size"]
    kv = tc["num_key_value_heads"] * d // tc["num_attention_heads"]
    total = d
    for i, kind in enumerate(tc["layer_types"]):
        total += 2 * d
        total += (2 * d * d + 2 * d * kv + 2 * d // tc["num_attention_heads"]) if kind == "full_attention" \
            else (4 * d * d + d * tc["conv_L_cache"])
        total += 3 * d * ff if i < tc["num_dense_layers"] else e * d + 3 * e * d * f
    return total
