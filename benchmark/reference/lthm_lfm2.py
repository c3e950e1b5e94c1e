"""Plain PyTorch reference of LTHM with LFM2-8B-A1B's hybrid block as the
query tower's backbone (``transformer_config.backbone: lfm2_moe``).

The backbone is written from the published equations (``transformers``'
``Lfm2RMSNorm``, ``Lfm2ShortConv.slow_forward``, ``Lfm2Attention``,
``Lfm2MLP``, ``Lfm2DecoderLayer``, ``Lfm2Model``'s ``embedding_norm``; the
routed MoE from ``lfm2_moe``'s config keys) with plain torch operations in
float32 and TF32 off; the LTHM parts around it (the product tower, the
logQ state, the contrastive loss, AdamW) are ``benchmark/reference/lthm.py``'s.
It imports nothing of the program, of JAX or of the JAX package, and takes
the weights and inputs the benchmark makes from the seed.

The routed MoE: sigmoid scores in float32, the top k of score plus
``expert_bias``, weights the chosen scores over their sum plus 1e-6 times
``routed_scaling_factor``; a loop over the experts picks each expert's rows
(``index_select``), runs its SwiGLU and adds them back under their weights
(``index_add``).

Departures from the published model: the towers replace the vocabulary
(LTHM's product tower embeds the items, its contrastive heads replace the
LM head); LTHM's ``wpe`` is kept beside RoPE, which reads positions 0..T-1
of the stack's input; ``expert_bias`` is drawn from the seed and never
updated (``benchmark/models/lthm_lfm2.py`` sets it, from the seed, to a
bias that evens the experts' loads, through ``on_route``).

``precision="fp8"`` is the control, as in ``lthm.py``: every product's
operands in float8 e4m3 under a per-tensor scale. The router's logits stay
float32 there too, as the configuration has them.

Memory: every layer of a training step is recomputed in its backward
(``checkpoint``), and inside it attention in blocks of users
(``USER_BLOCK``), the dense SwiGLU in blocks of rows (``FFN_ROWS``) and
each expert's SwiGLU are recomputed again, so a step at 64 users of 1025
positions fits beside the float32 weights, their copy, gradients and AdamW
state; a leaf's change is measured from the weights given, with no copy of
them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import lthm as base

USER_BLOCK = 8  # users of one attention block
FFN_ROWS = 8192  # rows of one dense SwiGLU block
Precision = base.Precision
# called with a MoE layer's leaf prefix and its scores (N, E) before the
# choice, which reads its ``expert_bias`` after the call
OnRoute = Optional[Callable[[str, torch.Tensor], None]]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def short_conv(x: torch.Tensor, w, pre: str, taps: int, prec: Precision) -> torch.Tensor:
    """B, C, u from ``in_proj``; ``conv1d(B u)`` (depthwise, padding
    taps - 1, cut to T); times C; ``out_proj``."""
    t = x.shape[1]
    bcx = prec.linear(x, w[pre + "in_proj.weight"]).transpose(-1, -2)
    b, c, u = bcx.chunk(3, dim=-2)
    conv = F.conv1d(b * u, w[pre + "weight"], padding=taps - 1, groups=u.shape[1])[..., :t]
    return prec.linear((c * conv).transpose(-1, -2), w[pre + "out_proj.weight"])


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def rope(t: int, hd: int, theta: float, device):
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.int64, device=device).float() / hd))
    freqs = torch.arange(t, device=device).float()[:, None] * inv_freq[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def _attend_block(q, k, v, prec_name: str):
    """q (b, H, T, hd), k/v (b, H, T, hd): causal softmax(q k^T / sqrt(hd)) v."""
    prec = Precision(prec_name)
    t = q.shape[-2]
    s = prec.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=q.device).tril(), float("-inf"))
    return prec.matmul(torch.softmax(s, dim=-1), v)


def attention(x: torch.Tensor, w, pre: str, tc: dict, prec: Precision, grad: bool) -> torch.Tensor:
    """Per-head RMSNorm on q and k, RoPE, the KV heads repeated to the
    query heads (head h reads KV head h // (H / KV)), causal softmax."""
    bsz, t, d = x.shape
    nh, nkv = tc["num_attention_heads"], tc["num_key_value_heads"]
    hd, eps = d // nh, tc["norm_eps"]
    q = rms_norm(prec.linear(x, w[pre + "q_proj.weight"]).view(bsz, t, nh, hd), w[pre + "q_layernorm.weight"], eps)
    k = rms_norm(prec.linear(x, w[pre + "k_proj.weight"]).view(bsz, t, nkv, hd), w[pre + "k_layernorm.weight"], eps)
    v = prec.linear(x, w[pre + "v_proj.weight"]).view(bsz, t, nkv, hd)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    cos, sin = rope(t, hd, tc["rope_theta"], x.device)
    q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
    k, v = (z[:, :, None].expand(bsz, nkv, nh // nkv, t, hd).reshape(bsz, nh, t, hd) for z in (k, v))
    outs = []
    for u0 in range(0, bsz, USER_BLOCK):
        sl = slice(u0, u0 + USER_BLOCK)
        if grad:
            outs.append(checkpoint(_attend_block, q[sl], k[sl], v[sl], prec.name, use_reentrant=False))
        else:
            outs.append(_attend_block(q[sl], k[sl], v[sl], prec.name))
    y = torch.cat(outs).transpose(1, 2).reshape(bsz, t, d)
    return prec.linear(y, w[pre + "out_proj.weight"])


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.linear(F.silu(prec.linear(x, w1)) * prec.linear(x, w3), w2)


def _ffn_rows(x, w1, w3, w2, prec_name: str):
    a = F.silu(F.linear(x, w1)) * F.linear(x, w3)
    return F.linear(Precision(prec_name).op(a), w2)


def dense_ffn(x: torch.Tensor, w, pre: str, prec: Precision, grad: bool) -> torch.Tensor:
    """The dense SwiGLU in blocks of ``FFN_ROWS`` rows, each recomputed in
    the backward. fp8 scales x and each weight over the whole tensor, the
    SwiGLU's output over its block of rows."""
    rows = prec.op(x.reshape(-1, x.shape[-1]))
    w1, w3, w2 = (prec.op(w[pre + n]) for n in ("w1.weight", "w3.weight", "w2.weight"))
    outs = []
    for r0 in range(0, rows.shape[0], FFN_ROWS):
        args = (rows[r0:r0 + FFN_ROWS], w1, w3, w2, prec.name)
        outs.append(checkpoint(_ffn_rows, *args, use_reentrant=False) if grad else _ffn_rows(*args))
    return torch.cat(outs).view(x.shape)


def routed_moe(x: torch.Tensor, w, pre: str, tc: dict, prec: Precision, grad: bool = False,
               on_route: OnRoute = None):
    """x (N, d) float32 -> (N, d): the routed MoE as the module docstring
    has it, each expert's SwiGLU recomputed in the backward."""
    e, k, hidden = tc["num_experts"], tc["num_experts_per_tok"], tc["moe_intermediate_size"]
    scores = torch.sigmoid(x @ w[pre + "gate"].t())
    if on_route is not None:
        on_route(pre, scores)
    choice = torch.topk(scores + w[pre + "expert_bias"], k, dim=-1).indices
    weights = scores.gather(1, choice)
    if tc["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    weights = weights * tc["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for expert in range(e):
        tok, slot = torch.nonzero(choice == expert, as_tuple=True)
        if tok.numel() == 0:
            continue
        w13 = w[pre + "w13"][expert]
        args = (x.index_select(0, tok), w13[:hidden], w13[hidden:], w[pre + "w2"][expert], prec)
        ye = checkpoint(swiglu, *args, use_reentrant=False) if grad else swiglu(*args)
        out = out.index_add(0, tok, ye * weights[tok, slot][:, None])
    return out


def block(x: torch.Tensor, w, i: int, tc: dict, prec: Precision, grad: bool, on_route: OnRoute = None):
    """One layer: the mixer on the operator norm and the feed-forward on
    the FFN norm, each added to the stream."""
    pre, eps = f"query_tower.transformer.block_{i}.", tc["norm_eps"]
    h = rms_norm(x, w[pre + "operator_norm.weight"], eps)
    if tc["layer_types"][i] == "full_attention":
        h = attention(h, w, pre + "self_attn.", tc, prec, grad)
    else:
        h = short_conv(h, w, pre + "conv.", tc["conv_L_cache"], prec)
    x = x + h
    h = rms_norm(x, w[pre + "ffn_norm.weight"], eps)
    ff = pre + "feed_forward."
    if i < tc["num_dense_layers"]:
        h = dense_ffn(h, w, ff, prec, grad)
    else:
        h = routed_moe(h.reshape(-1, h.shape[-1]), w, ff, tc, prec, grad, on_route).view(h.shape)
    return x + h


def encode(cfg: dict, w, batch: Dict[str, torch.Tensor], prec: Precision, grad: bool,
           on_route: OnRoute = None) -> Dict[str, torch.Tensor]:
    """The forward, as ``lthm.encode`` has it, with the LFM2 stack."""
    ids = batch["product_ids"].to(torch.int64)
    emb, prod, mask = base.product_tower(cfg, w, ids, prec)
    labels, stamps = batch["labels"].to(torch.int64), batch["timestamps"].to(torch.int64)
    inp, target, mask, labels, stamps, ids = (torch.flip(t, dims=(1,)) for t in (emb, prod, mask, labels, stamps, ids))
    b, s_all = mask.shape
    cw = min(cfg["context_width"], s_all)
    inp, target, mask, labels, stamps, ids = (t[:, -cw:] for t in (inp, target, mask, labels, stamps, ids))
    q = "query_tower."
    x = (prec.linear(inp, w[q + "inp_proj.weight"], w[q + "inp_proj.bias"])
         + w[q + "action_embedding.embedding"][labels.remainder(4)]
         + w[q + "time_hod.embedding"][torch.remainder(stamps // 3600, 24)]
         + w[q + "time_how.embedding"][torch.remainder(stamps // 3600, 24 * 7)]
         + w[q + "time_dow.embedding"][torch.remainder(stamps // 86400, 7)])
    x = torch.where(mask[..., None], w[q + "pad"], x)
    x = torch.cat([x.new_zeros((b, 1, x.shape[-1])), x], dim=1)
    x = x + w[q + "wpe.embedding"][cw - torch.arange(cw + 1, device=x.device)][None]
    tc = cfg["transformer_config"]
    for i in range(len(tc["layer_types"])):
        if grad:
            x = checkpoint(block, x, w, i, tc, prec, grad, use_reentrant=False)
        else:
            x = block(x, w, i, tc, prec, grad, on_route)
    x = rms_norm(x, w[q + "transformer.embedding_norm.weight"], tc["norm_eps"])
    outcomes = torch.cat([labels, labels.new_zeros((b, 1))], dim=-1)
    x = x + w[q + "outcome_conditioning.embedding"][outcomes.remainder(4)]
    d_prod = cfg["product_tower"]["item_emb_dim"]
    y = prec.linear(x, w[q + "emb_heads.weight"]).reshape(b, cw + 1, len(cfg["lookahead"]), d_prod)
    return {"current_token_emb": target, "next_token_emb": y, "current_token_mask": mask,
            "current_token_ids": ids}


def user_embeddings(cfg: dict, w, batch: Dict[str, torch.Tensor], prec: Precision,
                    on_route: OnRoute = None) -> torch.Tensor:
    """The serving entry's vector: the unit lookahead-0 query of the most
    recent position, (B, item_emb_dim)."""
    with torch.no_grad(), base.exact_f32():
        return base.l2n(encode(cfg, w, batch, prec, grad=False, on_route=on_route)["next_token_emb"][:, -1, 0, :])


def trainable(w) -> List[str]:
    """The stepped leaves: all but the frozen table, the LSH projections
    and the expert biases."""
    return [k for k in w if k != "product_emb_module.embedding" and not k.endswith((".projection_mat", "expert_bias"))]


def train(cfg: dict, w, batches: Sequence[Dict[str, torch.Tensor]], offset_seed: int, prec: Precision,
          users: Optional[int] = None, freeze: bool = False) -> dict:
    """len(batches) AdamW steps from ``w`` (left as it is, and the change
    measured from it), as ``lthm.train``: each step's loss, each leaf's
    first gradient norm, each leaf's change after the last step."""
    names = trainable(w)
    params = {k: w[k].detach().clone().requires_grad_(True) for k in names}
    weights = dict(w, **params)
    opt = base.AdamW(float(cfg["lr"]), tuple(cfg["betas"]), float(cfg["weight_decay"]))
    logq = base.LogQ(cfg, w["product_emb_module.embedding"].device)
    gen = torch.Generator().manual_seed(offset_seed)
    losses, grad_norms = [], {}
    with base.exact_f32():
        for step, batch in enumerate(batches):
            offsets = base.sample_offsets(gen, cfg["lookahead"])
            for p in params.values():
                p.grad = None
            out = encode(cfg, weights, batch, prec, grad=True)
            loss = base.contrastive_loss(cfg, out, logq, float(step), offsets, prec, users)
            del out
            loss.backward()
            losses.append(loss.item())
            if step == 0:
                grad_norms = {k: (p.grad.norm().item() if p.grad is not None else 0.0) for k, p in params.items()}
            if not freeze:
                opt.step(params)
    change = {k: (params[k].detach() - w[k]).norm().item() for k in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
