"""LTHM with LFM2-8B-A1B's hybrid block as its backbone: model FLOPs of a
training step from the shapes, and the FLOPs the routed experts' grouped
products execute in one.

Model FLOPs count, as ``lthm.py`` does, each weight product once a token
(two operations a multiply-add: the mixers' projections, the depthwise
convolution's taps, the dense SwiGLU, the router and each token's
``num_experts_per_tok`` experts), attention's two products over the causal
half of the (query, key) pairs, the towers as ``lthm.py``, the CE's three
N x N x D products a call, and the backward at twice the forward. They do
not count remat's second forward, gathers, norms or other elementwise
work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from benchmark.arith import bounds


@dataclass(frozen=True)
class Shapes:
    users: int
    history: int
    context: int
    d: int
    n_head: int
    n_kv_head: int
    layer_types: Tuple[str, ...]
    dense_layers: int
    ff: int  # the dense SwiGLU's width
    expert_ff: int  # an expert's width
    experts: int
    top_k: int
    taps: int
    remat: bool
    inp: int
    out: int
    item: int
    heads: int
    lsh_proj: int
    chunk: int

    @property
    def t(self) -> int:
        return self.context + 1

    @property
    def hd(self) -> int:
        return self.d // self.n_head

    @property
    def positions(self) -> int:
        return self.users * self.t

    @property
    def moe_layers(self) -> int:
        return len(self.layer_types) - self.dense_layers

    @property
    def ce_n(self) -> int:
        return self.chunk * self.context

    @property
    def ce_calls(self) -> int:
        return self.heads * -(-self.users // self.chunk)


def shapes(cfg: dict, users: int, history: int) -> Shapes:
    tc, pt = cfg["transformer_config"], cfg["product_tower"]
    mini = cfg.get("train_mini_batch_size", -1)
    return Shapes(
        users=users, history=history, context=min(cfg["context_width"], history), d=tc["hidden_size"],
        n_head=tc["num_attention_heads"], n_kv_head=tc["num_key_value_heads"],
        layer_types=tuple(tc["layer_types"]), dense_layers=tc["num_dense_layers"], ff=tc["intermediate_size"],
        expert_ff=tc["moe_intermediate_size"], experts=tc["num_experts"], top_k=tc["num_experts_per_tok"],
        taps=tc.get("conv_L_cache", 3), remat=bool(tc.get("enable_gradient_checkpointing", False)),
        inp=pt["inp_emb_dim"], out=pt["out_emb_dim"], item=pt["item_emb_dim"], heads=len(cfg["lookahead"]),
        lsh_proj=sum(s["num_proj"] for s in pt["cosine_lsh_config"]),
        chunk=min(mini if mini > 0 else users, users),
    )


def expert_flops(s: Shapes) -> float:
    """One forward of the routed experts over every MoE layer: each
    position's top-k experts, three products of d x expert_ff each."""
    return float(s.moe_layers * s.positions * s.top_k * 2 * 3 * s.d * s.expert_ff)


def layer_flops_per_position(s: Shapes) -> float:
    """The backbone's weight products a position, over every layer."""
    kv = s.n_kv_head * s.hd
    total = 0.0
    for i, kind in enumerate(s.layer_types):
        if kind == "full_attention":
            total += 2 * (2 * s.d * s.d + 2 * s.d * kv)
        else:
            total += 2 * (3 * s.d * s.d + s.d * s.d + s.taps * s.d)
        if i < s.dense_layers:
            total += 2 * 3 * s.d * s.ff
        else:
            total += 2 * s.d * s.experts + s.top_k * 2 * 3 * s.d * s.expert_ff
    return total


def forward_flops(s: Shapes) -> float:
    """One forward of the towers (no CE)."""
    product = s.users * s.history * 2 * (s.inp * s.out + s.inp * s.lsh_proj + s.out * s.item)
    query = s.users * s.context * 2 * s.out * s.d + s.positions * (layer_flops_per_position(s)
                                                                    + 2 * s.d * s.heads * s.item)
    n_attn = sum(k == "full_attention" for k in s.layer_types)
    attn = n_attn * s.users * 2 * 2 * s.hd * s.n_head * bounds.live_pairs(s.t, True)
    return float(product + query + attn)


def ce_flops(s: Shapes) -> float:
    return float(s.ce_calls * 3 * 2 * s.ce_n * s.ce_n * s.item)


def train_flops(s: Shapes) -> float:
    return 3.0 * forward_flops(s) + ce_flops(s)


def expert_executed_flops(s: Shapes) -> float:
    """The grouped products a training step runs: the forward, again in
    remat's rerun (no policy keeps them), and the backward's two products
    for each (the rows' and the weights' gradients)."""
    return (2.0 if s.remat else 1.0) * expert_flops(s) + 2.0 * expert_flops(s)
