"""LTHM with LFM2-8B-A1B's hybrid block as the query tower's backbone
(``transformer_config.backbone: lfm2_moe``): the benchmark's weights for it,
how the program is built and driven (as ``models/lthm.py``: the port's
wrapper, ``train_step`` and ``user_encoder``), and how the plain reference
(``benchmark/reference/lthm_lfm2.py``) is run on the same weights and
inputs.

The weights are the benchmark's: one ``torch.randn`` call on the device
from the seed fills every leaf, which is then scaled in place by its leaf's
rule (``leaves``), and they go into the program by name with
``load_state_dict(strict=True)``. The LTHM leaves around the backbone are
``models/lthm.py``'s, the backbone's are LFM2's: the norms' weights near 1,
each projection at 1/sqrt(fan in), the convolution's taps at 1/sqrt(taps),
the router at 1/sqrt(d).

The expert bias (a buffer) is what a trainer's load balancing would have
left (assumed): drawn at 0.02, then set in each MoE layer, in layer order,
by ``balance_expert_bias`` to the bias that evens the experts' loads over
one batch of the ``train64`` mix drawn from the same seed, as the plain
reference routes it (PERF.md §6: the busiest expert's rows over the
mean's, 1.8-2.4 in each layer with the drawn bias, 1.1-1.3 fitted). The
training steps then move the routers away from it, as they move any
other weight. The fit is made once a process for a seed, device and
configuration, so that the program and the reference read the same bias.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from benchmark.arith import lthm_lfm2 as arith
from benchmark.harness.traffic import make_pool
from benchmark.models import lthm
from benchmark.reference import lthm_lfm2 as ref
from benchmark.reference.lthm import l2n

build_program = lthm.build_program
train_state = lthm.train_state
train_step_fn = lthm.train_step_fn
serve_fn = lthm.serve_fn
trained_params = lthm.trained_params
first_grad_norms = lthm.first_grad_norms
ready_batch = lthm.ready_batch

EXPERT_BIAS_SCALE = 0.02
BALANCE_MIX = Path(__file__).resolve().parent.parent / "traffic" / "train64.json"
BALANCE_STEPS = 500
_BALANCED: Dict[tuple, Dict[str, torch.Tensor]] = {}


def backbone_leaves(tc: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, rule, scale) of the LFM2 stack's leaves, under the
    program's names."""
    d, e, f, ff = tc["hidden_size"], tc["num_experts"], tc["moe_intermediate_size"], tc["intermediate_size"]
    hd = d // tc["num_attention_heads"]
    kv, taps = tc["num_key_value_heads"] * hd, tc["conv_L_cache"]
    s = 1 / math.sqrt(d)
    out = []
    for i, kind in enumerate(tc["layer_types"]):
        b = f"query_tower.transformer.block_{i}."
        out += [(b + "operator_norm.weight", (d,), "one", 0.05), (b + "ffn_norm.weight", (d,), "one", 0.05)]
        if kind == "full_attention":
            a = b + "self_attn."
            out += [(a + "q_proj.weight", (d, d), "normal", s), (a + "k_proj.weight", (kv, d), "normal", s),
                    (a + "v_proj.weight", (kv, d), "normal", s), (a + "out_proj.weight", (d, d), "normal", s),
                    (a + "q_layernorm.weight", (hd,), "one", 0.05), (a + "k_layernorm.weight", (hd,), "one", 0.05)]
        else:
            c = b + "conv."
            out += [(c + "in_proj.weight", (3 * d, d), "normal", s), (c + "weight", (d, 1, taps), "normal",
                                                                      1 / math.sqrt(taps)),
                    (c + "out_proj.weight", (d, d), "normal", s)]
        m = b + "feed_forward."
        if i < tc["num_dense_layers"]:
            out += [(m + "w1.weight", (ff, d), "normal", s), (m + "w3.weight", (ff, d), "normal", s),
                    (m + "w2.weight", (d, ff), "normal", 1 / math.sqrt(ff))]
        else:
            out += [(m + "gate", (e, d), "normal", s), (m + "w13", (e, 2 * f, d), "normal", s),
                    (m + "w2", (e, d, f), "normal", 1 / math.sqrt(f)),
                    (m + "expert_bias", (e,), "normal", EXPERT_BIAS_SCALE)]
    out.append(("query_tower.transformer.embedding_norm.weight", (d,), "one", 0.05))
    return out


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """``models/lthm.py``'s towers (its leaves for a stack of no layers at
    the backbone's width) and the LFM2 stack's."""
    tc = cfg["transformer_config"]
    stub = {"num_layers": 0, "rotator_config": {"ff_mult": 1},
            "attn_config": {"n_embd": tc["hidden_size"], "n_head": 1, "pos_bias": {"context_window": 1}}}
    return lthm.leaves(dict(cfg, transformer_config=stub)) + backbone_leaves(tc)


def even_loads(scores: torch.Tensor, bias: torch.Tensor, k: int) -> torch.Tensor:
    """The bias (E,) under which the top k of ``scores`` (N, E) plus it
    give each expert about N k / E rows: auxiliary-loss-free balancing's
    sign update (arXiv:2408.15664) on one batch, each step lowering the
    bias of every expert above the mean load and raising the others', by a
    step that shrinks from 0.02 to 1e-5."""
    e = scores.shape[1]
    mean = scores.shape[0] * k / e
    b = bias.clone()
    for gamma in torch.logspace(math.log10(0.02), -5, BALANCE_STEPS).tolist():
        load = torch.bincount(torch.topk(scores + b, k, dim=-1).indices.reshape(-1), minlength=e)
        b -= gamma * torch.sign(load - mean)
    return b


def balance_expert_bias(cfg: dict, w: Dict[str, torch.Tensor], seed: int, device) -> None:
    """Sets each MoE layer's ``expert_bias`` in ``w`` (module docstring):
    the reference's forward on one batch of ``BALANCE_MIX`` from ``seed``,
    each layer's bias fitted to its scores (``even_loads``) before its
    experts are chosen, so later layers see the earlier ones balanced."""
    key = (seed, str(device), json.dumps(cfg, sort_keys=True))
    if key not in _BALANCED:
        mix = json.loads(BALANCE_MIX.read_text())
        (host,) = make_pool(dict(mix, pool=1), cfg["context_width"], cfg["context_width"], seed)
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        top_k = cfg["transformer_config"]["num_experts_per_tok"]

        def on_route(pre: str, scores: torch.Tensor) -> None:
            w[pre + "expert_bias"].copy_(even_loads(scores, w[pre + "expert_bias"], top_k))

        ref.user_embeddings(cfg, w, batch, ref.Precision("f32"), on_route=on_route)
        _BALANCED[key] = {n: v.clone() for n, v in w.items() if n.endswith("expert_bias")}
    for n, v in _BALANCED[key].items():
        w[n].copy_(v)


def make_weights(cfg: dict, seed: int, device, balance: bool = True) -> Dict[str, torch.Tensor]:
    """Every leaf a view of one draw of a generator on ``device`` seeded
    with ``seed``, scaled in place, and the expert biases balanced
    (``balance``): the same seed gives the same bits on the same device."""
    spec = leaves(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, rule, scale in spec:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if rule == "normal":
            x.mul_(scale)
        elif rule == "one":
            x.mul_(scale).add_(1.0)
        else:  # unit_cols
            x = l2n(x, dim=0)
        out[name] = x
    if balance:
        with torch.no_grad():
            balance_expert_bias(cfg, out, seed, device)
    return out


def shapes(cfg: dict, users: int, history: int) -> arith.Shapes:
    return arith.shapes(cfg, users, history)


def reference_train(cfg: dict, weights, batches, offset_seed: int, precision: str = "f32", **fault) -> dict:
    return ref.train(cfg, weights, batches, offset_seed, ref.Precision(precision), **fault)


def reference_serve(cfg: dict, weights, batch, precision: str = "f32") -> torch.Tensor:
    return ref.user_embeddings(cfg, weights, batch, ref.Precision(precision))
