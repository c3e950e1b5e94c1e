"""LTHM: the benchmark's weights for it, how the program under test is built
and driven, and how the plain reference (``benchmark/reference/lthm.py``)
is run on the same weights and inputs.

The weights are the benchmark's, not the program's initialisation: one
``torch.randn`` call on the device from the seed fills every leaf, which is
then scaled by its leaf's rule (``LEAVES``). They go into the program by
name with ``load_state_dict(strict=True)``, so a program whose leaves no
longer match the configuration fails at once; the reference reads the same
dictionary.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from benchmark.arith import lthm as arith
from benchmark.reference import lthm as ref

TABLE = "product_emb_module.embedding"


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, rule, scale) of every leaf of the model: ``normal``
    draws N(0, scale^2), ``one`` 1 + N(0, scale^2), ``unit_cols`` normal
    columns scaled to unit length (the LSH directions)."""
    pt, tc = cfg["product_tower"], cfg["transformer_config"]
    ac = tc["attn_config"]
    lm = pt["latent_model_config"]
    d, inp, out, item = ac["n_embd"], pt["inp_emb_dim"], pt["out_emb_dim"], pt["item_emb_dim"]
    hd, ff = d // ac["n_head"], int(tc["rotator_config"]["ff_mult"] * d)
    window = ac["pos_bias"]["context_window"]
    out_l = [(TABLE, (lm["vocab_size_latent"], inp), "normal", 1.0)]
    p = "product_tower."
    out_l += [(p + "emb_mapper.weight", (out, inp), "normal", 1 / math.sqrt(inp)),
              (p + "emb_mapper.bias", (out,), "normal", 0.02)]
    for i, spec in enumerate(pt["cosine_lsh_config"]):
        nb1, n_proj = spec["num_bins"] + 1, spec["num_proj"]
        out_l += [(f"{p}direction_emb_{i}.embedding", (nb1 * n_proj, out), "normal", 1.0),
                  (f"{p}direction_emb_{i}.projection_mat", (inp, n_proj), "unit_cols", 1.0)]
    out_l += [(p + "norm_emb.embedding", (pt["norm_bins"], out), "normal", 0.02),
              (p + "product_mapper.weight", (item, out), "normal", 1 / math.sqrt(out))]
    q = "query_tower."
    out_l += [(q + "pad", (1, 1, d), "normal", 1 / math.sqrt(d)),
              (q + "action_embedding.embedding", (4, d), "normal", 1.0),
              (q + "time_hod.embedding", (24, d), "normal", 1.0),
              (q + "time_how.embedding", (24 * 7, d), "normal", 1.0),
              (q + "time_dow.embedding", (7, d), "normal", 1.0),
              (q + "inp_proj.weight", (d, out), "normal", 1 / math.sqrt(out)),
              (q + "inp_proj.bias", (d,), "normal", 0.02),
              (q + "wpe.embedding", (cfg["context_width"] + 1, d), "normal", 1 / math.sqrt(d))]
    for i in range(tc["num_layers"]):
        b = f"{q}transformer.block_{i}."
        out_l += [(b + "ln_1.weight", (d,), "one", 0.05),
                  (b + "attn.pos_bias.bias", (2 * window + 1, ac["n_head"]), "normal", 0.3),
                  (b + "attn.q_proj.weight", (d, d), "normal", 1 / math.sqrt(d)),
                  (b + "attn.kv_proj.weight", (2 * hd, d), "normal", 1 / math.sqrt(d)),
                  (b + "attn.out_proj.weight", (d, d), "normal", 1 / math.sqrt(d)),
                  (b + "ln_2.weight", (d,), "one", 0.05),
                  (b + "c_fc.weight", (ff, d), "normal", 1 / math.sqrt(d)),
                  (b + "c_proj.weight", (d, ff), "normal", 1 / math.sqrt(ff))]
    out_l += [(q + "outcome_conditioning.embedding", (4, d), "normal", 1.0),
              (q + "emb_heads.weight", (len(cfg["lookahead"]) * item, d), "normal", 1 / math.sqrt(d))]
    return out_l


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from one draw of a generator on ``device`` seeded with
    ``seed``: the same seed gives the same bits on the same device."""
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
            x = x * scale if scale != 1.0 else x
        elif rule == "one":
            x = 1.0 + x * scale
        else:  # unit_cols
            x = ref.l2n(x, dim=0)
        out[name] = x
    return out


def shapes(cfg: dict, users: int, history: int) -> arith.Shapes:
    """The shapes the metric readers' arithmetic takes (``arith/lthm.py``)."""
    return arith.shapes(cfg, users, history)


# ----- the program under test -------------------------------------------------------


def build_program(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The port's LTHM wrapper on ``device`` holding ``weights``."""
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper

    wrapper = LTHMModelWrapper(LTHMModelConfig.from_dict(cfg), device=device, seed=0)
    wrapper.module.load_state_dict(weights, strict=True)
    return wrapper


def train_state(wrapper, train_cfg: dict, offset_seed: int):
    """The port's train state (``train/train_state.py``) with the optimizer
    the trainer builds from ``train_cfg`` (the run's ``train`` section);
    ``offset_seed`` seeds the generator the lookahead offsets are drawn
    from."""
    from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
    from recommendations_tpu_torch.train.train_state import TrainState

    return TrainState.create(wrapper, ModelTrainConfig(**train_cfg), seed=offset_seed)


def train_step_fn() -> Callable:
    """``train_step(state, batch) -> (loss, metrics)``, the window's entry."""
    from recommendations_tpu_torch.train.step import train_step

    return train_step


def serve_fn(wrapper) -> Callable:
    """The serving entry: batch -> {"user_emb": (B, item_emb_dim)}."""
    return wrapper.inference_models()["user_encoder"]


def trained_params(state) -> Dict[str, torch.Tensor]:
    """The parameters the optimizer steps, by name."""
    stepped = {id(p) for p in state.optimizer.params()}
    return {n: p for n, p in state.wrapper.module.named_parameters() if id(p) in stepped}


def first_grad_norms(state) -> Dict[str, float]:
    """Each stepped leaf's gradient norm, read from AdamW's first moment
    after the first step: m = (1 - b1) g; NaN for a leaf it keeps none of."""
    opt = state.optimizer.inner
    b1 = opt.param_groups[0]["betas"][0]
    return {n: (opt.state[p]["exp_avg"].norm() / (1.0 - b1)).item() if "exp_avg" in opt.state.get(p, {})
            else math.nan for n, p in trained_params(state).items()}


def ready_batch(batch: Dict[str, torch.Tensor], device, non_blocking: bool) -> Dict[str, torch.Tensor]:
    return {k: v.to(device, non_blocking=non_blocking) for k, v in batch.items()}


# ----- the reference --------------------------------------------------------------------


def reference_train(cfg: dict, weights, batches, offset_seed: int, precision: str = "f32", **fault) -> dict:
    return ref.train(cfg, weights, batches, offset_seed, ref.Precision(precision), **fault)


def reference_serve(cfg: dict, weights, batch, precision: str = "f32") -> torch.Tensor:
    return ref.user_embeddings(cfg, weights, batch, ref.Precision(precision))
