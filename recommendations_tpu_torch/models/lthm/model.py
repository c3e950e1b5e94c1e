"""LTHM network: KShift product embedding -> ProductTower -> QueryTower.

Port of ``recommendations_tpu/models/lthm/model.py``: the fresh KShift table
(dense or the fused record) or the frozen pretrained module
(``model_init_metadata``). ``bind_mesh`` lays the encoder over a device
mesh as the JAX encoder built with a mesh is: with ``shard_embedding_rows``
the table becomes this rank's row block
(``parallel/sharded_embedding.ShardedKShiftEmbedding``, a pretrained
module taking precedence), with ``sequence_parallel`` the transformer
splits the sequence over the ``model`` axis and attends by the ring, and
over an ``expert`` axis of more than one rank each ``MoELinear`` keeps its
share of the experts. ``forward(batch, training=...)`` serves (the default) or runs
the training forward, which applies the transformer's dropouts with masks
drawn from the step's ``dropout_seed`` (``nn/dropout.py``; serving and
validation draw none).

The dtypes follow the JAX package step by step: parameters are
float32, matmuls run in ``compute_dtype``, and the residual stream is
float32 from the position embedding on (a flax ``nn.Embed`` with no dtype
returns float32, and each block adds its compute-dtype outputs to it).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from recommendations_tpu_torch.core.spans import span
from recommendations_tpu_torch.models.lthm.config import LFM2MoEConfig, LTHMModelConfig
from recommendations_tpu_torch.models.lthm.pretrained import PretrainedProductEmbedding
from recommendations_tpu_torch.nn.attention import Dense
from recommendations_tpu_torch.nn.embeddings import (
    FlatEmbedding,
    HistogramEmbedding,
    KShiftEmbedding,
    PatternFromTimelocal,
    init_param,
)
from recommendations_tpu_torch.nn.functional import cast_param, l2_normalize
from recommendations_tpu_torch.nn.lfm2 import LFM2Stack
from recommendations_tpu_torch.nn.lsh import CosineVectorEmbedding
from recommendations_tpu_torch.nn.transformer import MoELinear, TransformerStack


def compute_dtype(cfg: LTHMModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


class ProductTower(nn.Module):
    """Product embedding -> LSH direction + norm-histogram features, masked
    rows zeroed, projected to the retrieval space. With
    ``detach_item_tower`` (the default) no gradient reaches the embedding
    table, as ``jax.lax.stop_gradient`` gives in the JAX package."""

    def __init__(self, cfg: LTHMModelConfig, generator: torch.Generator):
        super().__init__()
        tc = cfg.product_tower
        self.tc = tc
        self.dtype = compute_dtype(cfg)
        self.emb_mapper = Dense(tc.inp_emb_dim, tc.out_emb_dim, generator, dtype=self.dtype)
        for i, spec in enumerate(tc.cosine_lsh_config):
            self.add_module(
                f"direction_emb_{i}",
                CosineVectorEmbedding(
                    tc.inp_emb_dim, tc.out_emb_dim, generator,
                    n_proj=spec.num_proj, num_bins=spec.num_bins,
                ),
            )
        if tc.norm_bins > 1:
            self.norm_emb = HistogramEmbedding(
                0.0, 1.0, tc.norm_bins, tc.out_emb_dim, generator, compute_dtype=self.dtype
            )
        self.product_mapper = Dense(
            tc.out_emb_dim, tc.product_emb_dim, generator, use_bias=False, dtype=self.dtype
        )

    def forward(self, ids: torch.Tensor, x: torch.Tensor):
        tc = self.tc
        if tc.detach_item_tower:
            x = x.detach()
        x = x.float()
        x_norm = torch.sqrt(torch.sum(x * x, dim=-1))
        mask = (x_norm < tc.norm_threshold) | (ids == 0)
        xn = l2_normalize(x)
        emb = self.emb_mapper(xn.to(self.dtype)).float()
        for i in range(len(tc.cosine_lsh_config)):
            emb = emb + getattr(self, f"direction_emb_{i}")(xn)
        if tc.norm_bins > 1:
            emb = emb + self.norm_emb(x_norm)
        emb = torch.where(mask[..., None], 0.0, emb)
        prod_emb = self.product_mapper(emb.to(self.dtype)).float()
        return emb, prod_emb, mask


class PositionEmbedding(nn.Module):
    """flax ``nn.Embed`` with no dtype: float32 rows, init variance 1/features."""

    def __init__(self, num: int, features: int, generator: torch.Generator):
        super().__init__()
        self.embedding = init_param((num, features), 1.0 / math.sqrt(features), generator)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        return self.embedding[pos]


class QueryTower(nn.Module):
    """Causal transformer over the left-padded interaction sequence, with one
    linear head per lookahead horizon: the LTHM stack
    (``nn/transformer.py``), or LFM2's hybrid stack (``nn/lfm2.py``) when
    ``transformer_config`` names the ``lfm2_moe`` backbone."""

    def __init__(self, cfg: LTHMModelConfig, generator: torch.Generator):
        super().__init__()
        tcfg = cfg.transformer_config
        self.cfg = cfg
        d = cfg.emb_dim
        dt = self.dtype = compute_dtype(cfg)
        self.action_embedding = FlatEmbedding(4, d, generator, compute_dtype=dt)
        self.time_hod = PatternFromTimelocal(3600, 24, d, generator, compute_dtype=dt)
        self.time_how = PatternFromTimelocal(3600, 24 * 7, d, generator, compute_dtype=dt)
        self.time_dow = PatternFromTimelocal(86400, 7, d, generator, compute_dtype=dt)
        self.inp_proj = Dense(cfg.product_tower.out_emb_dim, d, generator, dtype=dt)
        self.pad = init_param((1, 1, d), 1.0 / math.sqrt(d), generator)
        self.wpe = PositionEmbedding(cfg.context_width + 1, d, generator)
        if isinstance(tcfg, LFM2MoEConfig):
            self.transformer = LFM2Stack(tcfg, generator, dtype=dt)
        else:
            self.transformer = self._lthm_stack(tcfg, generator, dt)
        self.outcome_conditioning = FlatEmbedding(4, d, generator, compute_dtype=dt)
        self.emb_heads = Dense(
            d, cfg.export_tokens * cfg.product_tower.product_emb_dim, generator,
            use_bias=False, dtype=dt,
        )

    @staticmethod
    def _lthm_stack(tcfg, generator: torch.Generator, dt: torch.dtype) -> TransformerStack:
        acfg = tcfg.attn_config
        return TransformerStack(
            tcfg.num_layers, acfg.n_embd, acfg.n_head, generator,
            remat=tcfg.enable_gradient_checkpointing,
            remat_policy=tcfg.remat_policy,
            attn_type=acfg.attn_type,
            is_causal=tcfg.is_causal,
            use_bias=acfg.bias,
            pos_bias_window=acfg.pos_bias.context_window if acfg.pos_bias else None,
            rotator=tcfg.rotator(),
            is_sparse_attn=tcfg.is_sparse_attn,
            max_block_size=tcfg.max_block_size,
            sparsity_factor=tcfg.sparsity_factor,
            n_cls=1,
            use_flash=tcfg.use_flash_attention,
            dtype=dt,
            dropout=acfg.dropout,
            attn_dropout=acfg.attn_dropout,
        )

    def forward(
        self, inp, target, mask, labels, timestamp, ids, training: bool = False,
        dropout_seed: Optional[int] = None, batch_shard: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        bsz, orig_s = mask.shape
        cw = min(cfg.context_width, orig_s)
        inp, target, mask, ids = inp[:, -cw:], target[:, -cw:], mask[:, -cw:], ids[:, -cw:]
        labels = labels[:, -cw:].to(torch.int64)
        timestamp = timestamp[:, -cw:].to(torch.int64)

        x = (
            self.inp_proj(inp.to(self.dtype))
            + self.action_embedding(labels)
            + self.time_hod(timestamp)
            + self.time_how(timestamp)
            + self.time_dow(timestamp)
        ).to(self.dtype)
        x = torch.where(mask[..., None], cast_param(self.pad, x.dtype), x)

        # CLS column + reverse positions (most recent event = position 0)
        x = torch.cat([x.new_zeros((bsz, 1, x.shape[-1])), x], dim=1)
        pos = cw - torch.arange(cw + 1, device=x.device)
        x = x + self.wpe(pos)[None]  # float32 from here on

        x = self.transformer(x, training=training, dropout_seed=dropout_seed, batch_shard=batch_shard)

        # outcome conditioning over (labels ++ future outcome 0), (B, S+1)
        outcomes = torch.cat([labels, labels.new_zeros((bsz, 1))], dim=-1)
        x = x + self.outcome_conditioning(outcomes)

        d_prod = cfg.product_tower.product_emb_dim
        y = self.emb_heads(x.to(self.dtype)).float()
        y = y.reshape(bsz, y.shape[1], cfg.export_tokens, d_prod)
        return {
            "current_token_emb": target,
            "next_token_emb": y,
            "current_token_mask": mask,
            "current_token_ids": ids,
        }


class LTHMEncoder(nn.Module):
    """Full LTHM forward with a fresh KShift product-embedding table (a
    dense table, or the fused record when ``cfg.uses_fused_table()``), or
    with the frozen pretrained module when the product tower names one
    (``model_init_metadata``)."""

    def __init__(
        self,
        cfg: LTHMModelConfig,
        generator: torch.Generator,
        ids_key: str = "product_ids",
        labels_key: str = "labels",
        timestamp_key: str = "timestamps",
    ):
        super().__init__()
        tc = cfg.product_tower
        self.cfg = cfg
        self.ids_key, self.labels_key, self.timestamp_key = ids_key, labels_key, timestamp_key
        lm = tc.latent_model_config
        if tc.model_init_metadata is not None:
            # frozen buffers; the wrapper loads the artifact into them
            self.product_emb_module = PretrainedProductEmbedding(
                lm.vocab_size_latent, tc.inp_emb_dim, generator,
                num_shifts=lm.num_shifts_latent,
                normalize_output=lm.normalize_embedding,
                compute_dtype=compute_dtype(cfg),
            )
        else:
            self.product_emb_module = KShiftEmbedding(
                lm.vocab_size_latent, tc.inp_emb_dim, generator,
                num_shifts=lm.num_shifts_latent,
                normalize_output=lm.normalize_embedding,
                compute_dtype=compute_dtype(cfg),
                fused_record=cfg.uses_fused_table(),
            )
        self.product_tower = ProductTower(cfg, generator)
        self.query_tower = QueryTower(cfg, generator)

    def bind_mesh(self, mesh) -> None:
        """Lay the encoder over ``mesh`` (see the module docstring); the
        parameters it shards keep this rank's block."""
        from recommendations_tpu_torch.parallel.sharded_embedding import ShardedKShiftEmbedding

        cfg, tc = self.cfg, self.cfg.product_tower
        if cfg.shard_embedding_rows and tc.model_init_metadata is None:
            lm, dense = tc.latent_model_config, self.product_emb_module
            n = mesh.size("model")
            if lm.vocab_size_latent % n:
                raise ValueError(f"vocab_size_latent {lm.vocab_size_latent} not divisible by model={n}")
            per = lm.vocab_size_latent // n
            shard = dense.embedding.detach().narrow(0, mesh.index("model") * per, per).clone()
            self.product_emb_module = ShardedKShiftEmbedding(
                shard, lm.vocab_size_latent, mesh, num_shifts=lm.num_shifts_latent,
                normalize_output=lm.normalize_embedding, compute_dtype=compute_dtype(cfg),
                schedule=cfg.embedding_lookup_schedule,
            )
        stack = self.query_tower.transformer
        if cfg.transformer_config.sequence_parallel:
            stack.bind_sequence_parallel(mesh.group("model"))
        for m in stack.modules():
            if isinstance(m, MoELinear):
                m.bind_experts(mesh.group("expert"))

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        training: bool = False,
        taps: Optional[Dict[str, torch.Tensor]] = None,
        dropout_seed: Optional[int] = None,
        batch_shard: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, torch.Tensor]:
        """``taps``: ``{"product_emb_rows": zeros (B, S, k, d)}`` on the
        fused-record table, whose gradient is the gathered rows' (the
        wrapper's ``make_taps``). ``dropout_seed``: the training step's,
        which a training forward with a nonzero dropout rate needs.
        ``batch_shard``: (first row, rows) of this rank's rows in the whole
        batch, for the dropout draws."""
        ids = batch[self.ids_key]
        with span("lthm/product_tower"):
            embs = self.product_emb_module(ids, tap=(taps or {}).get("product_emb_rows"))
            inp, target, mask = self.product_tower(ids, embs)
        # float timestamps and labels truncate to int64, as astype does
        labels = batch[self.labels_key].to(torch.int64)
        timestamp = batch[self.timestamp_key].to(torch.int64)
        # flip to left padding (history arrives most-recent-first, right-padded)
        flipped = [torch.flip(t, dims=(1,)) for t in (inp, target, mask, labels, timestamp, ids)]
        return self.query_tower(*flipped, training=training, dropout_seed=dropout_seed, batch_shard=batch_shard)
