"""Pre-LN transformer block and the residual stack.

Port of ``recommendations_tpu/nn/transformer.py`` for the MLP rotator. As in
the JAX package, the stack applies ``x = block(x)`` with standard pre-LN
residual blocks, which fixes the reference's double residual
(``x = x + block(x)`` around a block that already adds x, doubling the
stream every layer).

Per-block recomputation (remat, the JAX stack's ``nn.remat`` per block) runs
each block under ``torch.utils.checkpoint`` when a gradient is taken; serving
runs the blocks plainly. ``remat_policy`` as in the JAX package: ``full``
keeps only the block input; ``dots_no_batch`` keeps the outputs of the
projection and MLP matrix products (``aten.mm``/``addmm``), ``dots`` also the
batched ones (``aten.bmm``, the ``_sdpa`` logits), and both keep the outputs
(o, lse) of the flash forward, without and with the position bias, so the
backward does not launch it again.

Dropout in training, as the JAX package places it: on the stack's input,
token dropout on q, k and v and dropout after the attention's output
projection (``nn/attention.py``), and after the MLP. The stack takes the
training step's ``dropout_seed``; the input's masks come from a generator
seeded with ``fold_seed(seed, 0)`` and block i's from one seeded with
``fold_seed(seed, i + 1)``, made inside the block, so a block recomputed
under remat draws its masks again bit for bit.

Not ported yet, and raising: the MoE rotator and the sparse-token keep-sets.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from recommendations_tpu_torch.nn.attention import (
    Dense,
    MultiHeadAttention,
    MultiQueryAttention,
    causal_mask,
)
from recommendations_tpu_torch.nn.dropout import dropout, fold_seed, seeded_generator
from recommendations_tpu_torch.nn.functional import gelu_tanh
from recommendations_tpu_torch.ops import fused_attention as fa


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: statistics and normalization in float32,
    output in ``dtype`` (float32 when None)."""

    def __init__(
        self, features: int, device=None, eps: float = 1e-5, use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype or torch.float32)


class TransformerBlock(nn.Module):
    """Pre-LN residual block: x + attn(ln_1(x)); then + mlp(ln_2(x))."""

    def __init__(
        self,
        n_embd: int,
        n_head: int,
        generator: torch.Generator,
        attn_type: str = "multi_head",
        is_causal: bool = False,
        use_bias: bool = True,
        pos_bias_window: Optional[int] = None,
        rotator: float = 4.0,
        is_sparse_attn: bool = False,
        use_flash: bool = False,
        dtype: Optional[torch.dtype] = None,
        dropout: float = 0.0,
        attn_dropout: float = 0.0,
    ):
        super().__init__()
        if not isinstance(rotator, (int, float)):
            raise NotImplementedError(
                "MoE rotator (MoELinear): ROADMAP, port queue 'Attention and transformer'"
            )
        if is_sparse_attn:
            raise NotImplementedError(
                "sparse-token keep-sets (is_sparse_attn): ROADMAP, port queue 'Attention and transformer'"
            )
        self.is_causal = is_causal
        self.use_flash = use_flash
        self.dropout, self.attn_dropout = dropout, attn_dropout
        self.pos_bias_window = pos_bias_window
        dev = generator.device
        cls = MultiQueryAttention if attn_type == "multi_query" else MultiHeadAttention
        self.ln_1 = LayerNorm(n_embd, dev, use_bias=use_bias, dtype=dtype)
        self.attn = cls(
            n_embd, n_head, generator, use_bias=use_bias,
            pos_bias_window=pos_bias_window, use_flash=use_flash, dtype=dtype,
            dropout=dropout, attn_dropout=attn_dropout, name="attn",
        )
        self.ln_2 = LayerNorm(n_embd, dev, use_bias=use_bias, dtype=dtype)
        hidden = int(float(rotator) * n_embd)
        self.c_fc = Dense(n_embd, hidden, generator, use_bias, dtype)
        self.c_proj = Dense(hidden, n_embd, generator, use_bias, dtype)

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        training: bool = False,
        dropout_seed: Optional[int] = None,
    ) -> torch.Tensor:
        """``dropout_seed``: this block's seed; a training forward with a
        nonzero rate draws its masks from a generator made from it here."""
        t = x.shape[1]
        gen = None
        if training and (self.dropout or self.attn_dropout):
            if dropout_seed is None:
                raise ValueError("a training forward with dropout needs a dropout seed")
            gen = seeded_generator(dropout_seed, x.device)
        # the flash path masks causally in-kernel; _sdpa takes the additive mask
        flash_ok = (
            self.use_flash
            and attn_mask is None
            and (
                self.pos_bias_window is None
                or fa.fused_flash_bias_taken(t, self.pos_bias_window, x.is_cuda)
            )
        )
        if self.is_causal and not flash_ok:
            cm = causal_mask(t, x.device)
            attn_mask = cm if attn_mask is None else attn_mask + cm
        x = x + self.attn(
            self.ln_1(x), mask=attn_mask, causal=self.is_causal and flash_ok, training=training, generator=gen
        )
        y = self.c_proj(gelu_tanh(self.c_fc(self.ln_2(x))))
        return x + (y if gen is None else dropout(y, self.dropout, gen))


_aten = torch.ops.aten
# the operators whose outputs each policy keeps (``full`` keeps none)
REMAT_SAVED = {
    "full": frozenset(),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default, fa.FLASH_OP, fa.FLASH_BIAS_OP}),
    "dots": frozenset(
        {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, fa.FLASH_OP, fa.FLASH_BIAS_OP}
    ),
}


def _remat_context(saved: frozenset):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


class TransformerStack(nn.Module):
    """N transformer blocks, named ``block_{i}`` as in the JAX package; with
    ``remat``, each block recomputed in the backward under ``remat_policy``."""

    def __init__(
        self,
        num_layers: int,
        n_embd: int,
        n_head: int,
        generator: torch.Generator,
        remat: bool = False,
        remat_policy: str = "dots_no_batch",
        **block_kw,
    ):
        super().__init__()
        if remat_policy not in REMAT_SAVED:
            raise ValueError(f"remat_policy {remat_policy!r} not in {sorted(REMAT_SAVED)}")
        self.remat, self.remat_policy = remat, remat_policy
        self.num_layers = num_layers
        self.dropout = block_kw.get("dropout", 0.0)
        for depth in range(num_layers):
            self.add_module(
                f"block_{depth}", TransformerBlock(n_embd, n_head, generator, **block_kw)
            )

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        training: bool = False,
        dropout_seed: Optional[int] = None,
    ) -> torch.Tensor:
        """``dropout_seed``: the training step's; needed when a training
        forward has a nonzero rate."""
        remat = self.remat and torch.is_grad_enabled()
        context_fn = functools.partial(_remat_context, REMAT_SAVED[self.remat_policy])
        seeds = [None] * self.num_layers
        if training and dropout_seed is not None:
            seeds = [fold_seed(dropout_seed, depth + 1) for depth in range(self.num_layers)]
            if self.dropout:
                x = dropout(x, self.dropout, seeded_generator(fold_seed(dropout_seed, 0), x.device))
        elif training and self.dropout:
            raise ValueError("a training forward with dropout needs a dropout seed")
        for depth in range(self.num_layers):
            block = getattr(self, f"block_{depth}")
            if remat:
                x = checkpoint(block, x, attn_mask, training, seeds[depth], use_reentrant=False,
                               context_fn=context_fn)
            else:
                x = block(x, attn_mask, training, seeds[depth])
        return x
