"""Dropout of the training forward, with masks that recomputation draws again
bit for bit.

Port of the two dropouts of the JAX package:

- token dropout on q, k and v (``recommendations_tpu/nn/attention.py``
  ``_token_dropout_mask``, ``_qkv_dropout``, ``_apply_folded_dropout``):
  a (B, 1, T, 1) keep mask per tensor, shared by every head, scaled
  inverted as ``keep.float32 / (1 - rate)``; the product is taken in float32
  and cast back to the activation's dtype;
- flax ``nn.Dropout`` (the attention output, the MLP output, the stack's
  input): ``select(keep, x / keep_prob, 0)`` with the division in x's dtype
  (the python rate weakly typed to it); rate 0 returns x, rate 1 zeros.

Every draw goes through ``dropout_keep``. A block draws its masks from a
``torch.Generator`` on the activations' device, seeded from the training
step's dropout seed folded with the block's index (``fold_seed``): a block
that ``torch.utils.checkpoint`` runs again in the backward builds the same
generator from the same seed and draws the same masks (``checkpoint``
restores only the default generators, so a generator carried across the
recomputation would draw other masks and give a wrong gradient).

Over several ranks a draw takes a ``shard``: ``(batch_start, batch_rows,
seq_start, seq_len)``, the place of this rank's rows (data parallelism) and
sequence block (sequence parallelism) in the whole batch. The mask is drawn
for the whole batch's shape and this rank keeps its block, so R ranks apply
the masks of one process (JAX draws from one key for the global array).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, index: int) -> int:
    """A 63-bit seed for ``index`` under ``seed`` (splitmix64 of the pair),
    as ``jax.random.fold_in`` derives a key per module."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def seeded_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def dropout_keep(generator: torch.Generator, keep_prob: float, shape: Sequence[int], device) -> torch.Tensor:
    """The keep draw of every dropout: a bool tensor of ``shape``, True with
    probability ``keep_prob``."""
    return torch.rand(tuple(shape), generator=generator, device=device) < keep_prob


Shard = Optional[Tuple[int, int, int, int]]


def _keep(generator: torch.Generator, keep_prob: float, shape: Sequence[int], device, seq_dim: int,
          shard: Shard) -> torch.Tensor:
    """``dropout_keep`` of ``shape``, or this rank's block of the whole
    batch's draw under ``shard``."""
    if shard is None:
        return dropout_keep(generator, keep_prob, shape, device)
    b0, b_all, t0, t_all = shard
    full = list(shape)
    full[0], full[seq_dim] = b_all, t_all
    keep = dropout_keep(generator, keep_prob, full, device)
    return keep.narrow(0, b0, shape[0]).narrow(seq_dim, t0, shape[seq_dim])


def token_dropout_mask(generator: torch.Generator, rate: float, batch: int, seq: int, device,
                       shard: Shard = None) -> torch.Tensor:
    """Inverted token-dropout mask, float32 (B, 1, T, 1)."""
    keep = _keep(generator, 1.0 - rate, (batch, 1, seq, 1), device, 2, shard)
    return keep.float() / torch.full((), 1.0 - rate, dtype=torch.float32, device=device)


def qkv_dropout(q, k, v, rate: float, generator: Optional[torch.Generator], shard: Shard = None):
    """Token dropout on the folded (B, T, C) q, k and v: three masks, drawn
    in that order, each (B, 1, T, 1) applied as (B, T, 1)."""
    if not rate:
        return q, k, v
    b, t = q.shape[0], q.shape[1]
    return tuple(
        (x.float() * token_dropout_mask(generator, rate, b, t, x.device, shard)[:, 0]).to(x.dtype)
        for x in (q, k, v)
    )


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], shard: Shard = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)(x, deterministic=False)`` on (B, T, ...)."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = _keep(generator, keep_prob, x.shape, x.device, 1, shard)
    scale = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout_rates(module: torch.nn.Module) -> List[float]:
    """Every dropout rate ``module`` holds: the ``dropout`` and
    ``attn_dropout`` numbers of its submodules (the layers here keep their
    rates so) and each ``torch.nn.Dropout``'s ``p``."""
    rates = []
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            rates.append(float(m.p))
        for name in ("dropout", "attn_dropout"):
            rate = getattr(m, name, None)
            if isinstance(rate, (int, float)) and not isinstance(rate, bool):
                rates.append(float(rate))
    return rates
