"""Pre-LN transformer block, the MoE feed-forward, and the residual stack.

Port of ``recommendations_tpu/nn/transformer.py``. As in the JAX package,
the stack applies ``x = block(x)`` with standard pre-LN residual blocks,
which fixes the reference's double residual (``x = x + block(x)`` around a
block that already adds x, doubling the stream every layer).

The rotator is an MLP hidden multiplier (``c_fc``, ``c_proj``) or an
:class:`MoESpec`: ``moe_fc`` and ``moe_proj``, two :class:`MoELinear`
(a softmax gate over experts, each expert a two-layer MLP computed densely
as two products over the stacked expert weights, then the gated mix).

Sparse-token keep-sets (``is_sparse_attn``): block i keeps a fixed
pseudo-random subset of the positions (``_sparse_keep_sets``, a numpy
permutation seeded with i, the first ``n_cls`` always kept), attends and
runs its MLP over those only, in their order, and passes every other
position through ``x + null_connector(x)``.

Per-block recomputation (remat, the JAX stack's ``nn.remat`` per block) runs
each block under ``torch.utils.checkpoint`` when a gradient is taken; serving
runs the blocks plainly. ``remat_policy`` as in the JAX package: ``full``
keeps only the block input; ``dots_no_batch`` keeps the outputs of the
projection and MLP matrix products (``aten.mm``/``addmm``), ``dots`` also the
batched ones (``aten.bmm``, the ``_sdpa`` logits), and both keep the outputs
(o, lse) of the flash forward, without and with the position bias, so the
backward does not launch it again.

Sequence parallelism (``bind_sequence_parallel``, the JAX stack's
``use_ring`` over the mesh's ``model`` axis): the stack pads T to a
multiple of the ring at the end, each rank keeps its block of the sequence
(``collectives.scatter_to_group``), every positionwise operation runs on
the block, attention runs the ring (``parallel/ring_attention.py``) with
global positions, and the blocks are gathered back at the exit
(``collectives.all_gather``). The gradients of the blocks' parameters are
then each rank's partial, which the training strategy sums over the ring
(``param_grad_axes``).

Expert parallelism (``MoELinear.bind_experts``, the JAX rules that shard
the expert stacks over ``expert``): each rank of the expert group holds
E/n experts' stacks and biases and runs only those; the gates stay
replicated, and the gate-weighted float32 partial mix is summed over the
group (``collectives.psum``), the gates and the experts' input passing
through ``copy_to_group`` so that their gradients are whole on every rank.

Dropout in training, as the JAX package places it: on the stack's input,
token dropout on q, k and v and dropout after the attention's output
projection (``nn/attention.py``), and after the MLP. The stack takes the
training step's ``dropout_seed``; the input's masks come from a generator
seeded with ``fold_seed(seed, 0)`` and block i's from one seeded with
``fold_seed(seed, i + 1)``, made inside the block, so a block recomputed
under remat draws its masks again bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from recommendations_tpu_torch.core.spans import span
from recommendations_tpu_torch.nn.attention import (
    Dense,
    MultiHeadAttention,
    MultiQueryAttention,
    causal_mask,
)
from recommendations_tpu_torch.nn.dropout import dropout, fold_seed, seeded_generator
from recommendations_tpu_torch.nn.functional import cast_param, gelu_tanh
from recommendations_tpu_torch.ops import fused_attention as fa
from recommendations_tpu_torch.parallel import collectives as col


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


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """The MoE rotator's settings (the JAX package's ``MoESpec``)."""

    num_experts: int
    proj_features: int
    ff_mult_factor: float
    gate_sizes: Tuple[int, ...] = ()
    top_k: Optional[int] = None


def lecun_normal_(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in, where fan_in counts every
    axis but the last (the expert axis of a stacked kernel included)."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncated normal's own std
    t = torch.empty(shape, device=generator.device)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class MoELinear(nn.Module):
    """Softmax-gated mixture of expert two-layer MLPs, every expert computed.

    The gate is ``gate_{i}`` Dense + tanh-GELU per ``gate_sizes``, then
    ``gate_out``, divided by sqrt(in) (the root taken in float32 and cast to
    the gate's dtype); with ``top_k``, every gate below the k-th largest
    becomes -inf, so experts tied at the k-th value all stay; a float32
    softmax cast to the input's dtype. The experts are stacked weights
    ``w1`` (E, in, proj), ``b1``, ``w2`` (E, proj, out), ``b2``: each
    product accumulates in float32, is rounded to the input's dtype and its
    bias added there. The mix of the E outputs is taken in float32 and
    rounded once."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        proj_features: int,
        num_experts: int,
        generator: torch.Generator,
        use_bias: bool = True,
        top_k: Optional[int] = None,
        gate_sizes: Tuple[int, ...] = (),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.in_features, self.num_experts, self.top_k = in_features, num_experts, top_k
        self.gate_sizes = tuple(gate_sizes)
        width = in_features
        for i, g in enumerate(self.gate_sizes):
            self.add_module(f"gate_{i}", Dense(width, g, generator, use_bias, dtype))
            width = g
        self.gate_out = Dense(width, num_experts, generator, use_bias, dtype)
        dev = generator.device
        self.w1 = nn.Parameter(lecun_normal_((num_experts, in_features, proj_features), generator))
        self.b1 = nn.Parameter(torch.zeros((num_experts, proj_features), device=dev))
        self.w2 = nn.Parameter(lecun_normal_((num_experts, proj_features, out_features), generator))
        self.b2 = nn.Parameter(torch.zeros((num_experts, out_features), device=dev))
        self.expert_group, self.first_expert = None, 0

    def bind_experts(self, group) -> None:
        """Keep this rank's E/n experts of the group's (their stacks and
        biases sliced in place); None leaves every expert here."""
        n = col.group_size(group)
        if n == 1:
            return
        if self.num_experts % n:
            raise ValueError(f"{self.num_experts} experts not divisible by expert={n}")
        per = self.num_experts // n
        self.expert_group, self.first_expert = group, col.group_rank(group) * per
        for name in ("w1", "b1", "w2", "b2"):
            p = getattr(self, name)
            p.data = p.data.narrow(0, self.first_expert, per).clone()

    def gates(self, x: torch.Tensor) -> torch.Tensor:
        """(..., E) mixing weights in the input's dtype."""
        g = x
        for i in range(len(self.gate_sizes)):
            g = gelu_tanh(getattr(self, f"gate_{i}")(g))
        g = self.gate_out(g)
        g = g / torch.sqrt(torch.tensor(float(self.in_features))).to(g.dtype)
        if self.top_k is not None:
            k = min(self.top_k, self.num_experts)
            thresh = torch.topk(g, k, dim=-1).values[..., -1:]
            g = torch.where(g < thresh, float("-inf"), g)
        return torch.softmax(g.float(), dim=-1).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        gates = self.gates(x)
        g = self.expert_group
        if g is not None:
            gates = col.copy_to_group(gates, g).narrow(-1, self.first_expert, self.w1.shape[0])
            x = col.copy_to_group(x, g)
        h = torch.einsum("...i,eij->...ej", x, cast_param(self.w1, dt)) + cast_param(self.b1, dt)
        h = gelu_tanh(h)
        out = torch.einsum("...ej,ejo->...eo", h, cast_param(self.w2, dt)) + cast_param(self.b2, dt)
        mix = torch.sum(gates.float().unsqueeze(-1) * out.float(), dim=-2)
        return col.psum(mix, g).to(dt)


def _sparse_keep_sets(
    max_block_size: int, sparsity_factor: float, seed: int, n_cls: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The kept and the skipped positions of a block, each sorted: a
    permutation of ``max_block_size`` from ``RandomState(seed)``, its first
    ``n_cls`` entries replaced by the first positions, the first
    ``int(sparsity_factor * max_block_size)`` of it kept."""
    n_non_zeros = int(sparsity_factor * max_block_size)
    perm = np.random.RandomState(seed).permutation(max_block_size)
    full = np.concatenate([np.arange(n_cls, dtype=np.int64), perm[n_cls:]])
    return np.sort(full[:n_non_zeros]), np.sort(full[n_non_zeros:])


class TransformerBlock(nn.Module):
    """Pre-LN residual block: x + attn(ln_1(x)); then + mlp(ln_2(x)).
    ``rotator`` is the MLP hidden multiplier or an :class:`MoESpec`; with
    ``is_sparse_attn`` the block runs over its keep-set (seeded with
    ``sparse_seed``) and passes the other positions through
    ``null_connector``."""

    def __init__(
        self,
        n_embd: int,
        n_head: int,
        generator: torch.Generator,
        attn_type: str = "multi_head",
        is_causal: bool = False,
        use_bias: bool = True,
        pos_bias_window: Optional[int] = None,
        rotator: Union[float, MoESpec] = 4.0,
        is_sparse_attn: bool = False,
        max_block_size: Optional[int] = None,
        sparsity_factor: float = 0.5,
        sparse_seed: int = 0,
        n_cls: int = 0,
        use_flash: bool = False,
        use_ring: bool = False,
        dtype: Optional[torch.dtype] = None,
        dropout: float = 0.0,
        attn_dropout: float = 0.0,
    ):
        super().__init__()
        if not isinstance(rotator, (int, float, MoESpec)):
            raise NotImplementedError(f"rotator: an MLP multiplier or an MoESpec, got {type(rotator).__name__}")
        self.is_causal = is_causal
        self.use_flash = use_flash
        self.dropout, self.attn_dropout = dropout, attn_dropout
        self.pos_bias_window = pos_bias_window
        dev = generator.device
        cls = MultiQueryAttention if attn_type == "multi_query" else MultiHeadAttention
        self.ln_1 = LayerNorm(n_embd, dev, use_bias=use_bias, dtype=dtype)
        self.attn = cls(
            n_embd, n_head, generator, use_bias=use_bias,
            pos_bias_window=pos_bias_window, use_flash=use_flash, use_ring=use_ring, dtype=dtype,
            dropout=dropout, attn_dropout=attn_dropout, name="attn",
        )
        self.ln_2 = LayerNorm(n_embd, dev, use_bias=use_bias, dtype=dtype)
        self.moe = isinstance(rotator, MoESpec)
        if self.moe:
            hidden = int(rotator.ff_mult_factor * n_embd)
            moe_kw = dict(use_bias=use_bias, top_k=rotator.top_k, gate_sizes=tuple(rotator.gate_sizes), dtype=dtype)
            self.moe_fc = MoELinear(n_embd, hidden, rotator.proj_features, rotator.num_experts, generator, **moe_kw)
            self.moe_proj = MoELinear(hidden, n_embd, rotator.proj_features, rotator.num_experts, generator, **moe_kw)
        else:
            hidden = int(float(rotator) * n_embd)
            self.c_fc = Dense(n_embd, hidden, generator, use_bias, dtype)
            self.c_proj = Dense(hidden, n_embd, generator, use_bias, dtype)
        self.keep = None
        if is_sparse_attn:
            if max_block_size is None:
                raise ValueError("is_sparse_attn needs max_block_size")
            self.keep = _sparse_keep_sets(max_block_size, sparsity_factor, sparse_seed, n_cls)
            self.null_connector = Dense(n_embd, n_embd, generator, use_bias, dtype)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        with span("lthm/mlp"):
            if self.moe:
                return self.moe_proj(gelu_tanh(self.moe_fc(x)))
            return self.c_proj(gelu_tanh(self.c_fc(x)))

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        training: bool = False,
        dropout_seed: Optional[int] = None,
        shard=None,
    ) -> torch.Tensor:
        """``dropout_seed``: this block's seed; a training forward with a
        nonzero rate draws its masks from a generator made from it here
        (``shard``: this rank's block of the whole batch's draw)."""
        x_orig = x
        if self.keep is not None:
            if self.attn.ring_group is not None:
                raise ValueError("the sparse keep-sets select positions of the whole sequence: not with the ring")
            t_full = x.shape[1]
            idx, not_idx = (torch.as_tensor(a[a < t_full], device=x.device) for a in self.keep)
            if idx.numel() <= 1:
                return x + self.null_connector(x)
            x = x.index_select(1, idx)
            if attn_mask is not None:
                attn_mask = attn_mask.index_select(2, idx).index_select(3, idx)
        t = x.shape[1]
        gen = None
        if training and (self.dropout or self.attn_dropout):
            if dropout_seed is None:
                raise ValueError("a training forward with dropout needs a dropout seed")
            gen = seeded_generator(dropout_seed, x.device)
        # the flash path masks causally in-kernel; _sdpa takes the additive mask
        flash_ok = self.attn._ring_eligible(attn_mask, self.is_causal) or (
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
            self.ln_1(x), mask=attn_mask, causal=self.is_causal and flash_ok, training=training, generator=gen,
            shard=shard,
        )
        y = self._mlp(self.ln_2(x))
        x = x + (y if gen is None else dropout(y, self.dropout, gen, shard))
        if self.keep is None:
            return x
        skipped = x_orig.index_select(1, not_idx)
        out = torch.zeros_like(x_orig).index_copy(1, idx, x.to(x_orig.dtype))
        return out.index_copy(1, not_idx, (skipped + self.null_connector(skipped)).to(x_orig.dtype))


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
    """N transformer blocks, named ``block_{i}`` as in the JAX package, block
    i's keep-set seeded with i; with ``remat``, each block recomputed in the
    backward under ``remat_policy``."""

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
        self.is_causal = block_kw.get("is_causal", False)
        self.pos_bias_window = block_kw.get("pos_bias_window")
        self.ring_group = None
        for depth in range(num_layers):
            self.add_module(
                f"block_{depth}", TransformerBlock(n_embd, n_head, generator, sparse_seed=depth, **block_kw)
            )

    def bind_sequence_parallel(self, group) -> None:
        """Split the sequence over ``group`` (the mesh's ``model`` axis) and
        run every block's attention as the ring; a group of one rank (None)
        leaves the stack whole, as the JAX stack does below two ranks."""
        self.ring_group = group
        for depth in range(self.num_layers):
            attn = getattr(self, f"block_{depth}").attn
            attn.use_ring = group is not None
            attn.bind_ring(group, local_blocks=True)

    def forward(
        self,
        x: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        training: bool = False,
        dropout_seed: Optional[int] = None,
        batch_shard: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        """``dropout_seed``: the training step's; needed when a training
        forward has a nonzero rate. ``batch_shard``: (first row, rows) of
        this rank's rows in the whole batch, where the dropout masks are
        drawn for the whole batch."""
        group = self.ring_group
        t_orig = x.shape[1]
        b0, b_all = batch_shard if batch_shard is not None else (0, x.shape[0])
        t0, t_all = 0, t_orig
        if group is not None:
            if attn_mask is not None or not self.is_causal:
                raise ValueError("sequence_parallel requires attn_mask=None and is_causal")
            if self.pos_bias_window is not None and t_orig > self.pos_bias_window:
                raise ValueError(f"seq {t_orig} exceeds the pos-bias table window {self.pos_bias_window}")
            # pad T to the ring at the end (no real query reads a pad key
            # under causal masking), keep this rank's block
            n = col.group_size(group)
            t_all = ((t_orig + n - 1) // n) * n
            x = col.scatter_to_group(F.pad(x, (0, 0, 0, t_all - t_orig)), group, dim=1)
            t0 = col.group_rank(group) * x.shape[1]
        shard = None if (b_all, t_all) == tuple(x.shape[:2]) else (b0, b_all, t0, t_all)
        remat = self.remat and torch.is_grad_enabled()
        context_fn = functools.partial(_remat_context, REMAT_SAVED[self.remat_policy])
        seeds = [None] * self.num_layers
        if training and dropout_seed is not None:
            seeds = [fold_seed(dropout_seed, depth + 1) for depth in range(self.num_layers)]
            if self.dropout:
                x = dropout(x, self.dropout, seeded_generator(fold_seed(dropout_seed, 0), x.device), shard)
        elif training and self.dropout:
            raise ValueError("a training forward with dropout needs a dropout seed")
        for depth in range(self.num_layers):
            block = getattr(self, f"block_{depth}")
            if remat:
                # a block's dropout draws from its own seeded generator, never
                # the default ones: no RNG state to stash, which a captured
                # step could not read
                x = checkpoint(block, x, attn_mask, training, seeds[depth], shard, use_reentrant=False,
                               preserve_rng_state=False, context_fn=context_fn)
            else:
                x = block(x, attn_mask, training, seeds[depth], shard)
        if group is not None:
            x = col.all_gather(x, group, dim=1)[:, :t_orig]
        return x
