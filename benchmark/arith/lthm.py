"""LTHM's work from its shapes: the least time of its attention kernels and
of its contrastive CE, and its model FLOPs, per training step and per
request.

Model FLOPs count each weight product once a token (two operations a
multiply-add), attention's two products over the causal half of the
(query, key) pairs, the CE's three N x N x D products in each of its calls
(training only), and for training the backward at twice the forward. They
do not count remat's second forward, the embedding-bag lookups (gathers),
or elementwise work.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.arith import bounds


@dataclass(frozen=True)
class Shapes:
    users: int
    history: int  # events a user's arrays hold
    context: int  # positions the query tower reads (context_width, at most history)
    layers: int
    d: int
    n_head: int
    ff: int
    window: int
    inp: int
    out: int
    item: int
    heads: int  # lookahead horizons
    lsh_proj: int  # LSH projections over all tables
    chunk: int  # users of one CE call

    @property
    def t(self) -> int:
        """Attention's sequence: the CLS column and the context."""
        return self.context + 1

    @property
    def hd(self) -> int:
        return self.d // self.n_head

    @property
    def ce_n(self) -> int:
        return self.chunk * self.context

    @property
    def ce_calls(self) -> int:
        return self.heads * -(-self.users // self.chunk)


def shapes(cfg: dict, users: int, history: int) -> Shapes:
    tc, pt = cfg["transformer_config"], cfg["product_tower"]
    ac = tc["attn_config"]
    mini = cfg.get("train_mini_batch_size", -1)
    return Shapes(
        users=users, history=history, context=min(cfg["context_width"], history), layers=tc["num_layers"],
        d=ac["n_embd"], n_head=ac["n_head"], ff=int(tc["rotator_config"]["ff_mult"] * ac["n_embd"]),
        window=ac["pos_bias"]["context_window"], inp=pt["inp_emb_dim"], out=pt["out_emb_dim"],
        item=pt["item_emb_dim"], heads=len(cfg["lookahead"]),
        lsh_proj=sum(s["num_proj"] for s in pt["cosine_lsh_config"]),
        chunk=min(mini if mini > 0 else users, users),
    )


def attention_bound_s(s: Shapes, training: bool) -> float:
    """The bias kernels' least time over all layers: the forward, and in
    training the dQ and dK/dV kernels too (one forward a layer: remat keeps
    the flash forward's outputs)."""
    kernels = ("flash_bias_fwd", "flash_bias_dq", "flash_bias_dkv") if training else ("flash_bias_fwd",)
    per_layer = sum(bounds.flash_bias_s(k, s.users, s.t, s.n_head, s.hd, 1, 2 * s.window + 1) for k in kernels)
    return s.layers * per_layer


def ce_bound_s(s: Shapes) -> float:
    """The CE kernels' least time over a training step's calls."""
    return s.ce_calls * sum(bounds.ce_s(k, s.ce_n, s.item) for k in bounds.CE_KERNELS)


def forward_flops(s: Shapes) -> float:
    """One forward of the towers (no CE)."""
    product = s.users * s.history * 2 * (s.inp * s.out + s.inp * s.lsh_proj + s.out * s.item)
    per_pos = s.layers * 2 * (2 * s.d * s.d + s.d * 2 * s.hd + 2 * s.d * s.ff) + 2 * s.d * s.heads * s.item
    query = s.users * s.context * 2 * s.out * s.d + s.users * s.t * per_pos
    attn = s.layers * s.users * 2 * 2 * s.hd * s.n_head * bounds.live_pairs(s.t, True)
    return float(product + query + attn)


def ce_flops(s: Shapes) -> float:
    """A training step's CE: three N x N x D products a call."""
    return float(s.ce_calls * 3 * 2 * s.ce_n * s.ce_n * s.item)


def train_flops(s: Shapes) -> float:
    return 3.0 * forward_flops(s) + ce_flops(s)


def serve_flops(s: Shapes) -> float:
    return forward_flops(s)
