"""Plain PyTorch reference of LTHM: the product tower, the query tower, the
multi-horizon contrastive loss with its logQ state, and AdamW.

It follows the model of ``configs/model/lthm.yaml`` as the program under
test defines it, written again with plain torch operations in float32 and
no kernel, cache or batching of the program. It imports nothing of the
program, of JAX or of the JAX package; it takes the weights and inputs the
benchmark makes from the seed, never anything the program made.

``precision="fp8"`` is the control: every product's operands are rounded to
float8 e4m3 (a per-tensor scale at the operand's largest magnitude) and the
products accumulate in float32, the step below the program's bfloat16.

Memory: attention runs in blocks of users (``USER_BLOCK``) and each block
of a training step is recomputed in the backward (``checkpoint``), so a
step at 64 users of 1025 positions and 16 layers fits beside the 10M-row
table; the contrastive CE runs in blocks of rows (``CE_ROWS``) with its
gradient formed by hand, as the program's eager CE forms it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

USER_BLOCK = 8  # users of one attention block
CE_ROWS = 4096  # rows of one CE block
BIG_NEG = -1e9
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


# ----- precision -----------------------------------------------------------------


class exact_f32:
    """float32 products without TF32, for the duration of a reference run."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (y - x.detach())


class Precision:
    """The arithmetic of the reference's products: ``f32`` or ``fp8``."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r} not in ('f32', 'fp8')")
        self.name = name

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return fake_fp8(x) if self.name == "fp8" else x

    def lookup(self, x: torch.Tensor, cfg: dict) -> torch.Tensor:
        """The KShift rows and their sum as the configuration reads them: in
        its ``compute_dtype`` (fp8 for the control). The LSH buckets are a
        step function of these values, so the reference sees the values
        the configuration defines, not a float32 variant of them."""
        if self.name == "fp8":
            return fake_fp8(x)
        return x.to(getattr(torch, cfg["compute_dtype"])).float()

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.linear(self.op(x), self.op(w), b)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.op(a), self.op(b))


def l2n(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(sq, eps * eps))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


# ----- the product tower -------------------------------------------------------------


def kshift_rows(ids: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Row c of each id: rotl64(id, c) mod n, unsigned; ids.shape + (k,).
    Unsigned arithmetic on int64 bit patterns: for a negative x the
    unsigned value is x + 2**64."""
    x = ids.to(torch.int64)
    rots = [x]
    for c in range(1, k):
        rots.append((x << c) | ((x >> (64 - c)) & ((1 << c) - 1)))
    s = torch.stack(rots, dim=-1)
    r = s.remainder(n)
    return torch.where(s < 0, (r + (2**64 % n)).remainder(n), r)


def lsh_grid(num_bins: int, device) -> torch.Tensor:
    """The bucket boundaries on [-1, 1]: the bin centres' left edges shifted
    by half a bin, as the model defines them."""
    res = 2.0 / float(num_bins)
    grid = (np.linspace(-1.0, 1.0, num_bins + 1)[:-1] + 0.5 * res).astype(np.float32)
    return torch.from_numpy(grid).to(device)


def product_tower(cfg: dict, w: Dict[str, torch.Tensor], ids: torch.Tensor, prec: Precision):
    """(emb (B, L, out), prod_emb (B, L, item), mask (B, L)) of the history."""
    pt = cfg["product_tower"]
    lm = pt["latent_model_config"]
    table = w["product_emb_module.embedding"].detach()  # detach_item_tower: no gradient reaches it
    rows = prec.lookup(table[kshift_rows(ids, lm["vocab_size_latent"], lm["num_shifts_latent"])], cfg)
    x = prec.lookup(rows.sum(dim=-2), cfg)
    x = l2n(x) if lm["normalize_embedding"] else x / math.sqrt(lm["num_shifts_latent"])
    x_norm = torch.sqrt(torch.sum(x * x, dim=-1))
    mask = (x_norm < pt["norm_threshold"]) | (ids == 0)
    xn = l2n(x)
    p = "product_tower."
    emb = prec.linear(xn, w[p + "emb_mapper.weight"], w[p + "emb_mapper.bias"])
    for i, spec in enumerate(pt["cosine_lsh_config"]):
        nb1, n_proj = spec["num_bins"] + 1, spec["num_proj"]
        z = torch.matmul(l2n(xn), w[f"{p}direction_emb_{i}.projection_mat"])
        bucket = torch.sum(lsh_grid(spec["num_bins"], ids.device) < z[..., None], dim=-1)
        onehot = (bucket[..., None] == torch.arange(nb1, device=ids.device)).float()
        onehot = onehot.reshape(*bucket.shape[:-1], n_proj * nb1)
        emb = emb + prec.matmul(onehot, w[f"{p}direction_emb_{i}.embedding"])
    nb = pt["norm_bins"]
    if nb > 1:
        idx = torch.floor(x_norm * nb).to(torch.int64).clamp(0, nb - 1)
        emb = emb + w[p + "norm_emb.embedding"][idx]
    emb = torch.where(mask[..., None], 0.0, emb)
    prod = prec.linear(emb, w[p + "product_mapper.weight"])
    return emb, prod, mask


# ----- the query tower ---------------------------------------------------------------


def layer_norm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, weight.shape, weight, None, 1e-5)


def _attend_block(q, k, v, plane, prec_name: str):
    """q (b, H, T, hd) already scaled, k/v (b, T, hd), plane (H, T, T) the
    bias with the causal mask: softmax(q k^T + plane) v."""
    prec = Precision(prec_name)
    s = prec.matmul(q, k[:, None].transpose(-1, -2)) + plane[None]
    p = torch.softmax(s, dim=-1)
    return prec.matmul(p, v[:, None])


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], pre: str, n_head: int, prec: Precision,
              grad: bool) -> torch.Tensor:
    """Multi-query attention with the relative-position bias (table row
    q - k + T for T = window) and the causal mask."""
    b, t, d = x.shape
    hd = d // n_head
    q = prec.linear(x, w[pre + "q_proj.weight"]).reshape(b, t, n_head, hd).transpose(1, 2) / math.sqrt(hd)
    k, v = prec.linear(x, w[pre + "kv_proj.weight"]).split(hd, dim=-1)
    table = w[pre + "pos_bias.bias"]
    pos = torch.arange(t, device=x.device)[:, None] - torch.arange(t, device=x.device)[None, :] + t
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    plane = torch.where(causal[None], table.t()[:, pos], float("-inf"))  # (H, T, T)
    outs = []
    for u in range(0, b, USER_BLOCK):
        sl = slice(u, u + USER_BLOCK)
        if grad:
            outs.append(checkpoint(_attend_block, q[sl], k[sl], v[sl], plane, prec.name, use_reentrant=False))
        else:
            outs.append(_attend_block(q[sl], k[sl], v[sl], plane, prec.name))
    y = torch.cat(outs).transpose(1, 2).reshape(b, t, d)
    return prec.linear(y, w[pre + "out_proj.weight"])


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], i: int, n_head: int, prec: Precision, grad: bool):
    pre = f"query_tower.transformer.block_{i}."
    x = x + attention(layer_norm(x, w[pre + "ln_1.weight"]), w, pre + "attn.", n_head, prec, grad)
    h = gelu_tanh(prec.linear(layer_norm(x, w[pre + "ln_2.weight"]), w[pre + "c_fc.weight"]))
    return x + prec.linear(h, w[pre + "c_proj.weight"])


def encode(cfg: dict, w: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], prec: Precision,
           grad: bool) -> Dict[str, torch.Tensor]:
    """The forward: history (most recent first, right-padded) in, the
    current tokens' product embeddings and the heads' next-token
    embeddings out, as the program's encoder returns them."""
    ids = batch["product_ids"].to(torch.int64)
    emb, prod, mask = product_tower(cfg, w, ids, prec)
    labels = batch["labels"].to(torch.int64)
    stamps = batch["timestamps"].to(torch.int64)
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
    n_head = tc["attn_config"]["n_head"]
    for i in range(tc["num_layers"]):
        if grad:
            x = checkpoint(block, x, w, i, n_head, prec, grad, use_reentrant=False)
        else:
            x = block(x, w, i, n_head, prec, grad)
    outcomes = torch.cat([labels, labels.new_zeros((b, 1))], dim=-1)
    x = x + w[q + "outcome_conditioning.embedding"][outcomes.remainder(4)]
    d_prod = cfg["product_tower"]["item_emb_dim"]
    y = prec.linear(x, w[q + "emb_heads.weight"]).reshape(b, cw + 1, len(cfg["lookahead"]), d_prod)
    return {"current_token_emb": target, "next_token_emb": y, "current_token_mask": mask,
            "current_token_ids": ids}


def user_embeddings(cfg: dict, w: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                    prec: Precision) -> torch.Tensor:
    """What the serving entry returns: the unit lookahead-0 query of the
    most recent position, (B, item_emb_dim)."""
    with torch.no_grad(), exact_f32():
        return l2n(encode(cfg, w, batch, prec, grad=False)["next_token_emb"][:, -1, 0, :])


# ----- the loss -----------------------------------------------------------------------


class LogQ:
    """The streaming logQ estimator: per hash bucket an EMA of the gap in
    batch indices between sightings; within one batch the last occurrence
    of a bucket in flattened order writes, a padding token writing back
    what it read."""

    def __init__(self, cfg: dict, device):
        lq = cfg["log_q_config"]
        n, nb = len(lq["hash_offsets"]), lq["num_buckets"]
        self.alpha = lq["alpha"]
        self.b = torch.full((n, nb), 1.0 / lq["p_init"], dtype=torch.float32, device=device)
        self.a = torch.zeros((n, nb), dtype=torch.float32, device=device)
        self.offsets = torch.tensor(list(lq["hash_offsets"]), dtype=torch.int64, device=device)

    def buckets(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.remainder(ids.reshape(-1)[None, :] + self.offsets[:, None], self.b.shape[1])

    def update(self, ids: torch.Tensor, valid: torch.Tensor, batch_idx: float) -> None:
        h = self.buckets(ids)
        v = valid.reshape(-1)
        for row in range(h.shape[0]):
            hr = h[row]
            # the last occurrence of each bucket: scan from the end
            rev = torch.flip(hr, dims=(0,))
            uniq, inv = torch.unique(rev, return_inverse=True)
            first_in_rev = torch.full((uniq.numel(),), rev.numel(), dtype=torch.int64, device=hr.device)
            first_in_rev.scatter_reduce_(0, inv, torch.arange(rev.numel(), device=hr.device), "amin")
            keep = rev.numel() - 1 - first_in_rev
            hk, vk = hr[keep], v[keep]
            b_old, a_old = self.b[row, hk], self.a[row, hk]
            self.b[row, hk] = torch.where(vk, (1.0 - self.alpha) * b_old + self.alpha * (batch_idx - a_old), b_old)
            self.a[row, hk] = torch.where(vk, torch.full_like(a_old, batch_idx), a_old)

    def correction(self, ids: torch.Tensor) -> torch.Tensor:
        vals = torch.gather(self.b, 1, self.buckets(ids))
        return (-torch.log(vals.min(dim=0).values)).reshape(ids.shape)


def _masked_adj(q, c, v, lq, r0, s, inv_t, beta, prec):
    """Rows r0.. of the masked, logQ-adjusted logits, and their diagonal's
    column index."""
    n = c.shape[0]
    rows = torch.arange(r0, r0 + q.shape[0], device=q.device)
    cols = torch.arange(n, device=q.device)
    raw = prec.matmul(q, c.t()) * inv_t
    eye = rows[:, None] == cols[None, :]
    masked = ((rows[:, None] // s == cols[None, :] // s) & ~eye) | ~v[None, :]
    logits = torch.where(masked, BIG_NEG, raw)
    return torch.where(eye, logits, logits - beta * lq[None, :]), eye


class ContrastiveCE(torch.autograd.Function):
    """Per-row in-batch CE: rows are queries, columns the candidates, the
    positive on the diagonal; same-user columns and invalid candidates
    masked; the shift m bounds every logit. The gradient is formed by hand:
    (softmax - I) dce / temperature against the other side."""

    @staticmethod
    def forward(ctx, q, c, v, lq, s: int, inv_t: float, beta: float, prec_name: str):
        prec = Precision(prec_name)
        m = inv_t + beta * lq.abs().max() + 1.0
        ce = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
        for r0 in range(0, q.shape[0], CE_ROWS):
            adj, eye = _masked_adj(q[r0:r0 + CE_ROWS], c, v, lq, r0, s, inv_t, beta, prec)
            lse = m + torch.log(torch.exp(adj - m).sum(-1))
            ce[r0:r0 + CE_ROWS] = lse - adj[eye]
        ctx.save_for_backward(q, c, v, lq, ce)
        ctx.consts = (s, inv_t, beta, prec_name)
        return ce

    @staticmethod
    def backward(ctx, dce):
        q, c, v, lq, ce = ctx.saved_tensors
        s, inv_t, beta, prec_name = ctx.consts
        prec = Precision(prec_name)
        dq, dc = torch.zeros_like(q), torch.zeros_like(c)
        for r0 in range(0, q.shape[0], CE_ROWS):
            qb = q[r0:r0 + CE_ROWS]
            adj, eye = _masked_adj(qb, c, v, lq, r0, s, inv_t, beta, prec)
            ceb = ce[r0:r0 + CE_ROWS]
            lse = torch.where(torch.isfinite(ceb), ceb + adj[eye], 0.0)
            g = (torch.exp(adj - lse[:, None]) - eye.float()) * (dce[r0:r0 + CE_ROWS] * inv_t)[:, None]
            dq[r0:r0 + CE_ROWS] = prec.matmul(g, c)
            dc += prec.matmul(g.t(), qb)
        return dq, dc, None, None, None, None, None, None


def contrastive_loss(cfg: dict, out: Dict[str, torch.Tensor], logq: LogQ, batch_idx: float,
                     offsets: Sequence[int], prec: Precision, users: Optional[int] = None) -> torch.Tensor:
    """The training loss: per lookahead head, per chunk of
    ``train_mini_batch_size`` users, the mean CE over the used slots; the
    chunks averaged, the heads summed. The logQ state is updated first.
    ``users`` keeps only the first users of the batch (a planted fault)."""
    out_emb = l2n(out["next_token_emb"])
    in_emb = l2n(out["current_token_emb"])
    mask, ids = out["current_token_mask"], out["current_token_ids"]
    logq.update(ids, ~mask, batch_idx)
    lq_all = logq.correction(ids)
    if users is not None:
        out_emb, in_emb, mask, lq_all = out_emb[:users], in_emb[:users], mask[:users], lq_all[:users]
    b, s = mask.shape
    chunk = cfg["train_mini_batch_size"] if cfg["train_mini_batch_size"] > 0 else b
    chunk = min(chunk, b)
    bounds = [(c0, min(c0 + chunk, b)) for c0 in range(0, b, chunk)]
    inv_t, beta = 1.0 / cfg["softmax_temperature"], cfg["log_q_config"]["beta"]
    pos = torch.arange(s, device=mask.device)[None, :]
    total = torch.zeros((), dtype=torch.float32, device=mask.device)
    for i, off in enumerate(offsets):
        cand = torch.roll(in_emb, -off, dims=1)
        valid = ~torch.roll(mask, -off, dims=1) & (pos < s - off)
        lq = torch.roll(lq_all, -off, dims=1)
        query = out_emb[:, :s, i, :]
        head = []
        for c0, c1 in bounds:
            n = (c1 - c0) * s
            d = query.shape[-1]
            v = valid[c0:c1].reshape(n)
            ce = ContrastiveCE.apply(query[c0:c1].reshape(n, d), cand[c0:c1].reshape(n, d), v,
                                     lq[c0:c1].reshape(n).detach(), s, inv_t, beta, prec.name)
            vf = v.float()
            per_user = vf.reshape(c1 - c0, s).sum(-1)
            num_neg = vf.sum() - per_user.repeat_interleave(s) + vf - 1.0
            wgt = (v & (num_neg > 0)).float()
            ce = torch.where(torch.isfinite(ce), ce, 0.0)
            head.append((ce * wgt).sum() / wgt.sum().clamp_min(1.0))
        total = total + torch.stack(head).sum() / len(bounds)
    return total


def sample_offsets(generator: torch.Generator, lookahead: Sequence[int]) -> List[int]:
    """offset_0 = lookahead[0]; offset_i uniform on [offset_{i-1} + 1,
    lookahead[i]], an empty range giving its low end: the draws the
    training step makes from its generator."""
    offsets = [int(lookahead[0])]
    for hi in lookahead[1:]:
        lo = offsets[-1] + 1
        if int(hi) < lo:
            offsets.append(lo)
            continue
        offsets.append(int(torch.randint(lo, int(hi) + 1, (), generator=generator)))
    return offsets


# ----- training ------------------------------------------------------------------------


def trainable(cfg: dict, w: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves the optimizer steps: every parameter but the frozen table
    and the fixed LSH projections."""
    return [k for k in w if k != "product_emb_module.embedding" and not k.endswith(".projection_mat")]


class AdamW:
    """Decoupled weight decay, then Adam with bias corrections (eps outside
    the root), in float32."""

    def __init__(self, lr: float, betas: Tuple[float, float], weight_decay: float, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.wd, self.eps = lr, betas[0], betas[1], weight_decay, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for name, p in params.items():
            g = p.grad
            if g is None:
                continue
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(c2) + self.eps, value=-self.lr / c1)


def train(cfg: dict, w: Dict[str, torch.Tensor], batches: Sequence[Dict[str, torch.Tensor]], offset_seed: int,
          prec: Precision, users: Optional[int] = None, freeze: bool = False) -> dict:
    """len(batches) training steps from the weights ``w`` (left as they
    are: the steps update copies). Returns each step's loss, each leaf's first gradient norm and
    each leaf's change after the last step. ``offset_seed`` seeds the CPU
    generator the offsets are drawn from; ``users`` and ``freeze`` plant
    the faults of half a batch and of a state left unchanged."""
    names = trainable(cfg, w)
    start = {k: w[k].detach().clone() for k in names}
    params = {k: w[k].detach().clone().requires_grad_(True) for k in names}
    weights = dict(w, **params)
    opt = AdamW(float(cfg["lr"]), tuple(cfg["betas"]), float(cfg["weight_decay"]))
    logq = LogQ(cfg, w["product_emb_module.embedding"].device)
    gen = torch.Generator().manual_seed(offset_seed)
    losses, grad_norms = [], {}
    with exact_f32():
        for step, batch in enumerate(batches):
            _step(cfg, weights, params, batch, step, gen, logq, opt, prec, users, freeze, losses, grad_norms)
    change = {k: (params[k].detach() - start[k]).norm().item() for k in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def _step(cfg, weights, params, batch, step, gen, logq, opt, prec, users, freeze, losses, grad_norms) -> None:
    offsets = sample_offsets(gen, cfg["lookahead"])
    for p in params.values():
        p.grad = None
    loss = contrastive_loss(cfg, encode(cfg, weights, batch, prec, grad=True), logq, float(step), offsets, prec, users)
    loss.backward()
    losses.append(loss.item())
    if step == 0:
        grad_norms.update({k: (p.grad.norm().item() if p.grad is not None else 0.0) for k, p in params.items()})
    if not freeze:
        opt.step(params)
