"""The offline KShift embedding compression job.

Port of ``recommendations_tpu/tools/embedding_module_gen.py``: distill a
pretrained product-embedding table (parquet: ``product_id`` strings and
embedding arrays) into the hash-based module that
``models/lthm/pretrained.PretrainedProductEmbedding`` serves:

1. hash the ids with the training-time contract (``features/hashing.py``);
2. train a KShift table of ``expansion_factor * N`` rows to reconstruct the
   L2-normalized embeddings (MSE, Adagrad);
3. train a mask model (KShift(k=4) -> MLP -> sigmoid) to tell known ids from
   random ones (binary cross-entropy, Adagrad);
4. save ``{emb_table, mask_table, mask_w1, mask_b1, mask_w2, mask_b2}`` as
   ``embedding_module.pt`` (``torch.save`` of the arrays) beside
   ``embedding_module_meta.json``.

Adagrad is optax's (``scale_by_rss`` then the learning rate), written out:
the accumulator starts at ``initial_accumulator_value``, gathers g**2, and
the step is ``-lr * g * rsqrt(acc + 1e-7)`` (zero where acc is 0).
``torch.optim.Adagrad`` divides by ``sqrt(acc) + eps`` instead, which moves
the early steps of small gradients by a large factor. The batch orders and
the negative ids come from numpy's ``RandomState(seed)``, as in the JAX
package; the initial weights from a ``torch.Generator``, or are given
(``init``), as the parity tests give JAX's.

    python -m recommendations_tpu_torch.tools.embedding_module_gen \\
        --input embs.parquet --output DIR [--device cpu] [--recon-epochs 50 ...]
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from recommendations_tpu_torch import resolve_device
from recommendations_tpu_torch.features.hashing import hash_feature_name_to_int, hash_strings_to_long
from recommendations_tpu_torch.features.transforms import Table
from recommendations_tpu_torch.models.lthm.pretrained import mask_logits
from recommendations_tpu_torch.nn.embeddings import kshift_row_indices
from recommendations_tpu_torch.nn.functional import l2_normalize

logger = logging.getLogger(__name__)
MAX_LONG = 2**63
ADAGRAD_EPS = 1e-7  # optax.adagrad's default eps
ARTIFACT = "embedding_module.pt"
META = "embedding_module_meta.json"


class Adagrad:
    """optax.adagrad(lr, initial_accumulator_value) over a dict of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, initial_accumulator_value: float = 1e-10):
        self.lr = lr
        self.acc = {k: torch.full_like(p, initial_accumulator_value) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        for k, p in params.items():
            g = grads[k]
            acc = self.acc[k].add_(g * g)
            scale = torch.where(acc > 0, torch.rsqrt(acc + ADAGRAD_EPS), 0.0)
            p.sub_(self.lr * (scale * g))


def massage_embeddings(table: Table, id_column: str = "product_id", emb_column: str = "emb_128", dim: int = 32):
    """A parquet table -> (hashed int64 ids, float32 embeddings[:, :dim])."""
    seed = hash_feature_name_to_int(id_column)
    ids = hash_strings_to_long([str(v) for v in table[id_column]], seed, value_to_lower=False)
    embs = np.stack([np.asarray(e)[:dim] for e in table[emb_column]]).astype(np.float32)
    return ids, embs


def _batches(rng: np.random.RandomState, n: int, batch_size: int):
    """One epoch's batches of row positions in the JAX job's order. The last
    one is extended by its own first rows, as the JAX job extends it: to at
    most twice its length, not always to ``batch_size``."""
    order = rng.permutation(n)
    for b in range((n + batch_size - 1) // batch_size):
        sl = order[b * batch_size: (b + 1) * batch_size]
        if len(sl) < batch_size:
            sl = np.concatenate([sl, sl[: batch_size - len(sl)]])
        yield sl


def kshift_embed(table: torch.Tensor, ids: torch.Tensor, num_shifts: int) -> torch.Tensor:
    """KShiftEmbedding(normalize_output=True) in float32: the k rows summed
    and L2-normalized."""
    return l2_normalize(table[kshift_row_indices(ids, table.shape[0], num_shifts)].sum(dim=-2))


def train_reconstruction(
    ids: np.ndarray,
    embs: np.ndarray,
    expansion_factor: float = 1.15,
    k_shift: int = 16,
    num_epochs: int = 50,
    batch_size: int = 2**16,
    lr: float = 0.5,
    seed: int = 0,
    device="cuda",
    init: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """A KShift table fit by MSE to the L2-normalized targets. ``init``: the
    (rows, dim) starting table (by default normal, as flax's embedding
    initializer)."""
    device = resolve_device(device)
    n, dim = embs.shape
    num_rows = int(expansion_factor * n)
    target = l2_normalize(torch.from_numpy(np.asarray(embs, np.float32))).to(device)
    ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
    if init is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        table = torch.randn((num_rows, dim), generator=gen, device=device)
    else:
        table = torch.tensor(np.asarray(init, np.float32), device=device)
    params = {"embedding": table.requires_grad_()}
    opt = Adagrad(params, lr)
    rng = np.random.RandomState(seed)
    for epoch in range(num_epochs):
        last = None
        for sl in _batches(rng, n, batch_size):
            sl_t = torch.from_numpy(sl).to(device)
            pred = kshift_embed(params["embedding"], ids_t[sl_t], k_shift)
            loss = torch.mean((pred - target[sl_t]) ** 2)
            (g,) = torch.autograd.grad(loss, [params["embedding"]])
            opt.step(params, {"embedding": g})
            last = loss.detach()
        if epoch % max(1, num_epochs // 10) == 0:
            logger.info("recon epoch %d/%d loss %.5f", epoch, num_epochs, float(last))
    return {"emb_table": params["embedding"].detach().cpu().numpy()}


def train_mask_model(
    ids: np.ndarray,
    expansion_factor: float = 1.15,
    mask_emb_dim: int = 4,
    mask_hidden: int = 64,
    num_epochs: int = 20,
    batch_size: int = 2**15,
    lr: float = 0.5,
    seed: int = 1,
    device="cuda",
    init: Optional[Mapping[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """The known-vs-random id classifier: KShift(k=4) -> MLP -> sigmoid.
    Each batch of known ids meets as many random int64 ids. ``init``: the
    starting ``mask_*`` arrays (by default normal tables, weights over
    sqrt(fan-in), zero biases)."""
    device = resolve_device(device)
    n = len(ids)
    num_rows = int(expansion_factor * n)
    if init is None:
        gen = torch.Generator(device=device).manual_seed(seed)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=device)

        params = {
            "mask_table": normal(num_rows, mask_emb_dim),
            "mask_w1": normal(mask_emb_dim, mask_hidden) / np.sqrt(mask_emb_dim),
            "mask_b1": torch.zeros(mask_hidden, device=device),
            "mask_w2": normal(mask_hidden, 1) / np.sqrt(mask_hidden),
            "mask_b2": torch.zeros(1, device=device),
        }
    else:
        params = {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in init.items()}
    for p in params.values():
        p.requires_grad_()
    opt = Adagrad(params, lr)
    ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
    rng = np.random.RandomState(seed)
    for epoch in range(num_epochs):
        last = None
        for sl in _batches(rng, n, batch_size):
            # drawn after the epoch's permutation, from the same stream
            neg = rng.randint(-MAX_LONG, MAX_LONG - 1, size=batch_size, dtype=np.int64)
            x = torch.cat([ids_t[torch.from_numpy(sl).to(device)], torch.from_numpy(neg).to(device)])
            y = torch.cat([torch.ones(len(sl), device=device), torch.zeros(batch_size, device=device)])
            logits = mask_logits(x, params["mask_table"], params["mask_w1"], params["mask_b1"],
                                 params["mask_w2"], params["mask_b2"])
            # optax.sigmoid_binary_cross_entropy, in its log-sigmoid form
            loss = -torch.mean(y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits))
            grads = torch.autograd.grad(loss, list(params.values()))
            opt.step(params, dict(zip(params, grads)))
            last = loss.detach()
        if epoch % max(1, num_epochs // 5) == 0:
            logger.info("mask epoch %d/%d loss %.5f", epoch, num_epochs, float(last))
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def save_artifact(artifact: Mapping[str, np.ndarray], directory: str, meta: Optional[dict] = None) -> None:
    os.makedirs(directory, exist_ok=True)
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in artifact.items()},
               os.path.join(directory, ARTIFACT))
    if meta:
        with open(os.path.join(directory, META), "w") as f:
            json.dump(meta, f, indent=2)


def load_artifact(directory: str) -> Dict[str, np.ndarray]:
    tensors = torch.load(os.path.join(directory, ARTIFACT), map_location="cpu")
    return {k: v.numpy() for k, v in tensors.items()}


def execute(
    input_parquet: str,
    output_dir: str,
    dim: int = 32,
    expansion_factor: float = 1.15,
    k_shift: int = 16,
    recon_epochs: int = 50,
    mask_epochs: int = 20,
    device="cuda",
) -> Dict[str, float]:
    """Read, hash, train both parts, save; returns the seconds of each part."""
    import time

    from recommendations_tpu_torch.data.data_store import read_parquet_table

    t0 = time.perf_counter()
    ids, embs = massage_embeddings(read_parquet_table(input_parquet), dim=dim)
    logger.info("compressing %d embeddings dim=%d", len(ids), dim)
    t1 = time.perf_counter()
    artifact = train_reconstruction(ids, embs, expansion_factor, k_shift, num_epochs=recon_epochs, device=device)
    t2 = time.perf_counter()
    artifact.update(train_mask_model(ids, expansion_factor, num_epochs=mask_epochs, device=device))
    t3 = time.perf_counter()
    meta = {
        "num_embeddings": int(expansion_factor * len(ids)),
        "dim": dim,
        "num_shifts": k_shift,
        "normalize_output": True,
        "source": input_parquet,
    }
    save_artifact(artifact, output_dir, meta)
    logger.info("saved embedding module artifact to %s", output_dir)
    return {"read_s": t1 - t0, "reconstruction_s": t2 - t1, "mask_s": t3 - t2,
            "save_s": time.perf_counter() - t3}


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.INFO, force=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="parquet with product_id + emb_128")
    ap.add_argument("--output", required=True)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--expansion-factor", type=float, default=1.15)
    ap.add_argument("--k-shift", type=int, default=16)
    ap.add_argument("--recon-epochs", type=int, default=50)
    ap.add_argument("--mask-epochs", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = ap.parse_args()
    execute(a.input, a.output, a.dim, a.expansion_factor, a.k_shift, a.recon_epochs, a.mask_epochs, a.device)
