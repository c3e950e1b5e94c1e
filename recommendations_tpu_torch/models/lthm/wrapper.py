"""LTHM model wrapper: builds the encoder on a device, serves it, and gives
the training step its loss and optimizer groups.

Port of ``recommendations_tpu/models/lthm/wrapper.py``: ``format_inputs``,
``forward`` and ``inference_models`` (serving); ``init_aux_state``,
``loss_and_metrics``, ``param_labels`` and ``optimizers_for_param_groups``
(training, with a frozen product-embedding table). Weights come from a seeded
``torch.Generator`` or, through ``load_jax_variables``, from the JAX
package's variables.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from recommendations_tpu_torch import resolve_device
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.lthm.loss import Metrics, contrastive_step
from recommendations_tpu_torch.models.lthm.model import LTHMEncoder
from recommendations_tpu_torch.nn.functional import l2_normalize
from recommendations_tpu_torch.nn.logq import LogQState, init_logq_state

TABLE_GROUP = "EMB_TABLE"
MAIN_GROUP = "USE_OPTIM"


class LTHMAuxState(NamedTuple):
    logq: LogQState
    batch_idx: torch.Tensor  # float32 scalar batch counter




class LTHMModelWrapper:
    """``device`` defaults to the card; without one it raises unless the
    caller passes ``device="cpu"``."""

    def __init__(self, config: LTHMModelConfig, device="cuda", seed: int = 0):
        self.config = config
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.module = LTHMEncoder(config, gen).eval()

    def load_jax_variables(self, variables: Mapping[str, Any]) -> None:
        """Load the JAX package's variables (nested dicts of numpy arrays)."""
        sd = state_dict_from_jax(dict(variables), self.module)
        self.module.load_state_dict(sd, strict=True)

    def format_inputs(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Tensors on the wrapper's device; the id key must hold integers."""
        out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        key = self.module.ids_key
        ids = out[key]
        if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.dtype == torch.bool:
            raise TypeError(f"{key} expected int64, got {ids.dtype}")
        out[key] = ids.to(torch.int64)
        return out

    @torch.no_grad()
    def forward(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return self.module(self.format_inputs(batch))

    # ----- training ----------------------------------------------------------

    def init_aux_state(self) -> LTHMAuxState:
        lq = self.config.log_q_config
        return LTHMAuxState(
            logq=init_logq_state(lq.num_buckets, lq.hash_offsets, lq.p_init, self.device),
            batch_idx=torch.zeros((), dtype=torch.float32, device=self.device),
        )

    def loss_and_metrics(
        self,
        batch: Mapping[str, Any],
        aux_state: LTHMAuxState,
        training: bool,
        offsets=None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Metrics, LTHMAuxState]:
        """Forward (with autograd) and the contrastive loss: (loss, metrics
        under the JAX package's keys, new aux state). ``offsets`` overrides
        the draw of the lookahead offsets from ``generator``."""
        cfg = self.config
        with record_function("lthm/forward"):
            output = self.module(self.format_inputs(batch), training=training)
        with record_function("lthm/loss"):
            loss, metrics, new_logq = contrastive_step(
                output,
                aux_state.logq,
                aux_state.batch_idx,
                lookahead=list(cfg.lookahead),
                temperature=cfg.softmax_temperature,
                beta=cfg.log_q_config.beta,
                alpha=cfg.log_q_config.alpha,
                metrics_k_all=list(cfg.metrics_k_all),
                train_mini_batch_size=cfg.train_mini_batch_size,
                training=training,
                fused_ce=cfg.fused_ce,
                offsets=offsets,
                generator=generator,
            )
        new_aux = LTHMAuxState(
            logq=new_logq, batch_idx=aux_state.batch_idx + (1.0 if training else 0.0)
        )
        return loss, metrics, new_aux

    def param_labels(self) -> Dict[str, str]:
        """Parameter name -> optimizer group: the product-embedding table is
        its own group, everything else the main AdamW group."""
        return {
            name: TABLE_GROUP if name.split(".")[0] == "product_emb_module" else MAIN_GROUP
            for name, _ in self.module.named_parameters()
        }

    def optimizers_for_param_groups(self) -> Dict[str, Optional[dict]]:
        """Group -> AdamW settings, or None for a group that does not train.
        The frozen table takes ``requires_grad=False`` (the JAX package's
        ``optax.set_to_zero``); other table optimizers raise."""
        cfg = self.config
        t = cfg.resolved_table_optimizer()
        if t != "frozen":
            raise NotImplementedError(
                f"table_optimizer {t!r}: ROADMAP, port queue items 4 (rowwise_adam) and 8 "
                "(lazy and sparse tables); the port trains with table_optimizer 'frozen'"
            )
        self.module.product_emb_module.embedding.requires_grad_(False)
        return {
            MAIN_GROUP: dict(
                lr=cfg.lr, betas=tuple(cfg.betas), eps=1e-8, weight_decay=cfg.weight_decay
            ),
            TABLE_GROUP: None,
        }

    def inference_models(self) -> Dict[str, Callable]:
        """Serving entry points:
        - 'user_encoder': batch -> {'user_emb': (B, product_emb_dim)}, the
          L2-normalized lookahead-0 query of the last position, which a
          vector index is queried with;
        - 'sequence_encoder': the full forward."""

        def user_encoder(batch):
            out = self.forward(batch)
            return {"user_emb": l2_normalize(out["next_token_emb"][:, -1, 0, :])}

        def sequence_encoder(batch):
            return self.forward(batch)

        return {"user_encoder": user_encoder, "sequence_encoder": sequence_encoder}
