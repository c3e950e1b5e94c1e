"""Ranker model wrapper: the multi-task loss, its metrics, the optimizer
group and the scorer.

Port of ``recommendations_tpu/models/ranker/wrapper.py``. Per task, a
one-label task takes the sigmoid binary cross-entropy (optax's
``sigmoid_binary_cross_entropy``) and logs its AUC and positive rate; a
task of more labels the softmax cross-entropy with integer labels and logs
its accuracy. Each example weighs ``not _pad_mask`` (every example when the
batch has no pad mask); the loss is the tasks' weighted sum. Metrics go
under the JAX package's keys (``{train,val}_auc_<task>``, ``_pos_rate_``,
``_acc_``, ``_loss_<task>``, ``_loss``). Every parameter is in one AdamW
group, ``USE_OPTIM``, at the config's lr and weight decay (optax's adamw
defaults otherwise). Weights come from a seeded generator or, through
``load_jax_variables``, from the JAX package's variables.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from recommendations_tpu_torch import resolve_device
from recommendations_tpu_torch.models.base import BaseModelWrapper
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.ranker.config import RankerModelConfig
from recommendations_tpu_torch.models.ranker.metrics import binary_auc
from recommendations_tpu_torch.models.ranker.model import FactorizedDLRM
from recommendations_tpu_torch.parallel import collectives as col

MAIN_GROUP = "USE_OPTIM"

Metrics = Dict[str, torch.Tensor]


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's: -labels log sigmoid(x) - (1 - labels) log sigmoid(-x)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's: logsumexp(logits) - logits[label]."""
    label_logits = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


class RankerModelWrapper(BaseModelWrapper):
    """``device`` defaults to the card; without one it raises unless the
    caller passes ``device="cpu"``."""

    def __init__(self, config: RankerModelConfig, stats: Optional[Any] = None, device="cuda", seed: int = 0):
        self.config = config
        self.stats = stats
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.module = FactorizedDLRM(config, gen).eval()

    def load_jax_variables(self, variables: Mapping[str, Any]) -> None:
        """Load the JAX package's variables (nested dicts of numpy arrays)."""
        self.module.load_state_dict(state_dict_from_jax(dict(variables), self.module), strict=True)

    def format_inputs(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's numeric columns as tensors on the wrapper's device
        (string columns, which the model never reads, left out)."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype == object:
                continue
            out[k] = torch.as_tensor(v).to(self.device)
        return out

    @torch.no_grad()
    def forward(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return self.module(self.format_inputs(batch))

    def loss_and_metrics(
        self, batch: Mapping[str, Any], aux_state: Any, training: bool, **_step
    ) -> Tuple[torch.Tensor, Metrics, Any]:
        """(loss, metrics, aux_state). The training step's keywords (offsets,
        generator, taps, dropout_seed) are not used: the ranker draws
        nothing and has no table of its own.

        On a mesh (``bind_mesh``) the batch is this rank's rows of the
        global batch, and each mean is over the global batch, as JAX's one
        program computes it: the valid count is summed over ``data``, and
        the loss returned is this rank's rows' share of the global loss
        (the step sums the gradients over ``data``). The metrics are the
        global batch's: the sums over ``data``, and the AUC from the whole
        batch's logits, labels and mask gathered in row order."""
        inputs = self.format_inputs(batch)
        output = self.module(inputs)
        group = None if self.mesh is None else self.mesh.group("data")

        def total(x: torch.Tensor) -> torch.Tensor:
            """The sum over ``data`` of a detached value."""
            return x.detach() if group is None else col.all_reduce_(x.detach().clone(), group)

        prefix = "train" if training else "val"
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        metrics: Metrics = {}
        pad = inputs.get("_pad_mask")
        first = self.config.task_list[0].name
        w = (~pad.bool()).float() if pad is not None else torch.ones(output[first].shape[0], device=self.device)
        denom = torch.clamp_min(total(w.sum()), 1.0)
        for task in self.config.task_list:
            logits = output[task.name].float()
            labels = inputs[task.name].float()
            if task.num_labels == 1:
                logit = logits.reshape(-1)
                per_ex = sigmoid_binary_cross_entropy(logit, labels.reshape(-1))
                task_loss = (per_ex * w).sum() / denom
                with torch.no_grad():
                    gathered = [col.all_gather_tensor(x, group) for x in (logit.detach(), labels.reshape(-1), w)]
                    metrics[f"{prefix}_auc_{task.name}"] = binary_auc(*gathered[:2], valid=gathered[2] > 0)
                    metrics[f"{prefix}_pos_rate_{task.name}"] = total((labels.reshape(-1) * w).sum()) / denom
            else:
                ints = labels.to(torch.int32).reshape(-1).to(torch.int64)
                per_ex = softmax_cross_entropy_with_integer_labels(logits, ints)
                task_loss = (per_ex * w).sum() / denom
                with torch.no_grad():
                    acc = (torch.argmax(logits, -1) == ints).float()
                    metrics[f"{prefix}_acc_{task.name}"] = total((acc * w).sum()) / denom
            metrics[f"{prefix}_loss_{task.name}"] = total(task_loss)
            loss = loss + task.weight * task_loss
        metrics[f"{prefix}_loss"] = total(loss)
        return loss, metrics, aux_state

    def param_labels(self) -> Dict[str, str]:
        return {name: MAIN_GROUP for name, _ in self.module.named_parameters()}

    def optimizers_for_param_groups(self) -> Dict[str, Optional[dict]]:
        """``optax.adamw(lr, weight_decay=...)``: b1 0.9, b2 0.999, eps 1e-8."""
        cfg = self.config
        return {MAIN_GROUP: dict(lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)}

    def inference_models(self) -> Dict[str, Callable]:
        """'ranker_scorer': batch -> {task: the sigmoid of a one-label
        task's logit, the softmax of the others'}."""

        def ranker_scorer(batch):
            out = self.forward(batch)
            return {
                t.name: torch.sigmoid(out[t.name]) if t.num_labels == 1 else torch.softmax(out[t.name], dim=-1)
                for t in self.config.task_list
            }

        return {"ranker_scorer": ranker_scorer}
