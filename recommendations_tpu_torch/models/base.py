"""The model contract the trainer calls.

Port of ``recommendations_tpu/models/base.py``. A wrapper holds its module
(parameters and buffers) on its device and offers the training step, the
strategy and the export these calls, each with the default the JAX
strategy falls back to where a wrapper lacks the hook
(``train/strategy.py``'s ``getattr``/``hasattr`` calls):

- ``loss_and_metrics(batch, aux_state, training, **step)``: the forward
  with autograd and the loss: (loss, metrics, new aux state). The step
  passes ``offsets``, ``generator``, ``taps`` and ``dropout_seed`` as
  keywords; a wrapper takes those it uses and ignores the rest;
- ``init_aux_state``: the state threaded through the steps beside the
  parameters (None);
- ``draw_offsets(generator)``: the step's draw of the loss's host inputs
  from the state's ``generator``, passed back as ``offsets`` (None: the
  loss draws nothing);
- the table hooks: no sparse taps, no lazy table, no table state;
- ``nan_check_params``: the parameters the step's ``params_nan`` covers
  (every one);
- ``param_labels`` and ``optimizers_for_param_groups``: every parameter in
  ``DEFAULT_OPTIM_GROUP``, which no group claims, so the trainer config's
  optimizer steps it;
- the mesh hooks: ``bind_mesh`` keeps the mesh, and every parameter is
  replicated over it (the JAX package's ``REPLICATED`` partition rules):
  ``sharded_params`` is empty, ``param_grad_axes`` sums every gradient
  over ``data`` and ``unbind_mesh`` drops the mesh. A wrapper that shards
  parameters (LTHM) overrides them; one whose loss is a mean over the
  global batch (the ranker) also reads ``mesh`` in its loss;
- ``inference_models``: the serving entry points by name ({}).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

DEFAULT_OPTIM_GROUP = "DEFAULT_OPTIM_GROUP"


class BaseModelWrapper(abc.ABC):
    module: torch.nn.Module
    device: torch.device
    mesh = None  # the ``core.mesh.Mesh`` bound by ``bind_mesh``

    @abc.abstractmethod
    def loss_and_metrics(self, batch: Mapping[str, Any], aux_state: Any, training: bool, **step):
        """(loss, metrics, new aux state)."""

    def init_aux_state(self) -> Any:
        return None

    def draw_offsets(self, generator: torch.Generator) -> Optional[torch.Tensor]:
        return None

    # ----- the table hooks of the training step ------------------------------

    def uses_sparse_taps(self) -> bool:
        return False

    def uses_lazy_table(self) -> bool:
        return False

    def lazy_table(self) -> Optional[torch.nn.Parameter]:
        """The parameter whose gradient ``apply_lazy_table_update`` takes."""
        return None

    def init_table_state(self) -> Any:
        return None

    def nan_check_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_parameters())

    # ----- the optimizer hooks -------------------------------------------------

    def param_labels(self) -> Dict[str, str]:
        return {name: DEFAULT_OPTIM_GROUP for name, _ in self.module.named_parameters()}

    def optimizers_for_param_groups(self) -> Optional[Dict[str, Optional[dict]]]:
        """Group -> optimizer settings; None: the trainer config's optimizer."""
        return None

    # ----- the mesh --------------------------------------------------------------

    def bind_mesh(self, mesh) -> None:
        self.mesh = mesh

    def sharded_params(self) -> Dict[str, str]:
        """Parameter name -> the mesh axis its rows are split over: none."""
        return {}

    def param_grad_axes(self) -> Dict[str, Tuple[str, ...]]:
        """Parameter name -> the mesh axes its gradient is summed over: each
        rank of ``data`` holds other rows of the batch."""
        if self.mesh is None:
            return {}
        return {name: ("data",) for name, _ in self.module.named_parameters()}

    def unbind_mesh(self) -> None:
        self.mesh = None

    # ----- export --------------------------------------------------------------

    def inference_models(self) -> Dict[str, Callable]:
        return {}
