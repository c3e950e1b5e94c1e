"""LTHM model wrapper: builds the encoder on a device and serves it.

Port of the serving half of ``recommendations_tpu/models/lthm/wrapper.py``:
``format_inputs``, ``forward`` and ``inference_models``. Weights come from a
seeded ``torch.Generator`` or, through ``load_jax_variables``, from the JAX
package's variables.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from recommendations_tpu_torch import resolve_device
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.lthm.model import LTHMEncoder
from recommendations_tpu_torch.nn.functional import l2_normalize


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
