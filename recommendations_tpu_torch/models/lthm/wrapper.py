"""LTHM model wrapper: builds the encoder on a device, serves it, and gives
the training step its loss and optimizer groups.

Port of ``recommendations_tpu/models/lthm/wrapper.py``: ``format_inputs``,
``forward`` and ``inference_models`` (serving); ``init_aux_state``,
``loss_and_metrics``, ``param_labels`` and ``optimizers_for_param_groups``
(training), and the table paths the training step takes for each
``table_optimizer``:

- ``frozen``: the table takes no gradient;
- ``adamw``: the table trains in the main AdamW group;
- ``rowwise_adam``: the table trains in its own group on ``RowwiseAdam``;
- ``lazy_rowwise_adam``: ``uses_lazy_table``; the step calls
  ``apply_lazy_table_update`` with the table's dense gradient;
- ``sparse_fused_adam``: ``uses_sparse_taps``; the table is the fused
  record, the step takes the gradient of ``make_taps`` and calls
  ``apply_sparse_table_update``.

Weights come from a seeded ``torch.Generator`` or, through
``load_jax_variables``, from the JAX package's variables; a pretrained
product-embedding module (``model_init_metadata``) loads its artifact at
construction.

``bind_mesh`` lays the model over a device mesh (``core/mesh.py``) as the
JAX wrapper's does: the encoder shards what ``partition_rules`` shards (the
table's rows over ``model``, the MoE stacks over ``expert``), the loss
reads the whole batch of the ``data`` group (``models/lthm/loss.py``), and
``param_grad_axes`` tells the strategy over which axes each parameter's
gradient is summed.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from recommendations_tpu_torch import resolve_device
from recommendations_tpu_torch.core.partitioning import P, PartitionRules
from recommendations_tpu_torch.core.spans import span
from recommendations_tpu_torch.models.base import BaseModelWrapper
from recommendations_tpu_torch.models.lthm.config import (
    TABLE_OPT_SPARSE_FUSED_MIN_ROWS,
    LTHMModelConfig,
)
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.lthm.loss import Metrics, contrastive_step
from recommendations_tpu_torch.models.lthm.model import LTHMEncoder
from recommendations_tpu_torch.models.lthm.pretrained import load_pretrained_constants
from recommendations_tpu_torch.nn.embeddings import kshift_row_indices
from recommendations_tpu_torch.nn.functional import l2_normalize
from recommendations_tpu_torch.nn.logq import LogQState, init_logq_state
from recommendations_tpu_torch.parallel import collectives as col
from recommendations_tpu_torch.train.sparse_table import (
    FusedTableState,
    init_lazy_row_state,
    lazy_rowwise_adam_update,
    sparse_fused_adam_update,
)

TABLE_GROUP = "EMB_TABLE"
MAIN_GROUP = "USE_OPTIM"
TABLE_PARAM = "product_emb_module.embedding"

log = logging.getLogger(__name__)


class LTHMAuxState(NamedTuple):
    logq: LogQState
    batch_idx: torch.Tensor  # float32 scalar batch counter


class LTHMModelWrapper(BaseModelWrapper):
    """``device`` defaults to the card; without one it raises unless the
    caller passes ``device="cpu"``."""

    def __init__(self, config: LTHMModelConfig, device="cuda", seed: int = 0):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.module = LTHMEncoder(config, gen).eval()
        meta = config.product_tower.model_init_metadata
        if meta is not None:
            # the trained compressed-embedding module into its frozen buffers
            # (the JAX wrapper's init_variables)
            from recommendations_tpu_torch.tools.embedding_module_gen import load_artifact

            load_pretrained_constants(self.module, load_artifact(meta.embedding_module_path))
        # the JAX wrapper's two warnings, in its words
        if (
            config.uses_fused_table()
            and config.product_tower.latent_model_config.vocab_size_latent
            < TABLE_OPT_SPARSE_FUSED_MIN_ROWS
        ):
            log.warning(
                "table_optimizer=sparse_fused_adam below ~2M rows: the dense "
                "rowwise_adam path measures faster at this size (1075 vs 986 "
                "ex/s at 1M on v5e, QUALITY.md round 4) — sparse wins only "
                "where dense table passes dominate (10M rows: 881 vs 722). "
                "table_optimizer: auto encodes the measured dispatch."
            )
        if config.table_optimizer == "sparse_fused_adam" and config.shard_embedding_rows:
            log.warning(
                "table_optimizer=sparse_fused_adam with "
                "shard_embedding_rows=True falls back to dense rowwise_adam "
                "co-sharded with the rows (the fused record path is "
                "single-device). Note the semantics differ: the dense path "
                "decays every row's moments each step, the fused path only "
                "touched rows'."
            )

    # ----- the mesh ------------------------------------------------------------

    def bind_mesh(self, mesh) -> None:
        """Lay the model over ``mesh``: each sharded parameter keeps this
        rank's block (call before building the optimizer)."""
        self.mesh = mesh
        self.module.bind_mesh(mesh)

    def partition_rules(self) -> PartitionRules:
        """The JAX wrapper's rules: the table's rows over ``model`` (with
        ``shard_embedding_rows``), the expert stacks and their biases over
        ``expert``, everything else replicated."""
        rules = []
        if self.config.shard_embedding_rows:
            rules.append((r".*product_emb_module/embedding", P("model", None)))
        rules.append((r".*moe_(fc|proj)/(w1|w2)", P("expert", None, None)))
        rules.append((r".*moe_(fc|proj)/(b1|b2)", P("expert", None)))
        rules.append((r".*", P()))
        return PartitionRules(rules)

    def sharded_params(self) -> Dict[str, str]:
        """Parameter name -> the mesh axis its first dimension is split over,
        for the parameters this rank holds a block of."""
        if self.mesh is None:
            return {}
        specs = self.partition_rules().tree_specs(dict(self.module.named_parameters()))
        return {k: spec[0] for k, spec in specs.items() if spec and spec[0] and self.mesh.size(spec[0]) > 1}

    def param_grad_axes(self) -> Dict[str, Tuple[str, ...]]:
        """Parameter name -> the mesh axes its gradient is summed over: every
        rank of the ``data`` axis holds other rows, and under
        ``sequence_parallel`` every rank of ``model`` another block of the
        sequence, whose share of the transformer's gradients it holds."""
        if self.mesh is None:
            return {}
        ring = self.module.query_tower.transformer.ring_group is not None
        return {
            name: ("data", "model") if ring and name.startswith("query_tower.transformer.") else ("data",)
            for name, _ in self.module.named_parameters()
        }

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's state with every sharded parameter gathered whole
        (a collective: every rank of the mesh calls it)."""
        sd = self.module.state_dict()
        for name, axis in self.sharded_params().items():
            sd[name] = col.all_gather_tensor(sd[name].detach(), self.mesh.group(axis))
        return sd

    def unbind_mesh(self) -> None:
        """Gather the sharded parameters and go back to one device's module
        (no ring, every expert, the dense table): what the export, the
        evaluation and the inference after training run on. A collective."""
        if self.mesh is None:
            return
        full = self.full_state_dict()
        module = LTHMEncoder(self.config, torch.Generator(device=self.device).manual_seed(0)).eval()
        module.load_state_dict(full)
        self.module, self.mesh = module, None

    def load_jax_variables(self, variables: Mapping[str, Any]) -> None:
        """Load the JAX package's variables (nested dicts of numpy arrays)."""
        sd = state_dict_from_jax(dict(variables), self.module)
        self.module.load_state_dict(sd, strict=True)

    def format_inputs(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Tensors on the wrapper's device; the id key must hold integers."""
        with span("lthm/inputs"):
            out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
            key = self.module.ids_key
            ids = out[key]
            if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.dtype == torch.bool:
                raise TypeError(f"{key} expected int64, got {ids.dtype}")
            out[key] = ids.to(torch.int64)
            return out

    @torch.no_grad()
    def forward(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        inputs = self.format_inputs(batch)
        with span("lthm/forward"):
            return self.module(inputs)

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
        taps: Optional[Dict[str, torch.Tensor]] = None,
        dropout_seed: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Metrics, LTHMAuxState]:
        """Forward (with autograd) and the contrastive loss: (loss, metrics
        under the JAX package's keys, new aux state). ``offsets`` overrides
        the draw of the lookahead offsets from ``generator``; ``taps`` are
        ``make_taps``'s, on the fused-record table. The training forward
        draws its dropout masks from ``dropout_seed`` (the step's forward
        key; ``generator`` is its loss key, JAX's ``fwd_rng, loss_rng``);
        serving and validation apply no dropout."""
        cfg = self.config
        data_group = None if self.mesh is None else self.mesh.group("data")
        inputs = self.format_inputs(batch)
        rows = inputs[self.module.ids_key].shape[0]
        batch_shard = None
        if data_group is not None:
            batch_shard = (col.group_rank(data_group) * rows, col.group_size(data_group) * rows)
        with span("lthm/forward"):
            output = self.module(inputs, training=training, taps=taps,
                                 dropout_seed=dropout_seed if training else None, batch_shard=batch_shard)
        with span("lthm/loss"):
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
                data_group=data_group,
            )
        overflow = getattr(self.module.product_emb_module, "overflow", None)
        if overflow is not None:
            # dropped all-to-all requests come back as zero rows: alarm on any
            metrics["embedding_alltoall_overflow"] = overflow
        new_aux = LTHMAuxState(
            logq=new_logq, batch_idx=aux_state.batch_idx + (1.0 if training else 0.0)
        )
        return loss, metrics, new_aux

    # ----- the table's optimizer ---------------------------------------------

    def _uses_rowwise_table(self) -> bool:
        """The table is its own group (every table optimizer but adamw); a
        pretrained module has no table parameter."""
        cfg = self.config
        return cfg.resolved_table_optimizer() != "adamw" and cfg.product_tower.model_init_metadata is None

    def uses_sparse_taps(self) -> bool:
        """The fused-record table: the step takes the gradient of
        ``make_taps`` and calls ``apply_sparse_table_update``."""
        return self.config.uses_fused_table()

    def uses_lazy_table(self) -> bool:
        """Lazy rowwise Adam: the step calls ``apply_lazy_table_update``."""
        cfg = self.config
        return (
            cfg.resolved_table_optimizer() == "lazy_rowwise_adam"
            and cfg.product_tower.model_init_metadata is None
            and not cfg.shard_embedding_rows
        )

    def _table(self) -> torch.nn.Parameter:
        return self.module.product_emb_module.embedding

    def lazy_table(self) -> Optional[torch.nn.Parameter]:
        return self._table() if self.uses_lazy_table() else None

    def _row_indices(self, batch: Mapping[str, Any]) -> torch.Tensor:
        lm = self.config.product_tower.latent_model_config
        ids = self.format_inputs({self.module.ids_key: batch[self.module.ids_key]})[self.module.ids_key]
        return kshift_row_indices(ids, lm.vocab_size_latent, lm.num_shifts_latent)

    def make_taps(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Zero perturbations of the gathered rows, (B, S, k, d) in the
        compute dtype, that require a gradient: their gradient is the
        per-(token, shift) row cotangent that replaces a dense table
        gradient."""
        cfg = self.config
        ids = torch.as_tensor(batch[self.module.ids_key])
        k = cfg.product_tower.latent_model_config.num_shifts_latent
        d = cfg.product_tower.inp_emb_dim
        rows = torch.zeros((*ids.shape, k, d), dtype=getattr(torch, cfg.compute_dtype), device=self.device)
        return {"product_emb_rows": rows.requires_grad_()}

    def init_table_state(self):
        """The fused or lazy table's update state; None on the other paths."""
        if self.uses_sparse_taps():
            return FusedTableState(count=torch.zeros((), dtype=torch.int32, device=self.device))
        if self.uses_lazy_table():
            return init_lazy_row_state(self._table().detach())
        return None

    def apply_sparse_table_update(self, tap_grads, table_state, batch):
        """Rowwise Adam on the fused record's touched rows, in place:
        (new table state, rows_nan)."""
        cfg = self.config
        g = tap_grads["product_emb_rows"]
        rows = self._row_indices(batch).reshape(-1)
        g = g.reshape(-1, g.shape[-1])
        if self.mesh is not None:
            # every rank's (row, gradient) pairs in the whole batch's order:
            # the update sums each row's in the one process's order
            rows = col.all_gather_tensor(rows, self.mesh.group("data"))
            g = col.all_gather_tensor(g, self.mesh.group("data"))
        return sparse_fused_adam_update(
            self._table().data,
            rows,
            g,
            table_state,
            learning_rate=cfg.lr,
            b1=cfg.betas[0],
            b2=cfg.betas[1],
        )

    def apply_lazy_table_update(self, grad: torch.Tensor, table_state, batch):
        """Lazy rowwise Adam on the rows ``grad`` touches (the table's
        gradient before clipping), in place: the new table state. Its
        capacity is the batch's (token, shift) count."""
        cfg = self.config
        ids = batch[self.module.ids_key]
        capacity = int(torch.as_tensor(ids).numel()) * cfg.product_tower.latent_model_config.num_shifts_latent
        return lazy_rowwise_adam_update(
            self._table().data, grad, table_state,
            learning_rate=cfg.lr, capacity=capacity, b1=cfg.betas[0], b2=cfg.betas[1],
        )

    def nan_check_params(self) -> Dict[str, torch.Tensor]:
        """The parameters the step's ``params_nan`` covers: all but the fused
        record, whose written rows ``apply_sparse_table_update`` checks."""
        params = dict(self.module.named_parameters())
        if self.uses_sparse_taps():
            del params[TABLE_PARAM]
        return params

    def param_labels(self) -> Dict[str, str]:
        """Parameter name -> optimizer group: the product-embedding table is
        its own group, but with ``adamw`` everything is the main group."""
        rowwise = self._uses_rowwise_table()
        return {
            name: TABLE_GROUP if rowwise and name.split(".")[0] == "product_emb_module" else MAIN_GROUP
            for name, _ in self.module.named_parameters()
        }

    def optimizers_for_param_groups(self) -> Dict[str, Optional[dict]]:
        """Group -> optimizer settings, or None for a group the optimizer
        does not step (the JAX package's ``optax.set_to_zero``): the frozen
        table, and the lazy and fused tables, which the step updates itself.
        Behind ``detach_item_tower`` the table takes ``requires_grad=False``.
        ``rowwise_adam`` runs ``RowwiseAdam`` on the table."""
        cfg = self.config
        t = cfg.resolved_table_optimizer()
        groups: Dict[str, Optional[dict]] = {
            MAIN_GROUP: dict(
                lr=cfg.lr, betas=tuple(cfg.betas), eps=1e-8, weight_decay=cfg.weight_decay
            ),
        }
        if t == "frozen" or self.uses_lazy_table() or self.uses_sparse_taps():
            groups[TABLE_GROUP] = None
            if cfg.product_tower.detach_item_tower and self._uses_rowwise_table():
                # no gradient reaches it: none is taken
                self._table().requires_grad_(False)
        elif self._uses_rowwise_table():
            # rowwise_adam, and a row-sharded table under lazy_rowwise_adam or
            # sparse_fused_adam (the JAX wrapper's dense fallback)
            groups[TABLE_GROUP] = dict(optimizer="rowwise_adam", lr=cfg.lr, betas=tuple(cfg.betas), eps=1e-8)
        return groups

    def inference_models(self) -> Dict[str, Callable]:
        """Serving entry points:
        - 'user_encoder': batch -> {'user_emb': (B, product_emb_dim)}, the
          L2-normalized lookahead-0 query of the last position, which a
          vector index is queried with;
        - 'sequence_encoder': the full forward."""

        def user_encoder(batch):
            with span("lthm/serve"):
                out = self.forward(batch)
                return {"user_emb": l2_normalize(out["next_token_emb"][:, -1, 0, :])}

        def sequence_encoder(batch):
            return self.forward(batch)

        return {"user_encoder": user_encoder, "sequence_encoder": sequence_encoder}
