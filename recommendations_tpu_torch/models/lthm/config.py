"""LTHM model config as dataclasses.

Port of ``recommendations_tpu/models/lthm/config.py``: the same field names
and defaults, and ``from_dict`` takes the same nested dict the JAX config
takes. ``features`` is the feature schema (``features/feature_config.py``);
the config is registered under (lthm, lthm) for the pipeline config.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union

import numpy as np

from recommendations_tpu_torch.config.base import build_fields
from recommendations_tpu_torch.config.model_config import ModelConfig, register_model_config
from recommendations_tpu_torch.config.trainer_config import FileSystemConfig
from recommendations_tpu_torch.features.feature_config import FeaturesConfig
from recommendations_tpu_torch.features.transforms import Table, take_rows

# The JAX package's table-optimizer thresholds, kept at its values: moving
# either changes which rows' moments decay, so the trained model, and not
# only its speed (train/sparse_table.py).
TABLE_OPT_SPARSE_FUSED_MIN_ROWS = 2_000_000
TABLE_OPT_LAZY_MAX_ROWS = 5_000_000
TABLE_OPTIMIZERS = (
    "auto", "rowwise_adam", "lazy_rowwise_adam", "sparse_fused_adam", "adamw", "frozen",
)


def _build(cls, value):
    """A dataclass from a dict, its fields coerced by their annotations as
    pydantic coerces the JAX config's (YAML reads ``1e-4`` as a string), or
    the value itself when it is already one. Unknown fields are an error."""
    if value is None or isinstance(value, cls):
        return value
    if not isinstance(value, dict):
        raise TypeError(f"{cls.__name__} expects a dict, got {type(value).__name__}")
    return build_fields(cls, value, extra="forbid")


@dataclass
class CosineLSHSpec:
    num_bins: int
    num_proj: int


@dataclass
class LatentModelConfig:
    vocab_size_latent: int = 2**20
    num_shifts_latent: int = 8
    normalize_embedding: bool = False


@dataclass
class ModelInitMetadata:
    """Where the pretrained product-embedding module's artifact lies (the
    output of ``tools/embedding_module_gen.py``)."""

    embedding_module_path: str
    filesystem_config: Optional[FileSystemConfig] = None


@dataclass
class ProductTowerConfig:
    inp_emb_dim: int = 32
    out_emb_dim: int = 512
    product_emb_dim: int = 128
    item_emb_dim: Optional[int] = None
    detach_item_tower: bool = True
    norm_threshold: float = 0.05
    norm_bins: int = 20
    cosine_lsh_config: List[CosineLSHSpec] = field(default_factory=list)
    model_init_metadata: Optional[ModelInitMetadata] = None
    latent_model_config: LatentModelConfig = field(default_factory=LatentModelConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "ProductTowerConfig":
        d = dict(d)
        # the reference YAML calls it item_emb_dim; code reads product_emb_dim
        if d.get("item_emb_dim") is not None and "product_emb_dim" not in d:
            d["product_emb_dim"] = d["item_emb_dim"]
        # "???" is hydra's missing-value sentinel
        if d.get("model_init_metadata") in ("???", {}, ""):
            d["model_init_metadata"] = None
        d["model_init_metadata"] = _build(ModelInitMetadata, d.get("model_init_metadata"))
        d["cosine_lsh_config"] = [_build(CosineLSHSpec, s) for s in d.get("cosine_lsh_config", [])]
        if "latent_model_config" in d:
            d["latent_model_config"] = _build(LatentModelConfig, d["latent_model_config"])
        return _build(cls, d)


@dataclass
class LogQConfig:
    num_buckets: int = 2**24
    hash_offsets: List[int] = field(default_factory=lambda: [0])
    alpha: float = 0.05
    p_init: float = 0.01
    beta: float = 0.0


@dataclass
class PositionBiasConfig:
    context_window: int


@dataclass
class SelfAttentionConfig:
    attn_dropout: float = 0.1
    bias: bool = True
    dropout: float = 0.1
    n_head: int = 12
    n_embd: int = 768
    pos_bias: Optional[PositionBiasConfig] = None
    attn_type: str = "multi_head"  # 'multi_head' | 'multi_query'

    @classmethod
    def from_dict(cls, d: dict) -> "SelfAttentionConfig":
        d = dict(d)
        d["pos_bias"] = _build(PositionBiasConfig, d.get("pos_bias"))
        return _build(cls, d)


@dataclass
class MoEConfig:
    num_experts: int
    proj_features: int
    ff_mult_factor: float
    gate_sizes: Optional[Tuple[int, ...]] = None
    top_k: Optional[int] = None


@dataclass
class MLPConfig:
    ff_mult: float


@dataclass
class TransformerConfig:
    rotator_config: Any  # MoEConfig | MLPConfig | {'ff_mult': f} | float | an MoE dict, flat or under 'moe'
    attn_config: SelfAttentionConfig
    is_causal: bool = False
    max_block_size: Optional[int] = None
    is_sparse_attn: bool = False
    sparsity_factor: float = 0.5
    enable_gradient_checkpointing: bool = False
    remat_policy: str = "dots_no_batch"
    use_flash_attention: bool = False
    sequence_parallel: bool = False
    dropout: float = 0.0
    num_layers: int = 2

    @classmethod
    def from_dict(cls, d: dict) -> "TransformerConfig":
        d = dict(d)
        d["attn_config"] = SelfAttentionConfig.from_dict(d["attn_config"])
        return _build(cls, d)

    @property
    def width(self) -> int:
        return self.attn_config.n_embd

    def rotator(self):
        """``rotator_config`` as the block takes it: the MLP hidden
        multiplier (a float) or an ``MoESpec``, read as the JAX package
        reads it; anything else is the default multiplier 4."""
        from recommendations_tpu_torch.nn.transformer import MoESpec

        rc = self.rotator_config
        if isinstance(rc, (int, float)):
            return float(rc)
        if isinstance(rc, MLPConfig):
            return float(rc.ff_mult)
        if isinstance(rc, MoEConfig):
            rc = dataclasses.asdict(rc)
        if isinstance(rc, dict):
            if "ff_mult" in rc:
                return float(rc["ff_mult"])
            moe = rc.get("moe", rc)
            if "num_experts" in moe:
                return MoESpec(
                    num_experts=moe["num_experts"],
                    proj_features=moe["proj_features"],
                    ff_mult_factor=moe["ff_mult_factor"],
                    gate_sizes=tuple(moe.get("gate_sizes") or ()),
                    top_k=moe.get("top_k"),
                )
        return 4.0


LFM2_BACKBONES = ("lfm2_moe",)
LFM2_LAYER_TYPES = ("conv", "full_attention")


@dataclass
class LFM2MoEConfig:
    """``transformer_config`` with ``backbone: lfm2_moe``: LFM2-8B-A1B's
    hybrid stack (``nn/lfm2.py``) under the keys of its ``config.json``
    (``model_type`` lfm2_moe). ``layer_types`` gives the depth (and
    ``num_hidden_layers``, when given, must agree); the first
    ``num_dense_layers`` layers take the dense SwiGLU of
    ``intermediate_size``, the others ``num_experts`` routed experts of
    ``moe_intermediate_size``, ``num_experts_per_tok`` a token. The routing
    takes the published values only: it always uses the expert bias
    (``use_expert_bias`` true) and weighs the chosen experts by their scores
    over their sum (``norm_topk_prob`` true, ``routed_scaling_factor`` 1);
    the convolution has no bias."""

    backbone: str
    hidden_size: int
    num_attention_heads: int
    num_key_value_heads: int
    intermediate_size: int
    moe_intermediate_size: int
    num_experts: int
    num_experts_per_tok: int
    num_dense_layers: int
    layer_types: List[str]
    num_hidden_layers: Optional[int] = None
    conv_L_cache: int = 3
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    use_expert_bias: bool = True
    enable_gradient_checkpointing: bool = False
    remat_policy: str = "dots_no_batch"

    sequence_parallel = False  # not a field: the stack has no ring

    def __post_init__(self):
        if self.backbone not in LFM2_BACKBONES:
            raise ValueError(f"backbone {self.backbone!r} not in {LFM2_BACKBONES}")
        bad = sorted(set(self.layer_types) - set(LFM2_LAYER_TYPES))
        if bad:
            raise ValueError(f"layer_types {bad} not in {LFM2_LAYER_TYPES}")
        if self.num_hidden_layers is not None and self.num_hidden_layers != len(self.layer_types):
            raise ValueError(f"num_hidden_layers {self.num_hidden_layers} != {len(self.layer_types)} layer_types")
        if not self.use_expert_bias:
            raise NotImplementedError("use_expert_bias false: the routed MoE always reads its expert bias")
        if not self.norm_topk_prob or self.routed_scaling_factor != 1:
            raise NotImplementedError(
                f"norm_topk_prob {self.norm_topk_prob}, routed_scaling_factor {self.routed_scaling_factor}: "
                "the routed MoE weighs the chosen experts by their scores over their sum, unscaled")

    @classmethod
    def from_dict(cls, d: dict) -> "LFM2MoEConfig":
        return _build(cls, dict(d))

    @property
    def width(self) -> int:
        return self.hidden_size


@register_model_config
@dataclass
class LTHMModelConfig(ModelConfig):
    transformer_config: Union[TransformerConfig, LFM2MoEConfig]
    features: FeaturesConfig = field(default_factory=FeaturesConfig)
    kind: str = "lthm"
    type: str = "lthm_seq"
    name: str = "lthm"
    version: str = "v1"
    tasks: Optional[list] = None
    sparse: bool = False
    loss_type: str = "contrastive"
    log_q_config: LogQConfig = field(default_factory=LogQConfig)
    n_labels: int = 5
    lookahead: List[int] = field(default_factory=lambda: [0, 5, 6, 12, 24, 30])
    detach_input_for_loss_calc: bool = False
    softmax_temperature: float = 0.05
    metrics_k_all: List[int] = field(default_factory=lambda: [1, 5, 20, 50])
    context_width: int = 150
    lr: float = 6e-4
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.95)
    train_mini_batch_size: int = -1
    min_history_size: int = 1
    product_tower: ProductTowerConfig = field(default_factory=ProductTowerConfig)
    use_only_updated_data: bool = False
    knn_eval: bool = False
    compute_dtype: str = "bfloat16"
    shard_embedding_rows: bool = False
    embedding_lookup_schedule: str = "alltoall"
    table_optimizer: str = "auto"
    fused_ce: bool = False

    def __post_init__(self):
        if self.table_optimizer not in TABLE_OPTIMIZERS:
            raise ValueError(f"table_optimizer {self.table_optimizer!r} not in {TABLE_OPTIMIZERS}")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r} not in ('bfloat16', 'float32')")
        rows = self.product_tower.latent_model_config.vocab_size_latent
        if self.table_optimizer == "lazy_rowwise_adam" and rows >= TABLE_OPT_LAZY_MAX_ROWS:
            # the JAX package's gate and text (its scan is a nonzero over V)
            raise ValueError(
                "table_optimizer=lazy_rowwise_adam at "
                f"{rows} "
                f"rows (>= {TABLE_OPT_LAZY_MAX_ROWS}): its nonzero-over-V "
                "touched-row scan measures 969 ms/step at 10M rows on v5e. "
                "Use table_optimizer: auto (resolves to sparse_fused_adam at "
                "this size) or sparse_fused_adam explicitly."
            )

    @classmethod
    def from_dict(cls, d: dict) -> "LTHMModelConfig":
        d = dict(d)
        tc = d["transformer_config"]
        # a ``backbone`` key selects LFM2's stack; without one, the LTHM stack
        backbone = LFM2MoEConfig if isinstance(tc, dict) and "backbone" in tc else TransformerConfig
        d["transformer_config"] = backbone.from_dict(tc)
        if "product_tower" in d:
            d["product_tower"] = ProductTowerConfig.from_dict(d["product_tower"])
        if "log_q_config" in d:
            d["log_q_config"] = _build(LogQConfig, d["log_q_config"])
        if "betas" in d:
            d["betas"] = tuple(d["betas"])
        if isinstance(d.get("features"), dict):
            d["features"] = FeaturesConfig.from_dict(d["features"])
        return _build(cls, d)

    def get_builder(self, stats: Any = None, device="cuda"):
        from recommendations_tpu_torch.models.lthm.builder import LTHMModelBuilder

        return LTHMModelBuilder(stats, self, device=device)

    def custom_data_preprocessor(self, table: Table, kind: str = "train") -> Table:
        """Drop users with fewer than ``min_history_size`` real (nonzero)
        events in the first history feature, as the JAX package does."""
        hist = self.features.categorical_history_features
        if self.min_history_size <= 0 or not hist or hist[0].name not in table:
            return table
        counts = np.array([np.count_nonzero(np.asarray(h)) for h in table[hist[0].name]])
        return take_rows(table, counts >= self.min_history_size)

    @property
    def emb_dim(self) -> int:
        return self.transformer_config.width

    @property
    def export_tokens(self) -> int:
        return len(self.lookahead)

    @property
    def export_span(self) -> int:
        """The positions an exported query spans: the farthest lookahead + 1."""
        return max(self.lookahead) + 1

    def resolved_table_optimizer(self) -> str:
        """'auto' resolved as the JAX package resolves it."""
        t = self.table_optimizer
        if t != "auto":
            return t
        pt = self.product_tower
        if pt.detach_item_tower or pt.model_init_metadata is not None:
            return "frozen"
        if self.shard_embedding_rows:
            return "rowwise_adam"
        if pt.latent_model_config.vocab_size_latent >= TABLE_OPT_SPARSE_FUSED_MIN_ROWS:
            return "sparse_fused_adam"
        return "rowwise_adam"

    def uses_fused_table(self) -> bool:
        return (
            self.resolved_table_optimizer() == "sparse_fused_adam"
            and self.product_tower.model_init_metadata is None
            and not self.shard_embedding_rows
        )
