"""Declarative feature schema, compiled into host-side table transforms.

Port of ``recommendations_tpu/features/feature_config.py`` as dataclasses:
the ten feature kinds and ``Task``, the per-kind defaults cascade, the
registries keyed by ``kind`` (features, value mappers and sources), and the
compilation of an ordered list of transforms (NA fixing, then rename or
copy, then value transforms, then history handling) that
``default_data_mapper`` applies to a table of numpy columns
(``features/transforms.py``).
"""

from __future__ import annotations

import enum
import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from recommendations_tpu_torch.config.base import build_fields
from recommendations_tpu_torch.features import transforms
from recommendations_tpu_torch.features.transforms import Table, to_str_column


def _registered(registry: Dict[str, type], kind_field: str = "kind"):
    """Class decorator: enter a dataclass in ``registry`` under the default
    of its kind field."""

    def deco(cls):
        kind = cls.__dataclass_fields__[kind_field].default
        registry[kind.value if isinstance(kind, enum.Enum) else kind] = cls
        return cls

    return deco


def _dispatch(registry: Dict[str, type], value):
    """A dict becomes the registered class of its ``kind``, as the JAX
    package's ``dispatch`` classmethods."""
    if isinstance(value, dict):
        kind = value.get("kind")
        sub = registry.get(kind.value if isinstance(kind, enum.Enum) else kind)
        if sub is not None:
            return build_fields(sub, value)
    return value


@dataclass
class EmbeddingTable:
    num_embeddings: int
    emb_dim: int
    use_qr: bool = False


MAPPERS: Dict[str, type] = {}


@dataclass
class CategoricalValueToNumberMapper:
    kind: str

    @classmethod
    def from_dict(cls, d):
        return _dispatch(MAPPERS, d)


@_registered(MAPPERS)
@dataclass
class XXHashMapper(CategoricalValueToNumberMapper):
    kind: str = "xxhash"


@_registered(MAPPERS)
@dataclass
class NoneMapper(CategoricalValueToNumberMapper):
    kind: str = "none"


# ----- per-kind defaults ----------------------------------------------------


@dataclass
class NumericalFeaturesDefaults:
    embed_feature: Optional[bool] = None


@dataclass
class CategoricalFeaturesDefaults:
    embedding: Optional[EmbeddingTable] = None
    proj_dim: Optional[int] = None
    value_to_number_mapper: Optional[CategoricalValueToNumberMapper] = None
    default_dtype: Optional[str] = None
    transform_value_to_lowercase: Optional[bool] = True


@dataclass
class CategoricalHistoryFeatureDefaults(CategoricalFeaturesDefaults):
    pass


@dataclass
class TensorFeaturesDefaults:
    emb_dim: Optional[int] = None


@dataclass
class TensorListFeaturesDefaults:
    shape: Optional[Tuple[int, ...]] = None


@dataclass
class BoolFeaturesDefaults:
    emb_dim: Optional[int] = None


@dataclass
class TimestampFeaturesDefaults:
    emb_dim: Optional[int] = None


@dataclass
class LatLongFeaturesDefaults:
    emb_dim: Optional[int] = None


@dataclass
class OneHotStringFeaturesDefaults:
    pass


@dataclass
class EmbeddingTableConfig:
    shared: Optional[Dict[str, EmbeddingTable]] = None
    query: Optional[Dict[str, EmbeddingTable]] = None
    item: Optional[Dict[str, EmbeddingTable]] = None


@dataclass
class FeatureDefaults:
    do_not_fix_na_values: bool = False
    transform_all_feature_names_to_lowercase: bool = True
    embedding_table_config: Optional[EmbeddingTableConfig] = None
    bool_features: Optional[BoolFeaturesDefaults] = None
    numerical_features: Optional[NumericalFeaturesDefaults] = None
    categorical_features: Optional[CategoricalFeaturesDefaults] = None
    categorical_history_features: Optional[CategoricalHistoryFeatureDefaults] = None
    tensor_features: Optional[TensorFeaturesDefaults] = None
    tensor_list_features: Optional[TensorListFeaturesDefaults] = None
    timestamp_features: Optional[TimestampFeaturesDefaults] = None
    lat_lng_features: Optional[LatLongFeaturesDefaults] = None
    one_hot_string_features: Optional[OneHotStringFeaturesDefaults] = None


# ----- sources / kinds ------------------------------------------------------


class FeatureSourceKind(str, enum.Enum):
    INPUT = "input"
    DERIVED = "derived"


class FeatureTowerName(str, enum.Enum):
    QUERY = "query"
    PRODUCT = "product"
    USER = "user"
    CONTEXT = "context"
    OTHER = "other"


SOURCES: Dict[str, type] = {}


@dataclass
class FeatureSource:
    kind: FeatureSourceKind
    dtype: Optional[str] = None

    @classmethod
    def from_dict(cls, d):
        return _dispatch(SOURCES, d)


@_registered(SOURCES)
@dataclass
class InputFeatureSource(FeatureSource):
    kind: FeatureSourceKind = FeatureSourceKind.INPUT
    input_field: Optional[str] = None


@_registered(SOURCES)
@dataclass
class DerivedFeatureSource(FeatureSource):
    kind: FeatureSourceKind = FeatureSourceKind.DERIVED


class FeatureKind(str, enum.Enum):
    Bool = "bool"
    Numerical = "numerical"
    Categorical = "categorical"
    CategoricalList = "categorical_list"
    CategoricalHistory = "categorical_history"
    Tensor = "tensor"
    TensorList = "tensor_list"
    Timestamp = "timestamp"
    LatLong = "latlong"
    OneHotString = "one_hot_string"


FEATURES: Dict[str, type] = {}


@dataclass(kw_only=True)
class Feature:
    name: str
    kind: FeatureKind
    source: FeatureSource = field(default_factory=InputFeatureSource)
    do_not_convert_to_platform_type: bool = False
    include_in_eval_output: bool = False
    tower_name: FeatureTowerName = FeatureTowerName.OTHER

    @classmethod
    def from_dict(cls, d):
        """The registered class of the dict's ``kind`` (a plain ``Feature``
        for a kind no class registers)."""
        out = _dispatch(FEATURES, d)
        return build_fields(cls, d) if isinstance(out, dict) else out

    def populate_defaults(self, feature_defaults: FeatureDefaults) -> None:
        if isinstance(self.source, InputFeatureSource) and self.source.input_field is None:
            self.source.input_field = self.name
        if (
            feature_defaults.transform_all_feature_names_to_lowercase
            and any(c.isupper() for c in self.name)
            and isinstance(self.source, InputFeatureSource)
        ):
            self.name = self.name.lower()


@dataclass(kw_only=True)
class Task(Feature):
    """A supervised head (CTR, CVR) - reference ``feature_config.py:220-223``."""

    kind: FeatureKind = FeatureKind.Numerical
    num_labels: int = 1
    weight: float = 1.0
    detached_estimator: bool = False

    @classmethod
    def from_dict(cls, d):
        return build_fields(cls, d)


@_registered(FEATURES)
@dataclass(kw_only=True)
class BoolFeature(Feature):
    kind: FeatureKind = FeatureKind.Bool
    emb_dim: Optional[int] = None

    def populate_defaults(self, d: FeatureDefaults) -> None:
        super().populate_defaults(d)
        if self.source.dtype is None:
            self.source.dtype = "bool"
        if d.bool_features and d.bool_features.emb_dim is not None and self.emb_dim is None:
            self.emb_dim = d.bool_features.emb_dim


@_registered(FEATURES)
@dataclass(kw_only=True)
class NumericalFeature(Feature):
    kind: FeatureKind = FeatureKind.Numerical
    embed_feature: Optional[bool] = None

    def populate_defaults(self, d: FeatureDefaults) -> None:
        super().populate_defaults(d)
        if self.source.dtype is None:
            self.source.dtype = "float32"
        if (
            d.numerical_features
            and d.numerical_features.embed_feature is not None
            and self.embed_feature is None
        ):
            self.embed_feature = d.numerical_features.embed_feature


@_registered(FEATURES)
@dataclass(kw_only=True)
class OneHotStringFeature(Feature):
    kind: FeatureKind = FeatureKind.OneHotString

    def populate_defaults(self, d: FeatureDefaults) -> None:
        super().populate_defaults(d)
        if self.source.dtype not in (None, "one_hot_string"):
            raise ValueError(f"{self.name}: a one-hot string feature has dtype one_hot_string")
        self.source.dtype = "one_hot_string"


@_registered(FEATURES)
@dataclass(kw_only=True)
class CategoricalFeature(Feature):
    kind: FeatureKind = FeatureKind.Categorical
    emb_table_name: Optional[str] = None
    proj_dim: Optional[int] = None
    transform_value_to_lowercase: Optional[bool] = None
    value_to_number_mapper: Optional[CategoricalValueToNumberMapper] = None

    def populate_defaults(self, d: FeatureDefaults) -> None:
        super().populate_defaults(d)
        defaults = d.categorical_features
        if self.transform_value_to_lowercase is None:
            if defaults is not None and defaults.transform_value_to_lowercase is not None:
                self.transform_value_to_lowercase = defaults.transform_value_to_lowercase
        if self.source.dtype is None:
            if defaults is not None and defaults.default_dtype is not None:
                self.source.dtype = defaults.default_dtype
            else:
                self.source.dtype = "string_lower" if self.transform_value_to_lowercase else "string"
        if defaults is None:
            return
        if self.value_to_number_mapper is None and defaults.value_to_number_mapper is not None:
            self.value_to_number_mapper = defaults.value_to_number_mapper
        if self.proj_dim is None and defaults.proj_dim is not None:
            self.proj_dim = defaults.proj_dim
        if self.emb_table_name is None and defaults.embedding is not None:
            self.emb_table_name = "default_categorical"


@_registered(FEATURES)
@dataclass(kw_only=True)
class CategoricalHistoryFeature(Feature):
    kind: FeatureKind = FeatureKind.CategoricalHistory
    emb_table_name: Optional[str] = None
    history_length: int = 20
    history_id_feature_name: str
    value_to_number_mapper: Optional[CategoricalValueToNumberMapper] = None
    remove_history_id_from_history: bool = False

    def populate_defaults(self, d: FeatureDefaults) -> None:
        super().populate_defaults(d)
        defaults = d.categorical_history_features
        if self.source.dtype is None:
            if defaults is not None and defaults.default_dtype is not None:
                self.source.dtype = defaults.default_dtype
            else:
                self.source.dtype = "string_list"
        if defaults is None:
            return
        if self.value_to_number_mapper is None and defaults.value_to_number_mapper is not None:
            self.value_to_number_mapper = defaults.value_to_number_mapper


@_registered(FEATURES)
@dataclass(kw_only=True)
class TensorFeature(Feature):
    kind: FeatureKind = FeatureKind.Tensor
    emb_dim: int = 0

    def populate_defaults(self, d: FeatureDefaults) -> None:
        super().populate_defaults(d)
        if self.source.dtype is None:
            self.source.dtype = "tensor"
        if d.tensor_features and d.tensor_features.emb_dim is not None and self.emb_dim == 0:
            self.emb_dim = d.tensor_features.emb_dim

    def get_emb_dim_as_shape(self) -> Tuple[int]:
        return (self.emb_dim,)


@_registered(FEATURES)
@dataclass(kw_only=True)
class TensorListFeature(Feature):
    kind: FeatureKind = FeatureKind.TensorList
    shape: Tuple[int, ...]

    def populate_defaults(self, d: FeatureDefaults) -> None:
        super().populate_defaults(d)
        if self.source.dtype is None:
            self.source.dtype = "tensor_list"
        if d.tensor_list_features and d.tensor_list_features.shape is not None and self.shape == tuple():
            self.shape = d.tensor_list_features.shape

    def get_shape(self) -> Tuple[int, ...]:
        return self.shape


@_registered(FEATURES)
@dataclass(kw_only=True)
class TimestampFeature(Feature):
    kind: FeatureKind = FeatureKind.Timestamp
    emb_dim: Optional[int] = None

    def populate_defaults(self, d: FeatureDefaults) -> None:
        super().populate_defaults(d)
        if self.source.dtype is None:
            self.source.dtype = "int64"
        if d.timestamp_features and d.timestamp_features.emb_dim is not None and self.emb_dim is None:
            self.emb_dim = d.timestamp_features.emb_dim


@_registered(FEATURES)
@dataclass(kw_only=True)
class LatLongFeature(Feature):
    kind: FeatureKind = FeatureKind.LatLong
    emb_dim: Optional[int] = None

    def populate_defaults(self, d: FeatureDefaults) -> None:
        super().populate_defaults(d)
        if self.source.dtype is None:
            self.source.dtype = "float32"
        if d.lat_lng_features and d.lat_lng_features.emb_dim is not None and self.emb_dim is None:
            self.emb_dim = d.lat_lng_features.emb_dim


@dataclass
class GroupDatasetConfig:
    """Session-group formation knobs - reference ``feature_config.py:446-452``."""

    group_by_columns: List[str] = field(default_factory=list)
    sort_by_columns: List[str] = field(default_factory=list)
    sort_reverse: bool = True
    flatten: bool = False
    minimum_group_size: int = 0
    maximum_group_size: Optional[int] = None


_COMPILED = {"exclude": True}


@dataclass
class FeaturesConfig:
    defaults: FeatureDefaults = field(default_factory=FeatureDefaults)
    embedding_table_config: EmbeddingTableConfig = field(default_factory=EmbeddingTableConfig)
    embedding_tables: Dict[str, EmbeddingTable] = field(default_factory=dict)
    bool_features: List[BoolFeature] = field(default_factory=list)
    numerical_features: List[NumericalFeature] = field(default_factory=list)
    one_hot_string_features: List[OneHotStringFeature] = field(default_factory=list)
    categorical_features: List[CategoricalFeature] = field(default_factory=list)
    categorical_history_features: List[CategoricalHistoryFeature] = field(default_factory=list)
    tensor_features: List[TensorFeature] = field(default_factory=list)
    tensor_list_features: List[TensorListFeature] = field(default_factory=list)
    timestamp_features: List[TimestampFeature] = field(default_factory=list)
    lat_lng_features: List[LatLongFeature] = field(default_factory=list)
    extra_eval_output_fields: List[Feature] = field(default_factory=list)
    extra_input_fields: List[Feature] = field(default_factory=list)
    group_dataset: Optional[GroupDatasetConfig] = None

    # compiled in __post_init__; left out of the dump (recomputed on load,
    # and the transform list holds callables)
    input_columns: List[str] = field(default_factory=list, metadata=_COMPILED)
    input_to_feature_map: Dict[str, List[Feature]] = field(default_factory=dict, metadata=_COMPILED)
    features_map: Dict[str, Feature] = field(default_factory=dict, metadata=_COMPILED)
    dtypes: Dict[str, str] = field(default_factory=dict, metadata=_COMPILED)
    dtypes_string_map: Dict[str, str] = field(default_factory=dict, metadata=_COMPILED)
    transformers: List[Callable[[Table], None]] = field(default_factory=list, metadata=_COMPILED)

    @classmethod
    def from_dict(cls, d: dict) -> "FeaturesConfig":
        d = dict(d)
        if "defaults" not in d:
            raise TypeError("FeaturesConfig: 'defaults' is required")
        for name in ("extra_eval_output_fields", "extra_input_fields"):
            if d.get(name) is not None:
                d[name] = [Feature.from_dict(f) if isinstance(f, dict) else f for f in d[name]]
        return build_fields(cls, d)

    def __post_init__(self):
        self._compile()

    # -- compilation (reference feature_config.py:482-620) -------------------

    def _all_features(self) -> List[Feature]:
        return sum(
            [
                self.bool_features,
                self.numerical_features,
                self.categorical_features,
                self.categorical_history_features,
                self.tensor_features,
                self.tensor_list_features,
                self.timestamp_features,
                self.lat_lng_features,
                self.one_hot_string_features,
                self.extra_eval_output_fields,
                self.extra_input_fields,
            ],
            [],
        )

    def _compile(self) -> None:
        if self.defaults.categorical_features is not None and self.defaults.categorical_features.embedding is not None:
            self.embedding_tables["default_categorical"] = self.defaults.categorical_features.embedding
        if self.defaults.embedding_table_config is not None:
            self.embedding_table_config = self.defaults.embedding_table_config

        input_columns: List[str] = []
        for feature in self._all_features():
            if not isinstance(feature.source, DerivedFeatureSource):
                feature.populate_defaults(self.defaults)
            if isinstance(feature.source, InputFeatureSource):
                input_field = feature.source.input_field
                features = self.input_to_feature_map.get(input_field)
                if features is None:
                    features = []
                    input_columns.append(input_field)
                else:
                    existing = self.dtypes[input_field]
                    if existing != feature.source.dtype:
                        raise ValueError(
                            f"Input field ({input_field}) with 2 dtypes: {existing} vs {feature.source.dtype}"
                        )
                features.append(feature)
                self.input_to_feature_map[input_field] = features
                self.dtypes[input_field] = feature.source.dtype
                self.features_map[feature.name] = feature
                if feature.source.dtype in ("string", "string_lower"):
                    self.dtypes_string_map[input_field] = "str"
        self.input_columns = input_columns

        t = self.transformers
        if not self.defaults.do_not_fix_na_values:
            for column in self.input_columns:
                dt = self.dtypes[column]
                if dt == "bool":
                    t.append(functools.partial(transforms.fix_na_bool, column=column))
                elif dt in ("string", "string_lower"):
                    t.append(functools.partial(transforms.fix_na_str, column=column))
                elif dt == "tensor":
                    emb_dim = max(
                        [f.emb_dim for f in self.input_to_feature_map[column] if isinstance(f, TensorFeature)]
                        or [0]
                    )
                    t.append(functools.partial(transforms.fix_na_tensor, column=column, emb_dim=emb_dim))
                elif dt == "tensor_list":
                    shapes = [
                        f.shape for f in self.input_to_feature_map[column] if isinstance(f, TensorListFeature)
                    ]
                    if shapes:
                        t.append(functools.partial(transforms.fix_na_tensor_list, column=column, shape=shapes[0]))
                        t.append(functools.partial(transforms.fix_partial_tensor_list, column=column, shape=shapes[0]))
                elif dt in ("string_list", "int64_list"):
                    t.append(functools.partial(transforms.fix_na_string_list, column=column))
                elif dt == "int64":
                    t.append(functools.partial(transforms.fix_na_int64, column=column, value_to_lower=True))
                elif dt == "int64_upper":
                    t.append(functools.partial(transforms.fix_na_int64, column=column, value_to_lower=False))
                elif dt == "one_hot_string":
                    t.append(functools.partial(transforms.fix_na_one_hot_string, column=column))
            t.append(transforms.fill_na)

        for input_field, features in self.input_to_feature_map.items():
            for feature in features:
                if input_field != feature.name:
                    if input_field.lower() == feature.name.lower() or len(features) == 1:
                        t.append(
                            functools.partial(
                                transforms.rename_column, src_column=input_field, target_column=feature.name
                            )
                        )
                    else:
                        t.append(
                            functools.partial(
                                transforms.copy_value, src_column=input_field, target_column=feature.name
                            )
                        )

        for input_field, features in self.input_to_feature_map.items():
            for feature in features:
                if isinstance(feature, CategoricalFeature):
                    if feature.value_to_number_mapper is not None:
                        if isinstance(feature.value_to_number_mapper, XXHashMapper):
                            t.append(
                                functools.partial(
                                    transforms.xxhash_categorical_values_to_number,
                                    column=feature.name,
                                    value_to_lower=bool(feature.transform_value_to_lowercase),
                                )
                            )
                        elif not isinstance(feature.value_to_number_mapper, NoneMapper):
                            raise ValueError(
                                f"Unsupported mapper for {feature.name}: {feature.value_to_number_mapper}"
                            )
                    elif feature.transform_value_to_lowercase:
                        t.append(functools.partial(transforms.transform_value_to_lower, column=feature.name))
                elif isinstance(feature, LatLongFeature):
                    t.append(functools.partial(transforms.box_lat_long_feature, column=feature.name))
                elif isinstance(feature, OneHotStringFeature):
                    t.append(functools.partial(transforms.create_array_one_hot_feature, column=feature.name))

        # history features last: the current-item ids must already be hashed
        # for leak removal (reference feature_config.py:607-620)
        for input_field, features in self.input_to_feature_map.items():
            for feature in features:
                if isinstance(feature, CategoricalHistoryFeature):
                    hash_ids = isinstance(feature.value_to_number_mapper, XXHashMapper)
                    t.append(
                        functools.partial(
                            transforms.handle_categorical_history_feature,
                            column=feature.name,
                            hash_ids=hash_ids,
                            history_length=feature.history_length,
                            history_id_feature_name=feature.history_id_feature_name,
                            remove_history_id_from_history=feature.remove_history_id_from_history,
                        )
                    )

    # -- accessors (reference feature_config.py:622-678) ----------------------

    def get_dtypes(self) -> Dict[str, str]:
        return self.dtypes

    def get_input_columns(self) -> List[str]:
        return self.input_columns

    def get_features_map(self) -> Dict[str, Feature]:
        """Feature name -> feature, for every feature read from an input."""
        return self.features_map

    def _get_typed(self, key, kind, cls):
        feature = self.features_map.get(key)
        if feature is not None and feature.kind == kind and isinstance(feature, cls):
            return feature
        return None

    def get_tensor_feature(self, key) -> Optional[TensorFeature]:
        return self._get_typed(key, FeatureKind.Tensor, TensorFeature)

    def get_tensor_list_feature(self, key) -> Optional[TensorListFeature]:
        return self._get_typed(key, FeatureKind.TensorList, TensorListFeature)

    def get_categorical_history_feature(self, key) -> Optional[CategoricalHistoryFeature]:
        return self._get_typed(key, FeatureKind.CategoricalHistory, CategoricalHistoryFeature)

    def get_one_hot_string_feature(self, key) -> Optional[OneHotStringFeature]:
        return self._get_typed(key, FeatureKind.OneHotString, OneHotStringFeature)

    def is_do_not_convert_to_platform_type(self, key) -> bool:
        feature = self.features_map.get(key)
        return feature is not None and feature.do_not_convert_to_platform_type

    def get_transformers(self) -> List[Callable[[Table], None]]:
        """The compiled transforms, in the order ``default_data_mapper``
        applies them, each changing a column dict in place."""
        return self.transformers

    def default_data_mapper(self, batch: Table) -> Table:
        """The compiled transforms applied to a copy of ``batch``'s column
        dict; the string columns are made strings first."""
        batch = dict(batch)
        for column in self.dtypes_string_map:
            if column in batch:
                batch[column] = to_str_column(batch[column])
        for transformer in self.transformers:
            transformer(batch)
        return batch
