"""The port's feature hashing and feature transforms against the JAX
package's: hashes bit for bit (the native build also against a plain
Python xxHash), and ``default_data_mapper`` on the same synthetic frame
giving the same arrays as JAX's ``preprocess_fn``."""

import copy

import numpy as np
import pandas as pd
import pytest

from recommendations_tpu.config.model_config import ModelConfig as JaxModelConfig
from recommendations_tpu.config.yaml_loader import compose_config as jax_compose
from recommendations_tpu.features import hashing as jh
from recommendations_tpu.features.feature_config import FeaturesConfig as JaxFeaturesConfig
from recommendations_tpu.tools import synth_data as jsynth
from recommendations_tpu_torch import native
from recommendations_tpu_torch.config.yaml_loader import compose_config
from recommendations_tpu_torch.features import hashing as th
from recommendations_tpu_torch.features.feature_config import FeaturesConfig
from recommendations_tpu_torch.main_training import CONFIG_ROOT
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig

VALUES = ["sku_1", "SKU_1", "", "Ünïcödé ✓ 商品", "NA", "a" * 31, "b" * 32, "c" * 33, "d" * 100,
          0, 17, -3, 2.5, 1e20, "12345678901234567890", "tab\tand\nnewline", "\x00inner nul"]

# -- a plain Python xxHash (the public spec), the native build's oracle -------

M64 = (1 << 64) - 1
P64 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)
P32 = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)


def _rotl(x, r, bits):
    mask = (1 << bits) - 1
    return ((x << r) | (x >> (bits - r))) & mask


def xxh64_plain(data: bytes, seed: int = 0) -> int:
    def rnd(acc, lane):
        return (_rotl((acc + lane * P64[1]) & M64, 31, 64) * P64[0]) & M64

    n, p = len(data), 0
    if n >= 32:
        v = [(seed + P64[0] + P64[1]) & M64, (seed + P64[1]) & M64, seed & M64, (seed - P64[0]) & M64]
        while p + 32 <= n:
            for i in range(4):
                v[i] = rnd(v[i], int.from_bytes(data[p + 8 * i:p + 8 * i + 8], "little"))
            p += 32
        h = (_rotl(v[0], 1, 64) + _rotl(v[1], 7, 64) + _rotl(v[2], 12, 64) + _rotl(v[3], 18, 64)) & M64
        for vi in v:
            h = ((h ^ rnd(0, vi)) * P64[0] + P64[3]) & M64
    else:
        h = (seed + P64[4]) & M64
    h = (h + n) & M64
    while p + 8 <= n:
        h = (_rotl(h ^ rnd(0, int.from_bytes(data[p:p + 8], "little")), 27, 64) * P64[0] + P64[3]) & M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * P64[0]) & M64, 23, 64) * P64[1] + P64[2]) & M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * P64[4]) & M64, 11, 64) * P64[0]) & M64
        p += 1
    h ^= h >> 33
    h = (h * P64[1]) & M64
    h ^= h >> 29
    h = (h * P64[2]) & M64
    return h ^ (h >> 32)


def xxh32_plain(data: bytes, seed: int = 0) -> int:
    m = (1 << 32) - 1

    def rnd(acc, lane):
        return (_rotl((acc + lane * P32[1]) & m, 13, 32) * P32[0]) & m

    n, p = len(data), 0
    if n >= 16:
        v = [(seed + P32[0] + P32[1]) & m, (seed + P32[1]) & m, seed & m, (seed - P32[0]) & m]
        while p + 16 <= n:
            for i in range(4):
                v[i] = rnd(v[i], int.from_bytes(data[p + 4 * i:p + 4 * i + 4], "little"))
            p += 16
        h = (_rotl(v[0], 1, 32) + _rotl(v[1], 7, 32) + _rotl(v[2], 12, 32) + _rotl(v[3], 18, 32)) & m
    else:
        h = (seed + P32[4]) & m
    h = (h + n) & m
    while p + 4 <= n:
        h = (_rotl((h + int.from_bytes(data[p:p + 4], "little") * P32[2]) & m, 17, 32) * P32[3]) & m
        p += 4
    while p < n:
        h = (_rotl((h + data[p] * P32[4]) & m, 11, 32) * P32[0]) & m
        p += 1
    h ^= h >> 15
    h = (h * P32[1]) & m
    h ^= h >> 13
    h = (h * P32[2]) & m
    return h ^ (h >> 16)


@pytest.mark.parametrize("seed", [0, 1, 0xFFFFFFFF, 2**63 + 12345])
def test_native_build_equals_plain_python(seed):
    for v in VALUES:
        data = str(v).encode("utf-8")
        assert native.xxh64(data, seed) == xxh64_plain(data, seed), v
        assert native.xxh32(data, seed & 0xFFFFFFFF) == xxh32_plain(data, seed & 0xFFFFFFFF), v


@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("name", ["product_id", "Product_IDs", "customer_id", "ünï", ""])
def test_hashes_equal_jax_bit_for_bit(name, lower):
    assert th.hash_feature_name_to_int(name) == jh.hash_feature_name_to_int(name)
    seed = th.hash_feature_name_to_int(name)
    got, want = th.hash_strings_to_long(VALUES, seed, lower), jh.hash_strings_to_long(VALUES, seed, lower)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert got.min() < 0 < got.max()  # the whole int64 range
    for v in VALUES:
        assert th.hash_string_to_long(v, seed, lower) == jh.hash_string_to_long(v, seed, lower)
    # the plain version's contract: xxh64 - 2**63
    expect = [xxh64_plain((str(v).lower() if lower else str(v)).encode("utf-8"), seed) - 2**63 for v in VALUES]
    assert got.tolist() == expect
    assert th.hash_strings_to_long([], seed, lower).shape == (0,)


def _same_column(got, want):
    want = np.asarray(want)
    if want.dtype != object:
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        return np.array_equal(got, want, equal_nan=want.dtype.kind == "f")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (np.ndarray, list)):
            w = np.asarray(w)
            g = np.asarray(g)
            if g.dtype != w.dtype or not np.array_equal(g, w):
                return False
        elif g != w or type(g) is not type(w) and not (np.isscalar(g) and np.isscalar(w)):
            return False
    return True


def _lthm_model(name):
    d = compose_config(CONFIG_ROOT / f"{name}.yaml", search_paths=[str(CONFIG_ROOT)])["model"]
    jd = jax_compose(CONFIG_ROOT / f"{name}.yaml", search_paths=[str(CONFIG_ROOT)])["model"]
    jcls = JaxModelConfig.resolve(jd["kind"], jd["name"])
    return jcls(**copy.deepcopy(jd)), LTHMModelConfig.from_dict(d)


@pytest.mark.parametrize("name,history,min_history", [("lthm_tiny", 64, None), ("lthm_train", 768, None),
                                                      ("lthm_tiny", 64, 45)])
def test_lthm_preprocess_fn_equals_jax(name, history, min_history):
    """The LTHM YAML's features on synth_data's frame (some rows shorter than
    the history, a missing id and a missing customer): the same columns,
    dtypes and values as JAX's preprocess_fn (the pre-hook, the compiled
    transforms, the post-hook, which drops users with fewer than
    min_history_size events: both YAMLs set 0, so the last case sets 45)."""
    jm, tm = _lthm_model(name)
    if min_history is not None:
        jm.min_history_size = tm.min_history_size = min_history
    df = jsynth._pad_lists(jsynth.make_click_log(num_users=12, history_len=history, seed=4), history)
    df.loc[3, "product_id"] = None
    df.loc[5, "customer_id"] = None
    table = {c: df[c].to_numpy(dtype=object) for c in df.columns}
    want = jm.preprocess_fn("train")(df.copy())
    got = tm.preprocess_fn("train")(table)
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert _same_column(got[c], want[c].to_numpy()), c
    assert got["product_ids"][0].dtype == np.int64 and len(got["product_ids"][0]) == history
    assert len(got["product_ids"]) == (12 if min_history is None else len(want)) and len(want) >= 1
    if min_history is not None:
        assert len(want) < 12


FEATURES = {
    "defaults": {
        "categorical_features": {"value_to_number_mapper": {"kind": "xxhash"}, "transform_value_to_lowercase": True},
        "tensor_features": {"emb_dim": 3},
    },
    "bool_features": [{"name": "is_new", "kind": "bool"}],
    "numerical_features": [{"name": "Price", "kind": "numerical"}],
    "categorical_features": [
        {"name": "product_id", "kind": "categorical"},
        {"name": "brand", "kind": "categorical", "value_to_number_mapper": {"kind": "none"}},
        {"name": "ts", "kind": "categorical", "source": {"kind": "input", "dtype": "int64"},
         "value_to_number_mapper": {"kind": "none"}},
    ],
    "categorical_history_features": [
        {"name": "history", "kind": "categorical_history", "history_length": 5,
         "history_id_feature_name": "product_id", "remove_history_id_from_history": True,
         "value_to_number_mapper": {"kind": "xxhash"}},
    ],
    "tensor_features": [{"name": "vec", "kind": "tensor"}],
    "tensor_list_features": [{"name": "seq", "kind": "tensor_list", "shape": [4]}],
    "lat_lng_features": [{"name": "lat", "kind": "latlong"}],
    "one_hot_string_features": [{"name": "flags", "kind": "one_hot_string"}],
}


def test_every_kind_of_transform_equals_jax():
    """A schema with every kind of feature the transforms treat (NA fixing
    per dtype, the lower-cased rename, hashing with and without
    lower-casing, history leak removal and padding, one-hot strings,
    lat/long boxing, tensor lists cut and padded), with missing values."""
    rs = np.random.RandomState(0)
    n = 6
    skus = [f"SKU_{i}" for i in range(n)]
    df = pd.DataFrame({
        "is_new": [True, False, True, False, True, False],
        "Price": [1.5, np.nan, 3.0, 4.25, np.nan, 0.0],
        "product_id": skus[:4] + [None, "sku_5"],
        "brand": ["Acme", None, "acme", "Zeta", "z", ""],
        "ts": [1, 2, 3, 4, 5, 6],
        "history": [[skus[1], skus[0], "x"], [], None, [skus[3]] * 7, ["sku_5", "SKU_4"], ["a", "b"]],
        "vec": [rs.randn(3) for _ in range(5)] + [None],
        "seq": [rs.randn(4).astype(np.float32), rs.randn(2).astype(np.float32), None,
                rs.randn(6).astype(np.float32), rs.randn(4).astype(np.float32), rs.randn(1).astype(np.float32)],
        "lat": ["1.5", "x", None, 2, "3e2", "-7.25"],
        "flags": ["0101", None, "1" * 120, "", "0010", "abc1"],
    })
    jf = JaxFeaturesConfig(**copy.deepcopy(FEATURES))
    tf = FeaturesConfig.from_dict(copy.deepcopy(FEATURES))
    assert tf.get_input_columns() == jf.get_input_columns()
    assert tf.get_dtypes() == jf.get_dtypes()
    want = jf.default_data_mapper(df.copy())
    got = tf.default_data_mapper({c: df[c].to_numpy(dtype=object if df[c].dtype == object else None)
                                  for c in df.columns})
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert _same_column(got[c], want[c].to_numpy()), c
