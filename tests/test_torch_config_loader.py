"""The port's YAML loader and pipeline config against the JAX package's:
the composed config of each training YAML, with command-line overrides,
dumps to the same dict; the resolvers and the override parser agree; the
configs the port does not run yet raise with their ROADMAP item."""

import json

import pytest

from recommendations_tpu.config.yaml_loader import compose_config as jax_compose
from recommendations_tpu.config.yaml_loader import load_config as jax_load_config
from recommendations_tpu.config.yaml_loader import parse_cli_overrides as jax_parse
from recommendations_tpu_torch.config.base import model_dump, to_json_value
from recommendations_tpu_torch.config.pipeline_config import TrainerPipelineConfig
from recommendations_tpu_torch.config.yaml_loader import compose_config, load_config, parse_cli_overrides
from recommendations_tpu_torch.data.paths import get_train_data_paths
from recommendations_tpu_torch.main_training import CONFIG_ROOT
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig


def _plain(d):
    """Enums by value and tuples as lists, as JSON holds them."""
    return json.loads(json.dumps(to_json_value(d)))


# model_version and run_id come from the clock (and random characters) unless set
CASES = {
    "lthm_tiny": ["model_version=v1", "run_id=r1"],
    "lthm_tiny_overridden": ["model_version=v1", "run_id=r1", "train.train_steps=3", "train.batch_size=8",
                             "dataset.filesystem_config.kind=fake", "model.lr=2e-3",
                             "model.transformer_config.num_layers=1", "data_loader.bypass_dataloader=true",
                             "trackers.trackers=[{kind: jsonl, path: m.jsonl}]"],
    "lthm_train": ['datestr="20240101"', "model_version=v1", "run_id=r1"],
    "lthm_train_overridden": ['datestr="20240101"', "model_version=v1", "run_id=r1", "checkpoint_dir=/c",
                              "train.checkpoint_every_k_steps=4", "model.fused_ce=true"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_composed_config_equals_jax(case):
    """Every field of every section, the model's features and the trackers
    included, as pydantic's model_dump gives it (serialize_as_any: the
    subclasses' own fields), and as its plain model_dump gives it."""
    name = case.replace("_overridden", "")
    path = CONFIG_ROOT / f"{name}.yaml"
    args = CASES[case]
    jcfg = jax_load_config(path, overrides=jax_parse(args), search_paths=[str(CONFIG_ROOT)])
    tcfg = load_config(path, overrides=parse_cli_overrides(args), search_paths=[str(CONFIG_ROOT)])
    assert isinstance(tcfg, TrainerPipelineConfig) and isinstance(tcfg.model, LTHMModelConfig)
    assert _plain(model_dump(tcfg, serialize_as_any=True)) == _plain(jcfg.model_dump(serialize_as_any=True))
    assert _plain(model_dump(tcfg.model)) == _plain(jcfg.model.model_dump())
    assert tcfg.model.features.get_input_columns() == jcfg.model.features.get_input_columns()
    assert tcfg.model.features.get_dtypes() == jcfg.model.features.get_dtypes()


def test_datestr_resolves_to_yesterday_as_jax():
    """lthm_train.yaml's datestr is ${day_before_days:1}; the dates the
    dataset reads follow it (the card run fixes it to 20240101)."""
    path = CONFIG_ROOT / "lthm_train.yaml"
    j, t = jax_compose(path, search_paths=[str(CONFIG_ROOT)]), compose_config(path, search_paths=[str(CONFIG_ROOT)])
    assert t["datestr"] == j["datestr"] and len(t["datestr"]) == 8
    assert t["dataset"]["train_data_end_date"] == t["datestr"] == t["dataset"]["val_data_start_date"]
    assert t["run_id"].startswith(f"run_{t['model_version']}_") and len(t["run_id"]) == len(j["run_id"])


def test_resolvers_and_overrides_as_jax():
    args = ["a.b=1", "a.c=x", "d=[1, 2]", "e={k: v}", "f=1e-3", "g=true", "h=null"]
    assert parse_cli_overrides(args) == jax_parse(args)
    with pytest.raises(ValueError):
        parse_cli_overrides(["no_equals_sign"])


def test_unported_configs_raise_with_their_item():
    """The two configs the port once refused (item 6b) now load as JAX's: an
    mlflow tracker of JAX's fields, and an S3 dataset whose store, without
    boto3, raises ImportError when the paths are listed, as JAX's does
    (``tests/test_torch_trackers_stores.py`` drives both under stand-ins)."""
    import sys

    from recommendations_tpu.data.paths import get_train_data_paths as jax_train_paths

    over = ["trackers.trackers=[{kind: mlflow}]"]
    t = load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=parse_cli_overrides(over),
                    search_paths=[str(CONFIG_ROOT)]).trackers.trackers
    j = jax_load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=jax_parse(over),
                        search_paths=[str(CONFIG_ROOT)]).trackers.trackers
    assert [type(x).__name__ for x in t] == [type(x).__name__ for x in j] == ["MlflowTracker"]
    assert (t[0].kind, t[0].tracking_uri, t[0].experiment_name) == (j[0].kind, j[0].tracking_uri,
                                                                     j[0].experiment_name)
    over = ["dataset.filesystem_config={kind: s3, s3_bucket_path: b}"]
    s3 = load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=parse_cli_overrides(over), search_paths=[str(CONFIG_ROOT)])
    js3 = jax_load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=jax_parse(over), search_paths=[str(CONFIG_ROOT)])
    saved = sys.modules.get("boto3")
    sys.modules["boto3"] = None  # not importable: an optional dependency
    try:
        for paths, dataset in ((get_train_data_paths, s3.dataset), (jax_train_paths, js3.dataset)):
            with pytest.raises(ImportError, match="boto3"):
                paths(dataset)
    finally:
        if saved is None:
            sys.modules.pop("boto3", None)
        else:
            sys.modules["boto3"] = saved


def test_filesystem_config_checks_as_jax():
    from recommendations_tpu_torch.config.trainer_config import FileSystemConfig

    with pytest.raises(ValueError, match="local_dir_prefix"):
        FileSystemConfig(kind="local")
    with pytest.raises(ValueError, match="s3_bucket_path"):
        FileSystemConfig(kind="s3")
    assert FileSystemConfig(kind="fake").kind.value == "fake"


def test_precision_policy_as_jax():
    import jax.numpy as jnp
    import torch

    from recommendations_tpu.core import precision as jp
    from recommendations_tpu_torch.core import precision as tp

    for jpol, tpol in ((jp.DEFAULT_POLICY, tp.DEFAULT_POLICY), (jp.FP32_POLICY, tp.FP32_POLICY)):
        for f in ("param_dtype", "compute_dtype", "output_dtype"):
            assert str(getattr(tpol, f)).removeprefix("torch.") == jnp.dtype(getattr(jpol, f)).name
    tree = {"w": torch.ones(2), "ids": torch.ones(2, dtype=torch.int64), "x": [torch.zeros(1, dtype=torch.float64)], "n": 3}
    out = tp.DEFAULT_POLICY.cast_to_compute(tree)
    assert out["w"].dtype == out["x"][0].dtype == torch.bfloat16 and out["ids"].dtype == torch.int64 and out["n"] == 3
