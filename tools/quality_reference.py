"""The JAX package's whole-run learning figures on the CPU: the references
that ``chip_smoke.py``'s phase [7] holds the port's runs on the card to.

    JAX_PLATFORMS=cpu python3 tools/quality_reference.py [--configs lthm_tiny ranker joint] \\
        [--seeds 0 1 2] [--out DIR]

- ``lthm_tiny``: ``main_training --config-name lthm_tiny`` for 600 steps
  (``train.train_steps=600 train.epochs=20``, QUALITY.md's config 1) on
  ``tools/synth_data``'s click log: 2 dates (train 20240101, validate
  20240102) x 2 files x 800 users, history 64.
- ``ranker``: ``--config-name ranker_train`` with ``train.train_steps=400``
  (QUALITY.md's "400 steps x 10 epochs"; the YAML's 10 epochs end the run at
  320 steps) on ``write_ranking_dataset``'s impressions: 2 dates x 2 files x
  4096 rows.
- ``joint``: ``--config-name joint_train`` uncut (4096 users, 6000 LTHM
  steps, 10000 ranker steps an arm), ``synth.seed`` = ``data_seed(s)``.

Seed ``s``: the initial variables from ``PRNGKey(s)`` (the strategy draws
them from ``PRNGKey(0)``; the wrappers' ``init_variables`` is wrapped here
for the run, nothing in the package changes) and the synthetic data from
``data_seed(s)`` = 100 s (``write_*`` give file i the seed + i, so the
seeds' files do not overlap); seed 0 is QUALITY.md's data and the joint
config's own seed. ``chip_smoke.py`` makes the same data with the port's
``synth_data`` and draws the port's initial weights from torch seed ``s``.

Prints one JSON line a run (the final metrics the trainer reports) and, last,
one JSON object: per config and metric the runs' values, their mean and
their sample standard deviation (ddof 1). Nothing is written outside
``--out`` (default: a temporary directory), save the trainer's own
temporary checkpoint directories under ``TMPDIR``.
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
LTHM_STEPS, LTHM_EPOCHS = 600, 20
LTHM_FILES, LTHM_USERS, LTHM_HISTORY = 2, 800, 64
RANKER_STEPS = 400
DATES = ["20240101", "20240102"]
LTHM_METRICS = ["val_hit_rate_at_1_lookahead_0", "val_hit_rate_at_5_lookahead_0", "val_hit_rate_at_20_lookahead_0",
                "val_median_hit_position_lookahead_0", "val_loss"]
RANKER_METRICS = ["val_auc_click", "val_auc_conversion", "val_loss"]


def data_seed(seed: int) -> int:
    return 100 * seed


@contextlib.contextmanager
def init_seed(wrapper_cls, seed: int):
    """The strategy's ``init_variables(PRNGKey(0), ...)`` drawn from
    ``PRNGKey(seed)`` instead, for the length of the block."""
    import jax

    real = wrapper_cls.init_variables

    def init_variables(self, rng, batch):
        return real(self, jax.random.PRNGKey(seed), batch)

    wrapper_cls.init_variables = init_variables
    try:
        yield
    finally:
        wrapper_cls.init_variables = real


def _run(config_name: str, overrides: list) -> dict:
    import main_training
    from recommendations_tpu.config.yaml_loader import load_config, parse_cli_overrides

    cfg = load_config(os.path.join(CONFIGS, f"{config_name}.yaml"), overrides=parse_cli_overrides(overrides),
                      search_paths=[CONFIGS])
    return main_training.execute_pipeline(cfg)


def _floats(metrics: dict, keys) -> dict:
    return {k: float(metrics[k]) for k in keys}


def lthm_tiny(seed: int, out: str) -> dict:
    from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu.tools.synth_data import write_synthetic_dataset

    root = os.path.join(out, f"lthm_tiny_data_{seed}")
    write_synthetic_dataset(root, DATES, files_per_date=LTHM_FILES, users_per_file=LTHM_USERS,
                            history_len=LTHM_HISTORY, seed=data_seed(seed))
    with init_seed(LTHMModelWrapper, seed):
        metrics = _run("lthm_tiny", [
            f"dataset.filesystem_config.local_dir_prefix={root}",
            f"export.filesystem_config.local_dir_prefix={out}/lthm_tiny_export_{seed}",
            f"trackers.trackers=[{{kind: jsonl, path: {out}/lthm_tiny_{seed}.jsonl}}]",
            f"train.train_steps={LTHM_STEPS}", f"train.epochs={LTHM_EPOCHS}"])
    return {**_floats(metrics, LTHM_METRICS), "steps": int(metrics["train_steps_total"])}


def ranker(seed: int, out: str) -> dict:
    from recommendations_tpu.models.ranker.wrapper import RankerModelWrapper
    from recommendations_tpu.tools.synth_data import write_ranking_dataset

    root = os.path.join(out, f"ranker_data_{seed}")
    write_ranking_dataset(root, DATES, seed=data_seed(seed))
    with init_seed(RankerModelWrapper, seed):
        metrics = _run("ranker_train", [
            f"dataset.filesystem_config.local_dir_prefix={root}",
            f"export.filesystem_config.local_dir_prefix={out}/ranker_export_{seed}",
            f"trackers.trackers=[{{kind: jsonl, path: {out}/ranker_{seed}.jsonl}}]",
            f"train.train_steps={RANKER_STEPS}"])
    return {**_floats(metrics, RANKER_METRICS), "steps": int(metrics["train_steps_total"])}


def joint(seed: int, out: str) -> dict:
    from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu.models.ranker.wrapper import RankerModelWrapper

    root = os.path.join(out, f"joint_{seed}")
    overrides = [f"enriched_dir={root}/enriched", f"synth.root={root}/data", f"synth.seed={data_seed(seed)}"]
    for stage, src, test in (("retrieval", "clicks/*/*.parquet", "clicks/*/part-00000.parquet"),
                             ("ranking", "impressions/*/*.parquet", "impressions_val/*/*.parquet")):
        o = f"{stage}.overrides"
        overrides += [f"{o}.dataset.filesystem_config.local_dir_prefix={root}/data",
                      f"{o}.dataset.path_glob_train={root}/data/{src}", f"{o}.dataset.path_glob_test={root}/data/{test}"]
    with init_seed(LTHMModelWrapper, seed), init_seed(RankerModelWrapper, seed):
        metrics = _run("joint_train", overrides)
    return {"val_auc_click_with_embeddings": float(metrics["ranking"]["val_auc_click"]),
            "val_auc_click_ablated": float(metrics["ranking_ablated"]["val_auc_click"]),
            "auc_uplift_click": float(metrics["auc_uplift_click"])}


def summarize(runs: list) -> dict:
    out = {}
    for key in runs[0]:
        vals = [r[key] for r in runs]
        out[key] = {"values": vals, "mean": float(np.mean(vals)),
                    "std": float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=["lthm_tiny", "ranker"], choices=["lthm_tiny", "ranker", "joint"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import recommendations_tpu  # noqa: F401  (x64, as main_training.py)

    with contextlib.ExitStack() as stack:
        out = args.out or stack.enter_context(tempfile.TemporaryDirectory(prefix="quality_reference_"))
        os.makedirs(out, exist_ok=True)
        summary = {}
        for name in args.configs:
            runs = []
            for seed in args.seeds:
                t0 = time.perf_counter()
                result = {"lthm_tiny": lthm_tiny, "ranker": ranker, "joint": joint}[name](seed, out)
                print(json.dumps({"config": name, "seed": seed, "seconds": round(time.perf_counter() - t0, 1),
                                  **result}), flush=True)
                runs.append(result)
            summary[name] = summarize(runs)
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    _sys.exit(main())
