"""The port's training entry point, the counterpart of ``main_training.py``.

    python -m recommendations_tpu_torch.main_training --config-name lthm_tiny \\
        [--device cpu] [--config-dir DIR] [a.b.c=value ...]

Composes the YAML from ``configs/`` (hydra-style defaults and
interpolation, ``config/yaml_loader.py``), builds the pipeline config, runs
the stats job where the config's ``stats`` section asks for it (its result
goes to the model builder, as in ``main_training.py``), and trains,
validates, checkpoints and exports (and, where the config asks, runs the
KNN eval, the batch inference and the traced export programs) on one
device: the card unless ``--device cpu`` is given; without a card it
raises. A config with ``joint: true`` (``--config-name joint_train``) runs
the retrieval -> ranking pipeline (``pipeline/joint_pipeline.py``).

Over several ranks, as ``main_training.py`` calls ``init_distributed``:

    torchrun --nproc_per_node=N -m recommendations_tpu_torch.main_training \
        --config-name lthm_tiny [--device cpu] training_strategy.mesh_data=N

forms the process group from ``torchrun``'s environment (NCCL on cards,
each rank on ``cuda:{LOCAL_RANK}``; gloo with ``--device cpu``) and trains
over the config's mesh (``train/strategy.py``); rank 0 logs, checkpoints,
exports, evaluates and runs the inference.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from recommendations_tpu_torch import resolve_device
from recommendations_tpu_torch.core.mesh import init_distributed, local_device
from recommendations_tpu_torch.config.yaml_loader import load_config, parse_cli_overrides
from recommendations_tpu_torch.data.generator import get_data_loader_strategy
from recommendations_tpu_torch.data.paths import get_train_data_paths
from recommendations_tpu_torch.pipeline.joint_pipeline import JointPipelineConfig, JointTrainerPipeline
from recommendations_tpu_torch.pipeline.stats import compute_stats_for_pipeline
from recommendations_tpu_torch.pipeline.trainer_pipeline import TrainerPipeline
from recommendations_tpu_torch.train.strategy import get_training_strategy

logger = logging.getLogger("main_training")

CONFIG_ROOT = Path(__file__).resolve().parent.parent / "configs"


def build_pipeline(cfg, device="cuda") -> TrainerPipeline:
    device = resolve_device(device)
    stats = None
    if getattr(cfg, "stats", None) is not None and cfg.stats.compute_stats:
        stats = compute_stats_for_pipeline(cfg, get_train_data_paths(cfg.dataset))
    data_loader_strategy = get_data_loader_strategy(
        cfg.data_loader,
        columns=cfg.model.features.get_input_columns(),
        data_mapper=cfg.model.preprocess_fn,
    )
    return TrainerPipeline(
        pipeline_config=cfg,
        model_builder=cfg.model.get_builder(stats=stats, device=device),
        training_strategy=get_training_strategy(cfg.training_strategy, device=device),
        data_loader_strategy=data_loader_strategy,
    )


def main(argv=None, return_pipeline: bool = False):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-name", required=True)
    parser.add_argument("--config-dir", default=str(CONFIG_ROOT))
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    init_distributed(device)  # torchrun's environment; one process forms no group
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    config_path = Path(args.config_dir) / f"{args.config_name}.yaml"
    cfg = load_config(config_path, overrides=parse_cli_overrides(args.overrides), search_paths=[args.config_dir])
    if isinstance(cfg, JointPipelineConfig):
        # the two-stage retrieval -> ranking product path (BASELINE config 4)
        logger.info("joint pipeline: retrieval=%s ranking=%s device=%s", cfg.retrieval.model.name,
                    cfg.ranking.model.name, device)
        pipeline = JointTrainerPipeline(cfg, device)
    else:
        logger.info("model=%s/%s strategy=%s device=%s", cfg.model.kind, cfg.model.name, cfg.training_strategy.name,
                    device)
        pipeline = build_pipeline(cfg, device)
    metrics = pipeline.execute()
    logger.info("final metrics: %s", {k: round(v, 5) for k, v in metrics.items() if isinstance(v, float)})
    return (pipeline, metrics) if return_pipeline else 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s", force=True)
    try:
        code = main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(code)
