"""YAML config composition and interpolation.

Port of ``recommendations_tpu/config/yaml_loader.py``, with the same rules:

- ``defaults:`` list: each ``group: name`` entry loads
  ``<search_path>/<group>/<name>.yaml`` and merges it under the key
  ``group``; ``_self_`` places the file's own keys (hydra's semantics);
- ``${a.b.c}`` interpolation into the composed tree;
- the safe resolvers ``${now:%fmt}``, ``${random_chars:N}``,
  ``${current_time:}``, ``${day_before_days:N}``, ``${pow:a,b}`` and
  ``${mul:a,b}`` (no ``eval``);
- ``a.b.c=value`` command-line overrides, each value read as YAML.

A config with ``joint: true`` becomes the joint pipeline's config
(``pipeline/joint_pipeline.py``), its stages composed from the configs they
name.
"""

from __future__ import annotations

import datetime
import random
import re
import string
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml

_INTERP = re.compile(r"\$\{([^{}]+)\}")


def _resolver(name: str, arg: str, root: Dict[str, Any]) -> Any:
    name = name.strip()
    if name == "now":
        return datetime.datetime.now().strftime(arg.strip())
    if name == "random_chars":
        return "".join(random.choices(string.ascii_lowercase, k=int(arg)))
    if name == "current_time":
        return int(datetime.datetime.now().timestamp())
    if name == "day_before_days":
        d = datetime.datetime.now() - datetime.timedelta(days=int(arg))
        return d.strftime("%Y%m%d")
    if name == "pow":
        a, b = [int(x) for x in arg.split(",")]
        return a**b
    if name == "mul":
        out = 1.0
        for p in (float(x) for x in arg.split(",")):
            out *= p
        return int(out) if out == int(out) else out
    raise KeyError(f"Unknown resolver: {name}")


def _lookup(root: Dict[str, Any], dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        node = node[part]
    return node


def _resolve_value(value: Any, root: Dict[str, Any], depth: int = 0) -> Any:
    if depth > 20:
        raise ValueError("interpolation recursion limit")
    if isinstance(value, str):
        full = _INTERP.fullmatch(value.strip())
        if full:
            out = _resolve_expr(full.group(1), root)
            return _resolve_value(out, root, depth + 1) if isinstance(out, str) else out
        return _INTERP.sub(lambda m: str(_resolve_expr(m.group(1), root)), value)
    if isinstance(value, dict):
        return {k: _resolve_value(v, root, depth) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_value(v, root, depth) for v in value]
    return value


def _resolve_expr(expr: str, root: Dict[str, Any]) -> Any:
    if ":" in expr:
        name, arg = expr.split(":", 1)
        return _resolver(name, arg, root)
    return _resolve_value(_lookup(root, expr.strip()), root, 1)


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _find_group_file(search_paths: List[Path], group: str, name: str) -> Path:
    for sp in search_paths:
        p = sp / group / f"{name}.yaml"
        if p.exists():
            return p
    raise FileNotFoundError(f"No config '{group}/{name}.yaml' under {[str(s) for s in search_paths]}")


def compose_config(
    config_path: Union[str, Path],
    overrides: Optional[Dict[str, Any]] = None,
    search_paths: Optional[List[Union[str, Path]]] = None,
) -> Dict[str, Any]:
    config_path = Path(config_path)
    paths = [Path(p) for p in (search_paths or [])]
    if config_path.parent not in paths:
        paths.insert(0, config_path.parent)

    with open(config_path) as f:
        raw = yaml.safe_load(f) or {}

    defaults = raw.pop("defaults", [])
    composed: Dict[str, Any] = {}
    self_done = False
    for entry in defaults:
        if entry == "_self_":
            composed = _deep_merge(composed, raw)
            self_done = True
            continue
        if isinstance(entry, dict):
            [(group, name)] = entry.items()
            with open(_find_group_file(paths, group, str(name))) as f:
                group_cfg = yaml.safe_load(f) or {}
            composed = _deep_merge(composed, {group: group_cfg})
    if not self_done:
        composed = _deep_merge(composed, raw)
    if overrides:
        composed = _deep_merge(composed, overrides)
    return _resolve_value(composed, composed)


def load_config(
    config_path: Union[str, Path],
    overrides: Optional[Dict[str, Any]] = None,
    search_paths: Optional[List[Union[str, Path]]] = None,
):
    """Compose the YAML, then build the root pipeline config. A top-level
    ``joint: true`` selects the two-stage retrieval -> ranking config
    (``pipeline/joint_pipeline.py``), whose stages may name a single-model
    config (``{config_name: lthm_tiny, overrides: {...}}``), composed with the
    same search paths."""
    from recommendations_tpu_torch.config.pipeline_config import TrainerPipelineConfig

    data = compose_config(config_path, overrides, search_paths)
    if data.get("joint"):
        from recommendations_tpu_torch.pipeline.joint_pipeline import JointPipelineConfig

        base_dir = Path(config_path).parent
        for stage in ("retrieval", "ranking"):
            sec = data.get(stage)
            if isinstance(sec, dict) and "config_name" in sec:
                composed = compose_config(base_dir / f"{sec['config_name']}.yaml", sec.get("overrides"), search_paths)
                composed.pop("joint", None)
                data[stage] = composed
        return JointPipelineConfig.from_dict(data)
    return TrainerPipelineConfig.from_dict(data)


def parse_cli_overrides(args: List[str]) -> Dict[str, Any]:
    """hydra-style ``a.b.c=value`` overrides -> a nested dict."""
    out: Dict[str, Any] = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"Override must be key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        try:
            parsed = yaml.safe_load(value)
        except yaml.YAMLError:
            parsed = value
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parsed
    return out
