"""Dataclass configs built from YAML dicts and dumped back to dicts.

The JAX package's configs are pydantic models; the port's are dataclasses.
``build`` gives them what pydantic gives the JAX package: nested dataclasses,
lists and dicts of them, enums and optional fields are built from plain
values by the field's annotation, and YAML scalars are coerced (``1e-4``,
which YAML reads as a string, becomes a float). ``model_dump`` is pydantic's
``model_dump``: a field declared as a base class dumps the base class's
fields only, unless ``serialize_as_any`` asks for the value's own.

A field whose ``metadata`` has ``exclude`` is left out of the dump, as
pydantic's ``Field(exclude=True)``. A class's ``extra`` attribute says what
becomes of unknown keys: ``"ignore"`` (pydantic's default), ``"forbid"`` or
``"allow"`` (kept, and dumped, as attributes).
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Dict, Optional, Union

_NONE = type(None)


def _hints(cls) -> Dict[str, Any]:
    return typing.get_type_hints(cls)


def coerce(hint, value):
    """``value`` as the annotation ``hint`` asks, as pydantic's lax mode does."""
    if value is None:
        return None
    origin = typing.get_origin(hint)
    args = typing.get_args(hint)
    if origin is Union:
        inner = [a for a in args if a is not _NONE]
        if len(inner) == 1:
            return coerce(inner[0], value)
        return value
    if origin in (list, typing.List) and args:
        return [coerce(args[0], v) for v in value]
    if origin in (tuple, typing.Tuple) and args:
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(coerce(args[0], v) for v in value)
        return tuple(coerce(a, v) for a, v in zip(args, value))
    if origin in (dict, typing.Dict) and len(args) == 2:
        return {k: coerce(args[1], v) for k, v in value.items()}
    if isinstance(hint, type):
        if dataclasses.is_dataclass(hint):
            return build(hint, value)
        if issubclass(hint, enum.Enum):
            return value if isinstance(value, hint) else hint(value)
        if hint is float and isinstance(value, (str, int)) and not isinstance(value, bool):
            return float(value)
        if hint is int and isinstance(value, str):
            return int(value)
        if hint is str and isinstance(value, (int, float)) and not isinstance(value, bool):
            return str(value)
    return value


def build(cls, value):
    """A ``cls`` from a dict, or ``value`` itself when it already is one.
    A class with a ``from_dict`` classmethod builds itself."""
    if value is None or isinstance(value, cls):
        return value
    if not isinstance(value, dict):
        raise TypeError(f"{cls.__name__} expects a dict, got {type(value).__name__}")
    if "from_dict" in cls.__dict__:
        return cls.from_dict(value)
    return build_fields(cls, value)


def build_fields(cls, value: dict, extra: Optional[str] = None):
    """``cls(**value)`` with each known field coerced by its annotation;
    unknown keys as ``extra`` says (by default the class's ``extra``)."""
    hints = _hints(cls)
    names = {f.name for f in dataclasses.fields(cls) if f.init}
    unknown = [k for k in value if k not in names]
    extra = extra or getattr(cls, "extra", "ignore")
    if unknown and extra == "forbid":
        raise TypeError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    obj = cls(**{k: coerce(hints[k], v) for k, v in value.items() if k in names})
    if extra == "allow":
        for k in unknown:
            setattr(obj, k, value[k])
        obj.__dict__.setdefault("_extra_keys", []).extend(unknown)
    return obj


def model_dump(obj, serialize_as_any: bool = False, declared=None):
    """Plain dicts, lists and tuples of ``obj``, as pydantic's ``model_dump``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        if not serialize_as_any and isinstance(declared, type) and dataclasses.is_dataclass(declared):
            cls = declared
        hints = _hints(cls)
        out = {
            f.name: model_dump(getattr(obj, f.name), serialize_as_any, hints.get(f.name))
            for f in dataclasses.fields(cls)
            if not f.metadata.get("exclude")
        }
        for k in obj.__dict__.get("_extra_keys", ()):
            out[k] = model_dump(getattr(obj, k), serialize_as_any)
        return out
    origin = typing.get_origin(declared)
    args = typing.get_args(declared)
    if origin is Union:
        inner = [a for a in args if a is not _NONE]
        declared = inner[0] if len(inner) == 1 else None
        origin, args = typing.get_origin(declared), typing.get_args(declared)
    if isinstance(obj, list):
        elem = args[0] if origin in (list, typing.List) and args else None
        return [model_dump(v, serialize_as_any, elem) for v in obj]
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(model_dump(v, serialize_as_any) for v in obj)
    if isinstance(obj, dict):
        elem = args[1] if origin in (dict, typing.Dict) and len(args) == 2 else None
        return {k: model_dump(v, serialize_as_any, elem) for k, v in obj.items()}
    return obj


def to_json_value(obj):
    """A dump made JSON-ready, as pydantic's ``model_dump_json``: enums by
    value, tuples as lists."""
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [to_json_value(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_json_value(v) for k, v in obj.items()}
    return obj
