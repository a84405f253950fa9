"""Engine-parameter binding.

Counterpart of ``predictionio_tpu/controller/params.py`` (a copy: the
port imports nothing of the JAX package).

Reference: the ``Params`` marker trait (core/.../controller/Params.scala) plus
``JsonExtractor`` (core/.../workflow/JsonExtractor.scala), which binds the
``engine.json`` params blocks to Scala case classes.  Here ``Params`` is a
dataclass base with ``from_json``/``to_json`` doing the same field-checked
binding (unknown keys rejected, missing non-default keys rejected — matching
the reference's strict extraction mode).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, Mapping, Type, TypeVar

T = TypeVar("T", bound="Params")


@dataclasses.dataclass
class Params:
    """Base class for all DASE component parameter sets."""

    @classmethod
    def from_json(cls: Type[T], data: Any) -> T:
        if data is None:
            data = {}
        if isinstance(data, str):
            data = json.loads(data) if data.strip() else {}
        if not isinstance(data, Mapping):
            raise TypeError(f"{cls.__name__} params must be a JSON object, got {type(data).__name__}")
        fields = {f.name: f for f in dataclasses.fields(cls)}
        # The reference's engine.json uses camelCase keys ("appName",
        # "numIterations", "lambda"); accept both spellings.
        data = {_match_key(k, fields, cls.__name__): v for k, v in data.items()}
        unknown = set(data) - set(fields)
        if unknown:
            raise ValueError(f"{cls.__name__}: unknown parameter(s) {sorted(unknown)}")
        kwargs: Dict[str, Any] = {}
        for name, f in fields.items():
            if name in data:
                kwargs[name] = _coerce(data[name], f.type, f"{cls.__name__}.{name}")
            elif (
                f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING  # type: ignore[misc]
            ):
                raise ValueError(f"{cls.__name__}: required parameter {name!r} missing")
        return cls(**kwargs)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    def replace(self: T, **changes: Any) -> T:
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class EmptyParams(Params):
    """Reference: EmptyParams — for components that take no parameters."""


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _match_key(key: str, fields: Mapping[str, Any], cls_name: str) -> str:
    if key in fields:
        return key
    snake = _snake(key)
    if snake in fields:
        return snake
    if snake + "_" in fields:  # reserved words: lambda -> lambda_
        return snake + "_"
    return key


def _coerce(value: Any, annot: Any, where: str) -> Any:
    """Best-effort typed coercion from JSON values to the annotated type."""
    if isinstance(annot, str):
        # String annotations (from __future__ annotations): resolve builtins only.
        annot = {"int": int, "float": float, "str": str, "bool": bool}.get(annot, None)
        if annot is None:
            return value
    origin = typing.get_origin(annot)
    if origin is typing.Union:
        args = [a for a in typing.get_args(annot) if a is not type(None)]
        if value is None:
            return None
        if len(args) == 1:
            return _coerce(value, args[0], where)
        return value
    if origin in (list, tuple):
        (item_t, *_rest) = typing.get_args(annot) or (Any,)
        seq = [_coerce(v, item_t, where) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        return dict(value)
    if annot is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"{where}: expected float, got {value!r}")
        return float(value)
    if annot is int:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"{where}: expected int, got {value!r}")
        if isinstance(value, float) and not value.is_integer():
            raise TypeError(f"{where}: expected int, got {value!r}")
        return int(value)
    if annot is bool and not isinstance(value, bool):
        raise TypeError(f"{where}: expected bool, got {value!r}")
    if annot is str and not isinstance(value, str):
        raise TypeError(f"{where}: expected str, got {value!r}")
    return value
