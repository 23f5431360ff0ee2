"""Generic dataclass <-> plain-dict codec for the wire protocol.

The reference uses msgpack with hand-registered Go structs
(reference nomad/structs/structs.go:63-77 Encode/Decode). Here every
struct is a Python dataclass and the codec is derived from type hints,
so the HTTP API, the replicated log, and client state persistence all
share one serialization path.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from enum import Enum
from typing import Any, Optional, get_args, get_origin, get_type_hints

_HINTS_CACHE: dict[type, dict[str, Any]] = {}


def _hints(cls: type) -> dict[str, Any]:
    h = _HINTS_CACHE.get(cls)
    if h is None:
        h = get_type_hints(cls)
        _HINTS_CACHE[cls] = h
    return h


def to_dict(obj: Any) -> Any:
    """Recursively convert dataclasses/lists/dicts into JSON-able values."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, bytes):
        return obj.hex()
    raise TypeError(f"cannot encode {type(obj)!r}")


def from_dict(cls: Any, data: Any) -> Any:
    """Reconstruct a value of annotated type `cls` from plain data."""
    if data is None:
        return None
    origin = get_origin(cls)
    if origin is typing.Union:  # Optional[X] and unions
        args = [a for a in get_args(cls) if a is not type(None)]
        if len(args) == 1:
            return from_dict(args[0], data)
        return data  # ambiguous union: pass through
    if origin in (list, tuple, set):
        (item_t,) = get_args(cls) or (Any,)
        seq = [from_dict(item_t, v) for v in data]
        return origin(seq) if origin is not list else seq
    if origin is dict:
        args = get_args(cls)
        val_t = args[1] if len(args) == 2 else Any
        return {k: from_dict(val_t, v) for k, v in data.items()}
    if isinstance(cls, type) and issubclass(cls, Enum):
        return cls(data)
    if dataclasses.is_dataclass(cls):
        hints = _hints(cls)
        kwargs = {}
        names = {f.name for f in dataclasses.fields(cls)}
        for key, value in data.items():
            if key in names:
                kwargs[key] = from_dict(hints.get(key, Any), value)
        return cls(**kwargs)
    if cls in (Any, object) or cls is None:
        return data
    if isinstance(cls, type) and isinstance(data, cls):
        return data
    if cls is float and isinstance(data, int):
        return float(data)
    return data


def encode(obj: Any) -> bytes:
    return json.dumps(to_dict(obj), separators=(",", ":"), sort_keys=True).encode()


def decode(cls: Any, raw: bytes) -> Any:
    return from_dict(cls, json.loads(raw))
