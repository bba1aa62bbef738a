"""Carry descriptors and operands across from the JAX package.

libxsmm_torch imports nothing of libxsmm_tpu; a test that runs both on the
same descriptor and the same data moves them through plain values:

* `descriptor_fields(desc)` turns any descriptor dataclass (of either
  package, by duck typing) into `dataclasses.asdict` form with every enum
  member written as a string (its name; flag combinations "A|B").
* `descriptor_from_fields(fields)` rebuilds the port's descriptor from that
  dict. The class is named by `cls` or found from the dict's keys.
* `tensor_from_numpy(x, datatype, device)` loads a numpy array (including
  ml_dtypes' bfloat16/float8 arrays, bit for bit) as a tensor of the
  Datatype's torch dtype.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import descriptor as _d
from .device import resolve_device
from .dtypes import Datatype, to_torch

# the descriptor classes a dict can name, by their field sets
_CLASSES = (_d.GemmShape, _d.BatchReduceConfig, _d.GemmDescriptor,
            _d.UnaryArgops, _d.BinaryPostops, _d.GemmExtDescriptor,
            _d.MeltwDescriptor, _d.SpgemmConfig, _d.SparsePattern,
            _d.MeltwUnaryShape, _d.MeltwBinaryShape, _d.MeltwTernaryShape)


def _enum_str(e: enum.Enum) -> str:
    return e.name if e.name is not None else str(e.value)


def _plain(value):
    if isinstance(value, enum.Enum):
        return _enum_str(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def descriptor_fields(desc) -> Dict[str, Any]:
    """dataclasses.asdict(desc) with enum members as strings (the cached
    hash that descriptors keep in their __dict__ is not a field)."""
    return _plain(dataclasses.asdict(desc))


def _enum_from_str(cls, text: str):
    if issubclass(cls, enum.Flag):
        if text.lstrip("-").isdigit():
            return cls(int(text))
        out = cls(0)
        for part in text.split("|"):
            out |= cls[part]
        return out
    try:
        return cls[text]
    except KeyError:
        return cls(text)        # Datatype values such as "f32"


def _convert(hint, value):
    if value is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union:      # Optional[X]
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return _convert(args[0], value)
    if hint in (enum.Enum, enum.IntFlag):
        return value        # typed by another field (MeltwDescriptor)
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        return (value if isinstance(value, hint)
                else _enum_from_str(hint, str(value)))
    if dataclasses.is_dataclass(hint):
        return descriptor_from_fields(value, hint)
    if origin is tuple and isinstance(value, list):
        return tuple(value)
    return value


def _find_class(fields: Dict[str, Any]):
    keys = set(fields)
    for cls in _CLASSES:
        if {f.name for f in dataclasses.fields(cls)} == keys:
            return cls
    raise ValueError(f"no descriptor class has the fields {sorted(keys)}")


def descriptor_from_fields(fields: Dict[str, Any], cls: Optional[type] = None):
    """Rebuild a port descriptor from descriptor_fields() output."""
    cls = cls or _find_class(fields)
    hints = typing.get_type_hints(cls, vars(_d))
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in fields:
            kwargs[f.name] = _convert(hints.get(f.name), fields[f.name])
    if cls is _d.MeltwDescriptor:
        # op_type / flags are typed by the operation, not the annotation
        op = kwargs["operation"]
        op_cls = {"unary": _d.UnaryType, "binary": _d.BinaryType,
                  "ternary": _d.TernaryType}[op]
        flag_cls = {"unary": _d.UnaryFlags, "binary": _d.BinaryFlags,
                    "ternary": _d.TernaryFlags}[op]
        kwargs["op_type"] = _enum_from_str(op_cls, str(fields["op_type"]))
        kwargs["flags"] = _enum_from_str(flag_cls, str(fields["flags"]))
    return cls(**kwargs)


_BITS_VIEW = {torch.bfloat16: np.uint16, torch.float8_e5m2: np.uint8,
              torch.float8_e4m3fn: np.uint8}


def tensor_from_numpy(x, datatype: Datatype, device=None) -> torch.Tensor:
    """Load numpy data as a tensor of `datatype` on `device` (default: the
    GPU). An array that already holds that type (ml_dtypes' bfloat16 or
    float8, as np.asarray of a JAX array gives) is moved bit for bit;
    anything else is converted by torch (round to nearest even)."""
    dev = resolve_device(device)
    dtype = to_torch(datatype)
    x = np.array(x, order="C")      # a writable copy
    view = _BITS_VIEW.get(dtype)
    if view is not None and x.dtype.name == str(dtype).split(".")[-1]:
        return torch.from_numpy(x.view(view)).view(dtype).to(dev)
    return torch.from_numpy(x).to(device=dev, dtype=dtype)
