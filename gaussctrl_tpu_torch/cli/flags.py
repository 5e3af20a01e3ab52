"""Dotted-flag CLI parsing over nested dataclasses.

Counterpart of `gaussctrl_tpu/cli/flags.py`: every field of a (nested)
dataclass becomes a `--path.to.field` flag, as tyro exposes the reference's
configs, and values are parsed by the field's type.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, get_args, get_origin


def _coerce(value: str, typ) -> Any:
    origin = get_origin(typ)
    if origin is not None:
        args = [a for a in get_args(typ) if a is not type(None)]
        if args:
            return _coerce(value, args[0])
    if typ is bool or isinstance(typ, type) and issubclass(typ, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str):
        return typ(value)
    try:
        return int(value)
    except ValueError:
        try:
            return float(value)
        except ValueError:
            return value


def _field_types(cls):
    import typing
    try:
        return typing.get_type_hints(cls)
    except Exception:
        return {f.name: f.type for f in dataclasses.fields(cls)}


def add_dataclass_flags(parser: argparse.ArgumentParser, cls, prefix: str = ""):
    """Register --prefix.field flags for every leaf field of a dataclass."""
    hints = _field_types(cls)
    for f in dataclasses.fields(cls):
        name = f"{prefix}.{f.name}" if prefix else f.name
        typ = hints.get(f.name, f.type)
        if isinstance(typ, type) and dataclasses.is_dataclass(typ):
            add_dataclass_flags(parser, typ, name)
        else:
            parser.add_argument(f"--{name}", type=str, default=None,
                                help=f"({getattr(typ, '__name__', typ)})")


def apply_overrides(obj, args: argparse.Namespace, prefix: str = ""):
    """Apply parsed --a.b.c overrides onto a dataclass instance (returns new)."""
    hints = _field_types(type(obj))
    updates = {}
    for f in dataclasses.fields(obj):
        name = f"{prefix}.{f.name}" if prefix else f.name
        attr = name.replace("-", "_")
        if dataclasses.is_dataclass(getattr(obj, f.name)):
            updates[f.name] = apply_overrides(getattr(obj, f.name), args, name)
        else:
            raw = getattr(args, attr, None)
            if raw is not None:
                updates[f.name] = _coerce(raw, hints.get(f.name, f.type))
    return dataclasses.replace(obj, **updates) if updates else obj
