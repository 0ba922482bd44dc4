"""Minimal dataclass CLI (copy of vla_adapter_tpu/core/cli.py).

The reference drives every entry point with ``@draccus.wrap()`` dotted-path
overrides. This is the same use without the dependency:
``parse_config(DeployConfig, ["--port", "9000", "--act_int8", "true"])``
rebuilds the frozen dataclass tree with the overrides applied.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
import typing
from typing import Any, List, Optional, Sequence, Type, TypeVar

T = TypeVar("T")


def _convert(value: str, typ) -> Any:
    import types

    origin = typing.get_origin(typ)
    # both spellings: Optional[X]/Union[X, None] AND PEP 604 `X | None`
    # (types.UnionType) — the latter would otherwise fall through every
    # branch and store the raw CLI string
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        return _convert(value, args[0])
    if typ is bool or typ == "bool":
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if isinstance(typ, type) and issubclass(typ, enum.Enum):
        return typ(value)
    if origin in (tuple, list):
        args = typing.get_args(typ)
        elem = args[0] if args else str
        parts = [p for p in value.split(",") if p]
        if typing.get_origin(elem) in (tuple, list):
            # nested pairs use ':' between elements, ',' between pairs —
            # e.g. --train.remat_policy_overrides vit:nothing,head:nothing
            inner = typing.get_args(elem)
            # validate arity now: a malformed pair (`vit`, `vit:a:b` against
            # a 2-tuple schema) would otherwise surface later as an opaque
            # unpack error, far from the flag
            n_expect = (0 if not inner or inner[-1] is Ellipsis
                        else len(inner))
            out = []
            for p in parts:
                qs = p.split(":")
                if n_expect and len(qs) != n_expect:
                    raise SystemExit(
                        f"malformed element {p!r} for {typ}: expected "
                        f"{n_expect} ':'-separated fields, got {len(qs)} "
                        f"(e.g. vit:nothing,head:nothing)")
                out.append(tuple(
                    _convert(q, inner[min(i, len(inner) - 1)] if inner else str)
                    for i, q in enumerate(qs)
                ))
            return tuple(out) if origin is tuple else out
        out = [_convert(p, elem) for p in parts]
        return tuple(out) if origin is tuple else out
    return value


def _set_path(cfg, path: List[str], value: str):
    if len(path) == 1:
        fields = {f.name: f for f in dataclasses.fields(cfg)}
        if path[0] not in fields:
            raise KeyError(
                f"unknown field {path[0]!r} on {type(cfg).__name__}; "
                f"known: {sorted(fields)}"
            )
        f = fields[path[0]]
        typ = f.type
        if isinstance(typ, str):  # from __future__ annotations
            hints = typing.get_type_hints(type(cfg))
            typ = hints[f.name]
        return dataclasses.replace(cfg, **{path[0]: _convert(value, typ)})
    child = getattr(cfg, path[0])
    return dataclasses.replace(cfg, **{path[0]: _set_path(child, path[1:], value)})


def parse_config(cls: Type[T], argv: Optional[Sequence[str]] = None,
                 base: Optional[T] = None) -> T:
    """Build cls() (or start from `base`) and apply --a.b.c value overrides.
    Also accepts --flag=value."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = base if base is not None else cls()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"expected --option, got {arg!r}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
            i += 1
        else:
            key = arg[2:]
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for --{key}")
            value = argv[i + 1]
            i += 2
        cfg = _set_path(cfg, key.split("."), value)
    return cfg
