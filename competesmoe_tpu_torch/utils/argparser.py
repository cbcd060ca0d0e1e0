"""Dotted hierarchical argument parser.

Re-design of `moe_pretrain_model/framework/helpers/argument_parser.py`:
flags registered next to the code that uses them (`-lm.unroll 1024` style),
typed by their default value, with `none` sentinels, and `@args` hook
registration (task_db.py). The parsing part of
competesmoe_tpu/utils/argparser.py (pure Python), with the flat dict of a
parsed namespace that a checkpoint keeps.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional


class DotDict(SimpleNamespace):
    """Namespace addressable as args.lm.unroll from dotted keys."""


def _parse_bool(s: str) -> bool:
    if isinstance(s, bool):
        return s
    if s.lower() in ("1", "true", "yes", "on"):
        return True
    if s.lower() in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"not a bool: {s!r}")


class ArgumentParser:
    def __init__(self):
        self._defaults: Dict[str, Any] = {}
        self._parsers: Dict[str, Callable[[str], Any]] = {}
        self._choices: Dict[str, List[str]] = {}

    # -- registration --

    def add_argument(self, name: str, default: Any = None,
                     parser: Optional[Callable[[str], Any]] = None,
                     choice: Optional[List[str]] = None) -> None:
        key = name.lstrip("-")
        if key in self._defaults:
            raise ValueError(f"duplicate flag {key!r}")
        if parser is not None and isinstance(default, str):
            default = parser(default)  # e.g. "none" -> None
        self._defaults[key] = default
        if parser is not None:
            self._parsers[key] = parser
        elif isinstance(default, bool):
            self._parsers[key] = _parse_bool
        elif isinstance(default, int):
            self._parsers[key] = int
        elif isinstance(default, float):
            self._parsers[key] = float
        else:
            self._parsers[key] = str
        if choice:
            self._choices[key] = list(choice)

    # optional-value parsers, mirrored from the reference's API
    @staticmethod
    def int_or_none_parser(s: str) -> Optional[int]:
        return None if s.lower() == "none" else int(s)

    @staticmethod
    def str_or_none_parser(s: str) -> Optional[str]:
        return None if s.lower() == "none" else s

    # -- parsing --

    def parse(self, argv: Optional[List[str]] = None) -> DotDict:
        argv = list(sys.argv[1:] if argv is None else argv)
        values = dict(self._defaults)
        i = 0
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("-"):
                raise ValueError(f"expected flag, got {tok!r}")
            key = tok.lstrip("-")
            if "=" in key:
                key, raw = key.split("=", 1)
                i += 1
            else:
                if i + 1 >= len(argv):
                    raise ValueError(f"flag {tok} missing a value")
                raw = argv[i + 1]
                i += 2
            if key not in self._defaults:
                raise ValueError(f"unknown flag -{key}. Known: "
                                 f"{', '.join(sorted(self._defaults))}")
            val = self._parsers[key](raw)
            if key in self._choices and val not in self._choices[key]:
                raise ValueError(
                    f"-{key} must be one of {self._choices[key]}, got {val!r}")
            values[key] = val
        return self.to_namespace(values)

    @staticmethod
    def namespace_to_dict(ns: DotDict) -> Dict[str, Any]:
        """{dotted flag: value} of a parsed namespace."""
        out: Dict[str, Any] = {}

        def walk(node: DotDict, prefix: str) -> None:
            for key, val in vars(node).items():
                if isinstance(val, DotDict):
                    walk(val, f"{prefix}{key}.")
                else:
                    out[prefix + key] = val
        walk(ns, "")
        return out

    def to_namespace(self, values: Dict[str, Any]) -> DotDict:
        root = DotDict()
        for key, val in values.items():
            parts = key.split(".")
            cur = root
            for p in parts[:-1]:
                if not hasattr(cur, p) or not isinstance(getattr(cur, p),
                                                         DotDict):
                    setattr(cur, p, DotDict())
                cur = getattr(cur, p)
            setattr(cur, parts[-1], val)
        return root


# `@args` hook registry (task/task_db.py:30-59 role)
_ARG_HOOKS: List[Callable[[ArgumentParser], None]] = []


def args(fn: Callable[[ArgumentParser], None]):
    _ARG_HOOKS.append(fn)
    return fn


def build_parser() -> ArgumentParser:
    p = ArgumentParser()
    for hook in _ARG_HOOKS:
        hook(p)
    return p
