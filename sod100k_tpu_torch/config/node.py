"""Minimal yacs-compatible configuration node.

Port of ``sod100k_tpu/config/node.py``: attribute access, nested nodes,
merge_from_file / merge_from_other_cfg / merge_from_list with unknown-key
rejection and type coercion, clone, and pretty printing. YAML goes through
``miniyaml`` (the machine with the card has no PyYAML), which reads what
the reference configs use as PyYAML does; reference YAML files load
unchanged.
"""

from __future__ import annotations

import copy
from typing import Any

from . import miniyaml

# a node of the JAX package's schema with another name here
_RENAMED = {"TPU": "CUDA"}


class CfgNode(dict):
    def __init__(self, init: dict | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # --- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    # --- merging ----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode | dict", _path: str = "") -> None:
        for k, v in other.items():
            full = f"{_path}.{k}" if _path else k
            if k not in self:
                hint = (f" (this package's node is {_RENAMED[full]}:)"
                        if full in _RENAMED and _RENAMED[full] in self else "")
                raise KeyError(f"Non-existent config key: {full}{hint}")
            cur = self[k]
            if isinstance(cur, CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot overwrite node {full} with a leaf")
                cur.merge_from_other_cfg(v, full)
            else:
                self[k] = _coerce(v, cur, full)

    def merge_from_file(self, filename: str) -> None:
        data = miniyaml.load_file(filename) or {}
        self.merge_from_other_cfg(data)

    def merge_from_list(self, opts: list) -> None:
        assert len(opts) % 2 == 0, "override list must be key/value pairs"
        for key, val in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(val, str):
                val = miniyaml.parse_value(val)
            node[leaf] = _coerce(val, node[leaf], key)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __str__(self) -> str:
        def fmt(node, indent=0):
            lines = []
            for k in sorted(node):
                v = node[k]
                if isinstance(v, CfgNode):
                    lines.append(" " * indent + f"{k}:")
                    lines.append(fmt(v, indent + 2))
                else:
                    lines.append(" " * indent + f"{k}: {v}")
            return "\n".join(lines)

        return fmt(self)

    __repr__ = __str__


def _coerce(value: Any, current: Any, path: str) -> Any:
    """yacs-style permissive type checking: allow compatible replacements,
    coerce int->float and list<->tuple, reject the rest."""
    if current is None or value is None:
        return value
    # YAML 1.1 parses dot-less exponents like `1e-20` as strings; coerce them
    # numerically when the schema expects a number (yacs behaves likewise).
    if isinstance(current, (int, float)) and not isinstance(current, bool) \
            and isinstance(value, str):
        try:
            value = float(value)
        except ValueError:
            pass
    if isinstance(current, bool) or isinstance(value, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Type mismatch for {path}: {value!r} is not bool")
    if isinstance(current, float) and isinstance(value, int):
        return float(value)
    if isinstance(current, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if type(current) is type(value):
        return value
    if isinstance(current, (int, float)) and isinstance(value, (int, float)):
        return value
    raise TypeError(
        f"Type mismatch for {path}: {type(value).__name__} vs "
        f"{type(current).__name__}"
    )
