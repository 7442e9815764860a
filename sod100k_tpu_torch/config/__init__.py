"""yacs-compatible config layer; reference YAML files load unchanged."""

from .defaults import get_cfg
from .node import CfgNode

__all__ = ["CfgNode", "get_cfg"]
