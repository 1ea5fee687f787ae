"""YAML config system, API-compatible with the reference's yacs front-end.

The reference loads one whole YAML file into a frozen ``yacs.CfgNode``
(reference ``config.py:5-18``) selected by a single ``--config`` CLI flag
(``config.py:21-25``), defaulting to ``configs/Baseline.yaml``. Components
duck-type-probe the node (``'key' in config``, attribute access). We reproduce
those exact semantics with a small self-contained ``ConfigNode`` (no yacs
dependency): attribute access, containment checks, freezing, and a yacs-style
``__str__``.
"""

from __future__ import annotations

import argparse
import copy
import io
import os

import yaml


class ConfigNode(dict):
    """A dict with attribute access and freeze semantics (yacs-compatible subset)."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else dict(init_dict)
        super().__init__()
        object.__setattr__(self, ConfigNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            self[k] = self._convert(v)

    @classmethod
    def _convert(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigNode):
            return cls(v)
        if isinstance(v, list):
            return [cls._convert(x) for x in v]
        return v

    # --- attribute access -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if object.__getattribute__(self, ConfigNode.IMMUTABLE):
            raise AttributeError(f"Attempted to set {name} on an immutable ConfigNode")
        self[name] = self._convert(value)

    def __setitem__(self, key, value):
        if object.__getattribute__(self, ConfigNode.IMMUTABLE):
            raise AttributeError(f"Attempted to set {key} on an immutable ConfigNode")
        super().__setitem__(key, self._convert(value))

    # --- freeze ------------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)
        return self

    def defrost(self):
        self._set_immutable(False)
        return self

    def is_frozen(self):
        return object.__getattribute__(self, ConfigNode.IMMUTABLE)

    def _set_immutable(self, flag):
        object.__setattr__(self, ConfigNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v._set_immutable(flag)

    def clone(self):
        node = ConfigNode(copy.deepcopy(self.to_dict()))
        return node

    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigNode):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, ConfigNode) else x for x in v]
            else:
                out[k] = v
        return out

    def get(self, key, default=None):
        return super().get(key, default)

    # --- yacs-style printing ------------------------------------------------
    def __str__(self):
        def _render(node, indent):
            lines = []
            for k in sorted(node.keys()):
                v = node[k]
                if isinstance(v, ConfigNode):
                    lines.append(" " * indent + f"{k}:")
                    lines.extend(_render(v, indent + 2))
                else:
                    lines.append(" " * indent + f"{k}: {v}")
            return lines

        return "\n".join(_render(self, 0))

    def __repr__(self):
        return f"ConfigNode({super().__repr__()})"

    def dump(self):
        """Serialize back to YAML text."""
        buf = io.StringIO()
        yaml.safe_dump(self.to_dict(), buf, default_flow_style=False)
        return buf.getvalue()


def load_yaml_config(path) -> ConfigNode:
    with open(path) as f:
        data = yaml.safe_load(f)
    return ConfigNode(data or {})


def build_config_from_dict(d) -> ConfigNode:
    """Reference: ``utils/utils.py:95-99`` (dict → frozen config node)."""
    cfg = ConfigNode(d)
    cfg.freeze()
    return cfg


_DEFAULT_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "Baseline.yaml"
)


def setup_config(argv=None, default_path=None) -> ConfigNode:
    """Load one YAML file given by ``--config`` and freeze it.

    Mirrors reference ``config.py:5-18``: no CLI overrides, no merging — the
    YAML file *is* the config.
    """
    parser = argparse.ArgumentParser(description="Hawkeye (PyTorch)")
    parser.add_argument("--config", default=None, type=str, help="path to config file")
    args, _ = parser.parse_known_args(argv)
    path = args.config or default_path or _DEFAULT_CONFIG_PATH
    cfg = load_yaml_config(path)
    cfg.freeze()
    return cfg
