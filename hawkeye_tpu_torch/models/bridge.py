"""Weight bridge between the JAX package's flax variables and this port.

``load_jax_variables(module, variables)`` takes the JAX variables tree as
nested dicts of numpy arrays (``jax.device_get`` of the flax tree) and fills
the module's parameters; ``export_jax_variables(module)`` is the inverse, so
tests can compare parameters after an update.

Name map: a flax path ``a/b/convN/kernel`` is the parameter
``a.b.features.N.weight`` (``convN`` carries the torchvision index, for
``nn.Conv`` and the ``_Conv3x3Params`` twin alike); every other segment is
kept, ``kernel`` becomes ``weight``. Layouts: conv kernel HWIO <-> weight
OIHW, dense kernel [in, out] <-> weight [out, in]; biases as they are.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_CONV = re.compile(r"conv(\d+)")
_FEATURES = re.compile(r"features\.(\d+)")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def torch_name(jax_path) -> str:
    *mods, leaf = jax_path
    segs = []
    for s in mods:
        m = _CONV.fullmatch(s)
        segs.append(f"features.{m.group(1)}" if m else s)
    segs.append({"kernel": "weight"}.get(leaf, leaf))
    return ".".join(segs)


def jax_path(name: str) -> tuple:
    name = _FEATURES.sub(lambda m: f"conv{m.group(1)}", name)
    *mods, leaf = name.split(".")
    return tuple(mods) + ({"weight": "kernel"}.get(leaf, leaf),)


def _to_torch_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T  # [in, out] -> [out, in]
    return arr


def _to_jax_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "weight" and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if leaf == "weight" and arr.ndim == 2:
        return arr.T
    return arr


@torch.no_grad()
def load_jax_variables(module: torch.nn.Module, variables: dict):
    """Copy ``variables['params']`` into ``module``. Every parameter must be
    filled exactly once, with a matching shape, or this raises."""
    params = dict(module.named_parameters())
    filled = set()
    for path, arr in _flatten(variables["params"]):
        name = torch_name(path)
        if name not in params:
            raise KeyError(f"no parameter {name!r} for flax path {'/'.join(path)}")
        src = np.array(_to_torch_layout(np.asarray(arr), path[-1]), order="C",
                       copy=True)
        p = params[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)} vs flax "
                             f"{tuple(src.shape)}")
        p.copy_(torch.from_numpy(src).to(p.dtype))
        filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"parameters with no flax counterpart: {missing}")
    return module


def export_jax_variables(module: torch.nn.Module) -> dict:
    """The module's parameters as a flax-layout ``{'params': {...}}`` tree of
    float32 numpy arrays."""
    tree: dict = {}
    for name, p in module.named_parameters():
        path = jax_path(name)
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        arr = p.detach().float().cpu().numpy()
        # a copy: the array must not alias the parameter's memory
        node[path[-1]] = np.array(_to_jax_layout(arr, name.rsplit(".", 1)[-1]),
                                  order="C", copy=True)
    return {"params": tree}
