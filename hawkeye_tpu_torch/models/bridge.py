"""Weight bridge between the JAX package's flax variables and this port.

``load_jax_variables(module, variables)`` takes the JAX variables tree as
nested dicts of numpy arrays (``jax.device_get`` of the flax tree) and fills
the module's parameters from ``params`` and its BatchNorm buffers from
``batch_stats``; ``export_jax_variables(module)`` is the inverse, so tests
can compare parameters and statistics after an update.

Name map, built from the module itself: a module path keeps its segments,
except that inside a VGG trunk ``features.N`` is flax's ``convN`` (the
torchvision index; in a nested model such as Peer-Learning's ``base_model``/``base_model2``
the rewrite applies inside each of its VGG trunks);
ResNet's ``conv1``/``layer1_0``/... are flax's names as they are. Leaves:
the ``weight`` of an ``nn.Conv2d`` or ``nn.Linear`` is ``kernel``; a
BatchNorm ``weight`` is ``scale``, its ``running_mean``/``running_var`` are
``batch_stats/.../{mean,var}``; ``bias`` stays. A raw ``nn.Parameter`` of a
module keeps its flax name and layout (Interp-Parts' ``grouping.weight``,
the ``[K, C]`` part centres, is flax's ``grouping/weight``). Layouts: conv
kernel HWIO <-> weight OIHW, dense kernel [in, out] <-> weight [out, in];
the rest as they are.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .backbones.norm import BatchNorm
from .backbones.vgg import VGG

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _flax_key(module, name):
    """(collection, flax path) of the parameter or buffer ``name``."""
    *mods, leaf = name.split(".")
    path, m, i = [], module, 0
    while i < len(mods):
        if isinstance(m, VGG) and mods[i] == "features":
            path.append(f"conv{mods[i + 1]}")
            m = m.features[mods[i + 1]]
            i += 2
        else:
            path.append(mods[i])
            m = getattr(m, mods[i])
            i += 1
    if isinstance(m, BatchNorm):
        collection, leaf = _BN_LEAVES[leaf]
    elif isinstance(m, (nn.Conv2d, nn.Linear)) and leaf == "weight":
        collection, leaf = "params", "kernel"
    else:
        collection = "params"
    return collection, tuple(path) + (leaf,)


def _name_map(module):
    """{(collection, flax path): (torch name, tensor)} over the parameters and
    the persistent buffers (``num_batches_tracked`` has no flax counterpart;
    a non-persistent buffer, such as CBCNN's sketches and irDFT matrices, is
    a derived constant like flax's ``fourier_cache``, which the bridge
    neither reads nor writes)."""
    persistent = set(module.state_dict())
    tensors = dict(module.named_parameters())
    tensors.update((n, b) for n, b in module.named_buffers()
                   if n in persistent and not n.endswith("num_batches_tracked"))
    return {_flax_key(module, n): (n, t) for n, t in tensors.items()}


def _to_torch_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T  # [in, out] -> [out, in]
    return arr


def _to_jax_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


@torch.no_grad()
def load_jax_variables(module: torch.nn.Module, variables: dict):
    """Copy ``variables['params']`` and ``variables['batch_stats']`` into
    ``module``. Every parameter and buffer must be filled exactly once, with
    a matching shape, or this raises."""
    targets = _name_map(module)
    filled = set()
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})):
            key = (collection, path)
            if key not in targets:
                raise KeyError(f"no parameter or buffer for flax "
                               f"{collection}/{'/'.join(path)}")
            name, t = targets[key]
            src = np.array(_to_torch_layout(np.asarray(arr), path[-1]),
                           order="C", copy=True)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} vs flax "
                                 f"{tuple(src.shape)}")
            t.copy_(torch.from_numpy(src).to(t.dtype))
            filled.add(name)
    missing = sorted(n for n, _ in targets.values() if n not in filled)
    if missing:
        raise KeyError(f"parameters or buffers with no flax counterpart: {missing}")
    return module


def export_jax_variables(module: torch.nn.Module) -> dict:
    """The module's parameters (and BatchNorm statistics) as a flax-layout
    ``{'params': {...}[, 'batch_stats': {...}]}`` tree of float32 numpy
    arrays."""
    trees: dict = {}
    for (collection, path), (_, t) in _name_map(module).items():
        node = trees.setdefault(collection, {})
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        arr = t.detach().float().cpu().numpy()
        # a copy: the array must not alias the parameter's memory
        node[path[-1]] = np.array(_to_jax_layout(arr, path[-1]), order="C",
                                  copy=True)
    return trees
