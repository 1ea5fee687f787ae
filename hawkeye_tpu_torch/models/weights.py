"""Pretrained-backbone import and partial loading.

Counterpart of ``hawkeye_tpu/models/weights.py``. With no network, weights
come as local files (the reference's torch.hub URL loading,
``model/backbone/resnet.py:16-26``, has no counterpart):

- ``load_torch_state_dict``: a ``.pth`` read on the CPU, ``state_dict``
  unwrapped and ``module.`` stripped.
- ``convert_torchvision_resnet`` / ``convert_torchvision_vgg`` /
  ``convert_bbn_inat_resnet``: a torchvision (or BBN iNat ResNet-50) state
  dict under this package's names. The port's ResNet carries flax's
  submodule names (``layer1.0`` is ``layer1_0``, ``downsample.0``/``.1`` are
  ``downsample_conv``/``downsample_bn``), its VGG torchvision's
  ``features.N`` (convs and, in the ``_bn`` variants, BatchNorms) and the
  classifier's ``fc0``/``fc3``/``fc6`` (``classifier.0``'s input axis
  permuted to the NHWC flatten); the layouts (OIHW, BatchNorm
  ``weight``/``bias``/``running_mean``/``running_var``) are torchvision's
  already. Keys the JAX converters do not read (``num_batches_tracked``)
  are dropped here too.
- ``load_pretrained_backbone``: the JAX package's semantics. A missing file
  logs ``training from scratch`` and keeps the init; a ``.pth``/``.pt``/
  ``.tar`` is converted and loaded into the model's ``backbone`` by
  ``engine/checkpoint.partial_load``, which logs its counts; any other path
  (the recipes name ``.msgpack`` files) is a weights file of this package,
  read through ``engine/checkpoint.load_model`` (the ``.pt`` of a
  ``.msgpack``'s stem) into the whole model.
"""

from __future__ import annotations

import os
import re

import torch

_RESNET_KEY = re.compile(
    r"^layer(\d+)\.(\d+)\.(conv\d+\.weight|bn\d+\.(?:weight|bias|running_mean|"
    r"running_var)|downsample\.[01]\.(?:weight|bias|running_mean|running_var))$")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def load_torch_state_dict(path):
    """``{name: tensor}`` of a torch checkpoint on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def convert_torchvision_resnet(sd):
    """A torchvision resnet/resnext/wide_resnet state dict under the port's
    ResNet names."""
    out = {"conv1.weight": sd["conv1.weight"]}
    out.update((f"bn1.{leaf}", sd[f"bn1.{leaf}"]) for leaf in _BN_LEAVES)
    for k, v in sd.items():
        m = _RESNET_KEY.match(k)
        if m:
            li, bj, rest = m.groups()
            rest = (rest.replace("downsample.0", "downsample_conv")
                    .replace("downsample.1", "downsample_bn"))
            out[f"layer{li}_{bj}.{rest}"] = v
    for leaf in ("weight", "bias"):
        if f"fc.{leaf}" in sd:
            out[f"fc.{leaf}"] = sd[f"fc.{leaf}"]
    return out


def convert_torchvision_vgg(sd):
    """A torchvision vgg or vgg_bn state dict under the port's VGG names:
    ``features.N`` (convs and BatchNorms) as they are, ``classifier.0/3/6``
    as ``fc0/fc3/fc6``. ``classifier.0`` reads the flattened 7x7 map, which
    torchvision flattens in NCHW order (``c*49 + h*7 + w``) and the port, as
    the JAX model, in NHWC order (``h*7*C + w*C + c``): its input axis is
    permuted to that order."""
    feat = re.compile(r"^features\.\d+\.(weight|bias|running_mean|running_var)$")
    out = {k: v for k, v in sd.items() if feat.match(k)}
    for k, v in sd.items():
        m = re.match(r"^classifier\.(\d+)\.(weight|bias)$", k)
        if not m:
            continue
        idx, leaf = m.groups()
        if idx == "0" and leaf == "weight" and v.shape[1] % 49 == 0:
            c = v.shape[1] // 49
            v = v.reshape(v.shape[0], c, 7, 7).permute(0, 2, 3, 1).reshape(
                v.shape[0], 49 * c)
        out[f"fc{idx}.{leaf}"] = v
    return out


def convert_bbn_inat_resnet(sd):
    """A BBN iNaturalist2017 ResNet-50 checkpoint (reference
    ``ProtoTreeNet.get_inat_resnet50_weight``, ``model/methods/ProtoTree/
    ProtoTreeNet.py:41-59``): ``backbone.cb_block`` is ``layer4.2``,
    ``rb_block`` and the classifier are dropped, then the torchvision
    conversion. Keys match with or without their ``module.`` prefix, which
    ``load_torch_state_dict`` strips (the JAX converter looks for the
    prefixed names only)."""
    remapped = {}
    for k, v in sd.items():
        k = re.sub(r"^module\.", "", k)
        if k.startswith("backbone.cb_block"):
            remapped["layer4.2" + k.split("cb_block")[-1]] = v
        elif k.startswith(("backbone.rb_block", "classifier")):
            continue
        elif k.startswith("backbone."):
            remapped[k.split("backbone.")[-1]] = v
        else:
            remapped[k] = v
    return convert_torchvision_resnet(remapped)


_CONVERTERS = {"resnet": convert_torchvision_resnet, "vgg": convert_torchvision_vgg,
               "bbn_inat": convert_bbn_inat_resnet}


def load_pretrained_backbone(model, path, kind="resnet", logger=None):
    """Load a local pretrained checkpoint into ``model`` (its ``backbone``
    for a converted torch file); returns the load's report, or None when the
    file is missing and the model keeps its init."""
    from ..engine.checkpoint import load_model, partial_load, port_path

    torch_file = bool(path) and path.endswith((".pth", ".pt", ".tar"))
    if not path or not os.path.exists(path if torch_file else port_path(path)):
        if logger is not None:
            logger.info(f"pretrained weights not found at {path!r}; "
                        f"training from scratch")
        return None
    if torch_file:
        converter = _CONVERTERS.get(kind, convert_torchvision_resnet)
        return partial_load(model, converter(load_torch_state_dict(path)),
                            prefix="backbone.", logger=logger)
    return load_model(path, model, logger=logger)
