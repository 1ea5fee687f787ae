"""ProtoTree: a neural prototype tree, as arrays.

Counterpart of ``hawkeye_tpu/models/methods/prototree.py`` (reference
``model/methods/ProtoTree/``). A soft complete binary tree of height h
(9 in ``configs/ProtoTreeNet.yaml``: 511 branches, 512 leaves) whose
decision probabilities are prototype similarities: the trunk's c5, through
a bias-free 1x1 ``neck_conv`` and a sigmoid, gives D-wide features; each
branch's prototype [D] (the raw parameter ``prototypes`` [2^h - 1, D])
takes its least L2 distance over the positions, and ``exp(-d)`` is the
probability of going right. Leaf path probabilities come level by level
(``leaf_path_probs``), the leaves in heap order: branch i's children are
2i + 1 and 2i + 2, the leaves the last 2^h slots. The leaves' class
distributions are ``softmax(dist_params)`` of the buffer ``dist_params``
[2^h, C], flax's non-gradient ``tree_leaves`` collection
(``flax_collections``), which the leaf update of ``losses/prototree.py``
sets after each step; it is in the state dict, so saved models carry it.

The trunk computes in ``dtype`` (bfloat16 by default); the head computes in
its parameters' dtype (float32, as the JAX package's; float64 in a model
cast to float64). Two inits are not LeCun (``init_own_parameters``):
``neck_conv`` is flax's ``xavier_normal`` and ``prototypes`` is
``0.5 + 0.1 N(0, 1)``; ``dist_params`` starts at zero.

Sampling (``sampling``, else ``eval_sampling`` in eval mode; training always
uses ``distributed``): ``distributed`` mixes the leaves by their path
probabilities, ``sample_max`` takes the leaf of the largest one (the first
on ties), ``greedy`` walks from the root and goes right iff its
probability is above 0.5. ``logits`` are ``log(max(pred, 1e-12))``.

``save_tree``/``load_tree``: a directory with ``tree.json`` (the JAX
package's keys) and ``tree.pt`` (the state dict).
"""

from __future__ import annotations

import json
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONE, MODEL
from ...utils.tensors import device_constant
from ..init import _TRUNC_STD

SAMPLINGS = ("distributed", "sample_max", "greedy")


def l2_distances(features, prototypes):
    """features [B, H, W, D], prototypes [P, D] -> [B, P], each prototype's
    least distance over the positions, in the prototypes' dtype. ``amin``
    splits the gradient evenly among tied positions, as JAX's min does."""
    b, h, w, d = features.shape
    x = features.reshape(b, h * w, d).to(prototypes.dtype)
    x_sq = (x ** 2).sum(-1)[:, :, None]  # [B, HW, 1]
    p_sq = (prototypes ** 2).sum(-1)[None, None, :]  # [1, 1, P]
    xp = torch.einsum("bnd,pd->bnp", x, prototypes)
    dist = torch.sqrt((x_sq + p_sq - 2.0 * xp).abs() + 1e-14)  # [B, HW, P]
    return dist.amin(dim=1)


def leaf_path_probs(ps, height):
    """ps [B, 2^h - 1] right-branch probabilities in level order -> [B, 2^h]
    leaf path probabilities; left and right children interleave at each
    level, so the leaves come in heap order."""
    b = ps.shape[0]
    pa = ps.new_ones((b, 1))
    offset = 0
    for level in range(height):
        n = 2 ** level
        p_right = ps[:, offset:offset + n]
        pa = torch.stack([pa * (1.0 - p_right), pa * p_right], dim=-1).reshape(b, 2 * n)
        offset += n
    return pa


def all_node_path_probs(ps, height):
    """The probability of arriving at every branch node [B, 2^h - 1]."""
    b = ps.shape[0]
    pas = [ps.new_ones((b, 1))]
    offset = 0
    for level in range(height - 1):
        n = 2 ** level
        p_right = ps[:, offset:offset + n]
        pas.append(torch.stack([pas[-1] * (1.0 - p_right), pas[-1] * p_right],
                               dim=-1).reshape(b, 2 * n))
        offset += n
    return torch.cat(pas, dim=1)


class ProtoTreeNet(nn.Module):
    flax_collections = {"dist_params": "tree_leaves"}

    def __init__(self, num_classes, height=9, num_features=256,
                 backbone_name="resnet50", dtype=torch.bfloat16,
                 eval_sampling="distributed"):
        super().__init__()
        if eval_sampling not in SAMPLINGS:
            raise ValueError(f"unknown sampling strategy: {eval_sampling!r}")
        self.num_classes = int(num_classes)
        self.height = int(height)
        self.num_features = int(num_features)
        self.backbone_name = backbone_name
        self.dtype = dtype
        self.eval_sampling = eval_sampling
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype)
        self.neck_conv = nn.Conv2d(self.backbone.out_channels, self.num_features, 1,
                                   bias=False)
        self.prototypes = nn.Parameter(torch.empty(self.num_branches, self.num_features))
        self.register_buffer("dist_params",
                             torch.zeros(self.num_leaves, self.num_classes))

    @property
    def num_branches(self):
        return 2 ** self.height - 1

    @property
    def num_leaves(self):
        return 2 ** self.height

    @torch.no_grad()
    def init_own_parameters(self, generator):
        """``neck_conv``: flax's ``xavier_normal``, a normal truncated at two
        standard deviations with variance 1 / fan_avg; ``prototypes``:
        ``0.5 + 0.1 N(0, 1)``; ``dist_params``: zeros."""
        w = self.neck_conv.weight
        std = math.sqrt(2.0 / (w.shape[0] + w.shape[1])) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.prototypes.normal_(0.0, 1.0, generator=generator).mul_(0.1).add_(0.5)
        self.dist_params.zero_()

    def forward(self, x, sampling=None):
        if sampling is None:
            sampling = "distributed" if self.training else self.eval_sampling
        if sampling not in SAMPLINGS:
            raise ValueError(f"unknown sampling strategy: {sampling!r}")
        c5 = self.backbone(x)["c5"]  # NHWC
        w = self.neck_conv.weight
        feats = torch.sigmoid(F.linear(c5.to(w.dtype), w.flatten(1)))  # 1x1 conv
        similarities = torch.exp(-l2_distances(feats, self.prototypes))  # [B, P]
        pa_leaf = leaf_path_probs(similarities, self.height)  # [B, L]
        leaves = self.dist_params
        dist = torch.softmax(leaves - leaves.amax(dim=-1, keepdim=True), dim=-1)
        if sampling == "distributed":
            pred = pa_leaf @ dist
        elif sampling == "sample_max":
            pred = dist[pa_leaf.argmax(dim=1)]
        else:  # greedy: right iff p_right > 0.5; the leaf slot is node - (2^h - 1)
            node = torch.zeros(pa_leaf.shape[0], dtype=torch.long, device=x.device)
            for _ in range(self.height):
                p_right = similarities.gather(1, node[:, None])[:, 0]
                node = 2 * node + 1 + (p_right > 0.5).long()
            pred = dist[node - self.num_branches]
        floor = device_constant(1e-12, pred.dtype, pred.device)
        return {"logits": torch.log(torch.maximum(pred, floor)), "pred": pred,
                "pa_leaf": pa_leaf, "leaf_dist": dist}


def _dtype(name):
    return torch.float32 if str(name) in ("float32", "f32") else torch.bfloat16


@MODEL.register(name="ProtoTreeNet")
def build_prototree(config):
    backbone = config.get("backbone", None) or {}
    return ProtoTreeNet(
        num_classes=int(config.num_classes),
        height=int(config.get("height", 9)),
        num_features=int(config.get("num_features", 256)),
        backbone_name=(backbone.get("name", "resnet50") if hasattr(backbone, "get")
                       else "resnet50"),
        dtype=_dtype(config.get("dtype", "bfloat16")),
        eval_sampling=str(config.get("sampling", "distributed")),
    )


def save_tree(directory_path, model):
    """A self-contained tree (reference ``ProtoTree.save/save_state``,
    ``prototree.py:248-265``): the constructor's arguments and the state
    dict, the leaf distributions with it, so ``load_tree`` rebuilds the
    model without the recipe."""
    os.makedirs(directory_path, exist_ok=True)
    meta = {"num_classes": model.num_classes, "height": model.height,
            "num_features": model.num_features, "backbone_name": model.backbone_name,
            "dtype": "float32" if model.dtype == torch.float32 else "bfloat16",
            "eval_sampling": model.eval_sampling}
    with open(os.path.join(directory_path, "tree.json"), "w") as f:
        json.dump(meta, f, indent=1)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(directory_path, "tree.pt"))


def load_tree(directory_path, device="cpu"):
    """The model of a ``save_tree`` directory (reference ``ProtoTree.load``,
    ``prototree.py:267-269``), on ``device``."""
    with open(os.path.join(directory_path, "tree.json")) as f:
        meta = json.load(f)
    model = ProtoTreeNet(num_classes=int(meta["num_classes"]),
                         height=int(meta["height"]),
                         num_features=int(meta["num_features"]),
                         backbone_name=meta["backbone_name"],
                         dtype=_dtype(meta["dtype"]),
                         eval_sampling=meta["eval_sampling"])
    model.load_state_dict(torch.load(os.path.join(directory_path, "tree.pt"),
                                     map_location="cpu", weights_only=True))
    return model.to(device)
