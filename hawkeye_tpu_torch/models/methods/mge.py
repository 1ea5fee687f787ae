"""MGE-CNN: mixture of granularity-specific experts.

Counterpart of ``hawkeye_tpu/models/methods/mge.py`` (reference
``model/methods/MGE_CNN/``), its sequential path: three experts, each a
backbone with a classifier, a ``conv6`` part head and a ``cls_cat``
classifier; expert 0 sees the image, experts 1 and 2 the crop of the
previous expert's view around its class activation map; a gate backbone's
softmax mixes the three detached ``cls_cat`` logits. Outputs: ``logits``
(the mixture), ``all_logits`` [10, B, C] (each expert's three heads, then
the mixture) and ``pr_gate`` [B, 3].

The reference's GradCAM differentiates the target class's score with
respect to the last conv5 output, which feeds the spatial mean and the
classifier, so its weights are the ReLU'd classifier row of the target
(the label in train, each expert's own argmax otherwise): ``cam_bbox``
thresholds that CAM and crops the enclosing box with fixed-shape index
arithmetic and one batched resize, with no host round trip.

``fused_experts`` (the JAX package's, measured 20% slower on its TPU and
off by default there and here): the expert chain is data-dependent (each
crop comes from the previous expert's CAM), so phase A runs expert 0 on the
image and expert 1 on its crop forward only, without gradients, in train
mode where training, with the running statistics left as they were, only to
find the two crops (the sequential path detaches them too). Phase B is one
pass of the four backbones over ``[x, crop1, crop2, x]``
(``backbones.resnet.stacked_forward``: the views stacked along the
channels, every conv grouped four ways over the four backbones' weights
concatenated along the output channels, every BatchNorm one call over the
four backbones' channels, so each has its own statistics), forward and
backward, which folds the statistics. It gives the sequential path's
logits, gradients and statistics; the parameters are the sequential
path's (the JAX package's ``stack_expert_variables`` stacks its variables
into another tree; here the weights stay in each expert's modules and are
stacked at each call), so a checkpoint serves both paths.
The heads compute in their parameters' dtype (float32; float64 in a model
cast to float64), the backbones in ``dtype``. Submodules carry the flax
names (``expert_0``..``expert_2`` with ``backbone`` and ``head``,
``gate_backbone``, ``cls_gate_0``, ``cls_gate_1``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resample import crop_resize_bilinear, resize_bilinear
from ...registry import BACKBONE, MODEL
from ...utils import trace
from ..backbones.resnet import ResNet, _conv, stacked_forward


def l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def cam_bbox(images, conv5, weights, rate, img_size):
    """The crop of each image around its thresholded CAM, resized back.

    images [B, S, S, 3]; conv5 [B, h, w, F] (NHWC, detached here); weights
    [B, F]. The CAM is resized to S x S (``align_corners=True``), min-max
    normalised and held ``> rate``; the box spans the first to the last row
    and column that hold a position above it, and an empty or one-pixel box
    is the whole image. Returns (crops [B, S, S, 3] detached, boxes [B, 4]
    as (y0, x0, h, w) in pixels)."""
    dt = torch.promote_types(conv5.dtype, weights.dtype)
    cam = torch.einsum("bhwc,bc->bhw", conv5.detach().to(dt), weights.to(dt))
    cam = resize_bilinear(cam[..., None], img_size, img_size, align_corners=True)[..., 0]
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    mask = (cam - lo) / (hi - lo).clamp_min(1e-8) > rate
    idx = torch.arange(img_size, dtype=torch.float32, device=cam.device)

    def span(active):
        first = torch.where(active, idx, float(img_size)).amin(dim=1)
        last = torch.where(active, idx, -1.0).amax(dim=1)
        return first, last

    y1, y2 = span(mask.any(dim=2))
    x1, x2 = span(mask.any(dim=1))
    bad = (y2 <= y1) | (x2 <= x1)
    y1 = torch.where(bad, 0.0, y1)
    x1 = torch.where(bad, 0.0, x1)
    y2 = torch.where(bad, float(img_size), y2)
    x2 = torch.where(bad, float(img_size), x2)
    boxes = torch.stack([y1, x1, y2 - y1, x2 - x1], dim=1)
    crops = crop_resize_bilinear(images, boxes, img_size, img_size, align_corners=True)
    return crops.detach(), boxes


class _ExpertHead(nn.Module):
    """Classifier, ``conv6`` part head and ``cls_cat`` of one expert. The
    reference's ``conv6`` is a 1x1 conv with padding 1, so its ring of
    outputs is ``bias`` and enters the spatial max as ``relu(bias)``."""

    def __init__(self, c4, c5, num_classes):
        super().__init__()
        self.classifier = nn.Linear(c5, num_classes)
        self.conv6 = nn.Conv2d(c4, 10 * num_classes, 1, padding=1)
        self.cls_part = nn.Linear(10 * num_classes, num_classes)
        self.cls_cat = nn.Linear(c5 + 10 * num_classes, num_classes)

    def forward(self, pool, c4):
        """pool [B, F] in the head's dtype; c4 NHWC (detached here)."""
        dt = self.conv6.weight.dtype
        part = _conv(self.conv6, c4.detach().permute(0, 3, 1, 2).to(dt), dt)
        pool_part = F.relu(part).amax(dim=(2, 3))
        cat = torch.cat([10 * l2n(pool.detach()), 10 * l2n(pool_part.detach())], dim=1)
        return self.classifier(pool), self.cls_part(pool_part), self.cls_cat(cat)


class _Expert(nn.Module):
    """A backbone and its heads: (logits, logits_max, logits_cat, c5)."""

    def __init__(self, num_classes, backbone_name, dtype):
        super().__init__()
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype)
        c5 = self.backbone.out_channels
        self.head = _ExpertHead(c5 // 2, c5, num_classes)

    def forward(self, x):
        return self.heads(self.backbone(x))

    def heads(self, stages):
        """(logits, logits_max, logits_cat, c5) from the backbone's stages."""
        pool = stages["c5"].mean(dim=(1, 2)).to(self.head.classifier.weight.dtype)
        return (*self.head(pool, stages["c4"]), stages["c5"])


class MGECNN(nn.Module):
    def __init__(self, num_classes, image_size=448, box_thred=0.2,
                 backbone_name="resnet50", dtype=torch.bfloat16, fused_experts=False):
        super().__init__()
        self.fused_experts = bool(fused_experts)
        self.num_classes = int(num_classes)
        self.image_size = int(image_size)
        self.box_thred = float(box_thred)
        for i in range(3):
            self.add_module(f"expert_{i}", _Expert(self.num_classes, backbone_name, dtype))
        self.gate_backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype)
        self.cls_gate_0 = nn.Linear(self.gate_backbone.out_channels, 512)
        self.cls_gate_1 = nn.Linear(512, 3)
        if self.fused_experts and not isinstance(self.gate_backbone, ResNet):
            raise ValueError("fused_experts stacks ResNet backbones, not "
                             f"{backbone_name!r}")

    @trace.spanned("cam_crop")
    def _cam_crop(self, view, c5, weights):
        return cam_bbox(view, c5, weights, self.box_thred, self.image_size)[0]

    def _cam_weights(self, expert, logits, labels):
        """The ReLU'd classifier rows of the CAM's classes: the labels', else
        the expert's argmax."""
        y = labels if labels is not None else logits.detach().argmax(-1)
        return F.relu(expert.head.classifier.weight.detach()[y])

    def _gate(self, pool, cats, all_logits):
        pr_gate = torch.softmax(self.cls_gate_1(self.cls_gate_0(pool)), dim=-1)
        gate_logits = sum(cats[i] * pr_gate[:, i:i + 1] for i in range(3))
        all_logits.append(gate_logits)
        return {"logits": gate_logits, "all_logits": torch.stack(all_logits),
                "pr_gate": pr_gate}

    def forward(self, x, labels=None):
        """x NHWC; ``labels`` (train) pick the CAM's class, else each
        expert's argmax does."""
        if self.fused_experts:
            return self._fused(x, labels)
        all_logits, cats, view = [], [], x
        for i in range(3):
            expert = getattr(self, f"expert_{i}")
            logits, logits_max, logits_cat, c5 = expert(view)
            all_logits += [logits, logits_max, logits_cat]
            cats.append(logits_cat.detach())
            if i < 2:
                view = self._cam_crop(view, c5, self._cam_weights(expert, logits, labels))

        head = self.cls_gate_0.weight.dtype
        pool = self.gate_backbone(x)["c5"].mean(dim=(1, 2)).to(head)
        return self._gate(pool, cats, all_logits)

    def _fused(self, x, labels):
        """Phase A: the two crops from forward-only passes of experts 0 and
        1 that fold no statistics; phase B: the four backbones as one."""
        experts = [getattr(self, f"expert_{i}") for i in range(3)]
        views = [x]
        with torch.no_grad():
            for expert in experts[:2]:
                c5 = stacked_forward([expert.backbone], views[-1], fold=False)["c5"]
                cls = expert.head.classifier
                logits = (None if labels is not None  # only the CAM's class is read
                          else cls(c5.mean(dim=(1, 2)).to(cls.weight.dtype)))
                views.append(self._cam_crop(views[-1], c5,
                                            self._cam_weights(expert, logits, labels)))
        views.append(x)  # the gate backbone sees the image
        trunks = [e.backbone for e in experts] + [self.gate_backbone]
        stacked = stacked_forward(trunks, torch.cat(views, dim=-1))
        split = {k: stacked[k].chunk(4, dim=-1) for k in ("c4", "c5")}
        all_logits, cats = [], []
        for i, expert in enumerate(experts):
            logits, logits_max, logits_cat, _ = expert.heads(
                {k: split[k][i] for k in split})
            all_logits += [logits, logits_max, logits_cat]
            cats.append(logits_cat.detach())
        pool = split["c5"][3].mean(dim=(1, 2)).to(self.cls_gate_0.weight.dtype)
        return self._gate(pool, cats, all_logits)


@MODEL.register(name="MGE_CNN")
def build_mge(config):
    return MGECNN(
        num_classes=int(config.num_classes),
        image_size=int(config.get("image_size", 448)),
        box_thred=float(config.get("box_thred", 0.2)),
        backbone_name=config.get("backbone", "resnet50"),
        fused_experts=bool(config.get("fused_experts", False)),
    )
