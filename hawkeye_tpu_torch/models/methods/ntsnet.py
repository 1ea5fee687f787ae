"""NTS-Net: navigator-teacher-scrutinizer network.

Counterpart of ``hawkeye_tpu/models/methods/ntsnet.py`` (reference
``model/methods/NTS_Net/``). A ProposalNet conv pyramid scores a fixed
multi-scale anchor grid over c5; greedy NMS keeps the top-M anchors per
image; the M regions are cropped from the zero-padded input, resized to
``part_size`` and run through the backbone again; the top-K part features
join the global feature for the final classifier.

Everything runs on the device inside the step: the anchors and their IoU
adjacency are constants made once on the host (non-persistent buffers, out
of every checkpoint and the bridge), NMS is ``ops/nms.py``'s masked-argmax
loop, and the M crops are one ``crop_resize_multibox`` (align_corners, as
the reference's part resize). The proposal net reads a detached c5, NMS
detached scores; ``top_prob`` gathers the scores with their gradient; the
parts are detached.

Two paths with the same outputs, statistics and gradients:
``_sequential`` (the default) runs the backbone on the global batch, then on
the B*M parts, so BatchNorm folds in that order; ``fused_part_pass`` runs a
no-grad train-mode forward for the boxes (its statistic updates dropped),
then one (B + B*M) backbone call with per-view statistics
(``bn_groups=(B, B*M)``). It needs ``image_size == part_size``.

The heads (``fc``, ``concat_net``, ``partcls_net``) compute in their
parameters' dtype (float32, as the JAX package's heads; float64 in a model
cast to float64), on c5's spatial mean. Dropout (``dropout_rate`` 0.5)
draws from the ``torch.Generator`` the caller passes, global features first,
then parts, as API-Net's does; a comparison across devices or packages sets
the attribute to 0. Submodules carry the flax names.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import anchor_adjacency, nms_fixed_anchors_batch
from ...ops.resample import crop_resize_multibox
from ...registry import BACKBONE, MODEL
from ..backbones.resnet import _conv
from .apinet import dropout

# anchor pyramid: (stride, base size, scales, aspect ratios) per level, the
# published NTS-Net configuration (anchors.py:3-7)
ANCHOR_SETTING = (
    dict(stride=32, size=48, scales=[2 ** (1 / 3), 2 ** (2 / 3)],
         aspects=[0.667, 1, 1.5]),
    dict(stride=64, size=96, scales=[2 ** (1 / 3), 2 ** (2 / 3)],
         aspects=[0.667, 1, 1.5]),
    dict(stride=128, size=192, scales=[1, 2 ** (1 / 3), 2 ** (2 / 3)],
         aspects=[0.667, 1, 1.5]),
)


def generate_anchors(input_size: int):
    """Edge anchors [A, 4] (y0, x0, y1, x1) in float32, ordered as
    ProposalNet flattens its scores: per level, per (scale, aspect), then
    row-major over the level's map."""
    edges = []
    for info in ANCHOR_SETTING:
        stride = info["stride"]
        fm = int(np.ceil(input_size / stride))
        start = stride / 2.0
        oy = start + stride * np.arange(fm, dtype=np.float32)
        ox = start + stride * np.arange(fm, dtype=np.float32)
        cy, cx = np.meshgrid(oy, ox, indexing="ij")
        for scale in info["scales"]:
            for aspect in info["aspects"]:
                h = info["size"] * scale / np.sqrt(aspect)
                w = info["size"] * scale * np.sqrt(aspect)
                e = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                             axis=-1).reshape(-1, 4)
                edges.append(e.astype(np.float32))
    return np.concatenate(edges, axis=0)


class ProposalNet(nn.Module):
    """Conv pyramid scoring the anchor grid (reference NTSNet.py:63-82)."""

    def __init__(self, c_in, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.down1 = nn.Conv2d(c_in, 128, 3, 1, 1)
        self.down2 = nn.Conv2d(128, 128, 3, 2, 1)
        self.down3 = nn.Conv2d(128, 128, 3, 2, 1)
        self.tidy1 = nn.Conv2d(128, 6, 1)
        self.tidy2 = nn.Conv2d(128, 6, 1)
        self.tidy3 = nn.Conv2d(128, 9, 1)

    def forward(self, c5):
        """c5 NHWC -> scores [B, A] float32, each map flattened as (c, h, w)
        of its logical NCHW view, to line up with the anchors."""
        x = c5.permute(0, 3, 1, 2)
        d1 = F.relu(_conv(self.down1, x, self.dtype))
        d2 = F.relu(_conv(self.down2, d1, self.dtype))
        d3 = F.relu(_conv(self.down3, d2, self.dtype))
        b = x.shape[0]
        return torch.cat([_conv(t, d, self.dtype).reshape(b, -1) for t, d in
                          ((self.tidy1, d1), (self.tidy2, d2), (self.tidy3, d3))],
                         dim=1).float()


class NTSNet(nn.Module):
    def __init__(self, num_classes=200, proposal_num=6, cat_num=4, image_size=448,
                 pad_side=224, part_size=224, iou_thresh=0.25,
                 backbone_name="resnet50", dtype=torch.bfloat16,
                 fused_part_pass=False):
        super().__init__()
        self.proposal_num = int(proposal_num)
        self.cat_num = int(cat_num)
        self.image_size = int(image_size)
        self.pad_side = int(pad_side)
        self.part_size = int(part_size)
        self.fused_part_pass = bool(fused_part_pass)
        self.dropout_rate = 0.5  # flax's nn.Dropout(0.5)
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype,
                                                    grouped_bn=True)
        dim = self.backbone.out_channels
        self.fc = nn.Linear(dim, num_classes)
        self.proposal_net = ProposalNet(dim, dtype)
        self.concat_net = nn.Linear(dim * (self.cat_num + 1), num_classes)
        self.partcls_net = nn.Linear(dim, num_classes)
        # integer padded coordinates, as the reference's
        # (edge_anchors + 224).astype(np.int) (NTSNet.py:27)
        edge = np.trunc(generate_anchors(self.image_size) +
                        self.pad_side).astype(np.float32)
        self.register_buffer("edge_anchors", torch.from_numpy(edge), persistent=False)
        self.register_buffer("adjacency", torch.from_numpy(
            anchor_adjacency(edge, float(iou_thresh))), persistent=False)

    def forward(self, x, generator=None):
        """x NHWC. Returns ``logits`` (the concat head), ``raw_logits``,
        ``part_logits`` [B, M, C] and ``top_prob`` [B, M]. A train-mode
        forward with dropout needs ``generator``."""
        if self.training and self.dropout_rate > 0.0 and generator is None:
            raise ValueError("NTS-Net's train forward draws its dropout masks "
                             "from a generator: pass generator=")

        def drop(t):
            if not self.training:
                return t
            return dropout(t, self.dropout_rate, generator)

        if self.fused_part_pass and self.image_size == self.part_size:
            return self._fused(x, drop)
        return self._sequential(x, drop)

    def _pool(self, stages):
        """c5's spatial mean in the heads' dtype (the trunk's ``pool``)."""
        return stages["c5"].mean(dim=(1, 2)).to(self.fc.weight.dtype)

    def _nms(self, scores):
        return nms_fixed_anchors_batch(scores, self.adjacency, self.proposal_num)[0]

    def _crop(self, x, top_idx):
        """The parts [B, M, s, s, C] of the zero-padded input at the anchors
        ``top_idx`` [B, M]."""
        boxes = self.edge_anchors[top_idx]  # [B, M, 4] (y0, x0, y1, x1)
        byxhw = torch.stack([boxes[..., 0], boxes[..., 1],
                             boxes[..., 2] - boxes[..., 0],
                             boxes[..., 3] - boxes[..., 1]], dim=-1)
        pad = self.pad_side
        x_pad = F.pad(x, (0, 0, pad, pad, pad, pad))
        return crop_resize_multibox(x_pad, byxhw, self.part_size, self.part_size,
                                    align_corners=True)

    def _propose(self, x, c5):
        """Scores of a detached c5 -> NMS top-M -> crops. Returns the
        differentiable score gather and the detached parts [B*M, s, s, C]."""
        rpn_scores = self.proposal_net(c5.detach())
        top_idx = self._nms(rpn_scores.detach())
        top_prob = rpn_scores.gather(1, top_idx)
        parts = self._crop(x, top_idx).detach()
        return top_prob, parts.reshape(-1, *parts.shape[2:])

    def _heads(self, feature, part_features, raw_logits, top_prob):
        b = part_features.shape[0]
        cat_feat = part_features[:, :self.cat_num].reshape(b, -1)
        return {"logits": self.concat_net(torch.cat([cat_feat, feature], dim=1)),
                "raw_logits": raw_logits,
                "part_logits": self.partcls_net(part_features),
                "top_prob": top_prob}

    def _sequential(self, x, drop):
        """The reference's two passes (NTSNet.py:30-57)."""
        stages = self.backbone(x)
        feature = drop(self._pool(stages))
        raw_logits = self.fc(feature)
        top_prob, parts = self._propose(x, stages["c5"])
        part_features = drop(self._pool(self.backbone(parts)))
        return self._heads(feature, part_features.reshape(x.shape[0], self.proposal_num, -1),
                           raw_logits, top_prob)

    def _fused(self, x, drop):
        """Phase A: a no-grad forward for the boxes, in the current mode,
        its statistic updates dropped. Phase B: one (B + B*M) backbone call,
        per-view statistics in train mode."""
        b = x.shape[0]
        stats = list(self.backbone.buffers())
        saved = [t.clone() for t in stats] if self.training else []
        with torch.no_grad():
            c5 = self.backbone(x)["c5"]
        for t, s in zip(stats, saved):
            t.copy_(s)
        top_prob, parts = self._propose(x, c5)
        m = self.proposal_num
        stages = self.backbone(torch.cat([x, parts]),
                               bn_groups=(b, b * m) if self.training else 1)
        pool = self._pool(stages)
        feature = drop(pool[:b])  # the draws in the sequential path's order
        raw_logits = self.fc(feature)
        part_features = drop(pool[b:]).reshape(b, m, -1)
        return self._heads(feature, part_features, raw_logits, top_prob)


@MODEL.register(name="NTSNet")
def build_ntsnet(config):
    return NTSNet(
        num_classes=int(config.get("num_classes", 200)),
        proposal_num=int(config.get("proposal_num", 6)),
        cat_num=int(config.get("cat_num", 4)),
        image_size=int(config.get("image_size", 448)),
        backbone_name=config.get("backbone", "resnet50"),
        fused_part_pass=bool(config.get("fused_part_pass", False)),
        # the reference fixes both at 224 (NTSNet.py:26, :47)
        part_size=int(config.get("part_size", 224)),
        pad_side=int(config.get("pad_side", 224)),
    )
