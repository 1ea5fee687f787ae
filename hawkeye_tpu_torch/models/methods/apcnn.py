"""AP-CNN: attention pyramid CNN with ROI-guided refinement.

Counterpart of ``hawkeye_tpu/models/methods/apcnn.py`` (reference
``model/methods/APCNN.py``): a ResNet-50 trunk, a top-down FPN and a
bottom-up spatial/channel attention pyramid; per-level square anchor grids
scored by the spatial attention, greedy NMS keeping 5, 3 and 1 ROIs; stage
II crops the union of all ROIs out of the stride-8 map c3 (a random ROI
dropblock in train mode), resizes it back to c3's size and runs layer3,
layer4, the FPN, the attention and the same heads again. ``logits`` is the
mean of the 8 heads' logits, ``all_logits`` [8, B, C] holds them, ``rois``
[B, 9, 4] the boxes (y0, x0, y1, x1) in image pixels.

Everything runs on the device inside the step: the anchors and their
adjacency are constants made once on the host (non-persistent buffers), the
NMS is ``ops/nms.py``'s loop, the union crop ``crop_resize_bilinear``. The
anchors the boxes come from are clipped to the image, the adjacency is built
from the unclipped ones, as in the JAX package.

The trunk is explicit so that stage II can run layer3 and layer4 again, and
each block is the ResNet ``Bottleneck`` under ``layer{i}_{j}.block``, flax's
names; BatchNorm in layer3, layer4, the FPN and the heads therefore folds
twice per train step, stage I first. Trunk and FPN compute in ``dtype``, the
attention convs and the heads (BN, Dense, BN, ELU, Dense) in their
parameters' dtype (float32; float64 in a model cast to float64).

The dropblock's draws (``dropblock_draws``: a uniform ``pro`` and the ROI
indices ``i3``, ``i4`` per image) come from a caller's ``torch.Generator``,
or are passed in as ``dropblock=``; ``_roi_crop`` applies them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import anchor_adjacency, nms_fixed_anchors_batch
from ...ops.resample import crop_resize_bilinear
from ...registry import MODEL
from ...utils import trace
from ..backbones.norm import BatchNorm
from ..backbones.resnet import Bottleneck, _conv

# (stride, anchor size, ROIs kept) per pyramid level
ROI_LEVELS = ((8, 64, 5), (16, 128, 3), (32, 256, 1))


def level_anchors(size, fm_h, fm_w, stride):
    """Square anchors of side ``size`` centred at the feature positions,
    y-major as the attention flattens, boxes (y0, x0, y1, x1) in image
    pixels, float32."""
    ys = np.arange(fm_h, dtype=np.float32) * stride
    xs = np.arange(fm_w, dtype=np.float32) * stride
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    h = w = float(size)
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                    axis=-1).reshape(-1, 4)


class BasicConv(nn.Module):
    """1x1 conv (no bias), BatchNorm, ReLU, in ``dtype``."""

    def __init__(self, c_in, features, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(c_in, features, 1, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x):
        return F.relu(self.bn(_conv(self.conv, x, self.dtype)))


class ClsHead(nn.Module):
    """BN -> Dense(hidden) -> BN -> ELU -> Dense(classes) on pooled
    features, in the parameters' dtype."""

    def __init__(self, c_in, hidden, num_classes):
        super().__init__()
        self.bn1 = BatchNorm(c_in)
        self.fc1 = nn.Linear(c_in, hidden)
        self.bn2 = BatchNorm(hidden)
        self.fc2 = nn.Linear(hidden, num_classes)

    def forward(self, pooled):
        x = self.fc1(self.bn1(pooled.to(self.fc1.weight.dtype)))
        return self.fc2(F.elu(self.bn2(x)))


class _DeferredBottleneck(nn.Module):
    """A ResNet ``Bottleneck`` under the name ``block``, flax's path."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x):
        return self.block(x)


def _up2(x):
    """2x nearest upsampling of NCHW ``x``: source index ``dst // 2``, the
    JAX package's ``jnp.repeat`` along both axes."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class APCNN(nn.Module):
    def __init__(self, num_classes, image_size=448, stage_sizes=(3, 4, 6, 3),
                 fpn_dim=256, dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = int(num_classes)
        self.image_size = int(image_size)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.stage_names = []
        filters, c_in = 64, 64
        widths = []
        for i, n_blocks in enumerate(stage_sizes):
            stride = 1 if i == 0 else 2
            names = []
            for j in range(n_blocks):
                blk_stride = stride if j == 0 else 1
                down = j == 0 and (blk_stride != 1 or c_in != filters * 4)
                name = f"layer{i + 1}_{j}"
                self.add_module(name, _DeferredBottleneck(Bottleneck(
                    c_in, filters, blk_stride, down, dtype=dtype)))
                names.append(name)
                c_in = filters * 4
            self.stage_names.append(names)
            widths.append(c_in)
            filters *= 2
        c3, c4, c5 = widths[1:]

        d = int(fpn_dim)
        self.p5_master = BasicConv(c5, d, dtype)
        self.p5_gpb = BasicConv(c5, d, dtype)
        self.p5_2 = nn.Conv2d(d, d, 3, 1, 1)
        self.p4_1 = nn.Conv2d(c4, d, 1)
        self.p4_2 = nn.Conv2d(d, d, 3, 1, 1)
        self.p3_1 = nn.Conv2d(c3, d, 1)
        self.p3_2 = nn.Conv2d(d, d, 3, 1, 1)
        for lvl in (3, 4, 5):
            self.add_module(f"a{lvl}_spatial", nn.Conv2d(d, 1, 3, 1, 1))
            self.add_module(f"a{lvl}_ch1", nn.Conv2d(d, d // 16, 1))
            self.add_module(f"a{lvl}_ch2", nn.Conv2d(d // 16, d, 1))

        hidden = 512 if self.num_classes == 200 else 256
        for name in ("cls3", "cls4", "cls5"):
            self.add_module(name, ClsHead(d, hidden, self.num_classes))
        self.cls_concate = ClsHead(3 * d, hidden, self.num_classes)

        # static anchor grids and NMS adjacency per level: boxes from the
        # clipped anchors, adjacency from the unclipped ones
        s = self.image_size
        self.roi_topk = tuple(k for _, _, k in ROI_LEVELS)
        for lvl, (stride, size, _) in enumerate(ROI_LEVELS):
            fm = s // stride
            boxes = level_anchors(size, fm, fm, stride)
            clipped = np.clip(boxes, 0, s - 1)
            self.register_buffer(f"anchors{lvl}", torch.from_numpy(clipped),
                                 persistent=False)
            self.register_buffer(f"adjacency{lvl}", torch.from_numpy(
                anchor_adjacency(boxes, 0.05)), persistent=False)

    def dropblock_draws(self, generator, b):
        """The train-mode dropblock's draws for ``b`` images, on the
        generator's device: ``pro`` uniform in [0, 1), ``i3`` and ``i4`` the
        indices of a level-3 and a level-4 ROI."""
        dev = generator.device
        return {"pro": torch.rand((b,), generator=generator, device=dev),
                "i3": torch.randint(0, self.roi_topk[0], (b,), generator=generator,
                                    device=dev),
                "i4": torch.randint(0, self.roi_topk[1], (b,), generator=generator,
                                    device=dev)}

    def _run(self, stage, x):
        for name in self.stage_names[stage]:
            x = getattr(self, name)(x)
        return x

    def _fpn(self, c3, c4, c5):
        gpb = self.p5_gpb(c5.mean(dim=(2, 3), keepdim=True))
        p5 = self.p5_master(c5) + gpb
        p5_out = _conv(self.p5_2, p5, self.dtype)
        p4 = _conv(self.p4_1, c4, self.dtype) + _up2(p5)
        p4_out = _conv(self.p4_2, p4, self.dtype)
        p3 = _conv(self.p3_1, c3, self.dtype) + _up2(p4)
        return _conv(self.p3_2, p3, self.dtype), p4_out, p5_out

    def _apn(self, feats):
        """Attended features and the spatial masks [B, 1, h, w]; each
        level's channel gate is averaged with the previous level's."""
        outs, spatials, prev = [], [], None
        for lvl, f in zip((3, 4, 5), feats):
            spatial_conv = getattr(self, f"a{lvl}_spatial")
            dt = spatial_conv.weight.dtype
            f = f.to(dt)
            spatial = torch.sigmoid(_conv(spatial_conv, f, dt))
            ch = F.relu(_conv(getattr(self, f"a{lvl}_ch1"),
                              f.mean(dim=(2, 3), keepdim=True), dt))
            channel = torch.sigmoid(_conv(getattr(self, f"a{lvl}_ch2"), ch, dt))
            if prev is not None:
                channel = (channel + prev) / 2.0
            prev = channel
            outs.append(spatial * f + channel * f)
            spatials.append(spatial)
        return outs, spatials

    def _heads(self, feats, attended):
        out = [getattr(self, f"cls{lvl}")(t.mean(dim=(2, 3)))
               for lvl, t in zip((3, 4, 5), attended)]
        dt = self.cls_concate.fc1.weight.dtype
        concat = torch.cat([f.to(dt).mean(dim=(2, 3)) for f in feats], dim=1)
        return out + [self.cls_concate(concat)]

    @trace.spanned("nms")
    def _rois(self, spatial, level, border_frac):
        """Attention mask [B, 1, h, w] -> the level's top-k ROI boxes
        [B, k, 4] in image pixels: scores inside the border, above their
        row's mean, through NMS."""
        b, _, h, w = spatial.shape
        att = spatial[:, 0].detach()
        yy = torch.arange(h, device=att.device)[None, :, None]
        xx = torch.arange(w, device=att.device)[None, None, :]
        inner = ((yy >= int(border_frac * h)) & (yy < int((1 - border_frac) * h))
                 & (xx >= int(border_frac * w)) & (xx < int((1 - border_frac) * w)))
        scores = (att * inner.to(att.dtype)).reshape(b, h * w)
        above = scores > scores.mean(dim=1, keepdim=True)
        scores = torch.where(above, scores, float("-inf"))
        idx = nms_fixed_anchors_batch(scores, getattr(self, f"adjacency{level}"),
                                      self.roi_topk[level])[0]
        return getattr(self, f"anchors{level}")[idx]

    @trace.spanned("roi_crop")
    def _roi_crop(self, c3, rois, draws=None):
        """The union box of the ROIs, floored, cropped out of c3 (NCHW) and
        resized back to c3's size; with ``draws`` (train mode) one ROI of
        level 3 (``pro`` < 0.3) or 4 (0.3 <= ``pro`` < 0.6) is dropped first,
        and the map renormalised by the kept fraction of the union."""
        b, _, h, w = c3.shape
        scale = self.image_size / h
        boxes = torch.cat(rois, dim=1) / scale  # [B, 9, 4] in c3's pixels
        y0 = torch.floor(boxes[..., 0].amin(dim=1))
        x0 = torch.floor(boxes[..., 1].amin(dim=1))
        y1 = torch.floor(boxes[..., 2].amax(dim=1))
        x1 = torch.floor(boxes[..., 3].amax(dim=1))

        x_in = c3
        if draws is not None:
            pro = draws["pro"]
            rows = torch.arange(b, device=c3.device)
            cand3 = rois[0][rows, draws["i3"]] / scale
            cand4 = rois[1][rows, draws["i4"]] / scale
            use3 = pro < 0.3
            active = use3 | ((pro >= 0.3) & (pro < 0.6))
            drop = torch.where(use3[:, None], cand3, cand4)
            yy = torch.arange(h, dtype=torch.float32, device=c3.device)[None, :, None]
            xx = torch.arange(w, dtype=torch.float32, device=c3.device)[None, None, :]

            def at(col):
                return drop[:, col, None, None]

            inside = (yy >= at(0)) & (yy < at(2)) & (xx >= at(1)) & (xx < at(3))
            mask = 1.0 - (inside & active[:, None, None]).to(c3.dtype)
            x_in = c3 * mask[:, None]
            union = (((yy >= y0[:, None, None]) & (yy < y1[:, None, None]))
                     & ((xx >= x0[:, None, None]) & (xx < x1[:, None, None]))).float()
            kept = (mask.float() * union).sum(dim=(1, 2))
            total = union.sum(dim=(1, 2))
            x_in = x_in * (total / kept.clamp_min(1.0))[:, None, None, None]

        union_boxes = torch.stack([y0, x0, y1 - y0, x1 - x0], dim=1)
        crop = crop_resize_bilinear(x_in.permute(0, 2, 3, 1), union_boxes, h, w)
        return crop.permute(0, 3, 1, 2)

    def forward(self, x, generator=None, dropblock=None):
        """x NHWC. A train-mode forward takes the dropblock's draws from
        ``dropblock`` or, without it, from ``generator``."""
        if self.training and dropblock is None:
            if generator is None:
                raise ValueError("AP-CNN's train forward draws its dropblock from "
                                 "a generator: pass generator= or dropblock=")
            dropblock = self.dropblock_draws(generator, x.shape[0])
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.bn1(_conv(self.conv1, x, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)
        c3 = self._run(1, self._run(0, x))
        c4 = self._run(2, c3)
        c5 = self._run(3, c4)

        feats = self._fpn(c3, c4, c5)
        attended, spatials = self._apn(feats)
        logits = self._heads(feats, attended)

        border = 0.2 if self.num_classes == 200 else 0.1
        rois = [self._rois(a, lvl, border) for lvl, a in enumerate(spatials)]

        c3_crop = self._roi_crop(c3, rois, dropblock if self.training else None)
        c4_crop = self._run(2, c3_crop.to(self.dtype))
        c5_crop = self._run(3, c4_crop)
        feats = self._fpn(c3_crop, c4_crop, c5_crop)
        logits += self._heads(feats, self._apn(feats)[0])

        all_logits = torch.stack(logits)
        return {"logits": all_logits.mean(dim=0), "all_logits": all_logits,
                "rois": torch.cat(rois, dim=1)}


@MODEL.register(name="APCNN")
def build_apcnn(config):
    return APCNN(num_classes=int(config.num_classes),
                 image_size=int(config.get("image_size", 448)))
