"""S3N: selective sparse sampling.

Counterpart of ``hawkeye_tpu/models/methods/s3n.py`` (reference
``model/methods/S3N.py``). A class response map from the raw classifier's
weights (CAM, detached) picks one map or the mean of the top five by an
entropy gate; its 3x3 peaks above the mean (``ops/peaks.py``) seed
Gaussian kernels accumulated into a zoom saliency map and an inverse one;
each becomes a sampling grid (edge padding, a trainable 61x61 blur, the
attention-weighted mean coordinates, an ``align_corners=True`` resize to the
image), and the image warped by it goes through the backbone again. Four
classifiers: ``agg_origin`` on the raw view, ``agg_sampler`` and
``agg_sampler1`` on the zoom and inverse views (through a 3x3/2 conv, BN and
ReLU each), ``logits`` on the three pooled features together.

The phase ``p`` selects the peaks: 0 all of them for both maps; 1 each peak
to the zoom map where the score exceeds a uniform draw ``u``, else to the
inverse one; 2 only the highest peak (zoom) and the lowest (inverse).
``u`` [B, G, G] comes as ``u=`` or from the caller's ``torch.Generator``.

Everything is fixed-shape tensor work on the device: the peaks are a mask,
the per-peak kernels one ``bmm`` over the flattened peak axis, the six blurs
of a step one ``F.conv2d`` over the stacked maps, the two warps one 4-tap
gather (``ops/resample.grid_sample_bilinear``) in the compute dtype. With
``fused_warp_pass`` (the default) the two warped views go through the
backbone as one 2B batch whose train-mode BatchNorm has per-view statistics
(``bn_groups=2``), folded zoom first, as two passes would fold them.

The map-to-grid path and the heads compute in the classifiers' dtype
(float32; float64 in a model cast to float64), the trunk (a ResNet) and
the sampler buffers in ``dtype``. Submodules and parameters carry the flax
names (``blur_kernel`` is a raw ``[61, 61, 1, 1]`` parameter in flax's
layout).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.peaks import peak_mask
from ...ops.resample import grid_sample_bilinear, resize_bilinear
from ...registry import BACKBONE, MODEL
from ...utils import trace
from ..backbones.norm import BatchNorm
from ..backbones.resnet import _conv


def _gaussian_2d(size, fwhm=13.0):
    x = np.arange(size, dtype=np.float32)
    y = x[:, None]
    x0 = y0 = size // 2
    g = np.exp(-4 * np.log(2) * ((x - x0) ** 2 + (y - y0) ** 2) / fwhm ** 2)
    return g.astype(np.float32)


def saliency_from_peaks(score_map, mask, theta, base, weight_by="score"):
    """The sum of per-peak Gaussian kernels over a [B, G, G] score map, plus
    ``base``: the kernel of the peak at (py, px) is
    ``exp(-((iy-py)^2 + (ix-px)^2) / (2 (theta*G)^2))``, weighted by the
    peak's score (``weight_by="score"``) or its inverse. The exponential
    factors over the two axes, so the sum is one ``bmm`` of two
    [B, G, G*G] factors over the flattened peak axis."""
    b, g, _ = score_map.shape
    ii = torch.arange(g, dtype=score_map.dtype, device=score_map.device)
    d2 = (ii[:, None] - ii[None, :]) ** 2  # [G, G]
    pow2 = ((theta * g) ** 2).clamp_min(1e-8)
    w = score_map if weight_by == "score" else 1.0 / score_map.clamp_min(1e-6)
    w = w * mask.to(score_map.dtype)
    inv2p = (1.0 / (2.0 * pow2)).reshape(b, 1, g * g)
    # ey[b, iy, (py, px)] = exp(-d2[iy, py] / 2p), ex[b, ix, (py, px)] with px
    ey = torch.exp(-d2.repeat_interleave(g, dim=1).reshape(1, g, g * g) * inv2p)
    ex = torch.exp(-d2.repeat(1, g).reshape(1, g, g * g) * inv2p)
    ex = ex * w.reshape(b, 1, g * g)
    return base + torch.bmm(ey, ex.transpose(1, 2))


class ScaleParam(nn.Module):
    """``x * scale[0]``, ``scale`` a trainable [1] parameter."""

    def __init__(self, init_value):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([float(init_value)]))

    def forward(self, x):
        return x * self.scale[0]


class _Buffer(nn.Module):
    """3x3/2 conv (no bias), BatchNorm, ReLU, in ``dtype``, on NCHW."""

    def __init__(self, channels, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, 2, 1, bias=False)
        self.bn = BatchNorm(channels)

    def forward(self, x):
        return F.relu(self.bn(_conv(self.conv, x, self.dtype)))


class S3N(nn.Module):
    def __init__(self, num_classes, image_size=448, base_ratio=0.09,
                 radius_init=0.12, radius_inv_init=0.3, grid_size=31,
                 padding_size=30, backbone_name="resnet50", dtype=torch.bfloat16,
                 fused_warp_pass=True):
        super().__init__()
        self.num_classes = int(num_classes)
        self.image_size = int(image_size)
        self.base_ratio = float(base_ratio)
        self.grid_size = int(grid_size)
        self.padding_size = int(padding_size)
        self.dtype = dtype
        self.fused_warp_pass = bool(fused_warp_pass)
        if backbone_name.startswith("vgg"):
            # the JAX package's S3N reads the trunk's "c5", which its VGG
            # does not give either (KeyError there)
            raise NotImplementedError(
                f"S3N on model.backbone: {backbone_name}: a VGG trunk has no c5 stage")
        # per-view BatchNorm statistics for the fused pass
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype,
                                                    grouped_bn=True)
        c = self.backbone.out_channels
        self.raw_classifier = nn.Linear(c, self.num_classes)
        self.sampler_buffer = _Buffer(c, dtype)
        self.sampler_classifier = nn.Linear(c, self.num_classes)
        self.sampler_buffer1 = _Buffer(c, dtype)
        self.sampler_classifier1 = nn.Linear(c, self.num_classes)
        self.con_classifier = nn.Linear(3 * c, self.num_classes)
        self.radius = ScaleParam(radius_init)
        self.radius_inv = ScaleParam(radius_inv_init)
        k = 2 * self.padding_size + 1
        self.blur_kernel = nn.Parameter(torch.from_numpy(_gaussian_2d(k)[..., None, None]))

    def _trunk(self, x, bn_groups=1):
        return self.backbone(x, bn_groups=bn_groups)["c5"]

    def _blur(self, x):
        """[N, G+2P, G+2P] -> [N, G, G]: the valid correlation with the
        61x61 ``blur_kernel`` (its gradient flows)."""
        k = self.blur_kernel[..., 0, 0]
        return F.conv2d(x.to(k.dtype)[:, None], k[None, None])[:, 0]

    def _create_grid(self, sal):
        """Saliency [N, G, G] -> sampling grid [N, S, S, 2] (y, x) in
        pixels: edge padding, the attention-weighted mean coordinates under
        the blur, normalised to [-1, 1], resized to the image with
        ``align_corners=True``."""
        g, p, s = self.grid_size, self.padding_size, self.image_size
        n = sal.shape[0]
        padded = F.pad(sal[:, None], (p, p, p, p), mode="replicate")[:, 0]
        coords = (torch.arange(g + 2 * p, dtype=sal.dtype, device=sal.device) - p) / (g - 1.0)
        blurred = self._blur(torch.cat([padded, padded * coords[None, None, :],
                                        padded * coords[None, :, None]]))
        denom = blurred[:n].clamp_min(1e-8)
        gx = (blurred[n:2 * n] / denom * 2.0 - 1.0).clamp(-1.0, 1.0)
        gy = (blurred[2 * n:] / denom * 2.0 - 1.0).clamp(-1.0, 1.0)
        grid = resize_bilinear(torch.stack([gy, gx], dim=-1), s, s, align_corners=True)
        return (grid + 1.0) * 0.5 * (s - 1)

    def _decide_map(self, crm):
        """[B, G, G, C] class response maps -> [B, G, G] in [0, 1]: the top
        class's map where the top-5 probabilities' negative entropy exceeds
        -0.2, else the mean of the top five maps; min-max normalised. Ties
        among the probabilities go to the lower class index, as
        ``jax.lax.top_k`` takes them."""
        probs = torch.softmax(crm.mean(dim=(1, 2)), dim=-1)
        k = min(5, probs.shape[-1])
        top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_idx = top_p[:, :k], top_idx[:, :k]
        gate = (top_p * torch.log(top_p.clamp_min(1e-12))).sum(-1)
        b, g = crm.shape[:2]
        maps = crm.gather(3, top_idx[:, None, None, :].expand(b, g, g, k))
        decide = torch.where((gate > -0.2)[:, None, None], maps[..., 0], maps.mean(-1))
        lo = decide.amin(dim=(1, 2), keepdim=True)
        hi = decide.amax(dim=(1, 2), keepdim=True)
        return (decide - lo) / (hi - lo).clamp_min(1e-8)

    def _peaks(self, score_map, p, u):
        """(zoom mask, inverse mask) [B, G, G] bool for phase ``p``."""
        mask = peak_mask(score_map, 3)
        if p == 1:
            keep = score_map > u
            return mask & keep, mask & ~keep
        if p == 2:
            b, g, _ = score_map.shape
            flat = score_map.reshape(b, g * g)
            m = mask.reshape(b, g * g)
            pos = torch.arange(g * g, device=flat.device)
            hi = torch.where(m, flat, float("-inf")).argmax(-1)
            lo = torch.where(m, flat, float("inf")).argmin(-1)
            return ((pos == hi[:, None]).reshape(b, g, g),
                    (pos == lo[:, None]).reshape(b, g, g))
        return mask, mask

    @trace.spanned("saliency")
    def _saliency_grids(self, c5, p, u):
        """The raw view's c5 (NHWC) -> the zoom and inverse grids stacked
        [2B, S, S, 2]: the CAM, the decided map, its peaks, the saliency
        maps and their grids."""
        w = self.raw_classifier.weight.detach()
        crm = torch.einsum("bhwc,kc->bhwk", c5.detach().to(w.dtype), w)
        crm = crm + self.raw_classifier.bias.detach()
        g = self.grid_size
        score_map = self._decide_map(resize_bilinear(crm, g, g, align_corners=True))
        mask_zoom, mask_inv = self._peaks(score_map, p, u)
        root = score_map.clamp_min(1e-8).sqrt()
        sal_zoom = saliency_from_peaks(score_map, mask_zoom, self.radius(root),
                                       self.base_ratio, "score")
        sal_inv = saliency_from_peaks(score_map, mask_inv, self.radius_inv(root),
                                      self.base_ratio, "inv")
        return self._create_grid(torch.cat([sal_zoom, sal_inv]))

    @trace.spanned("warp")
    def _warp(self, x, grids):
        """The image (NHWC) sampled at each grid, in the compute dtype:
        [2B, S, S, 3], zoom views first."""
        x = x.to(self.dtype)
        return grid_sample_bilinear(torch.cat([x, x]), grids)

    def uniform_draws(self, generator, b):
        """Phase 1's uniform draws [B, G, G] in [0, 1) from ``generator``,
        on its device."""
        g = self.grid_size
        return torch.rand((b, g, g), generator=generator, device=generator.device)

    def forward(self, x, p=0, generator=None, u=None):
        """x NHWC. Phase 1 takes its draws from ``u`` or, without it, from
        ``generator``."""
        if p == 1 and u is None:
            if generator is None:
                raise ValueError("S3N's phase 1 draws from a generator: pass "
                                 "generator= or u=")
            u = self.uniform_draws(generator, x.shape[0])
        head = self.raw_classifier.weight.dtype
        c5 = self._trunk(x)
        pooled_raw = c5.mean(dim=(1, 2)).to(head)
        agg_origin = self.raw_classifier(pooled_raw)

        views = self._warp(x, self._saliency_grids(c5, p, u))
        if self.fused_warp_pass:
            c5_zoom, c5_inv = self._trunk(views, 2 if self.training else 1).chunk(2)
        else:
            x_zoom, x_inv = views.chunk(2)
            c5_zoom, c5_inv = self._trunk(x_zoom), self._trunk(x_inv)
        feat_d = self.sampler_buffer(c5_zoom.permute(0, 3, 1, 2)).to(head).mean(dim=(2, 3))
        feat_c = self.sampler_buffer1(c5_inv.permute(0, 3, 1, 2)).to(head).mean(dim=(2, 3))
        return {
            "logits": self.con_classifier(torch.cat([pooled_raw, feat_d, feat_c], dim=1)),
            "agg_origin": agg_origin,
            "agg_sampler": self.sampler_classifier(feat_d),
            "agg_sampler1": self.sampler_classifier1(feat_c),
        }


@MODEL.register(name="S3N")
def build_s3n(config):
    return S3N(
        num_classes=int(config.num_classes),
        image_size=int(config.get("image_size", 448)),
        base_ratio=float(config.get("base_ratio", 0.09)),
        radius_init=float(config.get("radius", 0.12)),
        radius_inv_init=float(config.get("radius_inv", 0.3)),
        backbone_name=config.get("backbone", "resnet50"),
        fused_warp_pass=bool(config.get("fused_warp_pass", True)),
    )
