"""CBCNN: compact bilinear pooling (count sketch + FFT) over VGG-16.

Counterpart of ``hawkeye_tpu/models/methods/cbcnn.py`` (reference
``model/methods/CBCNN.py``): two fixed count sketches (seeds 1/3 and 5/7)
of the post-pool5 map to d (``output_channel``, 6000 in
``configs/CBCNN_S1.yaml``), multiplied in the Fourier domain and summed over
positions (``ops/cbp.py``), signed square root and L2, then a float32
linear classifier. Two stages as BCNN: stage 1 runs the trunk with autograd
off, stage 2 fine-tunes everything from the stage-1 best model.

The sketches, their host-computed spectra and the two ``[K, K]`` irDFT
matrices are buffers with ``persistent=False``: derived constants, rebuilt
at construction and left out of every ``.pt`` file, as the JAX package
leaves its ``fourier_cache`` collection out of every checkpoint.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.cbp import (compact_bilinear_pool, make_irdft_half,
                        make_sketch_matrix, sketch_spectrum)
from ...registry import BACKBONE, MODEL


class CBCNN(nn.Module):
    def __init__(self, num_classes, stage=2, input_channel=512,
                 output_channel=6000, backbone_name="vgg16",
                 dtype=torch.bfloat16):
        super().__init__()
        self.stage = int(stage)
        self.output_channel = int(output_channel)
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype)
        self.fc = nn.Linear(self.output_channel, num_classes, dtype=torch.float32)
        sketches = (make_sketch_matrix(input_channel, output_channel, 1, 3),
                    make_sketch_matrix(input_channel, output_channel, 5, 7))
        for i, sketch in enumerate(sketches, 1):
            real, imag = sketch_spectrum(sketch)
            self.register_buffer(f"sketch{i}", torch.from_numpy(sketch),
                                 persistent=False)
            self.register_buffer(f"spectrum{i}_real", torch.from_numpy(real),
                                 persistent=False)
            self.register_buffer(f"spectrum{i}_imag", torch.from_numpy(imag),
                                 persistent=False)
        cos_m, sin_m = make_irdft_half(self.output_channel)
        self.register_buffer("irdft_cos", torch.from_numpy(cos_m),
                             persistent=False)
        self.register_buffer("irdft_sin", torch.from_numpy(sin_m),
                             persistent=False)

    def forward(self, x):
        # post-pool5 map, as the reference's full-features backbone
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.stage != 1):
            feats = self.backbone(x)["pooled_features"]
        v = compact_bilinear_pool(
            feats, (self.spectrum1_real, self.spectrum1_imag),
            (self.spectrum2_real, self.spectrum2_imag),
            out_dim=self.output_channel, irdft=(self.irdft_cos, self.irdft_sin))
        return {"logits": self.fc(v), "features": v}


@MODEL.register(name="CBCNN")
def build_cbcnn(config):
    return CBCNN(
        num_classes=int(config.num_classes),
        stage=int(config.get("stage", 2)),
        input_channel=int(config.get("input_channel", 512)),
        output_channel=int(config.get("output_channel", 6000)),
        backbone_name=config.get("backbone", "vgg16"),
    )
