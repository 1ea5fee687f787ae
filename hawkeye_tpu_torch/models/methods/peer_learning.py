"""Peer-Learning: webly-supervised co-teaching of two peer networks.

Counterpart of ``hawkeye_tpu/models/methods/peer_learning.py`` (reference
``model/methods/PeerLearningNet.py``): two instances of the nested
``base_model`` config (any registered model; BCNN in the shipped recipes),
``base_model`` and ``base_model2``, each with its own initialisation. Both
see every batch; the loss (``losses/peer_learning.py``) exchanges their
small-loss samples. Outputs: ``logits`` (the mean of the two peers, for the
default accuracy), ``logits1`` and ``logits2``.
"""

from __future__ import annotations

from torch import nn

from ...config import ConfigNode
from ...registry import MODEL


class PeerLearningNet(nn.Module):
    def __init__(self, base_config):
        super().__init__()
        base_cfg = ConfigNode(dict(base_config))
        self.base_model = MODEL.get(base_cfg["name"])(base_cfg)
        self.base_model2 = MODEL.get(base_cfg["name"])(base_cfg)

    def forward(self, x):
        out1 = self.base_model(x)
        out2 = self.base_model2(x)
        return {
            "logits": (out1["logits"] + out2["logits"]) / 2.0,
            "logits1": out1["logits"],
            "logits2": out2["logits"],
        }


@MODEL.register(name="PeerLearningNet")
def build_peer_learning(config):
    base = config.base_model
    if isinstance(base, ConfigNode):
        base = base.clone().defrost()
    return PeerLearningNet(base_config=dict(base))
