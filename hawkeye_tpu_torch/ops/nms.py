"""Fixed-shape non-maximum suppression on the device.

Counterpart of ``hawkeye_tpu/ops/nms.py``. The greedy loop runs ``topn``
iterations of plain tensor ops (a masked argmax, a row gather from the
adjacency, a mask update) with no host round trip: nothing in it reads a
value back from the device.

- ``anchor_adjacency``: when the box set is static (NTS-Net's anchor grid,
  AP-CNN's per-level grids), the IoU adjacency is computed once on the host,
  in float64 numpy, and kept on the device as a constant.
- ``nms_fixed_anchors_batch``: the greedy top-N over such a set for a batch
  of score rows. Slots that find no box left (every remaining score is
  ``-inf``) take the row's best index and its score.
- ``iou_matrix`` / ``nms_general``: greedy top-N with the IoU of runtime
  boxes, for one image; exhausted slots are reported by a mask.

``torch.argmax``, like ``jnp.argmax``, returns the first of equal maxima,
and index 0 for a row of ``-inf``.
"""

from __future__ import annotations

import numpy as np
import torch


def iou_matrix(boxes_a, boxes_b):
    """IoU between two box sets [N, 4] and [M, 4], boxes (y0, x0, y1, x1)."""
    a = boxes_a[:, None, :]
    b = boxes_b[None, :, :]
    y0 = torch.maximum(a[..., 0], b[..., 0])
    x0 = torch.maximum(a[..., 1], b[..., 1])
    y1 = torch.minimum(a[..., 2], b[..., 2])
    x1 = torch.minimum(a[..., 3], b[..., 3])
    inter = (y1 - y0).clamp_min(0.0) * (x1 - x0).clamp_min(0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter).clamp_min(1e-9)


def anchor_adjacency(edge_anchors: np.ndarray, iou_thresh: float) -> np.ndarray:
    """Host-side precomputation: [A, A] bool, True where IoU >= thresh."""
    a = edge_anchors.astype(np.float64)
    y0 = np.maximum(a[:, None, 0], a[None, :, 0])
    x0 = np.maximum(a[:, None, 1], a[None, :, 1])
    y1 = np.minimum(a[:, None, 2], a[None, :, 2])
    x1 = np.minimum(a[:, None, 3], a[None, :, 3])
    inter = np.clip(y1 - y0, 0, None) * np.clip(x1 - x0, 0, None)
    area = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    iou = inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-9)
    return iou >= iou_thresh


def _greedy(scores, adjacency_rows, topn: int):
    """``topn`` greedy picks per row of ``scores`` [B, A]; ``adjacency_rows(j)``
    gives the [B, A] rows that pick ``j`` [B] suppresses. Returns the picks
    and their masked scores (``-inf`` once a row is exhausted), [B, topn]."""
    mask = torch.ones_like(scores, dtype=torch.bool)
    idxs, vals = [], []
    for _ in range(topn):
        masked = torch.where(mask, scores, float("-inf"))
        j = masked.argmax(dim=1)
        idxs.append(j)
        vals.append(masked.gather(1, j[:, None])[:, 0])
        mask = mask & ~adjacency_rows(j)
    return torch.stack(idxs, dim=1), torch.stack(vals, dim=1)


def nms_fixed_anchors_batch(scores, adjacency, topn: int):
    """Greedy NMS over a static anchor set for each row of ``scores`` [B, A];
    ``adjacency`` [A, A] bool (IoU >= thresh, diagonal included) on the
    scores' device. Returns ([B, topn] indices, [B, topn] scores) in greedy
    order; an exhausted slot takes the row's best index and score."""
    idxs, vals = _greedy(scores, lambda j: adjacency[j], topn)
    best = scores.argmax(dim=1, keepdim=True)
    exhausted = ~torch.isfinite(vals)
    idxs = torch.where(exhausted, best, idxs)
    vals = torch.where(exhausted, scores.gather(1, best), vals)
    return idxs, vals


def nms_fixed_anchors(scores, adjacency, topn: int):
    """``nms_fixed_anchors_batch`` for one score row [A]: ([topn], [topn])."""
    idxs, vals = nms_fixed_anchors_batch(scores[None], adjacency, topn)
    return idxs[0], vals[0]


def nms_general(scores, boxes, topn: int, iou_thresh: float):
    """Greedy NMS with runtime boxes for one image: scores [N], boxes
    [N, 4]. Returns ([topn] indices, [topn] scores, [topn] valid mask); an
    exhausted slot has score 0 and ``valid`` False."""
    adj = iou_matrix(boxes, boxes) >= iou_thresh
    idxs, vals = _greedy(scores[None], lambda j: adj[j], topn)
    valid = torch.isfinite(vals[0])
    return idxs[0], torch.where(valid, vals[0], 0.0), valid
