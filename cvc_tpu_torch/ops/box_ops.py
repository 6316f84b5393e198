"""Box math on the host (the port of `cvc_tpu/ops/box_ops.py`).

numpy in float32, as the JAX version computes: the grounding scorer
compares IoUs with 0.5, so the type decides the cases at the threshold.
"""

from __future__ import annotations

import numpy as np


def box_iou(a, b) -> np.ndarray:
    """IoU matrix between two box sets.

    a [N, 4], b [M, 4] in x1,y1,x2,y2 -> [N, M] float32 IoU. Degenerate
    boxes get 0.
    """
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    zero = np.float32(0.0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.maximum(rb - lt, zero)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (np.maximum(a[:, 2] - a[:, 0], zero)
              * np.maximum(a[:, 3] - a[:, 1], zero))
    area_b = (np.maximum(b[:, 2] - b[:, 0], zero)
              * np.maximum(b[:, 3] - b[:, 1], zero))
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > zero,
                    inter / np.maximum(union, np.float32(1e-9)), zero)
