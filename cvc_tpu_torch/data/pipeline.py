"""Static-shape region padding for serving requests (the port's copy of
`box_geometry` and `pad_regions` from `cvc_tpu/data/pipeline.py`).

    feats       [S, Dfeat]   S = num_frames * num_regions attention slots
    box_geom    [S, 5]       x1, y1, x2, y2, area
    region_cls  [S]          detector class id (int32)
    region_mask [S]          1.0 for real proposals
"""

from __future__ import annotations

import numpy as np


def box_geometry(boxes: np.ndarray) -> np.ndarray:
    """[..., 4] x1y1x2y2 -> [..., 5] with the box area appended."""
    w = np.clip(boxes[..., 2] - boxes[..., 0], 0, None)
    h = np.clip(boxes[..., 3] - boxes[..., 1], 0, None)
    return np.concatenate([boxes, (w * h)[..., None]], axis=-1)


def pad_regions(feats: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
                num_frames: int, num_regions: int, feat_dim: int):
    """Pad/truncate one example's proposals to the static [S, ...] shapes.

    Accepts [N, D] (image) or [F, N, D] (video) features; returns flattened
    [S, D], [S, 5], [S], [S] with S = num_frames * num_regions.
    """
    S = num_frames * num_regions
    out = (np.empty((S, feat_dim), np.float32), np.empty((S, 5), np.float32),
           np.empty((S,), np.int32), np.empty((S,), np.float32))
    pad_regions_into(*out, feats, boxes, classes, num_frames, num_regions,
                     feat_dim)
    return out


def pad_regions_into(out_f: np.ndarray, out_g: np.ndarray, out_c: np.ndarray,
                     out_m: np.ndarray, feats: np.ndarray, boxes: np.ndarray,
                     classes: np.ndarray, num_frames: int, num_regions: int,
                     feat_dim: int) -> None:
    """`pad_regions` written into given contiguous [S, D], [S, 5], [S], [S]
    arrays, every slot overwritten, so a batch buffer can be reused
    without clearing it first."""
    if not all(a.flags.c_contiguous for a in (out_f, out_g, out_c, out_m)):
        raise ValueError("pad_regions_into writes through reshaped views: "
                         "the output arrays must be C-contiguous")
    if feats.ndim == 2:
        feats, boxes, classes = feats[None], boxes[None], classes[None]
    F = min(feats.shape[0], num_frames)
    n = min(feats.shape[1], num_regions)
    d = min(feats.shape[2], feat_dim)  # zero-pad narrow features, truncate wide
    of = out_f.reshape(num_frames, num_regions, feat_dim)
    ob = out_g.reshape(num_frames, num_regions, 5)
    oc = out_c.reshape(num_frames, num_regions)
    om = out_m.reshape(num_frames, num_regions)
    of[F:] = 0.0
    of[:F, n:] = 0.0
    of[:F, :n, d:] = 0.0
    of[:F, :n, :d] = feats[:F, :n, :d]
    ob[...] = 0.0
    ob[:F, :n, :4] = boxes[:F, :n]
    oc[...] = 0
    oc[:F, :n] = classes[:F, :n]
    om[...] = 0.0
    om[:F, :n] = 1.0
    out_g[...] = box_geometry(out_g[:, :4])
