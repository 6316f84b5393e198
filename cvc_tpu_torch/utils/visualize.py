"""Attention visualization helpers (the port's copy of
`cvc_tpu/utils/visualize.py`; the reference's attention-vis utilities in
`misc/utils.py`).

Host-side: given a generated caption, its per-step region attention and
the region boxes, emit (a) a machine-readable JSON of each word's top
attended regions, and (b) an optional matplotlib figure drawing the
attended box per object word over a blank canvas (features are
pre-extracted — there are no pixels in the pipeline, so the canvas shows
normalized box geometry only).
"""

from __future__ import annotations

import json
import os

import numpy as np


def attention_summary(words: list[str], attn: np.ndarray, boxes: np.ndarray,
                      top_k: int = 3) -> list[dict]:
    """[{word, regions: [{slot, weight, box}, ...]}, ...]"""
    out = []
    attn = np.asarray(attn)
    boxes = np.asarray(boxes)
    for t, w in enumerate(words):
        if t >= attn.shape[0]:
            break
        idx = np.argsort(-attn[t])[:top_k]
        out.append({
            "word": w,
            "regions": [{"slot": int(i), "weight": float(attn[t, i]),
                         "box": [float(v) for v in boxes[i][:4]]}
                        for i in idx],
        })
    return out


def save_attention_json(path: str, image_id: str, words: list[str],
                        attn: np.ndarray, boxes: np.ndarray,
                        top_k: int = 3) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"image_id": image_id,
                   "caption": " ".join(words),
                   "attention": attention_summary(words, attn, boxes, top_k)},
                  f, indent=2)


def render_attention_png(path: str, words: list[str], attn: np.ndarray,
                         boxes: np.ndarray, object_words=None) -> bool:
    """Draw each (object) word's argmax box on a unit canvas.  Returns
    False when matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import patches
    except Exception:
        return False
    attn = np.asarray(attn)
    boxes = np.asarray(boxes)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.set_xlim(0, 1)
    ax.set_ylim(1, 0)
    ax.set_title(" ".join(words))
    cmap = plt.get_cmap("tab10")
    shown = 0
    for t, w in enumerate(words):
        if t >= attn.shape[0]:
            break
        if object_words is not None and w not in object_words:
            continue
        b = boxes[int(np.argmax(attn[t]))][:4]
        color = cmap(shown % 10)
        ax.add_patch(patches.Rectangle((b[0], b[1]), b[2] - b[0], b[3] - b[1],
                                       fill=False, edgecolor=color, lw=2))
        ax.text(b[0], b[1], w, color=color, fontsize=9,
                va="bottom")
        shown += 1
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return True
