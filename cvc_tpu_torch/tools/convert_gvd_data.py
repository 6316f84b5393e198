"""Offline preprocessing: convert GVD-style artifacts to the canonical
layout (the port's copy of `tools/convert_gvd_data.py`, with the same
flags). The reference consumes (a) a region-feature HDF5/NPY dump from the
Visual-Genome Faster R-CNN, and (b) Flickr30k-/ANet-Entities annotation
JSONs; this converter normalizes both into the schema documented in
cvc_tpu_torch/data/datasets.py:

  HDF5:  f[id]/{features [N,2048] | [F,N,2048], boxes [N,4] (normalized
         x1y1x2y2), classes [N], global [Dg]?}
  JSON:  {"classes": [...], "images": [{id, split, captions, entities:
         [{caption_idx, word_idx, class, box}]}]}

    python -m cvc_tpu_torch.tools.convert_gvd_data --src_features src.h5 \
        --src_annotations src.json --out_features feats.h5 \
        --out_annotations ann.json

Since the upstream dumps come in several vintages, the converter accepts
a flexible source spec and is deliberately small — adapt the `iter_source`
loader to your dump if it differs. Host work only (h5py and numpy, imported
when it runs); like every entry point of the port it runs for CUDA, and
`main(argv, device="cpu")` on the CPU.
"""

import argparse
import json

import numpy as np

from cvc_tpu_torch.ops.dispatch import resolve_device


def iter_source(feature_file):
    """Yield (image_id, features, boxes, classes, global_or_None) from a
    source HDF5.  Handles both group-per-image layout and flat datasets
    keyed `<id>_features` / `<id>_boxes` / `<id>_classes`."""
    import h5py
    with h5py.File(feature_file, "r") as f:
        for key in f:
            node = f[key]
            if isinstance(node, h5py.Group):
                yield (key,
                       np.asarray(node["features"], np.float32),
                       np.asarray(node["boxes"], np.float32),
                       np.asarray(node.get("classes",
                                           np.zeros(len(node["boxes"]))),
                                  np.int32),
                       np.asarray(node["global"], np.float32)
                       if "global" in node else None)
            elif key.endswith("_features"):
                img_id = key[: -len("_features")]
                feats = np.asarray(node, np.float32)
                boxes = np.asarray(f[f"{img_id}_boxes"], np.float32)
                cls = (np.asarray(f[f"{img_id}_classes"], np.int32)
                       if f"{img_id}_classes" in f
                       else np.zeros(len(boxes), np.int32))
                yield img_id, feats, boxes, cls, None


def normalize_boxes(boxes, width, height):
    out = boxes.astype(np.float32).copy()
    if out.size and out.max() > 1.5:   # pixel coords -> normalized
        out[..., 0] /= width
        out[..., 2] /= width
        out[..., 1] /= height
        out[..., 3] /= height
    return np.clip(out, 0.0, 1.0)


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--src_features", required=True)
    p.add_argument("--src_annotations", required=True,
                   help="JSON: [{id, split, width, height, captions,"
                        " entities:[{caption_idx, word_idx, class, box}]}]")
    p.add_argument("--out_features", required=True)
    p.add_argument("--out_annotations", required=True)
    args = p.parse_args(argv)
    resolve_device(device)
    import h5py

    with open(args.src_annotations) as f:
        src_ann = json.load(f)
    if isinstance(src_ann, dict) and "images" in src_ann:
        src_images = src_ann["images"]
    else:
        src_images = src_ann
    meta = {str(img["id"]): img for img in src_images}

    classes: list[str] = []
    cls_index: dict[str, int] = {}
    images_out = []
    n = 0
    with h5py.File(args.out_features, "w") as out:
        for img_id, feats, boxes, cls, gfeat in iter_source(args.src_features):
            if img_id not in meta:
                continue
            m = meta[img_id]
            w, h = float(m.get("width", 1.0)), float(m.get("height", 1.0))
            g = out.create_group(img_id)
            g.create_dataset("features", data=feats)
            g.create_dataset("boxes", data=normalize_boxes(boxes, w, h))
            g.create_dataset("classes", data=cls)
            if gfeat is not None:
                g.create_dataset("global", data=gfeat)
            ents = []
            for e in m.get("entities", []):
                cname = str(e["class"])
                if cname not in cls_index:
                    cls_index[cname] = len(classes)
                    classes.append(cname)
                box = normalize_boxes(np.asarray(e["box"], np.float32)[None],
                                      w, h)[0]
                ents.append({"caption_idx": int(e["caption_idx"]),
                             "word_idx": int(e["word_idx"]),
                             "class": cname,
                             "box": [float(v) for v in box]})
            images_out.append({"id": img_id,
                               "split": m.get("split", "train"),
                               "captions": list(m["captions"]),
                               "entities": ents})
            n += 1
    with open(args.out_annotations, "w") as f:
        json.dump({"classes": classes, "images": images_out}, f)
    print(f"converted {n} images, {len(classes)} entity classes")
    return n


if __name__ == "__main__":
    main()
