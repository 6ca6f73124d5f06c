"""The synthetic shape task: the numpy data half of the JAX package's
models/seg_train.py.

The shipped weights `seg_w8.npz` were trained on these scenes: 1..3
bright rectangles or inscribed ellipses on a noisy dark background.  The
tests and `chip_smoke.py` make their frames and ground truth with
`render_shape_scene` and score rows with `segment_quality` (against the
scenes' truth) and `matched_mask_ious` (two runs against each other).
The train loop (`train_segmenter`) and the mp4 writer are not ported
yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# WIDTH is the task's model width, shared with the detection task
from .detect_train import SIZE, WIDTH, box_iou, same_box  # noqa: F401
from .segmentation import paste_masks, unpack_instances

KIND_RECT = 0
KIND_ELLIPSE = 1


def render_shape_scene(rng: np.random.RandomState, size: int = SIZE,
                       max_objects: int = 3
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Noisy dark frame with 1..max_objects bright shapes.  Returns
    (frame uint8 (S,S,3), boxes (N,4) unit [y1,x1,y2,x2], kinds (N,)
    int32 — KIND_RECT or KIND_ELLIPSE)."""
    frame = rng.randint(0, 40, (size, size, 3)).astype(np.uint8)
    ys, xs = np.mgrid[0:size, 0:size]
    n = rng.randint(1, max_objects + 1)
    boxes, kinds = [], []
    for _ in range(n):
        h = rng.randint(12, 28)
        w = rng.randint(12, 28)
        y = rng.randint(0, size - h)
        x = rng.randint(0, size - w)
        color = rng.randint(170, 255, 3)
        kind = int(rng.randint(0, 2))
        if kind == KIND_RECT:
            frame[y:y + h, x:x + w] = color
        else:
            cy, cx = y + h / 2, x + w / 2
            inside = (((ys - cy) / (h / 2)) ** 2 +
                      ((xs - cx) / (w / 2)) ** 2) <= 1.0
            frame[inside] = color
        boxes.append([y / size, x / size, (y + h) / size, (x + w) / size])
        kinds.append(kind)
    return frame, np.asarray(boxes, np.float32), np.asarray(kinds, np.int32)


def full_gt_mask(box: np.ndarray, kind: int, height: int,
                 width: int) -> np.ndarray:
    """Full-frame (H, W) boolean mask of one ground-truth shape."""
    y1, x1, y2, x2 = box
    ys, xs = np.mgrid[0:height, 0:width]
    yu = (ys + 0.5) / height
    xu = (xs + 0.5) / width
    in_box = (yu >= y1) & (yu < y2) & (xu >= x1) & (xu < x2)
    if kind == KIND_RECT:
        return in_box
    cy, cx = (y1 + y2) / 2, (x1 + x2) / 2
    ry, rx = (y2 - y1) / 2, (x2 - x1) / 2
    return (((yu - cy) / max(ry, 1e-6)) ** 2 +
            ((xu - cx) / max(rx, 1e-6)) ** 2) <= 1.0


def matched_mask_ious(rows_a, rows_b, iou=0.9):
    """Mask IoUs of the instances of `rows_a` whose box meets one of
    `rows_b` within `iou` (against that instance's mask)."""
    out = []
    for ra, rb in zip(rows_a, rows_b):
        a, b = unpack_instances(ra), unpack_instances(rb)
        for box, mask in zip(a["boxes"], a["masks"]):
            cand = [j for j, y in enumerate(b["boxes"])
                    if same_box(box, y, iou)]
            if cand:
                m = b["masks"][cand[0]]
                out.append((mask & m).sum() / max((mask | m).sum(), 1))
    return out


def segment_quality(rows, truths):
    """(matched, total, mean mask IoU with the right shape kind, with the
    wrong one) of InstanceSegment rows against (boxes, kinds) truth —
    the scoring of the JAX package's shipped-weight test."""
    matched = total = 0
    iou_c, iou_w = [], []
    for row, (gt_boxes, gt_kinds) in zip(rows, truths):
        r = unpack_instances(row)
        boxes = r["boxes"]
        full = paste_masks(boxes, r["masks"], SIZE, SIZE)
        for gt_box, kind in zip(gt_boxes, gt_kinds):
            total += 1
            cand = [j for j, b in enumerate(boxes)
                    if box_iou(gt_box, b) >= 0.3]
            if not cand:
                continue
            matched += 1

            def iou_with(k):
                gm = full_gt_mask(gt_box, k, SIZE, SIZE)
                return max((full[j] & gm).sum() / max((full[j] | gm).sum(),
                                                      1) for j in cand)
            iou_c.append(iou_with(int(kind)))
            iou_w.append(iou_with(1 - int(kind)))
    return matched, total, float(np.mean(iou_c)), float(np.mean(iou_w))
