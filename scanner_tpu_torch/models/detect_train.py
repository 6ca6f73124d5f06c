"""The synthetic detection, face and embedding tasks: the numpy data
half of the JAX package's models/detect_train.py.

The shipped weights `detect_ssd_w8.npz`, `face_ssd_w8.npz` and
`embed_w8.npz` were trained on these scenes; the tests and
`chip_smoke.py` make their frames and ground truth with them.  The train
loops (`train_detector`, `train_embedding`) and the mp4 writer are not
ported yet.  `recall` scores detections against the scenes' truth and
`boxes_agree` two runs against each other.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# shared synthetic-task geometry (training, tests and examples agree)
SIZE = 64
WIDTH = 8
EMBED_DIM = 128


def render_rect_scene(rng: np.random.RandomState, size: int = SIZE,
                      max_objects: int = 3
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Noisy dark frame with 1..max_objects bright axis-aligned
    rectangles.  Returns (frame uint8 (S,S,3), boxes (N,4) unit
    [y1,x1,y2,x2])."""
    frame = rng.randint(0, 40, (size, size, 3)).astype(np.uint8)
    n = rng.randint(1, max_objects + 1)
    boxes = []
    for _ in range(n):
        h = rng.randint(10, 28)
        w = rng.randint(10, 28)
        y = rng.randint(0, size - h)
        x = rng.randint(0, size - w)
        color = rng.randint(170, 255, 3)
        frame[y:y + h, x:x + w] = color
        boxes.append([y / size, x / size, (y + h) / size, (x + w) / size])
    return frame, np.asarray(boxes, np.float32)


def render_face_scene(rng: np.random.RandomState, size: int = SIZE,
                      max_objects: int = 2
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Face-like targets: bright ellipse with two dark eye dots."""
    frame = rng.randint(0, 40, (size, size, 3)).astype(np.uint8)
    n = rng.randint(1, max_objects + 1)
    ys, xs = np.mgrid[0:size, 0:size]
    boxes = []
    for _ in range(n):
        h = rng.randint(14, 30)
        w = int(h * rng.uniform(0.7, 0.9))
        cy = rng.randint(h // 2, size - h // 2)
        cx = rng.randint(w // 2, size - w // 2)
        mask = (((ys - cy) / (h / 2)) ** 2 + ((xs - cx) / (w / 2)) ** 2) <= 1
        tone = np.array([rng.randint(190, 250), rng.randint(150, 210),
                         rng.randint(120, 180)])
        frame[mask] = tone
        for ex in (-w // 5, w // 5):  # eyes
            ey, exx = cy - h // 6, cx + ex
            frame[max(ey - 1, 0):ey + 2, max(exx - 1, 0):exx + 2] = 15
        boxes.append([(cy - h / 2) / size, (cx - w / 2) / size,
                      (cy + h / 2) / size, (cx + w / 2) / size])
    return frame, np.asarray(boxes, np.float32)


def render_identity(rng_id: int, view_rng: np.random.RandomState,
                    size: int = SIZE) -> np.ndarray:
    """One augmented view of a procedural-texture identity: the identity
    seed fixes an 8x8 color tile; views vary by shift, brightness and
    noise."""
    base_rng = np.random.RandomState(1000 + rng_id)
    tile = base_rng.randint(0, 255, (8, 8, 3)).astype(np.float32)
    img = np.kron(tile, np.ones((size // 8, size // 8, 1), np.float32))
    # augment: circular shift, brightness scale, additive noise
    sy, sx = view_rng.randint(0, size, 2)
    img = np.roll(np.roll(img, sy, axis=0), sx, axis=1)
    img = img * view_rng.uniform(0.6, 1.4)
    img = img + view_rng.normal(0, 18, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _anchor_corners(anchors: np.ndarray) -> np.ndarray:
    cy, cx, h, w = anchors.T
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], 1)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) corner boxes -> (N,M) IoU."""
    y1 = np.maximum(a[:, None, 0], b[None, :, 0])
    x1 = np.maximum(a[:, None, 1], b[None, :, 1])
    y2 = np.minimum(a[:, None, 2], b[None, :, 2])
    x2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-9)


def match_anchors(anchors: np.ndarray, gt: np.ndarray,
                  pos_iou: float = 0.5, neg_iou: float = 0.4
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """SSD target assignment.  anchors (N,4) [cy,cx,h,w]; gt (M,4)
    corners.  Returns (cls (N,) int32: 1 pos / 0 neg / -1 ignore,
    deltas (N,4) f32, zero outside positives)."""
    N = anchors.shape[0]
    cls = np.zeros((N,), np.int32)
    deltas = np.zeros((N, 4), np.float32)
    if gt.shape[0] == 0:
        return cls, deltas
    iou = _iou_matrix(_anchor_corners(anchors), gt)
    best_gt = iou.argmax(1)
    best_iou = iou.max(1)
    cls[(best_iou >= neg_iou) & (best_iou < pos_iou)] = -1
    pos = best_iou >= pos_iou
    # every gt claims its best anchor even below the threshold
    forced = iou.argmax(0)
    pos[forced] = True
    best_gt[forced] = np.arange(gt.shape[0])
    cls[pos] = 1
    g = gt[best_gt[pos]]
    gcy = (g[:, 0] + g[:, 2]) / 2
    gcx = (g[:, 1] + g[:, 3]) / 2
    gh = g[:, 2] - g[:, 0]
    gw = g[:, 3] - g[:, 1]
    a = anchors[pos]
    deltas[pos] = np.stack([
        (gcy - a[:, 0]) / a[:, 2], (gcx - a[:, 1]) / a[:, 3],
        np.log(np.maximum(gh, 1e-4) / a[:, 2]),
        np.log(np.maximum(gw, 1e-4) / a[:, 3])], 1)
    return cls, deltas


def box_iou(a, b) -> float:
    """IoU of two corner boxes [y1,x1,y2,x2] (unit coords)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(_iou_matrix(a[None], b[None])[0, 0])


def recall(rows, truths, unpack, iou=0.3):
    """(hits, total): ground-truth boxes met by a detection at `iou`."""
    hits = total = 0
    for row, gts in zip(rows, truths):
        boxes = unpack(row)["boxes"]
        for gt in gts:
            total += 1
            hits += any(box_iou(gt, b) >= iou for b in boxes)
    return hits, total


def same_box(a, b, iou: float = 0.9, tol: float = 0.01) -> bool:
    """Two corner boxes agree: IoU >= `iou`, or every corner within `tol`
    (a box clipped to an edge of the frame has no area, so IoU cannot
    match it even with itself)."""
    return box_iou(a, b) >= iou or \
        float(np.abs(np.asarray(a) - np.asarray(b)).max()) <= tol


def boxes_agree(rows_a, rows_b, unpack, iou=0.9):
    """The share of frames on which every detection of `rows_a` is met
    by one of `rows_b` (`same_box` at `iou`)."""
    ok = 0
    for ra, rb in zip(rows_a, rows_b):
        a, b = unpack(ra)["boxes"], unpack(rb)["boxes"]
        ok += all(any(same_box(x, y, iou) for y in b) for x in a)
    return ok / len(rows_a)
