"""Train the instance segmenter on the synthetic shape task and save a
checkpoint: the counterpart of the JAX package's models/seg_train.py.

The shipped weights `seg_w8.npz` were trained on these scenes: 1..3
bright rectangles or inscribed ellipses on a noisy dark background.
Ground-truth masks are analytic: `roi_gt_mask` samples a shape on the
grid of a (jittered) roi in closed form.  `train_segmenter` is Adam at
1e-3 on the SSD loss plus twice the per-roi mask binary cross entropy,
over batches drawn in the reference's order;

    python -m scanner_tpu_torch.models.seg_train <out_dir> [--device cpu]

trains it on the card and exports `seg_w8.npz`.  The tests and
`chip_smoke.py` score rows with `segment_quality` (against the scenes'
truth) and `matched_mask_ious` (two runs against each other);
`synth_shape_video` encodes through libav, so it runs where libav is.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch.nn.functional as F

# WIDTH is the task's model width, shared with the detection task
from .detect_train import (SIZE, WIDTH, adam_loop, box_iou,  # noqa: F401
                           detection_loss, match_anchors, same_box)
from .segmentation import paste_masks, unpack_instances

KIND_RECT = 0
KIND_ELLIPSE = 1
TRAIN_ROIS = 4          # fixed gt-roi budget per training frame


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


def roi_gt_mask(box: np.ndarray, kind: int, roi: np.ndarray,
                mask_size: int) -> np.ndarray:
    """Analytic (M, M) binary mask of a shape (gt `box` + `kind`) sampled
    on the grid of an arbitrary `roi` (both unit corners).  Sampling on
    the roi grid rather than the box grid lets training jitter its rois —
    the mask head then learns the shape's actual boundary instead of
    "fill the roi"."""
    M = mask_size
    c = (np.arange(M, dtype=np.float32) + 0.5) / M
    yu = roi[0] + (roi[2] - roi[0]) * c
    xu = roi[1] + (roi[3] - roi[1]) * c
    y1, x1, y2, x2 = box
    if kind == KIND_RECT:
        iny = (yu >= y1) & (yu < y2)
        inx = (xu >= x1) & (xu < x2)
        return (iny[:, None] & inx[None, :]).astype(np.float32)
    cy, cx = (y1 + y2) / 2, (x1 + x2) / 2
    ry, rx = max((y2 - y1) / 2, 1e-6), max((x2 - x1) / 2, 1e-6)
    dy = ((yu - cy) / ry) ** 2
    dx = ((xu - cx) / rx) ** 2
    return ((dy[:, None] + dx[None, :]) <= 1.0).astype(np.float32)


def jitter_box(rng: np.random.RandomState, box: np.ndarray,
               frac: float = 0.12) -> np.ndarray:
    """Shift/scale a unit-coordinate box by up to ±frac of its size —
    the training-time stand-in for imperfect detector boxes."""
    y1, x1, y2, x2 = box
    h, w = y2 - y1, x2 - x1
    dy1, dy2 = rng.uniform(-frac, frac, 2) * h
    dx1, dx2 = rng.uniform(-frac, frac, 2) * w
    out = np.asarray([y1 + dy1, x1 + dx1, y2 + dy2, x2 + dx2], np.float32)
    out[2] = max(out[2], out[0] + 1e-3)
    out[3] = max(out[3], out[1] + 1e-3)
    return np.clip(out, 0.0, 1.0)


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


def synth_shape_video(path: str, num_frames: int = 16, size: int = SIZE,
                      fps: float = 24.0, seed: int = 17):
    """Encode a clip of independent shape scenes; returns the per-frame
    (boxes, kinds) ground truth (crf 14 keeps silhouettes crisp)."""
    from ..video.ingest import encode_frames_mp4

    rng = np.random.RandomState(seed)
    frames, gts = [], []
    for _ in range(num_frames):
        f, boxes, kinds = render_shape_scene(rng, size)
        frames.append(f)
        gts.append((boxes, kinds))
    encode_frames_mp4(path, frames, size, size, fps=fps, keyint=8, crf=14)
    return gts


def seg_batch(rng: np.random.RandomState, batch: int, anchors: np.ndarray,
              mask_size: int, size: int = SIZE):
    """One training batch: (frames (B,S,S,3) u8, cls (B,N) i32,
    deltas (B,N,4) f32, rois (B,K,4) f32, roi_masks (B,K,M,M) f32,
    roi_valid (B,K) f32) — rois are JITTERED ground-truth boxes,
    zero-padded to K=TRAIN_ROIS; mask targets are the shapes resampled on
    each jittered roi's grid."""
    N = anchors.shape[0]
    K, M = TRAIN_ROIS, mask_size
    frames = np.zeros((batch, size, size, 3), np.uint8)
    cls = np.zeros((batch, N), np.int32)
    deltas = np.zeros((batch, N, 4), np.float32)
    rois = np.zeros((batch, K, 4), np.float32)
    roi_masks = np.zeros((batch, K, M, M), np.float32)
    roi_valid = np.zeros((batch, K), np.float32)
    for b in range(batch):
        frames[b], boxes, kinds = render_shape_scene(rng, size)
        cls[b], deltas[b] = match_anchors(anchors, boxes)
        for k in range(min(len(boxes), K)):
            roi = jitter_box(rng, boxes[k])
            rois[b, k] = roi
            roi_masks[b, k] = roi_gt_mask(boxes[k], int(kinds[k]), roi, M)
            roi_valid[b, k] = 1.0
    return frames, cls, deltas, rois, roi_masks, roi_valid


def _initial_segmenter(seed: int, width: int, device: Any):
    """The model train_segmenter starts from (tests put the JAX
    package's initial parameters in its place)."""
    from ..engine.evaluate import resolve_device
    from .nets import init_module_
    from .segmentation import InstanceSegmentor
    return init_module_(InstanceSegmentor(num_classes=2, width=width),
                        seed).to(resolve_device(device))


def train_segmenter(checkpoint_dir: str, steps: int = 400, batch: int = 4,
                    size: int = SIZE, width: int = WIDTH, seed: int = 3,
                    export_npz: Optional[str] = None,
                    log_every: int = 50, *, device: Any = "cuda") -> float:
    """Train InstanceSegmentor on `device` (the card unless the caller
    asks for the CPU): the SSD detection loss plus twice the per-roi mask
    BCE on jittered ground-truth rois.  Saves a checkpoint, and the
    `.npz` weight file when `export_npz` is given; returns the final
    loss."""
    from .checkpoint import TrainCheckpointer, export_params_npz
    from .detection import make_anchors
    from .segmentation import MASK_SIZE

    anchors = make_anchors(-(-size // 16), -(-size // 16))
    model = _initial_segmenter(seed, width, device)
    rng = np.random.RandomState(seed)

    def loss_fn(frames, cls_t, box_t, rois, masks_t, roi_valid):
        logits, deltas, mask_logits = model(frames, rois)
        bce = F.binary_cross_entropy_with_logits(
            mask_logits, masks_t, reduction="none").mean(dim=(-2, -1))
        mask_loss = (bce * roi_valid).sum() / roi_valid.sum().clamp_min(1.0)
        # masks are the op's purpose: keep their gradient from being
        # drowned by the dense anchor losses
        return detection_loss(logits, deltas, cls_t, box_t) \
            + 2.0 * mask_loss

    opt, loss = adam_loop(
        model, loss_fn,
        lambda: seg_batch(rng, batch, anchors, MASK_SIZE, size),
        steps, log_every, "seg_train")
    TrainCheckpointer(checkpoint_dir).save(steps, model, opt)
    if export_npz:
        export_params_npz(model, export_npz)
    return loss


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


def main(argv: Optional[list] = None) -> None:
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_const", const="cpu",
                    dest="device", help="the same as --device cpu")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    loss = train_segmenter(
        os.path.join(args.out_dir, "seg_ckpt"), steps=args.steps,
        export_npz=os.path.join(args.out_dir, f"seg_w{WIDTH}.npz"),
        device=args.device)
    print(f"seg: final loss {loss:.5f}")


if __name__ == "__main__":
    main()
