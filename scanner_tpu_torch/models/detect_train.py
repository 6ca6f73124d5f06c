"""Train the SSD detector and the embedding net on the synthetic tasks
and save checkpoints: the counterpart of the JAX package's
models/detect_train.py.

* **ObjectDetect** — 1-3 bright rectangles on a noisy dark background
  (anchor-matched SSD loss).
* **FaceDetect** — the same machinery on face-like targets (a bright
  ellipse with two dark eyes), its own weights.
* **FaceEmbedding** — K procedural-texture identities under crop,
  brightness and noise augmentation, trained through a training-only
  classifier; the embedding is the L2-normalised projection.

The shipped weights `detect_ssd_w8.npz`, `face_ssd_w8.npz` and
`embed_w8.npz` were trained on these scenes.  Each loop is Adam at 1e-3
on the reference's losses (softmax cross entropy with positives weighted
10x, Huber with delta 1) over batches drawn from
`np.random.RandomState(seed)` in the reference's order, saves (steps,
model, Adam) through models/checkpoint.py and can export the `.npz`
weight file;

    python -m scanner_tpu_torch.models.detect_train <out_dir> \
        [--which all|detect|face|embed] [--device cpu]

trains all three on the card.  `recall` scores detections against the
scenes' truth and `boxes_agree` two runs against each other;
`synth_scene_video` encodes through libav, so it runs where libav is.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .face import EmbeddingNet

# shared synthetic-task geometry (training, tests and examples agree)
SIZE = 64
WIDTH = 8
EMBED_DIM = 128
EMBED_IDENTITIES = 16


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


def synth_scene_video(path: str, renderer: Callable = None,
                      num_frames: int = 24, size: int = SIZE,
                      fps: float = 24.0, seed: int = 11):
    """Encode a clip of independent synthetic scenes to mp4; returns the
    per-frame ground-truth box lists (crf 14 keeps the rectangles crisp
    enough for IoU checks)."""
    from ..video.ingest import encode_frames_mp4

    renderer = renderer or render_rect_scene
    rng = np.random.RandomState(seed)
    frames, gts = [], []
    for _ in range(num_frames):
        f, gt = renderer(rng, size)
        frames.append(f)
        gts.append(gt)
    encode_frames_mp4(path, frames, size, size, fps=fps, keyint=8, crf=14)
    return gts


def box_iou(a, b) -> float:
    """IoU of two corner boxes [y1,x1,y2,x2] (unit coords)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(_iou_matrix(a[None], b[None])[0, 0])


def detection_batch(rng: np.random.RandomState, batch: int,
                    anchors: np.ndarray, renderer: Callable,
                    size: int = SIZE):
    """(frames (B,S,S,3) u8, cls (B,N) i32, deltas (B,N,4) f32)."""
    frames = np.zeros((batch, size, size, 3), np.uint8)
    N = anchors.shape[0]
    cls = np.zeros((batch, N), np.int32)
    deltas = np.zeros((batch, N, 4), np.float32)
    for b in range(batch):
        frames[b], gt = renderer(rng, size)
        cls[b], deltas[b] = match_anchors(anchors, gt)
    return frames, cls, deltas


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def adam_loop(model: nn.Module, loss_fn: Callable, batch_fn: Callable,
              steps: int, log_every: int, name: str):
    """Adam at 1e-3 on `model` for `steps` steps, each on the numpy
    arrays batch_fn() returns, moved to the model's device and passed to
    loss_fn; returns (optimizer, final loss)."""
    from ..util.log import get_logger

    log = get_logger("train")
    dev = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = torch.tensor(float("nan"))
    for i in range(steps):
        args = [torch.from_numpy(a).to(dev) for a in batch_fn()]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(*args)
        loss.backward()
        opt.step()
        loss = loss.detach()
        if log_every and (i + 1) % log_every == 0:
            log.info("%s step %d/%d loss=%.5f", name, i + 1, steps,
                     float(loss))
    return opt, float(loss)


def detection_loss(logits, deltas, cls_t, box_t):
    """The SSD loss: softmax cross entropy over valid anchors with the
    rare positives weighted 10x, plus the Huber (delta 1) box loss over
    positives, each normalised by its weight."""
    valid = cls_t >= 0
    pos = cls_t == 1
    ce = F.cross_entropy(logits.transpose(1, 2), cls_t.clamp_min(0).long(),
                         reduction="none")
    w = torch.where(pos, 10.0, 1.0) * valid
    cls_loss = (ce * w).sum() / w.sum().clamp_min(1.0)
    hub = F.huber_loss(deltas, box_t, reduction="none", delta=1.0).sum(-1)
    box_loss = (hub * pos).sum() / pos.sum().clamp_min(1.0)
    return cls_loss + box_loss


def _initial_detector(seed: int, width: int, device: Any) -> nn.Module:
    """The model train_detector starts from (tests put the JAX package's
    initial parameters in its place)."""
    from ..engine.evaluate import resolve_device
    from .detection import SSDDetector
    from .nets import init_module_
    return init_module_(SSDDetector(num_classes=2, width=width),
                        seed).to(resolve_device(device))


def train_detector(checkpoint_dir: str, renderer: Callable = None,
                   steps: int = 300, batch: int = 4, size: int = SIZE,
                   width: int = WIDTH, seed: int = 0,
                   export_npz: Optional[str] = None,
                   log_every: int = 50, *, device: Any = "cuda") -> float:
    """Train SSDDetector on the synthetic scene task on `device` (the
    card unless the caller asks for the CPU); saves a checkpoint, and the
    `.npz` weight file when `export_npz` is given.  Returns the final
    loss."""
    from .checkpoint import TrainCheckpointer, export_params_npz
    from .detection import make_anchors

    renderer = renderer or render_rect_scene
    anchors = make_anchors(-(-size // 16), -(-size // 16))
    model = _initial_detector(seed, width, device)
    rng = np.random.RandomState(seed)
    opt, loss = adam_loop(
        model, lambda f, c, b: detection_loss(*model(f), c, b),
        lambda: detection_batch(rng, batch, anchors, renderer, size),
        steps, log_every, "detect_train")
    TrainCheckpointer(checkpoint_dir).save(steps, model, opt)
    if export_npz:
        export_params_npz(model, export_npz)
    return loss


class EmbeddingTraining(EmbeddingNet):
    """EmbeddingNet with the training-only identity classifier `w_cls`
    (dim, identities) on its normalised output.  The classifier has no
    flax counterpart (FLAX_PARAMS None): the `.npz` export leaves it out,
    and a FaceEmbedding restoring the checkpoint does not load it."""

    FLAX_PARAMS = {"w_cls": None}

    def __init__(self, dim: int, width: int, identities: int,
                 dtype=torch.bfloat16):
        super().__init__(dim=dim, width=width, dtype=dtype)
        self.w_cls = nn.Parameter(torch.zeros(dim, identities))


def _initial_embedding(seed: int, dim: int, width: int, identities: int,
                       device: Any) -> EmbeddingTraining:
    """The model train_embedding starts from: random weights from `seed`,
    and the classifier normal x 0.05 from a generator seeded by `seed`."""
    from ..engine.evaluate import resolve_device
    from .nets import init_module_
    model = init_module_(EmbeddingTraining(dim, width, identities), seed)
    with torch.no_grad():
        model.w_cls.normal_(0.0, 0.05,
                            generator=torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device))


def train_embedding(checkpoint_dir: str, steps: int = 300, batch: int = 16,
                    size: int = SIZE, width: int = WIDTH,
                    dim: int = EMBED_DIM,
                    identities: int = EMBED_IDENTITIES, seed: int = 0,
                    export_npz: Optional[str] = None,
                    log_every: int = 50, *, device: Any = "cuda") -> float:
    """Train EmbeddingNet by identity classification over procedural
    textures on `device`; the exported weights are the backbone and
    projection.  Returns the final loss."""
    from .checkpoint import TrainCheckpointer, export_params_npz

    model = _initial_embedding(seed, dim, width, identities, device)
    rng = np.random.RandomState(seed)

    def batch_fn():
        labels = rng.randint(0, identities, batch)
        frames = np.stack([render_identity(lab, rng, size)
                           for lab in labels])
        return frames, labels

    def loss_fn(frames, labels):
        logits = model(frames) @ model.w_cls * 10.0       # temperature
        return F.cross_entropy(logits, labels.long())

    opt, loss = adam_loop(model, loss_fn, batch_fn, steps, log_every,
                          "embed_train")
    TrainCheckpointer(checkpoint_dir).save(steps, model, opt)
    if export_npz:
        export_params_npz(model, export_npz)
    return loss


def main(argv: Optional[list] = None) -> None:
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--which", default="all",
                    choices=["all", "detect", "face", "embed"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_const", const="cpu",
                    dest="device", help="the same as --device cpu")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.which in ("all", "detect"):
        loss = train_detector(
            os.path.join(args.out_dir, "detect_ckpt"),
            render_rect_scene, steps=args.steps, seed=0,
            export_npz=os.path.join(args.out_dir,
                                    f"detect_ssd_w{WIDTH}.npz"),
            device=args.device)
        print(f"detect: final loss {loss:.5f}")
    if args.which in ("all", "face"):
        loss = train_detector(
            os.path.join(args.out_dir, "face_ckpt"),
            render_face_scene, steps=args.steps, seed=1,
            export_npz=os.path.join(args.out_dir,
                                    f"face_ssd_w{WIDTH}.npz"),
            device=args.device)
        print(f"face: final loss {loss:.5f}")
    if args.which in ("all", "embed"):
        loss = train_embedding(
            os.path.join(args.out_dir, "embed_ckpt"), steps=args.steps,
            seed=2,
            export_npz=os.path.join(args.out_dir, f"embed_w{WIDTH}.npz"),
            device=args.device)
        print(f"embed: final loss {loss:.5f}")


if __name__ == "__main__":
    main()
