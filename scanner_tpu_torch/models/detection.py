"""Single-shot object detection, on torch.

The counterpart of the JAX package's models/detection.py: an anchor-based
SSD head over the shared backbone, box decode, and a greedy NMS run as a
fixed number of vectorised steps over the batch (argmax, gather, IoU
mask), so a call has fixed shapes and never waits on the host.  The
engine op `ObjectDetect` serves the shipped weights at width 8.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from .convert import load_weights
from .infer import DataParallelApply
from .nets import Backbone, Conv

TOP_K = 32  # detections kept per frame (batched_nms steps)


def make_anchors(fh: int, fw: int, scales=(0.1, 0.25, 0.45),
                 ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """(fh*fw*A, 4) anchors as [cy, cx, h, w] in unit coords."""
    ys = (np.arange(fh) + 0.5) / fh
    xs = (np.arange(fw) + 0.5) / fw
    anchors = []
    for y in ys:
        for x in xs:
            for s in scales:
                for r in ratios:
                    anchors.append([y, x, s * np.sqrt(r), s / np.sqrt(r)])
    return np.asarray(anchors, np.float32)


class SSDHead(nn.Module):
    """(B, fh, fw, C) feature -> class logits (B, fh*fw*A, classes) and
    box deltas (B, fh*fw*A, 4), both float32: the two 3x3 convolutions
    run in float32 over the feature cast up, as flax's dtype=float32
    convolutions do."""

    def __init__(self, cin: int, num_classes: int = 2,
                 anchors_per_cell: int = 9):
        super().__init__()
        self.num_classes, self.A = num_classes, anchors_per_cell
        self.cls = Conv(cin, anchors_per_cell * num_classes, 3, 1,
                        torch.float32)
        self.box = Conv(cin, anchors_per_cell * 4, 3, 1, torch.float32)

    def forward(self, feat):
        x = feat.permute(0, 3, 1, 2)
        cls = self.cls(x).permute(0, 2, 3, 1)
        box = self.box(x).permute(0, 2, 3, 1)
        B, fh, fw, _ = cls.shape
        return (cls.reshape(B, fh * fw * self.A, self.num_classes),
                box.reshape(B, fh * fw * self.A, 4))


class SSDDetector(nn.Module):
    """(B, H, W, 3) uint8 -> (class logits, box deltas) per anchor."""

    def __init__(self, num_classes: int = 2, width: int = 32,
                 dtype=torch.bfloat16):
        super().__init__()
        self.Backbone_0 = Backbone(width=width, dtype=dtype)
        self.SSDHead_0 = SSDHead(self.Backbone_0.out_ch, num_classes)

    def forward(self, images):
        return self.SSDHead_0(self.Backbone_0(images))


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor
                 ) -> torch.Tensor:
    """Standard SSD box decode -> [y1, x1, y2, x2] unit coords, clipped to
    the image (downstream crops must never sample fully out of frame)."""
    cy = anchors[:, 0] + deltas[..., 0] * anchors[:, 2]
    cx = anchors[:, 1] + deltas[..., 1] * anchors[:, 3]
    h = anchors[:, 2] * torch.exp(torch.clamp(deltas[..., 2], -4, 4))
    w = anchors[:, 3] * torch.exp(torch.clamp(deltas[..., 3], -4, 4))
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                        dim=-1)
    return torch.clamp(boxes, 0.0, 1.0)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                top_k: int = TOP_K, iou_thresh: float = 0.5):
    """Greedy NMS with a fixed step count over (B, N, 4) boxes and (B, N)
    scores: each step takes every image's best remaining box (the first
    on ties, as jnp.argmax), records it, and knocks out the boxes that
    overlap it by more than `iou_thresh`.  Returns (idx (B, top_k)
    int64, scores (B, top_k) float32); a step that finds no positive
    score records -1 and 0.  No step reads a value on the host."""
    B = scores.shape[0]
    rows = torch.arange(B, device=scores.device)
    # one contiguous (B, N) plane per coordinate: every step reads them
    by1, bx1, by2, bx2 = (boxes[..., c].contiguous() for c in range(4))
    area = torch.clamp_min(by2 - by1, 0) * torch.clamp_min(bx2 - bx1, 0)
    sc = scores
    sel_idx, sel_sc = [], []
    for _ in range(top_k):
        j = torch.argmax(sc, dim=1)
        best = sc[rows, j]
        sel_idx.append(torch.where(best > 0, j, -1))
        sel_sc.append(torch.clamp_min(best, 0))
        y1 = torch.maximum(by1[rows, j][:, None], by1)
        x1 = torch.maximum(bx1[rows, j][:, None], bx1)
        y2 = torch.minimum(by2[rows, j][:, None], by2)
        x2 = torch.minimum(bx2[rows, j][:, None], bx2)
        inter = torch.clamp_min(y2 - y1, 0) * torch.clamp_min(x2 - x1, 0)
        iou = inter / torch.clamp_min(area[rows, j][:, None] + area - inter,
                                      1e-9)
        sc = torch.where(iou > iou_thresh, -1.0, sc)
        sc = sc.index_put((rows, j), torch.full_like(best, -1.0))
    return torch.stack(sel_idx, dim=1), torch.stack(sel_sc, dim=1)


def pack_detections(cls, deltas, anchors, score_thresh: float,
                    top_k: int = TOP_K):
    """The shared post-head decode contract: class logits + box deltas ->
    packed (B, top_k, 6) rows [y1, x1, y2, x2, score, valid] plus the
    selected boxes (B, top_k, 4).  ObjectDetect, FaceDetect and
    InstanceSegment all pack through here."""
    probs = torch.softmax(cls, dim=-1)[..., 1:]   # drop background
    scores = probs.max(dim=-1).values
    boxes = decode_boxes(anchors, deltas)
    idx, ssc = batched_nms(boxes, scores, top_k=top_k)
    sel = torch.gather(boxes, 1,
                       idx.clamp_min(0)[..., None].expand(-1, -1, 4))
    valid = ((idx >= 0) & (ssc > score_thresh)).to(torch.float32)
    packed = torch.cat([sel, ssc[..., None], valid[..., None]], dim=-1)
    return packed, sel


def unpack_detections(row) -> Dict[str, np.ndarray]:
    """Unpack one stored ObjectDetect/FaceDetect row — a (top_k, 6) array
    [y1, x1, y2, x2, score, valid] — into the classic
    {"boxes": (n, 4), "scores": (n,)} dict, dropping padding rows.
    Rows from tables written before the packed format (per-row dicts)
    pass through unchanged."""
    if isinstance(row, dict):
        return {"boxes": np.asarray(row["boxes"], np.float32),
                "scores": np.asarray(row["scores"], np.float32)}
    a = np.asarray(row, np.float32)
    keep = a[:, 5] > 0.5
    return {"boxes": a[keep, :4], "scores": a[keep, 4]}


def feature_grid(images) -> tuple:
    """The (fh, fw) anchor grid of (B, H, W, 3) frames: the SAME-padded
    stride-16 backbone's ceil-divided feature map."""
    return -(-images.shape[1] // 16), -(-images.shape[2] // 16)


class AnchoredModel(nn.Module):
    """A detector and its anchors, one grid per frame geometry, kept on
    the detector's device: (B, H, W, 3) uint8 -> packed rows."""

    def __init__(self, net: nn.Module, score_thresh: float):
        super().__init__()
        self.net, self.score_thresh = net, float(score_thresh)
        self._anchors = {}

    def anchors(self, images) -> torch.Tensor:
        key = feature_grid(images) + (images.device,)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(
                make_anchors(*key[:2])).to(images.device)
        return self._anchors[key]

    def forward(self, images):
        cls, deltas = self.net(images)
        return pack_detections(cls, deltas, self.anchors(images),
                               self.score_thresh)[0]


@register_op(device=DeviceType.TPU, batch=8)
class ObjectDetect(Kernel):
    """Per-frame object detections as packed (top_k, 6) rows
    [y1, x1, y2, x2, score, valid] in unit coordinates — decode with
    `unpack_detections` — on the device the engine gives this kernel.

    With no `checkpoint_dir`, width-8 instances load the shipped
    synthetic-task weights (scanner_tpu/models/weights/detect_ssd_w8.npz);
    `pretrained=False` or another width starts from random weights made
    from `seed`."""

    _shipped = "detect_ssd_w8.npz"
    _shipped_width = 8

    def __init__(self, config, width: int = 32, num_classes: int = 2,
                 score_thresh: float = 0.05, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 pretrained: bool = True):
        super().__init__(config)
        net = SSDDetector(num_classes=num_classes, width=width)
        shipped = self._shipped if (pretrained and num_classes == 2 and
                                    width == self._shipped_width) else None
        load_weights(net, shipped, checkpoint_dir, seed, type(self).__name__)
        self._dp = DataParallelApply(AnchoredModel(net, score_thresh),
                                     config.devices)

    def infer_cost_flops(self, batch):
        """FLOPs of one inference call on `batch` (the MFU probe,
        DataParallelApply.cost_flops); None when none are counted."""
        return self._dp.cost_flops(batch)

    def execute(self, frame: Sequence[FrameType]) -> Sequence[Any]:
        """(B, top_k, 6) float32 per batch: a tensor left on the card
        when the frames came as a CUDA tensor (the sink fetches once per
        task), a numpy array when they came from the host."""
        return self._dp(frame)
