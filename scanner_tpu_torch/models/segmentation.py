"""Instance segmentation: detection + per-instance masks, on torch.

The counterpart of the JAX package's models/segmentation.py, with its
fixed shapes end to end: detection keeps the packed (top_k, 6) rows of
ObjectDetect, masks are a fixed (top_k, M, M) grid per frame (padding
instances carry valid = 0), ROI align is a bilinear gather over a
fixed-size grid, and masks read a stride-2 trunk of their own.  The whole
forward (backbone -> head -> decode -> NMS -> ROI align -> mask head)
runs on the kernel's device; rows stay there until the sink fetches
them once per task.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from .convert import load_weights
from .detection import AnchoredModel, SSDHead, pack_detections
from .infer import DataParallelApply
from .nets import Backbone, Conv, ConvTranspose, GroupNorm

ROI_SIZE = 8          # roi-align grid (mask head upsamples 2x)
MASK_SIZE = 2 * ROI_SIZE
TOP_K = 8             # fixed instance budget per frame


def roi_align(feat: torch.Tensor, boxes: torch.Tensor,
              out_size: int) -> torch.Tensor:
    """Bilinear ROI align with fixed shapes.

    feat (B, fh, fw, C) float; boxes (B, K, 4) unit-coordinate corners
    [y1, x1, y2, x2] -> (B, K, S, S, C).  Each output cell samples the
    feature map at its roi-grid centre from 4 clamped corners; each
    corner is clamped from the unclipped floor, so a sample out of range
    takes the edge value instead of extrapolating inward."""
    B, fh, fw, _ = feat.shape
    S = out_size
    cell = (torch.arange(S, dtype=torch.float32, device=feat.device)
            + 0.5) / S
    ys = boxes[..., 0:1] + (boxes[..., 2:3] - boxes[..., 0:1]) * cell
    xs = boxes[..., 1:2] + (boxes[..., 3:4] - boxes[..., 1:2]) * cell
    fy = ys * fh - 0.5                                # (B, K, S)
    fx = xs * fw - 0.5
    yf, xf = torch.floor(fy), torch.floor(fx)
    wy = (fy - yf)[..., :, None, None]
    wx = (fx - xf)[..., None, :, None]
    yi, xi = yf.to(torch.int64), xf.to(torch.int64)
    y0, y1 = yi.clamp(0, fh - 1), (yi + 1).clamp(0, fh - 1)
    x0, x1 = xi.clamp(0, fw - 1), (xi + 1).clamp(0, fw - 1)
    b = torch.arange(B, device=feat.device)[:, None, None, None]

    def at(y, x):                                      # (B, K, S, S, C)
        return feat[b, y[..., :, None], x[..., None, :]]
    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


class MaskTrunk(nn.Module):
    """Stride-2 mask features: (B, H, W, 3) uint8 -> (B, H/2, W/2, width)
    in `dtype` (a 16 px object still spans 8 mask-feature cells)."""

    def __init__(self, width: int = 32, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        groups = min(8, width)
        self.Conv_0 = Conv(3, width, 5, 2, dtype)
        self.GroupNorm_0 = GroupNorm(width, groups, dtype)
        self.Conv_1 = Conv(width, width, 3, 1, dtype)
        self.GroupNorm_1 = GroupNorm(width, groups, dtype)
        self.Conv_2 = Conv(width, width, 3, 1, dtype)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).to(self.dtype) / 255.0
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        x = F.relu(self.GroupNorm_1(self.Conv_1(x)))
        return F.relu(self.Conv_2(x)).permute(0, 2, 3, 1)


class MaskHead(nn.Module):
    """(..., S, S, C) roi features -> (..., 2S, 2S) float32 mask logits."""

    def __init__(self, cin: int, width: int = 32, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(cin, 2 * width, 3, 1, dtype)
        self.Conv_1 = Conv(2 * width, 2 * width, 3, 1, dtype)
        self.ConvTranspose_0 = ConvTranspose(2 * width, width, 2, 2, dtype)
        self.Conv_2 = Conv(width, 1, 1, 1, torch.float32)

    def forward(self, roi_feat):
        lead, (S, _, C) = roi_feat.shape[:-3], roi_feat.shape[-3:]
        h = roi_feat.reshape(-1, S, S, C).permute(0, 3, 1, 2)
        h = F.relu(self.Conv_0(h.to(self.dtype)))
        h = F.relu(self.Conv_1(h))
        h = F.relu(self.ConvTranspose_0(h))
        out = self.Conv_2(h)[:, 0]
        return out.reshape(tuple(lead) + tuple(out.shape[1:]))


class InstanceSegmentor(nn.Module):
    """SSD detection + per-roi mask prediction over shared inputs.  The
    submodules carry the names of the flax module's setup()."""

    def __init__(self, num_classes: int = 2, width: int = 32,
                 roi_size: int = ROI_SIZE, dtype=torch.bfloat16):
        super().__init__()
        self.roi_size = roi_size
        self.backbone = Backbone(width=width, dtype=dtype)
        self.det_head = SSDHead(self.backbone.out_ch, num_classes)
        self.mask_trunk = MaskTrunk(width=width, dtype=dtype)
        self.mask_head = MaskHead(width, width=width, dtype=dtype)

    def detect(self, images):
        return self.det_head(self.backbone(images))

    def roi_masks(self, images, rois):
        """rois (B, K, 4) unit corners -> (B, K, 2*roi_size, 2*roi_size)
        mask logits."""
        mf = self.mask_trunk(images).to(torch.float32)
        return self.mask_head(roi_align(mf, rois, self.roi_size))

    def forward(self, images, rois=None):
        if rois is None:
            rois = torch.zeros((images.shape[0], TOP_K, 4),
                               device=images.device)
        cls, deltas = self.detect(images)
        return cls, deltas, self.roi_masks(images, rois)


class SegmentRows(AnchoredModel):
    """InstanceSegmentor -> packed (B, TOP_K, 6 + M*M) rows: detections,
    then the sigmoid mask grid of each selected box."""

    def forward(self, images):
        cls, deltas = self.net.detect(images)
        packed, sel = pack_detections(cls, deltas, self.anchors(images),
                                      self.score_thresh, top_k=TOP_K)
        mask_p = torch.sigmoid(self.net.roi_masks(images, sel))
        B = sel.shape[0]
        return torch.cat(
            [packed, mask_p.reshape(B, TOP_K, MASK_SIZE * MASK_SIZE)],
            dim=-1)


def unpack_instances(row, mask_thresh: float = 0.5,
                     mask_size: int = MASK_SIZE) -> Dict[str, np.ndarray]:
    """Unpack one stored InstanceSegment row — a (top_k, 6 + M*M) array
    [y1, x1, y2, x2, score, valid, mask probs…] — into
    {"boxes": (n, 4), "scores": (n,), "masks": (n, M, M) bool},
    dropping padding instances."""
    a = np.asarray(row, np.float32)
    keep = a[:, 5] > 0.5
    a = a[keep]
    masks = a[:, 6:].reshape(-1, mask_size, mask_size) > mask_thresh
    return {"boxes": a[:, :4], "scores": a[:, 4], "masks": masks}


def paste_masks(boxes: np.ndarray, masks: np.ndarray, height: int,
                width: int) -> np.ndarray:
    """Paste per-roi boolean masks (n, M, M) into full-frame boolean masks
    (n, H, W) by nearest-neighbour resampling inside each box (host-side
    numpy)."""
    n = len(boxes)
    M = masks.shape[1] if n else 0
    out = np.zeros((n, height, width), bool)
    for i in range(n):
        y1, x1, y2, x2 = boxes[i]
        py1 = int(np.clip(round(y1 * height), 0, height - 1))
        px1 = int(np.clip(round(x1 * width), 0, width - 1))
        py2 = int(np.clip(round(y2 * height), py1 + 1, height))
        px2 = int(np.clip(round(x2 * width), px1 + 1, width))
        h, w = py2 - py1, px2 - px1
        yy = np.clip(((np.arange(h) + 0.5) * M / h - 0.5).round(),
                     0, M - 1).astype(int)
        xx = np.clip(((np.arange(w) + 0.5) * M / w - 0.5).round(),
                     0, M - 1).astype(int)
        out[i, py1:py2, px1:px2] = masks[i][yy[:, None], xx[None, :]]
    return out


@register_op(device=DeviceType.TPU, batch=4)
class InstanceSegment(Kernel):
    """Per-frame instance segmentation as packed (top_k, 6 + M*M) rows —
    [y1, x1, y2, x2, score, valid] + an M×M mask probability grid per
    instance, unit coordinates — decode with `unpack_instances` /
    `paste_masks`.

    With no `checkpoint_dir`, width-8 instances load the shipped
    synthetic-shape-task weights (scanner_tpu/models/weights/seg_w8.npz);
    `pretrained=False` or another width starts from random weights made
    from `seed`."""

    _shipped = "seg_w8.npz"
    _shipped_width = 8

    def __init__(self, config, width: int = 32, num_classes: int = 2,
                 score_thresh: float = 0.05, seed: int = 3,
                 checkpoint_dir: Optional[str] = None,
                 pretrained: bool = True):
        super().__init__(config)
        net = InstanceSegmentor(num_classes=num_classes, width=width)
        shipped = self._shipped if (pretrained and num_classes == 2 and
                                    width == self._shipped_width) else None
        load_weights(net, shipped, checkpoint_dir, seed, "InstanceSegment")
        self._dp = DataParallelApply(SegmentRows(net, score_thresh),
                                     config.devices)

    def infer_cost_flops(self, batch):
        """FLOPs of one inference call on `batch` (the MFU probe,
        DataParallelApply.cost_flops); None when none are counted."""
        return self._dp.cost_flops(batch)

    def execute(self, frame: Sequence[FrameType]) -> Sequence[Any]:
        """(B, top_k, 6 + M*M) float32 per batch: a tensor left on the
        card for frames that came as a CUDA tensor, numpy for frames from
        the host."""
        return self._dp(frame)
