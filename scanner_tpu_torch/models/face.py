"""Face detection and embedding, on torch.

The counterpart of the JAX package's models/face.py: `FaceDetect` is the
SSD detector with face-tuned defaults and its own shipped weights;
`FaceEmbedding` maps crops to L2-normalised vectors through the shared
backbone and a projection.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from .convert import load_weights
from .detection import ObjectDetect
from .infer import DataParallelApply
from .nets import Backbone, Dense


@register_op(name="FaceDetect", device=DeviceType.TPU, batch=8)
class FaceDetect(ObjectDetect):
    """SSD detector with face-tuned defaults.  Width-8 instances load the
    shipped face-task weights (scanner_tpu/models/weights/face_ssd_w8.npz)
    unless a checkpoint is given or pretrained=False."""

    _shipped = "face_ssd_w8.npz"
    _shipped_width = 8

    def __init__(self, config, width: int = 32, score_thresh: float = 0.1,
                 seed: int = 1, checkpoint_dir: Optional[str] = None,
                 pretrained: bool = True):
        super().__init__(config, width=width, num_classes=2,
                         score_thresh=score_thresh, seed=seed,
                         checkpoint_dir=checkpoint_dir,
                         pretrained=pretrained)


class EmbeddingNet(nn.Module):
    """(B, H, W, 3) uint8 -> (B, dim) float32 unit vectors."""

    def __init__(self, dim: int = 128, width: int = 32,
                 dtype=torch.bfloat16):
        super().__init__()
        self.Backbone_0 = Backbone(width=width, dtype=dtype)
        self.Dense_0 = Dense(self.Backbone_0.out_ch, dim, torch.float32)

    def forward(self, images):
        feat = self.Backbone_0(images)
        # jnp.mean of a bf16 array sums in float32 and rounds the mean
        # back to bf16 before the float32 Dense casts it up
        pooled = feat.float().mean(dim=(1, 2)).to(feat.dtype)
        emb = self.Dense_0(pooled)
        # zero inputs (e.g. a crop that fell outside the frame) must yield
        # a zero vector, not 0/0 = NaN
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb / torch.clamp_min(norm, 1e-12)


@register_op(device=DeviceType.TPU, batch=16)
class FaceEmbedding(Kernel):
    """L2-normalised face/crop embedding vectors, (B, dim) float32 per
    batch.  Width-8/dim-128 instances load the shipped identity-metric
    weights (scanner_tpu/models/weights/embed_w8.npz) unless a checkpoint
    is given or pretrained=False."""

    _shipped = "embed_w8.npz"
    _shipped_width = 8

    def __init__(self, config, dim: int = 128, width: int = 32,
                 seed: int = 2, checkpoint_dir: Optional[str] = None,
                 pretrained: bool = True):
        super().__init__(config)
        net = EmbeddingNet(dim=dim, width=width)
        shipped = self._shipped if (pretrained and dim == 128 and
                                    width == self._shipped_width) else None
        load_weights(net, shipped, checkpoint_dir, seed)
        self._dp = DataParallelApply(net, config.devices)

    def infer_cost_flops(self, batch):
        """FLOPs of one inference call on `batch` (the MFU probe,
        DataParallelApply.cost_flops); None when none are counted."""
        return self._dp.cost_flops(batch)

    def execute(self, frame: Sequence[FrameType]) -> Sequence[Any]:
        """A tensor left on the card for frames that came as a CUDA
        tensor, a numpy array for frames from the host."""
        return self._dp(frame)
