"""Pose estimation: the flagship model family, on torch.

The counterpart of the JAX package's models/pose.py: per-frame conv
backbone -> temporal attention over the clip (ring attention through
`attn_fn`) -> MoE mixer -> FiLM -> deconv heatmap head, its Adam train
step, and the engine op `PoseDetect`.  Ported on one card: the sharded
dp/sp/tp train step, pipeline parallelism and remat are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from .convert import load_weights
from .infer import lowered_flops
from .nets import Backbone, DeconvHead, Dense, TemporalBlock, init_module_

NUM_KEYPOINTS = 17


class VideoPoseNet(nn.Module):
    """(B, T, H, W, 3) uint8 clip -> (B, T, H/4, W/4, K) float32
    heatmaps."""

    def __init__(self, width: int = 32, temporal_layers: int = 2,
                 keypoints: int = NUM_KEYPOINTS, dtype=torch.bfloat16,
                 attn_fn: Optional[Callable] = None):
        super().__init__()
        self.keypoints, self.temporal_layers = keypoints, temporal_layers
        self.Backbone_0 = Backbone(width=width, dtype=dtype)
        C = self.Backbone_0.out_ch
        for li in range(temporal_layers):
            setattr(self, f"TemporalBlock_{li}",
                    TemporalBlock(C, dtype=dtype, attn_fn=attn_fn))
        self.film = Dense(C, C, dtype)
        self.DeconvHead_0 = DeconvHead(C, keypoints, dtype)

    def forward(self, clip):
        B, T, H, W, _ = clip.shape
        feat = self.Backbone_0(clip.reshape(B * T, H, W, 3))
        _, fh, fw, C = feat.shape
        # clip-level context: GAP tokens mixed across time
        tokens = feat.mean(dim=(1, 2)).reshape(B, T, C)
        for li in range(self.temporal_layers):
            tokens = getattr(self, f"TemporalBlock_{li}")(tokens)
        # FiLM-style broadcast of temporal context back onto spatial maps
        scale = self.film(tokens)
        feat = feat.reshape(B, T, fh, fw, C) \
            * (1.0 + scale[:, :, None, None, :])
        heat = self.DeconvHead_0(feat.reshape(B * T, fh, fw, C))
        return heat.reshape(B, T, heat.shape[1], heat.shape[2],
                            self.keypoints)


def init_params(seed: int = 0, device: Any = "cuda",
                **kw) -> VideoPoseNet:
    """A VideoPoseNet with random weights from `seed`, on `device` (the
    card unless the caller asks for the CPU)."""
    from ..engine.evaluate import resolve_device
    model = init_module_(VideoPoseNet(**kw), seed)
    return model.to(resolve_device(device))


def make_train_step(model: VideoPoseNet, optimizer=None):
    """Adam at 1e-3 on the heatmaps' mean squared error; returns
    (optimizer, step) with step(clip, target) -> loss (a 0-d tensor)."""
    opt = optimizer or torch.optim.Adam(model.parameters(), lr=1e-3)

    def train_step(clip, target):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(clip) - target) ** 2)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, train_step


# ---------------------------------------------------------------------------
# Engine op
# ---------------------------------------------------------------------------

def heatmaps_to_keypoints(heat: np.ndarray) -> np.ndarray:
    """(h, w, K) heatmaps -> (K, 3) [x, y, score] in heatmap coords."""
    h, w, K = heat.shape
    flat = heat.reshape(-1, K)
    idx = flat.argmax(axis=0)
    scores = flat[idx, np.arange(K)]
    ys, xs = np.divmod(idx, w)
    return np.stack([xs, ys, scores], axis=1).astype(np.float32)


def apply_and_peaks(model: VideoPoseNet, clip: torch.Tensor) -> torch.Tensor:
    """Forward + argmax on the model's device: (B, 1, H, W, 3) uint8 ->
    (B, K, 3) [x, y, score] in heatmap coords, so only keypoints leave
    the card, not (B, h, w, K) heatmaps."""
    heat = model(clip)[:, 0]                              # (B, h, w, K)
    B, h, w, K = heat.shape
    flat = heat.reshape(B, h * w, K)
    idx = flat.argmax(dim=1)                              # (B, K)
    scores = torch.gather(flat, 1, idx[:, None, :])[:, 0, :]
    ys, xs = idx // w, idx % w
    return torch.stack([xs.float(), ys.float(), scores], dim=-1)


@register_op(device=DeviceType.TPU, batch=8)
class PoseDetect(Kernel):
    """Per-frame pose keypoints (reference pose_detection app op), on the
    device the engine gives this kernel (the client's card, or the CPU).

    With `checkpoint_dir=` an exported `.npz` weight file or a
    checkpoint directory of models/checkpoint.py (train_pose writes one)
    is loaded; with none, width 8 loads the shipped weights (pretrained=True) and other
    widths start from random weights made from `seed`."""

    _shipped = "pose_blobnet_w8.npz"
    _shipped_width = 8

    def __init__(self, config, width: int = 32, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 pretrained: bool = True):
        super().__init__(config)
        self.device = torch.device(config.devices[0]) if config.devices \
            else torch.device("cpu")
        self.model = VideoPoseNet(width=width)
        shipped = self._shipped if (pretrained and
                                    width == self._shipped_width) else None
        load_weights(self.model, shipped, checkpoint_dir, seed)
        self.model.to(self.device).eval()

    def infer_cost_flops(self, batch):
        """FLOPs of one inference call on `batch` (the MFU probe,
        infer.lowered_flops); None when none are counted."""
        if not isinstance(batch, (np.ndarray, torch.Tensor)):
            batch = np.stack(batch)
        x = torch.as_tensor(batch).to(self.device)
        return lowered_flops(apply_and_peaks, self.model, x[:, None])

    def execute(self, frame: Sequence[FrameType]) -> Sequence[Any]:
        """(B, K, 3) [x, y, score] per batch: a tensor left on the card
        when the frames came as a CUDA tensor (the sink fetches once per
        task), a numpy array when they came from the host."""
        on_host = not isinstance(frame, torch.Tensor)
        if not isinstance(frame, (np.ndarray, torch.Tensor)):
            frame = np.stack(frame)
        x = torch.as_tensor(frame).to(self.device)
        with torch.no_grad():
            kp = apply_and_peaks(self.model, x[:, None])
        return kp.cpu().numpy() if on_host else kp
