"""Train VideoPoseNet on the synthetic keypoint task.

The counterpart of the JAX package's models/pose_train.py: clips of a
bright blob moving on a straight line through noise, with a Gaussian
heatmap target on keypoint 0.  The shipped weights
(`scanner_tpu/models/weights/pose_blobnet_w8.npz`) were trained on this
task.  `train_pose()` is the library entry; the mp4 helper and orbax
checkpoints are not ported.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .pose import NUM_KEYPOINTS, VideoPoseNet, init_params, make_train_step

# default synthetic-task geometry (kernel/test/example all share it)
SIZE = 48
WIDTH = 8


def render_blob_frame(h: int, w: int, cx: float, cy: float,
                      rng: np.random.RandomState,
                      radius: float = 4.0) -> np.ndarray:
    """Noisy dark frame with a bright Gaussian blob at (cx, cy)."""
    ys, xs = np.mgrid[0:h, 0:w]
    blob = np.exp(-(((xs - cx) ** 2 + (ys - cy) ** 2)
                    / (2.0 * radius ** 2)))
    base = rng.randint(0, 40, (h, w, 3)).astype(np.float32)
    frame = base + 215.0 * blob[..., None]
    return np.clip(frame, 0, 255).astype(np.uint8)


def heatmap_target(h: int, w: int, cx: float, cy: float,
                   sigma: float = 1.5) -> np.ndarray:
    """(h, w, K) target: keypoint 0 gets a Gaussian at (cx, cy) in
    heatmap coords; the remaining keypoints are empty."""
    ys, xs = np.mgrid[0:h, 0:w]
    g = np.exp(-(((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * sigma ** 2)))
    out = np.zeros((h, w, NUM_KEYPOINTS), np.float32)
    out[..., 0] = g
    return out


def synth_batch(rng: np.random.RandomState, batch: int, time: int,
                size: int = SIZE) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Clips with a blob moving on a straight line; returns
    (clips (B,T,H,W,3) uint8, targets (B,T,H/4,W/4,K) f32,
    centers (B,T,2) [cx, cy] in frame coords)."""
    hm = size // 4
    clips = np.zeros((batch, time, size, size, 3), np.uint8)
    targets = np.zeros((batch, time, hm, hm, NUM_KEYPOINTS), np.float32)
    centers = np.zeros((batch, time, 2), np.float32)
    margin = 8
    for b in range(batch):
        x0, y0 = rng.uniform(margin, size - margin, 2)
        ang = rng.uniform(0, 2 * math.pi)
        step = rng.uniform(0.5, 2.5)
        for t in range(time):
            cx = float(np.clip(x0 + t * step * math.cos(ang),
                               margin / 2, size - margin / 2))
            cy = float(np.clip(y0 + t * step * math.sin(ang),
                               margin / 2, size - margin / 2))
            clips[b, t] = render_blob_frame(size, size, cx, cy, rng)
            targets[b, t] = heatmap_target(hm, hm, cx / 4.0, cy / 4.0)
            centers[b, t] = (cx, cy)
    return clips, targets, centers


def train_pose(steps: int = 300, batch: int = 4, time: int = 2,
               size: int = SIZE, width: int = WIDTH, seed: int = 0,
               log_every: int = 50, attn_fn: Optional[Callable] = None,
               device: Any = "cuda") -> Tuple[VideoPoseNet, float]:
    """Train on the synthetic task on `device` (the card unless the
    caller asks for the CPU), with the temporal blocks' attention
    `attn_fn` (None: plain exact attention; a ring from
    parallel.make_ring_attention runs the flash kernel); returns
    (model, final loss)."""
    from ..util.log import get_logger

    log = get_logger("train")
    model = init_params(seed, device=device, width=width, attn_fn=attn_fn)
    dev = next(model.parameters()).device
    _, step_fn = make_train_step(model)
    rng = np.random.RandomState(seed)
    loss = float("nan")
    for i in range(steps):
        clips, targets, _ = synth_batch(rng, batch, time, size)
        loss = float(step_fn(torch.from_numpy(clips).to(dev),
                             torch.from_numpy(targets).to(dev)))
        if log_every and (i + 1) % log_every == 0:
            log.info("pose_train step %d/%d loss=%.5f", i + 1, steps, loss)
    return model, loss
