"""Train VideoPoseNet on the synthetic keypoint task and save a
checkpoint.

The counterpart of the JAX package's models/pose_train.py: clips of a
bright blob moving on a straight line through noise, with a Gaussian
heatmap target on keypoint 0.  The shipped weights
(`scanner_tpu/models/weights/pose_blobnet_w8.npz`) were trained on this
task.  `train_pose()` is the library entry and saves through
models/checkpoint.py's TrainCheckpointer, which
`PoseDetect(checkpoint_dir=...)` restores;

    python -m scanner_tpu_torch.models.pose_train <ckpt_dir> [--device cpu]

trains the default configuration on the card.  `synth_blob_video`
encodes through libav, so it runs where libav is.
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


def synth_blob_video(path: str, num_frames: int = 24, size: int = SIZE,
                     fps: float = 24.0, seed: int = 7) -> np.ndarray:
    """Encode a blob-motion clip to mp4; returns (num_frames, 2) true
    centers.  The e2e counterpart of synth_batch: the same task the
    shipped weights were trained on, but through the video codec path."""
    from ..video.ingest import encode_frames_mp4

    rng = np.random.RandomState(seed)
    margin = 8
    x0, y0 = rng.uniform(margin, size - margin, 2)
    ang = rng.uniform(0, 2 * math.pi)
    step = rng.uniform(0.8, 1.6)
    centers = np.zeros((num_frames, 2), np.float32)
    frames = []
    for t in range(num_frames):
        cx = float(np.clip(x0 + t * step * math.cos(ang),
                           margin / 2, size - margin / 2))
        cy = float(np.clip(y0 + t * step * math.sin(ang),
                           margin / 2, size - margin / 2))
        centers[t] = (cx, cy)
        frames.append(render_blob_frame(size, size, cx, cy, rng))
    encode_frames_mp4(path, frames, size, size, fps=fps, keyint=8, crf=16)
    return centers


def _initial_state(seed: int, width: int, attn_fn: Optional[Callable],
                   device: Any) -> VideoPoseNet:
    """The model train_pose starts from (tests put the JAX package's
    initial parameters in its place)."""
    return init_params(seed, device=device, width=width, attn_fn=attn_fn)


def train_pose(checkpoint_dir: str, steps: int = 300, batch: int = 4,
               time: int = 2, size: int = SIZE, width: int = WIDTH,
               seed: int = 0, log_every: int = 50, *,
               attn_fn: Optional[Callable] = None,
               device: Any = "cuda") -> float:
    """Train on the synthetic task on `device` (the card unless the
    caller asks for the CPU) and save (steps, model, Adam) under
    `checkpoint_dir`; returns the final loss.  `attn_fn` is the temporal
    blocks' attention (None: plain exact attention; a ring from
    parallel.make_ring_attention(impl="cuda") runs the flash kernel)."""
    from ..util.log import get_logger
    from .checkpoint import TrainCheckpointer

    log = get_logger("train")
    model = _initial_state(seed, width, attn_fn, device)
    dev = next(model.parameters()).device
    opt, step_fn = make_train_step(model)
    rng = np.random.RandomState(seed)
    loss = float("nan")
    for i in range(steps):
        clips, targets, _ = synth_batch(rng, batch, time, size)
        loss = step_fn(torch.from_numpy(clips).to(dev),
                       torch.from_numpy(targets).to(dev))
        if log_every and (i + 1) % log_every == 0:
            log.info("pose_train step %d/%d loss=%.5f", i + 1, steps,
                     float(loss))
    TrainCheckpointer(checkpoint_dir).save(steps, model, opt)
    return float(loss)


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint_dir")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    loss = train_pose(args.checkpoint_dir, steps=args.steps,
                      width=args.width, size=args.size, device=args.device)
    print(f"trained {args.steps} steps, final loss {loss:.5f}, "
          f"checkpoint at {args.checkpoint_dir}")


if __name__ == "__main__":
    main()
