"""Plain reference for OpenPose, the COCO body model with six stages.

Cao, Simon, Wei, Sheikh, "Realtime Multi-Person 2D Pose Estimation using
Part Affinity Fields", CVPR 2017 (arXiv:1611.08050); the network of
`models/pose/coco/pose_deploy_linevec.prototxt` in
github.com/CMU-Perceptual-Computing-Lab/openpose.  Plain torch in
float32, TF32 off, weights in a dict keyed by the caffemodel's layer
names (`conv1_1/weight`, `conv1_1/bias`, ...); no batching beyond what
the caller passes, no cache.  Not a test module; imports nothing of the
program.

  prep     (B, H, W, 3) uint8 RGB -> BGR, scaled to 368 rows by area
           interpolation, width round(W * 368 / H) padded on the right
           with zero pixels to a multiple of 16, x / 256 - 0.5.
  network  VGG-19 front (conv1_1 .. conv4_2, 2x2 max pools after
           conv1_2, conv2_2, conv3_4), conv4_3_CPM, conv4_4_CPM -> F;
           stage 1: per branch three 3x3 convs, a 1x1 to 512, a 1x1 to C
           (38 PAF channels for L1, 19 heatmaps for L2); stages 2-6 on
           concat(L1, L2, F): 7x7 convs Mconv1-5, 1x1 Mconv6, 1x1 Mconv7
           to C.  Every conv has a bias and a ReLU, except each branch's
           last.
  post     the last stage's maps upsampled 8x (bicubic, half-pixel
           centres) to the net resolution; peaks: above 0.05 and strictly
           above all 8 neighbours; the 16 best per part; for each of the
           19 limbs and each pair of its parts' peaks, the mean over 10
           evenly spaced points (rounded to the nearest pixel) of the
           PAF's dot product with the unit vector between the peaks.
  people   the paper's greedy assembly (`assemble_people`).

Departures from the published description, each also made by the
program:
- weights made from a seed, not the trained caffemodel: He-normal for
  every conv with a ReLU, zero biases; each branch's last conv drawn so
  that heatmaps spread about 0.25 and PAFs about 0, as a trained
  model's maps lie in about [0, 1] and [-1, 1];
- the input is scaled with `F.interpolate(mode="area")` (each output
  pixel the mean of its window) where OpenPose warps with OpenCV's
  INTER_AREA, and the pad is zero pixels (-0.5 after normalising);
- peaks are integer pixel positions of the upsampled heatmap, with no
  sub-pixel refinement, and at most 16 a part (OpenPose keeps up to
  127);
- a limb's score is the plain mean of the 10 samples: OpenPose's
  further test that 80 % of the samples exceed 0.05 is left out, since
  the rows carry only the mean; the assembly keeps the distance prior
  (score + min(0.5 H / length - 1, 0) > 0);
- one scale (OpenPose's default --scale_number 1).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NET_H = 368
MULT = 16
STRIDE = 8
PARTS = 18
HEAT = 19
PAF = 38
K = 16
THRESH = 0.05
SAMPLES = 10
LIMBS = ((1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
         (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
         (0, 15), (15, 17), (2, 16), (5, 17))
# each limb's PAF (x, y) channels: OpenPose's map indices less 19
PAF_XY = ((12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25),
          (0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29),
          (30, 31), (34, 35), (32, 33), (36, 37), (18, 19), (26, 27))
ROW = PARTS * K * 4 + len(LIMBS) * K * K
WIDTHS = {"conv1": 64, "conv2": 128, "conv3": 256, "conv4": 512,
          "cpm": 256, "features": 128, "stage1": 128,
          "stage1_hidden": 512, "stage": 128, "stages": 6}
POOL_AFTER = ("conv1_2", "conv2_2", "conv3_4")


def layers(widths: Optional[Dict[str, int]] = None
           ) -> List[Tuple[str, int, int, int, bool]]:
    """(name, in, out, kernel, relu) of each conv in running order."""
    w = dict(WIDTHS, **(widths or {}))
    out = [("conv1_1", 3, w["conv1"], 3, True),
           ("conv1_2", w["conv1"], w["conv1"], 3, True),
           ("conv2_1", w["conv1"], w["conv2"], 3, True),
           ("conv2_2", w["conv2"], w["conv2"], 3, True),
           ("conv3_1", w["conv2"], w["conv3"], 3, True),
           ("conv3_2", w["conv3"], w["conv3"], 3, True),
           ("conv3_3", w["conv3"], w["conv3"], 3, True),
           ("conv3_4", w["conv3"], w["conv3"], 3, True),
           ("conv4_1", w["conv3"], w["conv4"], 3, True),
           ("conv4_2", w["conv4"], w["conv4"], 3, True),
           ("conv4_3_CPM", w["conv4"], w["cpm"], 3, True),
           ("conv4_4_CPM", w["cpm"], w["features"], 3, True)]
    for b, c in ((1, PAF), (2, HEAT)):
        out += [(f"conv5_1_CPM_L{b}", w["features"], w["stage1"], 3, True),
                (f"conv5_2_CPM_L{b}", w["stage1"], w["stage1"], 3, True),
                (f"conv5_3_CPM_L{b}", w["stage1"], w["stage1"], 3, True),
                (f"conv5_4_CPM_L{b}", w["stage1"], w["stage1_hidden"], 1,
                 True),
                (f"conv5_5_CPM_L{b}", w["stage1_hidden"], c, 1, False)]
    for t in range(2, w["stages"] + 1):
        for b, c in ((1, PAF), (2, HEAT)):
            s = w["stage"]
            out += [(f"Mconv1_stage{t}_L{b}", PAF + HEAT + w["features"], s,
                     7, True),
                    (f"Mconv2_stage{t}_L{b}", s, s, 7, True),
                    (f"Mconv3_stage{t}_L{b}", s, s, 7, True),
                    (f"Mconv4_stage{t}_L{b}", s, s, 7, True),
                    (f"Mconv5_stage{t}_L{b}", s, s, 7, True),
                    (f"Mconv6_stage{t}_L{b}", s, s, 1, True),
                    (f"Mconv7_stage{t}_L{b}", s, c, 1, False)]
    return out


def init_weights(seed: int, widths: Optional[Dict[str, int]] = None,
                 device="cpu") -> Dict[str, torch.Tensor]:
    """Float32 weights made from `seed` on `device` (see the module's
    departures)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, cin, cout, k, relu in layers(widths):
        fan_in = cin * k * k
        if relu:
            std = math.sqrt(2.0 / fan_in)
        else:
            std = (0.2 if name.endswith("_L1") else 0.1) / math.sqrt(
                fan_in * 0.05)
        out[name + "/weight"] = torch.randn(
            (cout, cin, k, k), generator=gen, device=device) * std
        out[name + "/bias"] = torch.full(
            (cout,), 0.25 if not relu and name.endswith("_L2") else 0.0,
            device=device)
    return out


def widths_of(weights: Dict[str, torch.Tensor]) -> Dict[str, int]:
    def out(name):
        return int(weights[name + "/weight"].shape[0])
    stages = 1
    while f"Mconv1_stage{stages + 1}_L1/weight" in weights:
        stages += 1
    return {"conv1": out("conv1_1"), "conv2": out("conv2_1"),
            "conv3": out("conv3_1"), "conv4": out("conv4_1"),
            "cpm": out("conv4_3_CPM"), "features": out("conv4_4_CPM"),
            "stage1": out("conv5_1_CPM_L1"),
            "stage1_hidden": out("conv5_4_CPM_L1"), "stages": stages,
            "stage": out("Mconv1_stage2_L1") if stages > 1 else 128}


def prep(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> (B, 3, 368, net width) float32 BGR."""
    _, h, w, _ = frames.shape
    sw = max(1, int(round(w * NET_H / h)))
    nw = MULT * -(-sw // MULT)
    x = frames.permute(0, 3, 1, 2).flip(1).float()
    x = F.interpolate(x, size=(NET_H, sw), mode="area")
    return F.pad(x, (0, nw - sw)) / 256.0 - 0.5


def network(weights: Dict[str, torch.Tensor], x: torch.Tensor,
            rnd: Optional[Callable] = None):
    """Net input -> (L1, L2) of the last stage, float32; `rnd`, when
    given, rounds the input, every weight and every layer's output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rnd = rnd or (lambda t: t)
    specs = {s[0]: s for s in layers(widths_of(weights))}

    def conv(name, t):
        _, _, _, k, relu = specs[name]
        t = F.conv2d(t, rnd(weights[name + "/weight"]),
                     rnd(weights[name + "/bias"]), padding=k // 2)
        if relu:
            t = F.relu(t)
        if name in POOL_AFTER:
            t = F.max_pool2d(t, 2, 2, ceil_mode=True)
        return rnd(t)

    t = rnd(x)
    for name in ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1",
                 "conv3_2", "conv3_3", "conv3_4", "conv4_1", "conv4_2",
                 "conv4_3_CPM", "conv4_4_CPM"):
        t = conv(name, t)
    feats = t
    l1, l2 = feats, feats
    for i in range(1, 6):
        l1 = conv(f"conv5_{i}_CPM_L1", l1)
        l2 = conv(f"conv5_{i}_CPM_L2", l2)
    for s in range(2, widths_of(weights)["stages"] + 1):
        inp = torch.cat([l1, l2, feats], dim=1)
        l1, l2 = inp, inp
        for i in range(1, 8):
            l1 = conv(f"Mconv{i}_stage{s}_L1", l1)
            l2 = conv(f"Mconv{i}_stage{s}_L2", l2)
    return l1, l2


def maps(weights, frames: torch.Tensor, rnd: Optional[Callable] = None):
    """Frames -> (heatmaps (B, 19, h, w), PAFs (B, 38, h, w)) upsampled to
    the net resolution, float32."""
    l1, l2 = network(weights, prep(frames), rnd)
    up = lambda m: F.interpolate(m, scale_factor=STRIDE, mode="bicubic",
                                 align_corners=False)
    return up(l2), up(l1)


def neighbours_max(heat: torch.Tensor) -> torch.Tensor:
    """Each pixel's largest of 8 neighbours; +inf on the border."""
    p = F.pad(heat, (1, 1, 1, 1), value=float("inf"))
    h, w = heat.shape[-2:]
    out = torch.full_like(heat, -float("inf"))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = torch.maximum(
                    out, p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out


def peaks(heat: torch.Tensor, k: int = K):
    """(B, 18+, h, w) -> (x, y, score, valid), each (B, 18, k), best
    first; an invalid slot scores -1."""
    hm = heat[:, :PARTS]
    w = hm.shape[-1]
    is_peak = (hm > THRESH) & (hm > neighbours_max(hm))
    score, idx = torch.where(is_peak, hm, -1.0).flatten(2).topk(k, dim=2)
    return idx % w, idx // w, score, score > THRESH


def line_integral(paf: torch.Tensor, limb: int, ax, ay, bx, by
                  ) -> torch.Tensor:
    """(38, h, w) PAFs of one frame; integer positions of a limb's two
    peaks, broadcastable -> the mean of the PAF . unit vector over the
    10 samples from A to B (0 where A and B coincide)."""
    h, w = paf.shape[-2:]
    ax, ay, bx, by = (torch.as_tensor(v, dtype=torch.float32,
                                      device=paf.device)
                      for v in (ax, ay, bx, by))
    dx, dy = bx - ax, by - ay
    norm = torch.sqrt(dx * dx + dy * dy)
    total = torch.zeros(torch.broadcast_shapes(ax.shape, bx.shape),
                        device=paf.device)
    cx, cy = PAF_XY[limb]
    for i in range(SAMPLES):
        sx = torch.round(ax + dx * i / (SAMPLES - 1)).clamp(0, w - 1).long()
        sy = torch.round(ay + dy * i / (SAMPLES - 1)).clamp(0, h - 1).long()
        total = total + (paf[cx][sy, sx] * dx + paf[cy][sy, sx] * dy) \
            / torch.where(norm > 1e-6, norm, torch.ones_like(norm))
    return torch.where(norm > 1e-6, total / SAMPLES, torch.zeros_like(total))


def rows_from_maps(heat: torch.Tensor, paf: torch.Tensor,
                   frame_h: int) -> np.ndarray:
    """Upsampled maps -> the packed rows: (18, 16, 4) [x, y, score,
    valid] in frame pixels, then (19, 16, 16) pair scores (0 unless both
    peaks are valid)."""
    x, y, score, valid = peaks(heat)
    back = frame_h / NET_H
    out = []
    for b in range(heat.shape[0]):
        pk = torch.stack([x[b].float() * back, y[b].float() * back,
                          torch.where(valid[b], score[b],
                                      torch.zeros_like(score[b])),
                          valid[b].float()], dim=-1)
        pairs = []
        for li, (pa, pb) in enumerate(LIMBS):
            s = line_integral(paf[b], li, x[b, pa][:, None], y[b, pa][:, None],
                              x[b, pb][None, :], y[b, pb][None, :])
            ok = valid[b, pa][:, None] & valid[b, pb][None, :]
            pairs.append(torch.where(ok, s, torch.zeros_like(s)))
        out.append(torch.cat([pk.reshape(-1),
                              torch.stack(pairs).reshape(-1)]))
    return torch.stack(out).cpu().numpy()


def rows(weights, frames: torch.Tensor, rnd: Optional[Callable] = None
         ) -> np.ndarray:
    """Frames -> packed rows (B, ROW) float32."""
    heat, paf = maps(weights, frames, rnd)
    return rows_from_maps(heat, paf, frames.shape[1])


def assemble_people(peaks_: np.ndarray, pairs: np.ndarray, frame_h: int
                    ) -> List[np.ndarray]:
    """The paper's greedy assembly (the original Caffe demo's loop) on
    one row's (18, 16, 4) peaks and (19, 16, 16) pair scores; each
    person as an (18, 3) [x, y, score] array, zeros for absent parts;
    people with fewer than 4 parts or a mean score under 0.4 dropped."""
    cand = peaks_.reshape(PARTS * K, 4)
    subset = np.zeros((0, PARTS + 2))
    for k, (pa, pb) in enumerate(LIMBS):
        va = [i for i in range(K) if peaks_[pa, i, 3] > 0.5]
        vb = [j for j in range(K) if peaks_[pb, j, 3] > 0.5]
        if not va or not vb:
            continue
        conn_cand = []
        for i in va:
            for j in vb:
                vec = peaks_[pb, j, :2] - peaks_[pa, i, :2]
                norm = math.sqrt(vec[0] ** 2 + vec[1] ** 2)
                if norm <= 1e-6:
                    continue
                s = pairs[k, i, j] + min(0.5 * frame_h / norm - 1, 0)
                if s > 0:
                    conn_cand.append((i, j, s))
        conn_cand.sort(key=lambda c: c[2], reverse=True)
        connection = []
        for i, j, s in conn_cand:
            if i not in [c[3] for c in connection] and \
                    j not in [c[4] for c in connection]:
                connection.append((pa * K + i, pb * K + j, s, i, j))
                if len(connection) >= min(len(va), len(vb)):
                    break
        for ca, cb, s, _, _ in connection:
            found = [r for r in range(len(subset))
                     if subset[r][pa] == ca + 1 or subset[r][pb] == cb + 1]
            if len(found) == 1 or (len(found) >= 2 and np.any(
                    (subset[found[0]][:PARTS] > 0)
                    & (subset[found[1]][:PARTS] > 0))):
                r = found[0]
                if subset[r][pb] != cb + 1 or len(found) >= 2:
                    subset[r][pb] = cb + 1
                    subset[r][-1] += 1
                    subset[r][-2] += cand[cb, 2] + s
            elif len(found) >= 2:
                r1, r2 = found[:2]
                subset[r1][:PARTS] += subset[r2][:PARTS]
                subset[r1][-2:] += subset[r2][-2:]
                subset[r1][-2] += s
                subset = np.delete(subset, r2, 0)
            elif k < len(LIMBS) - 2:
                row = np.zeros(PARTS + 2)
                row[pa], row[pb] = ca + 1, cb + 1
                row[-1] = 2
                row[-2] = cand[ca, 2] + cand[cb, 2] + s
                subset = np.vstack([subset, row])
    people = []
    for r in subset:
        if r[-1] < 4 or r[-2] / r[-1] < 0.4:
            continue
        person = np.zeros((PARTS, 3), np.float32)
        for p in range(PARTS):
            if r[p] > 0:
                person[p] = cand[int(r[p]) - 1, :3]
        people.append(person)
    return people
