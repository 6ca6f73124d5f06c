"""Plain reference for `openpose_coco_640x480` (BASELINE.md config 3:
the upstream pose_detection app's OpenPose over every frame): a copy of
the program's plain reference for OpenPose, COCO body, 6 stages
(Cao et al., CVPR 2017; the network of openpose's
models/pose/coco/pose_deploy_linevec.prototxt), in plain torch and
float32 with TF32 off.  Imports nothing of the program.

  prep     (B, H, W, 3) uint8 RGB -> BGR, scaled to 368 rows by area
           interpolation, width round(W * 368 / H) padded on the right
           with zero pixels to a multiple of 16, x / 256 - 0.5.
  network  the VGG-19 front, conv4_3_CPM, conv4_4_CPM -> F; stage 1's
           two branches on F; stages 2-6 on concat(L1, L2, F).
  post     maps upsampled 8x (bicubic); peaks above 0.05 and strictly
           above their 8 neighbours, the 16 best per part; per limb the
           16 x 16 pairs' mean of PAF . unit vector over 10 samples.
Departures from the published description (each made by the program
too): seeded weights; area interpolation for the input; integer peak
positions; 16 peaks a part; a limb's score the plain mean of its
samples; one scale.  The people assembly is neither timed nor compared.

What is compared: every row every job of the window stored, against the
reference's maps of the same frame (computed in blocks of BLOCK frames,
once per distinct frame).  Ties are judged by the reference's values
(bf16 moves a peak between pixels whose values differ by less than its
error: bicubic 8x upsampling leaves neighbouring pixels near a peak
within ~1e-3 of each other):
  pose_score_err    the largest |stored peak score - the reference's
                    upsampled heatmap at the same pixel|;
  pose_pair_err     the largest |stored pair score - the reference's
                    line integral between the same two stored peaks|
                    (and |stored| where the pair is not valid);
  pose_peaks_wrong  per distinct frame, in its worst stored row (the
                    jobs store each frame again and again): stored valid
                    peaks that are not a reference 3x3
                    local maximum within MARGIN (reference value above
                    0.05 - MARGIN and above its neighbours' largest -
                    MARGIN), plus reference peaks above max(0.05, the
                    stored 16th score) + MARGIN that no stored peak of
                    their part holds: none on the same bump, where the
                    reference stays within MARGIN of the peak's value
                    all along the segment between the two (SEGMENT
                    samples; a bump that rises above its saddle with a
                    higher one by less than bf16 moves the maps merges
                    into it in the program's maps); summed over the
                    frames, plus 288 (every peak of a row) for each
                    missing or malformed row.
A NaN reads as infinite.  The limits and MARGIN are set from seeded
readings (harness/readings.py --control 1; PERF.md section 2): over 21
seeds the program read at most 0.0131 (score), 0.0206 (pair) and 2
peaks (0 on the 5 seeds read with this judge, 2 where earlier seeds
counted a frame's repeats), and at most 0.0100, 0.0206 and 1 in 15
whole runs; the float8 control at least 0.078 and 0.099, and 0 to 128
peaks.
  pose_score_err    0.04: three times the program's largest, half the
                    control's smallest;
  pose_pair_err     0.06: likewise (0.0206 against 0.099);
  pose_peaks_wrong  6: three times the program's largest (its ties that
                    the margin does not settle: a ridge the straight
                    segment leaves).  It has no upper reading: the
                    control reads 0 on some seeds, so the control's
                    failures rest on the two errors; it is kept for the
                    faults they miss, a part's peaks or a row dropped
                    (test_benchmark_openpose.py);
  MARGIN            0.04, three times the program's largest score
                    error: the ties that bf16 may turn.

The control is the same network with its input, weights and every
layer's output rounded to float8 e4m3 (saturating), the step below the
configuration's bf16.
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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



# -- the benchmark's side --------------------------------------------------

LIMITS = {"pose_score_err": 0.04, "pose_pair_err": 0.06,
          "pose_peaks_wrong": 6}
MARGIN = 0.04        # on heatmap values, for ties (pose_peaks_wrong)
SEGMENT = 33         # samples of the segment from a peak to a stored one
BLOCK = 16           # frames the reference runs at once


def config_widths(config: Dict) -> Dict[str, int]:
    return dict(config["net"]["widths"], stages=config["net"]["stages"])


def prepare(config: Dict, seed: int, device, workdir: str) -> Dict:
    """The weights, made from `seed` on `device` and written as the
    caffe-named `.npz` the op loads; {"weights": its path}."""
    w = init_weights(seed, config_widths(config), device)
    path = os.path.join(workdir, "openpose_seeded.npz")
    np.savez(path, **{k: v.cpu().numpy() for k, v in w.items()})
    return {"weights": path}


def load(prepared: Dict, device) -> Dict[str, torch.Tensor]:
    with np.load(prepared["weights"]) as data:
        return {k: torch.from_numpy(data[k]).to(device) for k in data}


def _finite_max(t: torch.Tensor) -> float:
    if t.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(t, nan=float("inf")).max())


def judge(heat: torch.Tensor, paf: torch.Tensor, stored: torch.Tensor,
          frame_h: int) -> Tuple[float, float, int]:
    """One frame's upsampled reference maps against its R stored rows
    (R, ROW): (score error, pair error, peaks wrong in the worst row)."""
    r = stored.shape[0]
    pk = stored[:, :PARTS * K * 4].reshape(r, PARTS, K, 4)
    pairs = stored[:, PARTS * K * 4:].reshape(r, len(LIMBS), K, K)
    hm = heat[:PARTS]
    h, w = hm.shape[-2:]
    valid = pk[..., 3] > 0.5
    scale = NET_H / frame_h
    fx = torch.nan_to_num(torch.round(pk[..., 0] * scale), nan=-1.0)
    fy = torch.nan_to_num(torch.round(pk[..., 1] * scale), nan=-1.0)
    inside = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    x, y = fx.clamp(0, w - 1).long(), fy.clamp(0, h - 1).long()
    part = torch.arange(PARTS, device=hm.device)[None, :, None].expand_as(x)
    v, nb = hm[part, y, x], neighbours_max(hm)[part, y, x]
    score_err = _finite_max(torch.where(
        valid, torch.where(inside, (pk[..., 2] - v).abs(),
                           torch.full_like(v, float("inf"))),
        torch.zeros_like(v)))
    wrong = (valid & ~(inside & (v > THRESH - MARGIN)
                       & (v > nb - MARGIN))).sum((1, 2))       # (R,)
    # reference peaks the rows should hold: each one above the 16th
    # stored score by MARGIN is held where a stored peak of its part lies
    # on the same bump, every pixel of the segment between the two within
    # MARGIN of the peak (a bump that rises above its saddle with a
    # higher neighbour by less than the maps' error merges into it)
    rx, ry, rs, rv = peaks(heat[None], 2 * K)
    kth = torch.where(valid[..., K - 1], pk[..., K - 1, 2],
                      torch.full_like(pk[..., K - 1, 2], THRESH))
    bound = torch.clamp(kth, min=THRESH)[..., None]          # (R, 18, 1)
    need = rv & (rs > bound + MARGIN)                         # (R, 18, 2K)
    t = torch.linspace(0, 1, SEGMENT, device=hm.device)
    qx, qy = rx[..., None, None].float(), ry[..., None, None].float()
    sx = torch.round(qx + (x[:, :, None, :, None] - qx) * t).long()
    sy = torch.round(qy + (y[:, :, None, :, None] - qy) * t).long()
    low = hm[part[:, :, :1, None, None], sy, sx].amin(-1)     # (R,18,2K,K)
    held = (low >= rs[..., None] - MARGIN) & (valid & inside)[:, :, None, :]
    wrong = wrong + (need & ~held.any(-1)).sum((1, 2))
    pair_err = 0.0
    for li, (pa, pb) in enumerate(LIMBS):
        usable = valid & inside
        ok = usable[:, pa, :, None] & usable[:, pb, None, :]
        ref = line_integral(paf, li, x[:, pa, :, None], y[:, pa, :, None],
                            x[:, pb, None, :], y[:, pb, None, :])
        got = pairs[:, li]
        pair_err = max(pair_err, _finite_max(
            torch.where(ok, (got - ref).abs(), got.abs())))
    return score_err, pair_err, int(wrong.max())


def compare(config: Dict, prepared: Dict, frames: np.ndarray,
            results: Sequence[Tuple[Tuple[int, int], List]],
            device) -> Dict[str, Tuple[float, float]]:
    """{number: (value, limit)} for the jobs' stored rows: `results`
    holds each job's (start, end) clip and its rows in order."""
    weights = load(prepared, device)
    by_frame: Dict[int, List[np.ndarray]] = defaultdict(list)
    wrong = 0
    for (start, end), got in results:
        # a missing or malformed row: every peak it should hold is wrong
        wrong += PARTS * K * abs(len(got) - (end - start))
        for i, row in enumerate(got[:end - start]):
            a = np.asarray(row, np.float32).reshape(-1)
            if a.shape != (ROW,):
                wrong += PARTS * K
                continue
            by_frame[start + i].append(a)
    score_err = pair_err = 0.0
    todo = sorted(by_frame)
    with torch.no_grad():
        for lo in range(0, len(todo), BLOCK):
            blk = todo[lo:lo + BLOCK]
            heat, paf = maps(weights, torch.from_numpy(
                frames[blk]).to(device))
            for b, f in enumerate(blk):
                s, p, n = judge(heat[b], paf[b], torch.from_numpy(
                    np.stack(by_frame[f])).to(device), frames.shape[1])
                score_err, pair_err = max(score_err, s), max(pair_err, p)
                wrong += n
    return {"pose_score_err": (score_err, LIMITS["pose_score_err"]),
            "pose_pair_err": (pair_err, LIMITS["pose_pair_err"]),
            "pose_peaks_wrong": (float(wrong), LIMITS["pose_peaks_wrong"])}


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3, saturating at its largest, 448."""
    return t.clamp(-448, 448).to(torch.float8_e4m3fn).to(t.dtype)


def control_results(config: Dict, prepared: Dict, frames: np.ndarray,
                    clips: Sequence[Tuple[int, int]], device) -> List:
    """The control in the program's place: rows of the network run with
    float8 e4m3 input, weights and layer outputs."""
    weights = load(prepared, device)
    out = []
    with torch.no_grad():
        for start, end in clips:
            got = []
            for lo in range(start, end, BLOCK):
                got.extend(rows(weights, torch.from_numpy(
                    frames[lo:min(lo + BLOCK, end)]).to(device), fp8))
            out.append(((start, end), got))
    return out
