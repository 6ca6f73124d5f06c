"""OpenPose, the COCO body model with six stages, on torch.

Multi-person 2D pose with Part Affinity Fields (Cao, Simon, Wei, Sheikh,
CVPR 2017, arXiv:1611.08050); the network is the COCO body model
`models/pose/coco/pose_deploy_linevec.prototxt` of
CMU-Perceptual-Computing-Lab/openpose.  The engine op `OpenPose` (the
upstream pose_detection app's op) runs per batch of (B, H, W, 3) uint8
RGB frames, on the device the engine gives it and with no host sync:

  prep  bf16 BGR input: the frame scaled to NET_HEIGHT rows with area
        interpolation (`F.interpolate(mode="area")`, the mean over each
        output pixel's window), its width to round(W * NET_HEIGHT / H),
        padded on the right with zero pixels to a multiple of 16
        (OpenPose's `-1x368` net resolution: 496 x 368 for 640 x 480),
        then x / 256 - 0.5;
  net   the VGG-19 front (conv1_1 .. conv4_2), conv4_3_CPM and
        conv4_4_CPM (the features F, stride 8), stage 1's two branches
        on F, and stages 2..6 on concat(L1, L2, F); every convolution
        has a bias and a ReLU except each branch's last; bf16 weights
        and activations with fp32 accumulation, channels_last;
  post  in float32: L2 (19 heatmaps) and L1 (38 PAF channels)
        upsampled 8x, bicubic (align_corners=False, OpenCV's
        INTER_CUBIC convention), to the net resolution; a 3x3 non-
        maximum suppression on the 18 part heatmaps (a peak is above
        NMS_THRESH and strictly above its 8 neighbours, border pixels
        never, as OpenPose's nms kernel); the TOP_K best peaks per part;
        for each of COCO's 19 limbs the TOP_K x TOP_K candidate pairs'
        line integral: the mean over LINE_SAMPLES evenly spaced points
        (rounded to the nearest pixel) of the PAF's dot product with
        the unit vector from the limb's first peak to its second.

Each frame's row is one float32 array of ROW_LEN values (`unpack_pose`
reads it back): the peaks as (18, TOP_K, 4) [x, y, score, valid] in
frame pixels, best first, then the pair scores as (19, TOP_K, TOP_K),
0 where either peak is not valid.  `assemble_people` is OpenPose's
greedy assembly of those into skeletons, on the host, for the reader.

Weights: `load_weights` reads a `.npz` keyed by the caffemodel's layer
names (`conv1_1/weight`, `conv1_1/bias`, ..., `Mconv7_stage6_L2/bias`,
caffe's OIHW layouts); the layer widths come from the file.  Without
one, weights made from `seed` at the published widths, initialised so
that the maps have a trained model's ranges (heatmaps about [0, 1],
PAFs about [-1, 1]).  The weights one process loads are kept per file
and device (`weight_cache`), so the kernel instance every job builds
shares them.

The op records three spans in its job's profile, inside
`evaluate:OpenPose` (util/profiler.py `span`): `openpose:prep`,
`openpose:net` and `openpose:post`, host-clock spans of the dispatch
and of any wait the launch queue forces.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from ..util import profiler as _prof
from . import weight_cache
from .infer import DataParallelApply

NET_HEIGHT = 368          # OpenPose's default --net_resolution -1x368
NET_MULTIPLE = 16         # the net width is padded to a multiple of this
STRIDE = 8                # of the features F and the maps
NUM_PARTS = 18            # COCO body parts; heatmap 18 is the background
NUM_HEAT = NUM_PARTS + 1
NUM_PAF = 38              # 19 limbs x (x, y)
TOP_K = 16                # peaks kept per part
NMS_THRESH = 0.05         # OpenPose's body NMS threshold
LINE_SAMPLES = 10         # points of a limb's line integral

# COCO's limbs as (part A, part B) and their PAF channels (x, y):
# OpenPose's POSE_COCO_PAIRS and POSE_COCO_MAP_IDX less the 19 heatmaps
LIMBS = ((1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
         (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
         (0, 15), (15, 17), (2, 16), (5, 17))
LIMB_PAF = ((12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25),
            (0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29),
            (30, 31), (34, 35), (32, 33), (36, 37), (18, 19), (26, 27))
NUM_LIMBS = len(LIMBS)
PEAKS_LEN = NUM_PARTS * TOP_K * 4
ROW_LEN = PEAKS_LEN + NUM_LIMBS * TOP_K * TOP_K

# the published widths (OpenPoseNet's defaults)
PUBLISHED = {"conv1": 64, "conv2": 128, "conv3": 256, "conv4": 512,
             "cpm": 256, "features": 128, "stage1": 128,
             "stage1_hidden": 512, "stage": 128, "stages": 6}
# seeded weights: the last convolution of each branch is drawn so that
# its output spreads by this much about this centre (heatmap, PAF),
# for an input whose mean square is FINAL_INPUT_MS
HEAT_STD, HEAT_CENTER = 0.1, 0.25
PAF_STD = 0.2
FINAL_INPUT_MS = 0.05


def net_size(height: int, width: int) -> Tuple[int, int, int]:
    """(net height, scaled width, net width) for an H x W frame: the
    frame scaled to NET_HEIGHT rows keeps its aspect ratio, and the net
    width pads the scaled width to a multiple of NET_MULTIPLE."""
    sw = max(1, int(round(width * NET_HEIGHT / height)))
    return NET_HEIGHT, sw, NET_MULTIPLE * -(-sw // NET_MULTIPLE)


def layer_specs(widths: Optional[Dict[str, int]] = None
                ) -> List[Tuple[str, int, int, int, bool]]:
    """Every convolution as (caffe name, in, out, kernel, relu), in the
    order the network runs them; pools sit after conv1_2, conv2_2 and
    conv3_4."""
    w = dict(PUBLISHED, **(widths or {}))
    c1, c2, c3, c4 = w["conv1"], w["conv2"], w["conv3"], w["conv4"]
    out = [("conv1_1", 3, c1, 3, True), ("conv1_2", c1, c1, 3, True),
           ("conv2_1", c1, c2, 3, True), ("conv2_2", c2, c2, 3, True),
           ("conv3_1", c2, c3, 3, True)]
    out += [(f"conv3_{i}", c3, c3, 3, True) for i in (2, 3, 4)]
    out += [("conv4_1", c3, c4, 3, True), ("conv4_2", c4, c4, 3, True),
            ("conv4_3_CPM", c4, w["cpm"], 3, True),
            ("conv4_4_CPM", w["cpm"], w["features"], 3, True)]
    f, s1, h1, s = w["features"], w["stage1"], w["stage1_hidden"], \
        w["stage"]
    for b, c in ((1, NUM_PAF), (2, NUM_HEAT)):
        out += [(f"conv5_1_CPM_L{b}", f, s1, 3, True),
                (f"conv5_2_CPM_L{b}", s1, s1, 3, True),
                (f"conv5_3_CPM_L{b}", s1, s1, 3, True),
                (f"conv5_4_CPM_L{b}", s1, h1, 1, True),
                (f"conv5_5_CPM_L{b}", h1, c, 1, False)]
    for t in range(2, w["stages"] + 1):
        for b, c in ((1, NUM_PAF), (2, NUM_HEAT)):
            out.append((f"Mconv1_stage{t}_L{b}", NUM_PAF + NUM_HEAT + f, s,
                        7, True))
            out += [(f"Mconv{i}_stage{t}_L{b}", s, s, 7, True)
                    for i in (2, 3, 4, 5)]
            out += [(f"Mconv6_stage{t}_L{b}", s, s, 1, True),
                    (f"Mconv7_stage{t}_L{b}", s, c, 1, False)]
    return out


POOLED_AFTER = ("conv1_2", "conv2_2", "conv3_4")


def net_flops(height: int, width: int,
              widths: Optional[Dict[str, int]] = None) -> int:
    """Multiply-adds x 2 of the network at a net input of height x
    width (the post-processing is not counted)."""
    total, h, w = 0, height, width
    for name, cin, cout, k, _ in layer_specs(widths):
        total += 2 * cin * cout * k * k * h * w
        if name in POOLED_AFTER:
            h, w = -(-h // 2), -(-w // 2)
    return total


def widths_of(state: Dict[str, Any]) -> Dict[str, int]:
    """The widths a caffe-named state holds (its arrays' shapes)."""
    def out(name):
        return int(state[f"{name}/weight"].shape[0])
    stages = 1
    while f"Mconv1_stage{stages + 1}_L1/weight" in state:
        stages += 1
    w = {"conv1": out("conv1_1"), "conv2": out("conv2_1"),
         "conv3": out("conv3_1"), "conv4": out("conv4_1"),
         "cpm": out("conv4_3_CPM"), "features": out("conv4_4_CPM"),
         "stage1": out("conv5_1_CPM_L1"),
         "stage1_hidden": out("conv5_4_CPM_L1"), "stages": stages}
    w["stage"] = out("Mconv1_stage2_L1") if stages > 1 else PUBLISHED["stage"]
    return w


class OpenPoseNet(nn.Module):
    """The network: (B, 3, h, w) BGR input -> (L1 PAFs (B, 38, h/8,
    w/8), L2 heatmaps (B, 19, h/8, w/8)) of the last stage.  Layers are
    named as the caffemodel's (`layers["conv4_3_CPM"]`)."""

    def __init__(self, conv1: int = 64, conv2: int = 128, conv3: int = 256,
                 conv4: int = 512, cpm: int = 256, features: int = 128,
                 stage1: int = 128, stage1_hidden: int = 512,
                 stage: int = 128, stages: int = 6):
        super().__init__()
        self.widths = dict(conv1=conv1, conv2=conv2, conv3=conv3,
                           conv4=conv4, cpm=cpm, features=features,
                           stage1=stage1, stage1_hidden=stage1_hidden,
                           stage=stage, stages=stages)
        self.specs = layer_specs(self.widths)
        self.layers = nn.ModuleDict({
            name: nn.Conv2d(cin, cout, k, padding=k // 2)
            for name, cin, cout, k, _ in self.specs})
        self.relu = {name: relu for name, _, _, _, relu in self.specs}
        self.stages = stages

    def _run(self, x, names):
        for name in names:
            x = self.layers[name](x)
            if self.relu[name]:
                x = F.relu(x)
            if name in POOLED_AFTER:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return x

    def forward(self, x):
        names = [s[0] for s in self.specs]
        feats = self._run(x, names[:names.index("conv4_4_CPM") + 1])
        l1 = self._run(feats, [f"conv5_{i}_CPM_L1" for i in range(1, 6)])
        l2 = self._run(feats, [f"conv5_{i}_CPM_L2" for i in range(1, 6)])
        for t in range(2, self.stages + 1):
            inp = torch.cat([l1, l2, feats], dim=1)
            l1 = self._run(inp, [f"Mconv{i}_stage{t}_L1" for i in range(1, 8)])
            l2 = self._run(inp, [f"Mconv{i}_stage{t}_L2" for i in range(1, 8)])
        return l1, l2


def seeded_state(seed: int, widths: Optional[Dict[str, int]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Caffe-named float32 weights made from `seed`: He-normal weights and
    zero biases for every convolution with a ReLU; each branch's last
    convolution drawn so that its maps spread as a trained model's
    (HEAT_STD about HEAT_CENTER for heatmaps, PAF_STD about 0 for
    PAFs)."""
    gen = torch.Generator().manual_seed(int(seed))
    state = {}
    for name, cin, cout, k, relu in layer_specs(widths):
        fan_in = cin * k * k
        if relu:
            std = math.sqrt(2.0 / fan_in)
        else:
            target = PAF_STD if name.endswith("_L1") else HEAT_STD
            std = target / math.sqrt(fan_in * FINAL_INPUT_MS)
        state[f"{name}/weight"] = torch.randn(
            (cout, cin, k, k), generator=gen) * std
        bias = torch.zeros(cout)
        if not relu and name.endswith("_L2"):
            bias += HEAT_CENTER
        state[f"{name}/bias"] = bias
    return state


def load_weights(checkpoint_dir: Optional[str], seed: int,
                 device) -> OpenPoseNet:
    """The network in bf16 and channels_last on `device`: weights from
    the caffe-named `.npz` `checkpoint_dir` (a file, or a directory
    holding one), else made from `seed` at the published widths.  The
    parameters are built once per process (weight_cache.shared) and
    shared by every kernel instance (the engine builds one a job)."""
    device = torch.device(device)

    def build(path):
        if path is not None:
            with np.load(path) as data:
                state = {k: torch.from_numpy(data[k]) for k in data}
        else:
            state = seeded_state(seed)
        widths = widths_of(state)
        params = {}
        for name, *_ in layer_specs(widths):
            for leaf in ("weight", "bias"):
                t = state[f"{name}/{leaf}"].to(device, torch.bfloat16)
                if leaf == "weight":
                    t = t.contiguous(memory_format=torch.channels_last)
                params[f"layers.{name}.{leaf}"] = t
        return widths, params

    widths, params = weight_cache.shared(
        "OpenPose", checkpoint_dir, seed, device, torch.bfloat16, build)
    with torch.device("meta"):
        net = OpenPoseNet(**widths)
    net.load_state_dict(params, assign=True)
    return net.requires_grad_(False).eval()


# -- prep and post ------------------------------------------------------------

def prep(frames: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> (B, 3, NET_HEIGHT, net width) BGR net
    input in `dtype`, channels_last."""
    _, h, w, _ = frames.shape
    nh, sw, nw = net_size(h, w)
    x = frames.permute(0, 3, 1, 2).flip(1).float()
    x = F.interpolate(x, size=(nh, sw), mode="area")
    x = F.pad(x, (0, nw - sw)) / 256.0 - 0.5
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def upsample(maps: torch.Tensor) -> torch.Tensor:
    """Net maps -> float32 at the net resolution: x STRIDE, bicubic."""
    return F.interpolate(maps.float(), scale_factor=STRIDE, mode="bicubic",
                         align_corners=False)


def neighbour_max(x: torch.Tensor) -> torch.Tensor:
    """The largest of each pixel's 8 neighbours; +inf on the border, so
    that no border pixel is a peak."""
    p = F.pad(x, (1, 1, 1, 1), value=float("inf"))
    rows = torch.maximum(torch.maximum(p[..., :-2], p[..., 1:-1]),
                         p[..., 2:])            # 3 wide, every padded row
    side = torch.maximum(p[..., 1:-1, :-2], p[..., 1:-1, 2:])
    return torch.maximum(torch.maximum(rows[..., :-2, :], rows[..., 2:, :]),
                         side)


def find_peaks(heat: torch.Tensor, k: int = TOP_K,
               thresh: float = NMS_THRESH):
    """(B, P, H, W) heatmaps -> the k best peaks per map as (x, y,
    score, valid) tensors of shape (B, P, k), best first; an invalid
    slot has score -1."""
    w = heat.shape[-1]
    peak = (heat > thresh) & (heat > neighbour_max(heat))
    score, idx = torch.where(peak, heat, -1.0).flatten(2).topk(k, dim=2)
    return idx % w, idx // w, score, score > thresh


def limb_indices(device=None) -> Dict[str, torch.Tensor]:
    """The limbs' parts and PAF channels as index tensors.  Made from
    host lists: a copy to a card waits for it, so a caller keeps them
    on the device (OpenPoseModel's buffers)."""
    cols = list(zip(*LIMBS)) + list(zip(*LIMB_PAF))
    return {k: torch.tensor(c, device=device)
            for k, c in zip(("a", "b", "cx", "cy"), cols)}


def line_scores(paf: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                valid: torch.Tensor, idx: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """(B, 38, H, W) PAFs and (B, 18, K) integer peak positions ->
    (B, 19, K, K) line integrals of each limb's pairs (its first part's
    peak i, its second's peak j); 0 where either is not valid or the
    two coincide.  `idx`: limb_indices on the PAFs' device."""
    b, _, h, w = paf.shape
    a_idx, b_idx = idx["a"], idx["b"]
    xf, yf = x.float(), y.float()
    ax, ay = xf[:, a_idx, :, None], yf[:, a_idx, :, None]    # (B,L,K,1)
    bx, by = xf[:, b_idx, None, :], yf[:, b_idx, None, :]    # (B,L,1,K)
    dx, dy = bx - ax, by - ay                                 # (B,L,K,K)
    norm = torch.sqrt(dx * dx + dy * dy)
    ok = valid[:, a_idx, :, None] & valid[:, b_idx, None, :] & (norm > 1e-6)
    safe = torch.where(ok, norm, torch.ones_like(norm))
    ux, uy = dx / safe, dy / safe
    t = torch.arange(LINE_SAMPLES, device=paf.device, dtype=torch.float32)
    sx = torch.round(ax[..., None] + dx[..., None] * t / (LINE_SAMPLES - 1))
    sy = torch.round(ay[..., None] + dy[..., None] * t / (LINE_SAMPLES - 1))
    at = (sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)).long()
    at = at.reshape(b, NUM_LIMBS, -1)                        # (B,L,K*K*S)
    flat = paf.flatten(2)
    vx = torch.gather(flat[:, idx["cx"]], 2, at).reshape(sx.shape)
    vy = torch.gather(flat[:, idx["cy"]], 2, at).reshape(sx.shape)
    score = (vx * ux[..., None] + vy * uy[..., None]).mean(-1)
    return torch.where(ok, score, torch.zeros_like(score))


def post(l1: torch.Tensor, l2: torch.Tensor, frame_h: int,
         idx: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Net maps -> packed (B, ROW_LEN) float32 rows for frames of
    `frame_h` rows (`idx` as line_scores takes it)."""
    heat = upsample(l2[:, :NUM_PARTS])
    paf = upsample(l1)
    x, y, score, valid = find_peaks(heat)
    back = frame_h / NET_HEIGHT            # net pixels -> frame pixels
    peaks = torch.stack([x.float() * back, y.float() * back,
                         torch.where(valid, score, torch.zeros_like(score)),
                         valid.float()], dim=-1)
    pairs = line_scores(paf, x, y, valid, idx)
    b = peaks.shape[0]
    return torch.cat([peaks.reshape(b, -1), pairs.reshape(b, -1)], dim=1)


class OpenPoseModel(nn.Module):
    """(B, H, W, 3) uint8 RGB frames -> packed (B, ROW_LEN) rows, with
    the op's three spans."""

    def __init__(self, net: OpenPoseNet):
        super().__init__()
        self.net = net
        # on the module's device, so that no call copies them from the
        # host (a copy from pageable memory waits for the device)
        for k, t in limb_indices().items():
            self.register_buffer(f"limb_{k}", t, persistent=False)

    def forward(self, frames):
        with _prof.span("openpose:prep"):
            x = prep(frames, next(self.net.parameters()).dtype)
        with _prof.span("openpose:net"):
            l1, l2 = self.net(x)
        with _prof.span("openpose:post"):
            idx = {k: getattr(self, f"limb_{k}")
                   for k in ("a", "b", "cx", "cy")}
            return post(l1, l2, frames.shape[1], idx)


# -- rows and people, on the host ---------------------------------------------

def unpack_pose(row) -> Dict[str, np.ndarray]:
    """One stored row -> {"peaks": (18, K, 4) [x, y, score, valid] in
    frame pixels, "pairs": (19, K, K) line integrals}."""
    a = np.asarray(row, np.float32).reshape(-1)
    return {"peaks": a[:PEAKS_LEN].reshape(NUM_PARTS, TOP_K, 4),
            "pairs": a[PEAKS_LEN:].reshape(NUM_LIMBS, TOP_K, TOP_K)}


def assemble_people(pose: Dict[str, Any], frame_h: int,
                    min_parts: int = 4,
                    min_mean_score: float = 0.4) -> List[np.ndarray]:
    """OpenPose's greedy assembly of one unpacked row: per limb, its
    candidate pairs whose score with the distance prior (the line
    integral + min(0.5 frame_h / length - 1, 0)) is positive, best
    first, each peak used once; limbs then joined into people that share
    a peak.  A person with fewer than `min_parts` parts or a mean score
    under `min_mean_score` is dropped.  Returns each person as an (18,
    3) array of [x, y, score], score 0 for an absent part."""
    peaks, pairs = pose["peaks"], pose["pairs"]
    # candidate ids: part p's peak i is p * K + i
    people: List[Dict[str, Any]] = []     # {"ids": [18], "score", "n"}
    for k, (pa, pb) in enumerate(LIMBS):
        va = np.flatnonzero(peaks[pa, :, 3] > 0.5)
        vb = np.flatnonzero(peaks[pb, :, 3] > 0.5)
        if not len(va) or not len(vb):
            continue
        cands = []
        for i in va:
            for j in vb:
                length = float(np.hypot(*(peaks[pb, j, :2] -
                                          peaks[pa, i, :2])))
                if length <= 1e-6:
                    continue
                s = float(pairs[k, i, j]) + min(0.5 * frame_h / length - 1,
                                                0.0)
                if s > 0:
                    cands.append((s, i, j))
        cands.sort(key=lambda c: -c[0])
        used_a, used_b, conns = set(), set(), []
        for s, i, j in cands:
            if i in used_a or j in used_b:
                continue
            used_a.add(i)
            used_b.add(j)
            conns.append((pa * TOP_K + i, pb * TOP_K + j, s))
            if len(conns) >= min(len(va), len(vb)):
                break
        for ida, idb, s in conns:
            sb = float(peaks[pb, idb % TOP_K, 2])
            hit = [q for q in people
                   if q["ids"][pa] == ida or q["ids"][pb] == idb][:2]
            if len(hit) == 2 and not any(
                    a >= 0 and b >= 0
                    for a, b in zip(hit[0]["ids"], hit[1]["ids"])):
                # two people that share no part: one person
                q1, q2 = hit
                q1["ids"] = [a if a >= 0 else b
                             for a, b in zip(q1["ids"], q2["ids"])]
                q1["n"] += q2["n"]
                q1["score"] += q2["score"] + s
                people.remove(q2)
            elif hit:
                q = hit[0]
                if len(hit) == 2 or q["ids"][pb] != idb:
                    q["ids"][pb] = idb
                    q["n"] += 1
                    q["score"] += sb + s
            elif k < NUM_LIMBS - 2:
                # the ear-shoulder limbs start nobody
                ids = [-1] * NUM_PARTS
                ids[pa], ids[pb] = ida, idb
                people.append({"ids": ids, "n": 2, "score": float(
                    peaks[pa, ida % TOP_K, 2]) + sb + s})
    out = []
    for q in people:
        if q["n"] < min_parts or q["score"] / q["n"] < min_mean_score:
            continue
        person = np.zeros((NUM_PARTS, 3), np.float32)
        for p, cid in enumerate(q["ids"]):
            if cid >= 0:
                person[p] = peaks[p, cid % TOP_K, :3]
        out.append(person)
    return out


# -- the engine op -----------------------------------------------------------

@register_op(device=DeviceType.TPU, batch=16)
class OpenPose(Kernel):
    """Per-frame OpenPose peaks and limb scores as packed float32 rows
    (`unpack_pose`; `assemble_people` for skeletons), replicated over
    the devices the engine gives this kernel (DataParallelApply).

    `checkpoint_dir`: a caffe-named `.npz` (or a directory holding one);
    without it, weights made from `seed` at the published widths."""

    def __init__(self, config, checkpoint_dir: Optional[str] = None,
                 seed: int = 0):
        super().__init__(config)
        devices = config.devices or ["cpu"]
        from .infer import _device
        net = load_weights(checkpoint_dir, seed, _device(devices[0]))
        self.widths = net.widths
        self._dp = DataParallelApply(OpenPoseModel(net), config.devices)

    def cost(self, shapes):
        """FLOPs of the network (not the post-processing) and the bytes
        of one call on (B, H, W, 3) frames."""
        b, h, w = shapes[0][:3]
        nh, _, nw = net_size(h, w)
        return {"flops": float(b * net_flops(nh, nw, self.widths)),
                "bytes_in": float(b * h * w * 3),
                "bytes_out": float(b * ROW_LEN * 4)}

    def infer_cost_flops(self, batch):
        """FLOPs of one inference call on `batch` (the network's, from
        its shapes)."""
        return self.cost([tuple(np.shape(batch))])["flops"]

    def execute(self, frame: Sequence[FrameType]) -> Sequence[Any]:
        """(B, ROW_LEN) float32 per batch: a tensor left on the card when
        the frames came as a CUDA tensor (the sink fetches once per
        task), a numpy array when they came from the host."""
        return self._dp(frame)
