"""Operations of the OpenPose network (COCO body, 6 stages) from the
configuration's shapes alone, and the dense bf16 peaks they are set
against, so the yardstick stays the same whatever runs the network.

Counted: 2 x multiply-adds of every convolution at its output's size
(3x3 and 7x7 "same" convolutions, pools after conv1_2, conv2_2,
conv3_4).  Not counted: the ReLUs, pools and concatenations, the input
scaling, and the post-processing (8x upsampling, NMS, top-K, line
integrals), whose operations are a few hundredths of a per cent of the
convolutions'.  366.43 GFLOP a frame at 496 x 368.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# published dense bf16 peaks (NVIDIA H100 SXM data sheet, no sparsity,
# at the full 700 W power limit), by torch.cuda.get_device_name()
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}

PAFS, HEATMAPS = 38, 19


def convolutions(widths: Dict[str, int], stages: int
                 ) -> List[Tuple[int, int, int, int]]:
    """(in, out, kernel, downsampling before it) of every convolution:
    the last is the stride (1, 2, 4, 8) of its input."""
    w = widths
    c1, c2, c3, c4 = w["conv1"], w["conv2"], w["conv3"], w["conv4"]
    out = [(3, c1, 3, 1), (c1, c1, 3, 1), (c1, c2, 3, 2), (c2, c2, 3, 2),
           (c2, c3, 3, 4), (c3, c3, 3, 4), (c3, c3, 3, 4), (c3, c3, 3, 4),
           (c3, c4, 3, 8), (c4, c4, 3, 8), (c4, w["cpm"], 3, 8),
           (w["cpm"], w["features"], 3, 8)]
    s1, h1 = w["stage1"], w["stage1_hidden"]
    for c in (PAFS, HEATMAPS):
        out += [(w["features"], s1, 3, 8), (s1, s1, 3, 8), (s1, s1, 3, 8),
                (s1, h1, 1, 8), (h1, c, 1, 8)]
    s = w["stage"]
    for _ in range(2, stages + 1):
        for c in (PAFS, HEATMAPS):
            out += [(PAFS + HEATMAPS + w["features"], s, 7, 8)]
            out += [(s, s, 7, 8)] * 4
            out += [(s, s, 1, 8), (s, c, 1, 8)]
    return out


def flops_per_frame(height: int, width: int, widths: Dict[str, int],
                    stages: int) -> int:
    """The network's operations on one height x width net input."""
    total = 0
    for cin, cout, k, down in convolutions(widths, stages):
        h, w = -(-height // down), -(-width // down)
        total += 2 * cin * cout * k * k * h * w
    return total


def config_flops_per_frame(config: Dict) -> int:
    """Per frame at the configuration's net resolution."""
    net = config["net"]
    res = net["resolution"]
    return flops_per_frame(res["height"], res["width"], net["widths"],
                           net["stages"])


def peak(kind: str):
    """A card's dense bf16 peak in FLOP/s, or None for one not listed."""
    return PEAK_BF16_FLOPS.get(kind)
