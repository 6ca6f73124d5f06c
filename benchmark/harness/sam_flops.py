"""Operations of SAM's ViT-H image encoder from the configuration's
shapes alone, so the yardstick stays the same whatever runs the
network; the dense bf16 peak is openpose_flops' table.

Counted: 2 x multiply-adds of the patch embedding (a stride-`patch`
convolution), of qkv and proj over every token a block attends over
(the windowed blocks' grid padded to a multiple of the window), of the
MLP over the grid, of the attention's q k^T and p v products (over the
windows' padded tokens, or the whole grid in a global block), of the
relative-position terms (q against each row's and each column's table
entries) and of the neck's two convolutions.  Not counted: LayerNorms,
softmax, GELU, the bias additions, the resize and normalisation of the
input.  5,961.08 GFLOP a frame at 1024 x 1024, 481.28 of them in the
attention's products.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.harness import openpose_flops


def _blocks(net: Dict):
    """(tokens attended over, keys a query sees, table side) of every
    block."""
    g = net["img_size"] // net["patch"]
    ws = net["window"]
    hp = -(-g // ws) * ws
    for i in range(net["depth"]):
        if i in net["global_blocks"]:
            yield g * g, g * g, g
        else:
            yield hp * hp, ws * ws, ws


def attention_flops_per_frame(net: Dict) -> int:
    """The attention's two products, q k^T and p v, of one frame."""
    return sum(2 * 2 * tokens * keys * net["width"]
               for tokens, keys, _ in _blocks(net))


def flops_per_frame(net: Dict) -> int:
    """The encoder's operations on one frame (see the module)."""
    g = net["img_size"] // net["patch"]
    w, out = net["width"], net["out"]
    total = 2 * g * g * w * 3 * net["patch"] ** 2
    total += 2 * g * g * (w * out + out * out * 9)
    for tokens, _, side in _blocks(net):
        total += 2 * tokens * 4 * w * w
        total += 2 * g * g * 2 * w * net["mlp"]
        total += 2 * tokens * w * 2 * side
    return total + attention_flops_per_frame(net)


def config_flops(config: Dict) -> Tuple[int, int]:
    """(the encoder's, the attention's) operations a frame."""
    net = config["net"]
    return flops_per_frame(net), attention_flops_per_frame(net)


def peak(kind: str):
    """A card's dense bf16 peak in FLOP/s, or None for one not listed."""
    return openpose_flops.peak(kind)
