"""Pose estimation: the flagship model family, on torch.

The counterpart of the JAX package's models/pose.py: per-frame conv
backbone -> temporal attention over the clip (ring or Ulysses attention
through `attn_fn`) -> MoE mixer -> FiLM -> deconv heatmap head, its Adam
train step, the sharded train step over a device mesh (dp batch, sp
time, tp channels, ep experts, pp pipelined trunk), remat, and the
engine op `PoseDetect`.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..common import DeviceType, FrameType
from ..graph.ops import Kernel, register_op
from .convert import (_flax_entries, flatten_params, flax_params,
                      load_params, load_weights)
from .infer import lowered_flops
from .nets import Backbone, DeconvHead, Dense, TemporalBlock, init_module_

NUM_KEYPOINTS = 17


def _stacked_like(module: nn.Module, stages: int) -> nn.Module:
    """A parameter holder with `module`'s names, each parameter stacked
    on a leading stage axis, values taken from `module` (its zero biases
    and unit norm scales)."""
    box = nn.Module()
    for name, p in module.named_parameters(recurse=False):
        box.register_parameter(name, nn.Parameter(
            p.detach().unsqueeze(0).repeat((stages,) + (1,) * p.dim())))
    for name, child in module.named_children():
        box.add_module(name, _stacked_like(child, stages))
    return box


class PipelinedTemporalStack(nn.Module):
    """The temporal trunk as an in-program pipeline: one TemporalBlock's
    parameters repeated `num_stages` times, stacked on a leading axis
    (`stages.<TemporalBlock name>`) that param_shardings splits over the
    mesh's 'pp' ranks, executed with the GPipe microbatch schedule
    (parallel/pp.py).  Each pp rank holds exactly one stage's weights.
    Stages are collective-free, so sp must be 1 (dp/tp compose), and
    `attn_fn` must be too.  `mesh` is the DeviceMesh the pipeline runs
    over (read at the first forward)."""

    def __init__(self, ch: int, num_stages: int, mesh=None,
                 num_microbatches: int = 2, dtype=torch.bfloat16,
                 attn_fn: Optional[Callable] = None, remat: bool = False):
        super().__init__()
        self.num_stages, self.num_microbatches = num_stages, num_microbatches
        self.mesh, self.remat, self._pipe = mesh, remat, None
        self._block = functools.partial(TemporalBlock, ch, dtype=dtype,
                                        attn_fn=attn_fn)
        self.stages = _stacked_like(self._block(), num_stages)
        # each stage runs this block with its slice of `stages` swapped
        # in; not a submodule, so its own (meta) parameters are nowhere
        # in the state dict
        with torch.device("meta"):
            object.__setattr__(self, "stage_template", self._block())

    def init_(self, gen: torch.Generator) -> None:
        for i in range(self.num_stages):
            blk = self._block()
            for mod in blk.modules():
                if hasattr(mod, "init_"):
                    mod.init_(gen)
            with torch.no_grad():
                for name, p in blk.named_parameters():
                    self.stages.get_parameter(name)[i].copy_(p)

    def _stage(self, params, x):
        run = lambda p, x: torch.func.functional_call(  # noqa: E731
            self.stage_template, p, (x,))
        if self.remat:
            return checkpoint(run, params, x, use_reentrant=False)
        return run(params, x)

    def forward(self, tokens):
        from ..parallel.pp import make_pipeline
        if self._pipe is None:
            self._pipe = make_pipeline(self.mesh, self._stage,
                                       self.num_microbatches)
        return self._pipe(dict(self.stages.named_parameters()), tokens)


class VideoPoseNet(nn.Module):
    """(B, T, H, W, 3) uint8 clip -> (B, T, H/4, W/4, K) float32
    heatmaps.

    `pipeline_mesh` (a DeviceMesh with a 'pp' axis) pipelines the
    temporal trunk over its stages (PipelinedTemporalStack_0, one
    temporal block per stage); None keeps TemporalBlock_0..L-1.
    `remat` recomputes the backbone and each temporal block (or stage)
    on the backward pass instead of storing their activations (the
    memory / compute trade for long clips); the parameters and their
    names are the same either way, so one weight file serves both."""

    def __init__(self, width: int = 32, temporal_layers: int = 2,
                 keypoints: int = NUM_KEYPOINTS, dtype=torch.bfloat16,
                 attn_fn: Optional[Callable] = None,
                 pipeline_mesh=None, pipeline_microbatches: int = 2,
                 remat: bool = False):
        super().__init__()
        self.keypoints, self.temporal_layers = keypoints, temporal_layers
        self.remat = remat
        self.Backbone_0 = Backbone(width=width, dtype=dtype)
        C = self.Backbone_0.out_ch
        if pipeline_mesh is not None:
            self.PipelinedTemporalStack_0 = PipelinedTemporalStack(
                C, temporal_layers, pipeline_mesh, pipeline_microbatches,
                dtype, attn_fn, remat)
        else:
            for li in range(temporal_layers):
                setattr(self, f"TemporalBlock_{li}",
                        TemporalBlock(C, dtype=dtype, attn_fn=attn_fn))
        self.film = Dense(C, C, dtype)
        self.DeconvHead_0 = DeconvHead(C, keypoints, dtype)

    def _run(self, module: nn.Module, x):
        if self.remat:
            return checkpoint(module, x, use_reentrant=False)
        return module(x)

    def forward(self, clip):
        B, T, H, W, _ = clip.shape
        feat = self._run(self.Backbone_0, clip.reshape(B * T, H, W, 3))
        _, fh, fw, C = feat.shape
        # clip-level context: GAP tokens mixed across time
        tokens = feat.mean(dim=(1, 2)).reshape(B, T, C)
        if hasattr(self, "PipelinedTemporalStack_0"):
            tokens = self.PipelinedTemporalStack_0(tokens)
        else:
            for li in range(self.temporal_layers):
                tokens = self._run(getattr(self, f"TemporalBlock_{li}"),
                                   tokens)
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


# flax keys of the pipelined trunk and of the plain blocks; the torch
# state names follow the same pattern with "." for "/"
_FLAX_STACK = "params/PipelinedTemporalStack_0/stages/params/"
_FLAX_BLOCK = "params/TemporalBlock_{}/"
_TORCH_STACK = "PipelinedTemporalStack_0.stages."
_TORCH_BLOCK = "TemporalBlock_{}."


def _unstack(flat: Dict[str, Any], stack: str, block: str) -> Dict[str, Any]:
    out = {k: v for k, v in flat.items() if not k.startswith(stack)}
    for k, v in flat.items():
        if k.startswith(stack):
            for i in range(v.shape[0]):
                out[block.format(i) + k[len(stack):]] = v[i]
    return out


def pp_params_to_plain(params) -> Dict[str, np.ndarray]:
    """Convert pipeline-layout VideoPoseNet parameters (stacked stages
    under PipelinedTemporalStack_0/stages) to the plain serving layout
    (TemporalBlock_i) — train with pp, serve with the engine kernels.
    Takes flax-keyed parameters, flat (convert.flax_params, an `.npz`)
    or nested; returns them flat.  The schedule is exactly the
    sequential composition (parallel/pp.py), so converted parameters
    give the same outputs."""
    flat = flatten_params(params)
    if not any(k.startswith(_FLAX_STACK) for k in flat):
        return flat  # already plain
    return _unstack(flat, _FLAX_STACK, _FLAX_BLOCK)


def plain_params_to_pp(params) -> Dict[str, np.ndarray]:
    """Inverse of pp_params_to_plain: stack TemporalBlock_0..S-1 (count
    derived from the keys) into the pipeline layout so plain-trained (or
    shipped) weights can continue training on a pp mesh."""
    flat = flatten_params(params)
    if any(k.startswith(_FLAX_STACK) for k in flat):
        return flat  # already pipelined
    n = 0
    while any(k.startswith(_FLAX_BLOCK.format(n)) for k in flat):
        n += 1
    if not n:
        raise ValueError("no TemporalBlock_i entries to stack")
    blocks = tuple(_FLAX_BLOCK.format(i) for i in range(n))
    out = {k: v for k, v in flat.items() if not k.startswith(blocks)}
    for k in flat:
        if k.startswith(blocks[0]):
            rest = k[len(blocks[0]):]
            out[_FLAX_STACK + rest] = np.stack(
                [np.asarray(flat[b + rest]) for b in blocks])
    return out


def pp_state_to_plain(state: Dict[str, Any]) -> Dict[str, Any]:
    """pp_params_to_plain over torch state names (a port checkpoint of a
    pipelined model, restored into the plain one: models/checkpoint.py)."""
    return _unstack(state, _TORCH_STACK, _TORCH_BLOCK)


def _flax_spec(key: str, shape, sizes: Dict[str, int]):
    """The JAX package's param_shardings rule for one flax leaf: the
    mesh axis of each flax dim, or None."""
    nd = len(shape)
    expert = "ep" if sizes.get("ep", 1) > 1 else "tp"
    if sizes.get("pp", 1) > 1 and "stages" in key:
        return ("pp",) + (None,) * (nd - 1)
    if ("w1" in key or "w2" in key) and nd == 3 \
            and shape[0] % sizes[expert] == 0:
        return (expert, None, None)
    if nd == 2 and shape[1] % sizes["tp"] == 0:
        return (None, "tp")
    if nd == 4 and shape[3] % sizes["tp"] == 0:
        return (None, None, None, "tp")
    return (None,) * nd


def _torch_dim(to_torch, flax_shape, d: int) -> int:
    """The torch dim that flax dim `d` becomes under a layout change
    (transposes and flips: models/nets.py FLAX_PARAMS), found by sending
    a probe of length 2 along `d` through it."""
    probe = np.zeros([2 if i == d else 1 for i in range(len(flax_shape))])
    return list((probe if to_torch is None else to_torch(probe)).shape) \
        .index(2)


def param_shardings(model: nn.Module, mesh) -> Dict[str, Any]:
    """{torch parameter name: parallel.mesh.Sharding} for every
    parameter of `model`, chosen by its flax key under the JAX package's
    rules: pipelined stage stacks on 'pp'; MoE expert tensors (w1/w2)
    on their expert dim over 'ep' when the mesh has more than one ep
    rank, else 'tp'; dense and conv kernels on their output channel over
    'tp' (torch dim 0 of Dense and Conv, dim 1 of ConvTranspose);
    everything else replicated.  `mesh` is a DeviceMesh or a MeshLayout.
    The layers then compute their local channels or experts and gather
    or sum across the axis (models/nets.py), where GSPMD inserts those
    collectives in the JAX package."""
    from ..parallel.mesh import axis_sizes, sharding

    sizes = axis_sizes(mesh)
    out = {}
    for key, name, p, to_torch, to_flax in _flax_entries(model):
        shape = tuple(getattr(p, "global_shape", p.shape))
        flax_shape = shape if to_flax is None else to_flax(
            np.broadcast_to(np.float32(0), shape)).shape
        spec = [None] * len(shape)
        for d, axis in enumerate(_flax_spec(key, flax_shape, sizes)):
            if axis is not None:
                spec[_torch_dim(to_torch, flax_shape, d)] = axis
        out[name] = sharding(mesh, *spec)
    return out


def _sum_replicated_grads(model: nn.Module) -> None:
    """All-reduce (sum) each sharded parameter's gradient over the mesh
    dims on which the parameter is replicated, one flat buffer per set
    of dims."""
    buckets: Dict[tuple, list] = {}
    for p in model.parameters():
        sh = getattr(p, "sharding", None)
        if p.grad is None or sh is None:
            continue
        dims = tuple(i for i, pl in enumerate(sh.placements)
                     if not pl.is_shard() and sh.mesh.size(i) > 1)
        if dims:
            buckets.setdefault((sh.mesh, dims), []).append(p.grad)
    for (mesh, dims), grads in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        for i in dims:
            dist.all_reduce(flat, group=mesh.get_group(i))
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def make_sharded_train_step(mesh, clip_shape=(8, 8, 64, 64, 3),
                            width: int = 32,
                            attn_scheme: Optional[str] = None,
                            remat: bool = False,
                            pipeline_microbatches: int = 2,
                            temporal_layers: Optional[int] = None):
    """Build the sharded training step over the DeviceMesh `mesh`
    (parallel.mesh.device_mesh): dp-sharded batch, sp-sharded time (ring
    or Ulysses attention), tp-sharded kernels, experts over ep (or tp),
    the temporal trunk pipelined over pp.  Returns
    (step, model, optimizer, (clip, target)) with
    step(clip, target) -> the global mean loss (a 0-d tensor); clip and
    target are the JAX package's deterministic batch as DTensors, each
    rank holding its dp x sp block.  The model starts from
    init_params(seed=0)'s weights whatever the mesh, each parameter
    holding this rank's block under param_shardings
    (distributed.shard_params_); the optimizer is Adam at 1e-3 on those
    blocks.

    attn_scheme selects the sequence-parallel attention: "ring"
    (default), "pallas" (the ring through the flash kernel,
    kernels/attention.py) or "ulysses" (all-to-all head sharding); None
    reads SCANNER_TPU_ATTN (same values).  No attention function is
    built when sp is 1.

    A mesh with a 'pp' axis > 1 pipelines the temporal trunk, one
    temporal block per stage; pipeline stages are collective-free, so pp
    requires sp == 1.  `pipeline_microbatches` (M) sets the bubble
    fraction (S-1)/(M+S-1); the per-dp-shard batch must divide by M.
    remat=True recomputes backbone and temporal blocks (or stages) on
    the backward pass.  Pass `temporal_layers` to assert the depth you
    expect: on a pp mesh a mismatch with the pp axis size raises.

    Every rank's backward pass gives the gradient of the sum of every
    rank's loss (parallel/collectives.py), each rank's loss being its
    block's share of the global mean over the ranks that hold the same
    block; a parameter's gradient is then summed over the mesh dims on
    which it is replicated."""
    from ..parallel.distributed import replicate_to_global, shard_params_
    from ..parallel.mesh import axis_sizes, mesh_device

    sizes = axis_sizes(mesh)
    pp, sp, dp = sizes.get("pp", 1), sizes["sp"], sizes["dp"]
    if pp > 1 and sp > 1:
        raise ValueError(
            "pp > 1 requires sp == 1: pipeline stages are "
            "collective-free, so sequence-parallel attention cannot run "
            "inside a stage")
    attn = None
    if sp > 1:
        scheme = attn_scheme or os.environ.get("SCANNER_TPU_ATTN", "ring")
        if scheme not in ("ring", "pallas", "ulysses"):
            raise ValueError(
                f"unknown attention scheme {scheme!r}; expected "
                "'ring', 'pallas' or 'ulysses'")
        if scheme == "ulysses":
            from ..parallel.ulysses import make_ulysses_attention
            attn = make_ulysses_attention(mesh, axis="sp")
        else:
            from ..parallel.ring_attention import make_ring_attention
            attn = make_ring_attention(
                group=mesh.get_group("sp"),
                impl="cuda" if scheme == "pallas" else "xla")
    layers = 2 if temporal_layers is None else temporal_layers
    if pp > 1:
        if temporal_layers is not None and temporal_layers != pp:
            raise ValueError(
                f"temporal_layers={temporal_layers} but the mesh's pp axis "
                f"has {pp} stages; the pipelined trunk runs exactly one "
                "temporal block per stage, so the two must be equal "
                "(resize the pp axis or drop the argument)")
        layers = pp
    model = init_params(0, device="cpu", width=width,
                        temporal_layers=layers, attn_fn=attn, remat=remat)
    if pp > 1:
        plain = model
        model = VideoPoseNet(width=width, temporal_layers=pp, attn_fn=attn,
                             pipeline_mesh=mesh,
                             pipeline_microbatches=pipeline_microbatches,
                             remat=remat)
        load_params(model, plain_params_to_pp(flax_params(plain)))
    shard_params_(model, param_shardings(model, mesh))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    B, T = clip_shape[0], clip_shape[1]
    tshape = (B, T, clip_shape[2] // 4, clip_shape[3] // 4, NUM_KEYPOINTS)
    # deterministic nonzero data so the step exercises real numerics
    clip = replicate_to_global(mesh, ("dp", "sp"), (
        np.arange(np.prod(clip_shape)) % 251).astype(np.uint8)
        .reshape(clip_shape))
    target = replicate_to_global(mesh, ("dp", "sp"), np.sin(
        np.arange(np.prod(tshape))).astype(np.float32).reshape(tshape))
    count = float(np.prod(tshape))
    # ranks that hold the same data block (tp, pp, ep) each count 1/n
    same_block = mesh.size() // (dp * sp)
    data_groups = [mesh.get_group(a) for a in ("dp", "sp") if sizes[a] > 1]
    dev = mesh_device(mesh)

    def step(clip, target):
        clip = clip.to_local() if isinstance(clip, DTensor) else clip
        target = target.to_local() if isinstance(target, DTensor) \
            else target
        opt.zero_grad(set_to_none=True)
        part = ((model(clip.to(dev)) - target.to(dev)) ** 2).sum() / count
        (part / same_block).backward()
        _sum_replicated_grads(model)
        opt.step()
        loss = part.detach().clone()
        for g in data_groups:
            dist.all_reduce(loss, group=g)
        return loss

    return step, model, opt, (clip, target)


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
