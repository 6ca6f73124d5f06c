"""The CUDA kernels against their plain versions on the card: the
histogram bit for bit, the flash-attention update (TF32 on the tensor
cores) within a tolerance stated below.  Also the ops of the image
stdlib and the model zoo on the card against the same ops on the CPU:
resamplers within 1 uint8 count, flow within atol 1e-3, HistDiff over
Histogram rows (the kernel's id entry) exactly, and the model ops within
the bounds of chip_smoke.py's [model_serve] (boxes within IoU 0.9 on 95 %
of frames, cosine >= 0.99, mask IoU >= 0.9 on matched instances).  And
a cluster job through a Worker(device="cuda:0") against a CPU worker's
rows, and a two-member gang on the one card against a local run, byte
for byte.  And the train path on the card: train_pose through the flash
kernel (two launches a step), its checkpoint restored by PoseDetect and a
trained detector's `.npz` by ObjectDetect, each giving the in-memory
model's outputs.  And in-program sharding on a one-rank NCCL group on the
card: placements and temporal_diff exact, Ulysses against
reference_attention (rtol 2e-4, atol 2e-5), a one-stage pipeline against
its stage, the sharded train step with and without remat (equal losses
under deterministic cuDNN; the first within rel 1e-3 of the unsharded
step) and its DCP resume bit for bit.  And several cards: the model ops
over DataParallelApply's replicas (every card, or two on one) against one
card within the model bounds, and a Worker(coordinator=) on a one-rank
NCCL group for its lifetime.  Marked `cuda`: they need an NVIDIA card with nvcc
(sm_90a) and skip elsewhere — except the check that a worker asked for
a card without one raises, which hides the card and runs everywhere.  Run on the card with

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from scanner_tpu_torch.kernels import color, cuda_ops
from torch_model_checks import stop_process_engine  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode; its "
                    "plain version is tested on the CPU)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(16, 480, 640, 3), (3, 97, 131, 3),
                                   (1, 1, 1, 3), (2, 5, 7, 1),
                                   (4, 33, 41, 4)])
def test_frames_kernel_bit_exact(card, shape):
    g = torch.Generator().manual_seed(sum(shape))
    f = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    want = cuda_ops.histogram_frames_plain(f)
    before = cuda_ops.histogram_launches
    got = cuda_ops.histogram_frames(f.to(card))
    torch.cuda.synchronize()
    assert cuda_ops.histogram_launches == before + 1
    assert torch.equal(got.cpu(), want)
    if shape[0] > 1:   # a view whose start is not 16-byte aligned
        got = cuda_ops.histogram_frames(f.to(card)[1:])
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want[1:])


def test_flat_frames_kernel_bit_exact(card):
    f = torch.full((16, 480, 640, 3), 200, dtype=torch.uint8)
    got = cuda_ops.histogram_frames(f.to(card))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_ops.histogram_frames_plain(f))


def _frames_exact(card, f, bins=16):
    """The kernel on `f` (moved to the card unless it is there) against
    the plain version, bit for bit, and one launch."""
    before = cuda_ops.histogram_launches
    got = cuda_ops.histogram_frames(f if f.is_cuda else f.to(card), bins)
    torch.cuda.synchronize()
    assert cuda_ops.histogram_launches == before + 1
    assert torch.equal(got.cpu(), cuda_ops.histogram_frames_plain(f.cpu(),
                                                                  bins))


@pytest.mark.parametrize("batch", [1, 8, 16, 32, 33])
def test_frames_kernel_batch_sizes(card, batch):
    """The engine's 16-frame calls and 8-frame tail, the shot path's 32, a
    lone frame and a ragged 33: each picks another number of blocks per
    frame (one cluster each)."""
    g = torch.Generator().manual_seed(batch)
    _frames_exact(card, torch.randint(0, 256, (batch, 480, 640, 3),
                                      generator=g, dtype=torch.uint8))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("bins", [1, 16, 17, 128])
def test_frames_kernel_channels_bins(card, channels, bins):
    """16 bins at C = 1, 3 and 4 take the private-counter kernel with the
    channel count fixed at compile time; other bins and C = 2 the general
    one."""
    g = torch.Generator().manual_seed(channels * 1000 + bins)
    _frames_exact(card, torch.randint(0, 256, (3, 37, 53, channels),
                                      generator=g, dtype=torch.uint8), bins)


@pytest.mark.parametrize("offset", range(16))
def test_frames_kernel_views_at_every_byte_offset(card, offset):
    """Views into one buffer that start 0..15 bytes past a 16-byte
    boundary: every head length and channel phase."""
    shape = (3, 61, 47, 3)
    n = 3 * 61 * 47 * 3
    g = torch.Generator().manual_seed(offset)
    buf = torch.randint(0, 256, (n + 16,), generator=g,
                        dtype=torch.uint8).to(card)
    _frames_exact(card, buf[offset:offset + n].view(shape))


@pytest.mark.parametrize("bins", [16, 17])
def test_frames_kernel_flat_channels(card, bins):
    """Channels flat at 0, 255 and 128: every lane on one bin."""
    f = torch.empty((4, 480, 640, 3), dtype=torch.uint8)
    for c, v in enumerate((0, 255, 128)):
        f[..., c] = v
    _frames_exact(card, f, bins)


def test_frames_kernel_flat_full_hd(card):
    """A flat 1920 x 1080 frame puts 2,073,600 counts in one bin."""
    f = torch.full((1, 1080, 1920, 3), 77, dtype=torch.uint8)
    _frames_exact(card, f)
    assert int(cuda_ops.histogram_frames(f.to(card))[0, 0, 77 * 16 // 256]) \
        == 1920 * 1080


@pytest.mark.parametrize("rows,pix,bins", [(5, 1000, 16), (3, 7, 4),
                                           (48, 30001, 16), (2, 50, 128),
                                           (4, 333, 1)])
def test_ids_kernel_bit_exact(card, rows, pix, bins):
    g = torch.Generator().manual_seed(rows + pix)
    v = torch.randint(-2, bins + 3, (rows, pix), generator=g,
                      dtype=torch.int32)
    got = cuda_ops.histogram_ids(v.to(card), bins)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_ops.histogram_ids_plain(v, bins))


def test_wrapper_raises_on_non_contiguous(card):
    f = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError):
        cuda_ops.histogram_frames(f.transpose(1, 2))


def test_color_on_card_bit_exact(card):
    import numpy as np
    h, w = 97, 129
    n = h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)
    flat = np.random.RandomState(0).randint(0, 256, (3, n)).astype(np.uint8)
    got = color.yuv420_to_rgb_device(torch.from_numpy(flat).to(card), h, w)
    assert (got.cpu().numpy() == color.yuv420_to_rgb_host(flat, h, w)).all()


# -- the flash-attention kernel (csrc/flash_attention.cu) ------------------
# against flash_block_update_plain on the card, at the shapes chip_smoke.py
# checks.  The kernel multiplies TF32 operands, so the plain version is fed
# the same operands (tf32_operand, per TF32_ROUNDING); the logits then
# differ only in f32 summation order and K tiling, so m and l keep rtol
# 2e-4, atol 2e-5 (tests/test_parallel.py's).  The kernel also rounds the
# probabilities to TF32 for p . V (relative error <= 2^-11 each) and the
# plain version does not: acc / l takes rtol 2e-4, atol 2 * 2^-11 *
# max|v|.  TF32 is off for the plain version's matmuls.

FLASH_CASES = {
    # (BH, Tq, Tk, D, q_off, k_off, causal, carry)
    "long_d128": (16, 2048, 2048, 128, 0, 0, False, False),
    "long_d128_causal": (16, 2048, 2048, 128, 0, 0, True, False),
    "d8": (8, 512, 512, 8, 0, 0, True, False),
    "d32": (8, 2048, 2048, 32, 0, 0, True, False),
    "d32_train_step": (8, 2048, 2048, 32, 0, 0, False, False),
    "ragged": (3, 193, 77, 40, 0, 0, False, True),
    "offsets": (5, 130, 150, 64, 100, 37, True, True),
    "d6_padded": (2, 100, 90, 6, 0, 0, True, True),
    "d128_untiled_offsets": (3, 300, 250, 128, 37, 11, True, True),
    "more_blocks_than_a_wave": (40, 1024, 1024, 64, 0, 0, False, False),
    "causal_k_before_queries": (4, 256, 256, 32, 1024, 0, True, True),
}


def _flash_inputs(seed, BH, Tq, Tk, D, carry):
    from scanner_tpu_torch.kernels.attention import NEG_INF
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(BH, Tq, D, generator=g) * D ** -0.5
    k = torch.randn(BH, Tk, D, generator=g)
    v = torch.randn(BH, Tk, D, generator=g)
    if carry:
        m = torch.randn(BH, Tq, generator=g)
        l = torch.rand(BH, Tq, generator=g) * 2.5 + 0.5
        acc = torch.randn(BH, Tq, D, generator=g)
    else:
        m = torch.full((BH, Tq), NEG_INF)
        l = torch.zeros(BH, Tq)
        acc = torch.zeros(BH, Tq, D)
    return q, k, v, m, l, acc


def _flash_close(got, args, q_off, k_off, causal):
    """The kernel's (m, l, acc) on `args` against the plain version on
    the TF32 operands the kernel multiplies."""
    from scanner_tpu_torch.kernels import attention
    q, k, v = (attention.tf32_operand(t, attention.TF32_ROUNDING[n])
               for n, t in zip("qkv", args[:3]))
    want = attention.flash_block_update_plain(q, k, v, *args[3:], q_off,
                                              k_off, causal=causal)
    m, l, acc = (t.cpu() for t in got)
    wm, wl, wacc = (t.cpu() for t in want)
    for t in (m, l, acc):
        assert torch.isfinite(t).all()
    torch.testing.assert_close(m, wm, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(l, wl, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(acc / l.clamp_min(1e-30)[..., None],
                               wacc / wl.clamp_min(1e-30)[..., None],
                               rtol=2e-4,
                               atol=2 * 2.0 ** -11 * float(v.abs().max()))


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(card, case):
    from scanner_tpu_torch.kernels import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    BH, Tq, Tk, D, qo, ko, causal, carry = FLASH_CASES[case]
    args = [t.to(card) for t in _flash_inputs(len(case), BH, Tq, Tk, D,
                                              carry)]
    before = attention.flash_launches
    got = attention.flash_block_update(*args, qo, ko, causal=causal)
    torch.cuda.synchronize()
    assert attention.flash_launches == before + 1
    _flash_close(got, args, qo, ko, causal)


@pytest.mark.parametrize("carry", [False, True])
def test_flash_kernel_fully_masked_block(card, carry):
    from scanner_tpu_torch.kernels import attention
    args = [t.to(card) for t in _flash_inputs(1, 4, 100, 64, 32, carry)]
    got = attention.flash_block_update(*args, 0, 500, causal=True)
    torch.cuda.synchronize()
    for g, a in zip(got, args[3:]):
        assert torch.equal(g, a)


def test_flash_kernel_chained_blocks(card):
    from scanner_tpu_torch.kernels import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, m, l, acc = (t.to(card) for t in
                          _flash_inputs(2, 4, 256, 512, 32, True))
    state = (m, l, acc)
    for blk, k_off in ((slice(0, 256), 256), (slice(256, 512), 0)):
        args = [q, k[:, blk], v[:, blk], *state]
        state = attention.flash_block_update(*args, 256, k_off, causal=True)
        torch.cuda.synchronize()
        _flash_close(state, args, 256, k_off, True)


def test_flash_kernel_refuses_wide_heads(card):
    from scanner_tpu_torch.kernels import attention
    args = [t.to(card) for t in _flash_inputs(0, 1, 8, 8, 136, False)]
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_block_update(*args, 0, 0)


def test_flash_kernel_takes_unaligned_views(card):
    """q, k, v whose data start 4 bytes past a 16-byte boundary: the
    wrapper copies them for the TMA loads and the result is unchanged."""
    from scanner_tpu_torch.kernels import attention
    args = [t.to(card) for t in _flash_inputs(3, 2, 96, 80, 36, True)]
    views = []
    for t in args[:3]:
        buf = torch.zeros(t.numel() + 1, device=card)
        buf[1:] = t.reshape(-1)
        views.append(buf[1:].view(t.shape))
    assert all(x.data_ptr() % 16 for x in views)
    got = attention.flash_block_update(*views, *args[3:], 0, 0)
    want = attention.flash_block_update(*args, 0, 0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the image stdlib and the model zoo on the card, against the CPU -------


def _window_rows(seed):
    import numpy as np
    return np.random.RandomState(seed).choice(
        [-3, 0, 1, 15, 16, 17, 200, 255, 256, 4000], (16, 2, 3, 16)) \
        .astype(np.int32)


def test_histdiff_over_histogram_rows_takes_the_id_entry(card):
    from scanner_tpu_torch.kernels.shot import HistDiff
    win = torch.from_numpy(_window_rows(0))
    ids, total = cuda_ops.histogram_ids_launches, cuda_ops.histogram_launches
    got = HistDiff(None).execute_traced(win.to(card))
    torch.cuda.synchronize()
    assert cuda_ops.histogram_ids_launches == ids + 1
    assert cuda_ops.histogram_launches == total + 1
    assert torch.equal(got.cpu(), HistDiff(None).execute_traced(win))


def _frames(card, n=8, h=480, w=640, seed=3):
    g = torch.Generator().manual_seed(seed)
    f = torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8)
    return f, f.to(card)


@pytest.mark.parametrize("op", ["resize", "blur", "crop_resize"])
def test_resamplers_on_card_within_one_count(card, op):
    from scanner_tpu_torch.kernels import imgproc
    f, fc = _frames(card)
    if op == "resize":
        def run(x):
            return imgproc.resize(x, 240, 320)
    elif op == "blur":
        def run(x):
            return imgproc.blur(x, [float(v) for v in
                                    imgproc._gaussian_kernel1d(3, 1.1)])
    else:
        boxes = torch.tensor([[0.0, 0.0, 0.5, 0.5], [0.1, 0.2, 0.9, 0.7],
                              [0.3, 0.3, 0.35, 0.4], [0.0, 0.0, 1.0, 1.0]]
                             * 2)

        def run(x):
            return imgproc.crop_resize(x, boxes.to(x.device), 64, 64)
    got = run(fc)
    assert got.is_cuda
    d = (got.cpu().to(torch.int32) - run(f).to(torch.int32)).abs()
    assert int(d.max()) <= 1


def test_optical_flow_on_card_matches_cpu(card):
    from scanner_tpu_torch.kernels import imgproc
    f, fc = _frames(card, n=4, h=120, w=160)
    win = torch.stack([f, f.roll((1, 2), (1, 2))], dim=1)
    k = imgproc.OpticalFlow(None)
    got = k.execute(win.to(card))
    assert got.is_cuda and got.shape == (4, 120, 160, 2)
    torch.testing.assert_close(got.cpu(), k.execute(win), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("op", ["ObjectDetect", "FaceEmbedding",
                                "InstanceSegment"])
def test_model_ops_on_card_match_cpu(card, op):
    """The shipped weights on the shipped tasks' scenes: on the card
    (rows left there) and on the CPU (numpy)."""
    import numpy as np
    from scanner_tpu_torch.common import DeviceType
    from scanner_tpu_torch.graph.ops import KernelConfig
    from scanner_tpu_torch.models import (detect_train, detection, face,
                                          seg_train, segmentation)
    from torch_model_checks import boxes_agree, matched_mask_ious
    rng = np.random.RandomState(21)
    if op == "ObjectDetect":
        frames = [detect_train.render_rect_scene(rng)[0] for _ in range(40)]
        cls, kw = detection.ObjectDetect, dict(score_thresh=0.3)
    elif op == "FaceEmbedding":
        frames = [detect_train.render_identity(i % 8, rng)
                  for i in range(40)]
        cls, kw = face.FaceEmbedding, {}
    else:
        frames = [seg_train.render_shape_scene(rng)[0] for _ in range(40)]
        cls, kw = segmentation.InstanceSegment, dict(score_thresh=0.3)
    frames = np.stack(frames)
    on_card = cls(KernelConfig(device=DeviceType.TPU, devices=[card]),
                  width=8, **kw)
    got = on_card.execute(torch.from_numpy(frames).to(card))
    assert got.is_cuda
    got = got.cpu().numpy()
    want = cls(KernelConfig(device=DeviceType.CPU), width=8,
               **kw).execute(frames)
    if op == "FaceEmbedding":
        assert (got * want).sum(axis=1).min() >= 0.99
    elif op == "ObjectDetect":
        assert boxes_agree(want, got, detection.unpack_detections) >= 0.95
    else:
        assert boxes_agree(want, got, segmentation.unpack_instances) >= 0.95
        assert np.mean(matched_mask_ious(want, got)) >= 0.9


def test_train_save_and_serve_on_card(card, tmp_path):
    """train_pose with the one-rank "cuda" ring launches the flash kernel
    once per temporal block and step; PoseDetect restores its checkpoint
    and ObjectDetect a trained detector's `.npz`, and both give the
    in-memory model's outputs on the card."""
    import numpy as np
    from scanner_tpu_torch.common import DeviceType
    from scanner_tpu_torch.graph.ops import KernelConfig
    from scanner_tpu_torch.kernels import attention
    from scanner_tpu_torch.models import (checkpoint, detect_train,
                                          detection, pose, pose_train)
    from scanner_tpu_torch.parallel import make_ring_attention
    ckpt = str(tmp_path / "pose")
    attention.reset_counts()
    loss = pose_train.train_pose(ckpt, steps=4, batch=2, log_every=0,
                                 attn_fn=make_ring_attention(impl="cuda"),
                                 device=card)
    assert np.isfinite(loss) and attention.flash_launches == 2 * 4
    clips, _, _ = pose_train.synth_batch(np.random.RandomState(5), 2, 8)
    frames = torch.from_numpy(clips.reshape(16, 48, 48, 3)).to(card)
    config = KernelConfig(device=DeviceType.TPU, devices=[card])
    model = checkpoint.load_params(ckpt, pose.VideoPoseNet(width=8))
    with torch.no_grad():
        want = pose.apply_and_peaks(model.to(card).eval(), frames[:, None])
    got = pose.PoseDetect(config, width=8, checkpoint_dir=ckpt) \
        .execute(frames)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    npz = str(tmp_path / "detect.npz")
    detect_train.train_detector(str(tmp_path / "det"), steps=4, batch=2,
                                export_npz=npz, log_every=0, device=card)
    scenes = torch.from_numpy(np.stack([detect_train.render_rect_scene(
        np.random.RandomState(i))[0] for i in range(8)])).to(card)
    net = checkpoint.load_params(str(tmp_path / "det"),
                                 detection.SSDDetector(width=8))
    with torch.no_grad():
        want = detection.AnchoredModel(net, 0.05).to(card).eval()(scenes)
    got = detection.ObjectDetect(config, width=8, checkpoint_dir=npz) \
        .execute(scenes)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _queue_c_frames(case):
    import numpy as np
    rng = np.random.RandomState(11)
    if case == "int32_in_range":
        return rng.randint(0, 256, (2, 8, 8, 3)).astype(np.int32)
    if case == "int32_out_of_range":
        return rng.randint(-40, 600, (2, 8, 8, 3)).astype(np.int32)
    return rng.randint(0, 256, (3, 9, 7, 5)).astype(np.uint8)


@pytest.mark.parametrize("case", ["int32_in_range", "int32_out_of_range",
                                  "uint8_c5"])
def test_histogram_op_bins_integer_frames_on_card(card, case):
    """The frames the JAX op bins and the port's op once refused take the
    kernel's id entry on the card, and give the counts of the op's CPU
    path (which tests/test_torch_histogram.py holds to the JAX op)."""
    from scanner_tpu_torch.kernels.imgproc import Histogram
    frames = torch.from_numpy(_queue_c_frames(case))
    ids = cuda_ops.histogram_ids_launches
    got = Histogram(None).execute(frames.to(card))
    torch.cuda.synchronize()
    assert got.is_cuda and cuda_ops.histogram_ids_launches == ids + 1
    assert torch.equal(got.cpu(), Histogram(None).execute(frames))


def test_chain_graph_replays_match_eager_calls(card):
    """A Resize -> Blur -> Histogram chain captured as one CUDA graph:
    each replay gives the counts of the same composition run eagerly on
    the card, returns its own tensor (a clone of the static output), and
    counts its histogram launch; a second evaluator of the same chain
    replays the process's graph without capturing again."""
    import numpy as np
    from scanner_tpu_torch.engine import evaluate
    from scanner_tpu_torch.engine.evaluate import (TaskEvaluator,
                                                   resolve_device)
    from scanner_tpu_torch.graph import analysis
    from scanner_tpu_torch.graph.ops import OpGenerator
    from scanner_tpu_torch.graph.streams_dsl import IOGenerator
    from scanner_tpu_torch.util.profiler import Profiler

    class _Stream:
        is_video = False
        n = 64

    io, ops = IOGenerator(), OpGenerator()
    col = ops.Histogram(frame=ops.Blur(frame=ops.Resize(
        frame=io.Input([_Stream()]), width=[320], height=[240]),
        kernel_size=3, sigma=1.1))
    info = analysis.analyze([io.Output(col, [_Stream()])])
    rng = np.random.RandomState(4)
    frames = [torch.from_numpy(rng.randint(0, 256, (8, 480, 640, 3))
                               .astype(np.uint8)).to(card)
              for _ in range(3)]
    for _ in range(2):
        te = TaskEvaluator(info, Profiler(), resolve_device("cuda"))
        try:
            (fki,) = te.fused.values()
            assert fki.chain_id == "Resize+Blur+Histogram"
            fki.bind_stream(0, 0)
            replayed = cuda_ops.histogram_replay_launches
            outs = [fki.execute(f) for f in frames]
            torch.cuda.synchronize()
            (cg,) = [cg for key, cg in evaluate._CHAIN_GRAPHS.items()
                     if key[0] == fki.program_key]
            assert len(cg.graphs) == 1
            assert cuda_ops.histogram_replay_launches == replayed + 3
            for f, out in zip(frames, outs):
                assert torch.equal(out, fki._chain_fn(f))
            assert not torch.equal(outs[0], outs[1])
        finally:
            te.close()


def test_frame_cache_pages_on_card(card):
    """The frame cache's pages are tensors on the card: a task's rows
    staged through the cache equal direct staging byte for byte, a
    second plan gathers them from pages on the card (an index tensor on
    the page's device), pages own their storage, and the card's
    hbm_pressure label reaches its pool."""
    import numpy as np
    from scanner_tpu_torch.engine import framecache as fc
    from scanner_tpu_torch.engine.batch import staged_device_put
    dev = torch.device("cuda", torch.cuda.current_device())
    label = str(dev)
    c = fc.FrameCache()
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (40, 480 * 640 * 3 // 2)).astype(np.uint8)
    fc.set_page_frames(8)
    try:
        rows = np.arange(0, 24)
        p = c.plan(dev, ("db", 1), "frame", 0, "yuv420", rows, 40)
        got = c.assemble(p, p.miss_rows, frames[rows], hw=(480, 640))
        want = staged_device_put(frames[rows], dev, "staging", "t")
        assert got.device == dev and torch.equal(got, want)
        p.lease.release()
        sparse = np.array([1, 5, 9, 17, 22, 30])
        p2 = c.plan(dev, ("db", 1), "frame", 0, "yuv420", sparse, 40)
        assert p2.hit_mask.tolist() == [True] * 5 + [False]
        got = c.assemble(p2, p2.miss_rows, frames[p2.miss_rows])
        assert torch.equal(got.cpu(), torch.from_numpy(frames[sparse]))
        p2.lease.release()
        for page in c._pages.values():
            assert page.data.device == dev and page.data._base is None
        st_ = c.status_dict()["devices"][label]
        assert st_["pages"] == 3 and st_["pinned_bytes"] == 0
        c.pressure_shrink(label)
        assert c.status_dict()["devices"][label]["pressure_shrinks"] == 1
    finally:
        fc.set_page_frames(0)


def test_device_trace_names_histogram_kernel(card, tmp_path):
    """A level-2 capture around histogram calls made on another thread
    (as the evaluator makes them) holds the kernel's launches by name,
    aligned inside the host window."""
    import threading
    from scanner_tpu_torch.util import torchprof
    from scanner_tpu_torch.util.profiler import Profiler
    x = torch.randint(0, 256, (8, 480, 640, 3), dtype=torch.uint8,
                      device=card)
    cuda_ops.histogram_frames(x)
    torch.cuda.synchronize()
    prof = Profiler(level=2)
    with torchprof.device_trace(prof, out_dir=str(tmp_path)):
        t = threading.Thread(target=lambda: [cuda_ops.histogram_frames(x)
                                             for _ in range(5)])
        t.start()
        t.join()
        torch.cuda.synchronize()
    rec = prof.device_traces[0]
    evs = torchprof.load_device_events(rec)
    kern = [e for e in evs if e.get("cat") == "kernel"
            and "hist" in e.get("name", "")]
    assert len(kern) == 5, [e.get("name") for e in evs
                            if e.get("cat") == "kernel"]
    lo, hi = rec["t0"] * 1e6, rec["t1"] * 1e6
    assert all(lo <= e["ts"] <= hi for e in kern)
    assert all(e["pid"] >= torchprof.DEVICE_PID_BASE for e in kern)


def test_worker_on_cuda_without_card_raises(tmp_path, monkeypatch):
    """A cluster worker asked for a card that is not there raises before
    it binds a server or dials the master (no CPU fallback).  Runs
    everywhere: the card is hidden."""
    import threading

    from scanner_tpu_torch.common import ScannerException
    from scanner_tpu_torch.engine.service import Worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(threading.enumerate())
    for dev in ("cuda", "cuda:0"):
        with pytest.raises(ScannerException, match="no CUDA card"):
            Worker("localhost:1", db_path=str(tmp_path / "db"), device=dev)
    assert [t.name for t in threading.enumerate() if t not in before] == []


def test_cluster_job_on_card_matches_cpu_cluster(card, tmp_path):
    """One Histogram job through an in-process master and a
    Worker(device="cuda:0"), and the same job through a CPU worker's
    cluster: the same stored bytes, with the kernel launched."""
    import numpy as np

    import scanner_tpu_torch as st
    from scanner_tpu_torch.engine.service import Master, Worker
    from scanner_tpu_torch.storage import Database, PosixStorage
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (40, 96, 128, 3)).astype(np.uint8)
    rows = {}
    for dev in ("cuda:0", "cpu"):
        db = str(tmp_path / dev.replace(":", ""))
        Database(PosixStorage(db)).new_table(
            "frames", ["frame"], [[f] for f in frames],
            codecs={"frame": "pickle"})
        m = Master(db_path=db)
        w = Worker(f"localhost:{m.port}", db_path=db, device=dev)
        sc = st.Client(db_path=db, master=f"localhost:{m.port}")
        try:
            before = cuda_ops.histogram_launches
            src = sc.io.Input([st.NamedStream(sc, "frames")])
            sc.run(sc.io.Output(sc.ops.Histogram(frame=src),
                                [st.NamedStream(sc, "h")]),
                   st.PerfParams.manual(8, 16), show_progress=False)
            if dev != "cpu":
                assert cuda_ops.histogram_launches > before
            desc = sc._db.table_descriptor("h")
            rows[dev] = list(sc._db.load_column("h", desc.columns[0].name))
            assert sc.shutdown_cluster() == 1
        finally:
            sc.stop()
            w.stop()
            m.stop()
    assert len(rows["cpu"]) == 40 and rows["cuda:0"] == rows["cpu"]


def test_gang_of_two_members_on_card_matches_local_run(card, tmp_path):
    """A gang_hosts=2 Histogram bulk through an in-process master and
    two Worker(device="cuda:0"): each member is a child process with
    its own CUDA context on the one card, evaluates its row shard
    through the kernel, and member 0 stores the same bytes as a local
    run on the card."""
    import numpy as np

    import scanner_tpu_torch as st
    from scanner_tpu_torch.engine.service import Master, Worker
    from scanner_tpu_torch.storage import Database, PosixStorage
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (40, 96, 128, 3)).astype(np.uint8)
    db = str(tmp_path / "db")
    Database(PosixStorage(db)).new_table(
        "frames", ["frame"], [[f] for f in frames],
        codecs={"frame": "pickle"})
    local = st.Client(db_path=db, device="cuda:0")
    src = local.io.Input([st.NamedStream(local, "frames")])
    local.run(local.io.Output(local.ops.Histogram(frame=src),
                              [st.NamedStream(local, "want")]),
              st.PerfParams.manual(10, 20), show_progress=False)
    desc = local._db.table_descriptor("want")
    want = list(local._db.load_column("want", desc.columns[0].name))
    local.stop()
    m = Master(db_path=db)
    ws = [Worker(f"localhost:{m.port}", db_path=db, device="cuda:0")
          for _ in range(2)]
    sc = st.Client(db_path=db, master=f"localhost:{m.port}")
    try:
        before = cuda_ops.histogram_launches
        src = sc.io.Input([st.NamedStream(sc, "frames")])
        sc.run(sc.io.Output(sc.ops.Histogram(frame=src),
                            [st.NamedStream(sc, "gang")]),
               st.PerfParams.manual(10, 20, gang_hosts=2),
               show_progress=False)
        # two tasks, each split 10 + 10 rows over the members: at least
        # one launch per member per task, folded into this process
        assert cuda_ops.histogram_launches - before >= 4
        desc = sc._db.table_descriptor("gang")
        got = list(sc._db.load_column("gang", desc.columns[0].name))
    finally:
        sc.stop()
        for w in ws:
            w.stop()
        m.stop()
    assert len(want) == 40 and got == want


def _replica_devices():
    """Every card of the machine; two entries of cuda:0 on one card."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 \
        else [torch.device("cuda", 0)] * 2


@pytest.mark.parametrize("op", ["ObjectDetect", "PoseDetect"])
def test_data_parallel_apply_replicas_on_card(card, op):
    """A model op over DataParallelApply's replicas on the card(s),
    against the same op on one card, on uneven batches (odd rows over 2
    replicas pad one), with [model_serve]'s bounds where it applies
    them: boxes within IoU 0.9 on >= 95 % of 39 rect scenes at
    score_thresh 0.3, the blob keypoint within one heatmap cell; the
    rows gathered on cuda:0; the FLOP probe counts the whole batch
    either way."""
    import numpy as np

    from scanner_tpu_torch import models
    from scanner_tpu_torch.common import DeviceType
    from scanner_tpu_torch.graph.ops import KernelConfig
    from scanner_tpu_torch.models import detect_train as dt
    from scanner_tpu_torch.models import pose_train
    from scanner_tpu_torch.models.detection import unpack_detections
    kw = {}
    if op == "ObjectDetect":
        rng = np.random.RandomState(21)
        frames = np.stack([dt.render_rect_scene(rng)[0]
                           for _ in range(39)])
        kw = {"score_thresh": 0.3}
    else:
        clips, _, _ = pose_train.synth_batch(np.random.RandomState(0), 2,
                                             8, 48)
        frames = clips.reshape(-1, 48, 48, 3)[:13]
    first = torch.device("cuda", 0)

    def build(devices):
        return getattr(models, op)(
            KernelConfig(device=DeviceType.TPU, devices=devices), width=8,
            **kw)
    one, dp = build([first]), build(_replica_devices())
    x = torch.from_numpy(frames).to(first)
    want, got = one.execute(x), dp.execute(x)
    assert got.device == first and got.shape == want.shape
    want, got = want.cpu().numpy(), got.cpu().numpy()
    if op == "ObjectDetect":
        assert dt.boxes_agree(want, got, unpack_detections) >= 0.95
    else:
        assert np.abs(got[:, 0, :2] - want[:, 0, :2]).max() <= 1.0
    host = dp.execute(frames)
    assert isinstance(host, np.ndarray) and host.shape == want.shape
    assert one.infer_cost_flops(frames) == dp.infer_cost_flops(frames)


def test_coordinator_worker_on_card_one_rank_nccl(card, tmp_path):
    """A Worker(device="cuda:0", coordinator=...) joins a one-rank NCCL
    group before it registers, serves a Histogram job with the CPU's
    rows through the kernel, and leaves the group when stopped."""
    import socket

    import numpy as np
    import torch.distributed as dist

    import scanner_tpu_torch as st
    from scanner_tpu_torch.engine.service import Master, Worker
    from scanner_tpu_torch.parallel.distributed import (CoordinatorConfig,
                                                        is_initialized)
    from scanner_tpu_torch.storage import Database, PosixStorage
    frames = np.random.RandomState(6).randint(
        0, 256, (40, 96, 128, 3)).astype(np.uint8)
    want = cuda_ops.histogram_frames_plain(torch.from_numpy(frames)).numpy()
    db = str(tmp_path / "db")
    Database(PosixStorage(db)).new_table(
        "frames", ["frame"], [[f] for f in frames],
        codecs={"frame": "pickle"})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    m = Master(db_path=db)
    w = Worker(f"localhost:{m.port}", db_path=db, device="cuda:0",
               coordinator=CoordinatorConfig(coord, 1, 0))
    sc = st.Client(db_path=db, master=f"localhost:{m.port}")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        assert w.group_join_s > 0
        before = cuda_ops.histogram_launches
        src = sc.io.Input([st.NamedStream(sc, "frames")])
        sc.run(sc.io.Output(sc.ops.Histogram(frame=src),
                            [st.NamedStream(sc, "h")]),
               st.PerfParams.manual(8, 16), show_progress=False)
        assert cuda_ops.histogram_launches > before
        got = np.stack(list(st.NamedStream(sc, "h").load()))
        assert sc.shutdown_cluster() == 1
    finally:
        sc.stop()
        w.stop()
        m.stop()
    assert not is_initialized() and not dist.is_initialized()
    np.testing.assert_array_equal(got, want)


@pytest.fixture()
def one_rank_mesh(card):
    """A (dp, sp, tp) = (1, 1, 1) DeviceMesh over a one-rank NCCL group on
    the card, destroyed after the test."""
    import socket
    import torch.distributed as dist
    from scanner_tpu_torch.parallel import device_mesh, make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, device_id=dev)
    try:
        yield device_mesh(make_mesh({"dp": 1, "sp": 1, "tp": 1},
                                    devices=[dev]))
    finally:
        dist.destroy_process_group()


def test_sharded_placements_and_halo_on_card(one_rank_mesh):
    import numpy as np
    from scanner_tpu_torch.parallel import (replicate_to_global,
                                            shard_batch, temporal_diff)
    rows = np.random.RandomState(0).randint(0, 9999, (600, 3, 16)) \
        .astype(np.int32)
    for placed in (shard_batch(one_rank_mesh, rows),
                   replicate_to_global(one_rank_mesh, (None, "tp"), rows)):
        assert placed.to_local().is_cuda
        assert (placed.to_local().cpu().numpy() == rows).all()
    diff = temporal_diff(one_rank_mesh)(
        shard_batch(one_rank_mesh, rows, "sp")).to_local()
    assert diff.is_cuda
    np.testing.assert_array_equal(
        diff.cpu().numpy(), rows - np.concatenate([rows[:1], rows[:-1]]))


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_one_rank_on_card(one_rank_mesh, causal):
    from scanner_tpu_torch.parallel import (make_ulysses_attention,
                                            reference_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(2, 512, 4, 32, generator=g, device="cuda")
               for _ in range(3))
    got = make_ulysses_attention(one_rank_mesh, "sp", causal=causal)(q, k, v)
    torch.testing.assert_close(got, reference_attention(q, k, v, causal),
                               rtol=2e-4, atol=2e-5)


def test_pipeline_one_stage_on_card(card):
    """make_pipeline at pp 1, M 2 against its stage, and a one-stage
    pipelined VideoPoseNet against the plain layout after
    pp_params_to_plain (bf16: within 1e-2 of the output's scale)."""
    import socket
    import torch.distributed as dist
    from scanner_tpu_torch.models import pose
    from scanner_tpu_torch.models.convert import flax_params, load_params
    from scanner_tpu_torch.parallel import (device_mesh, make_mesh,
                                            make_pipeline,
                                            stack_stage_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = device_mesh(make_mesh({"dp": 1, "sp": 1, "tp": 1, "pp": 1},
                                     devices=[dev]))
        g = torch.Generator(device="cuda").manual_seed(2)
        p = {"w": torch.randn(32, 32, generator=g, device="cuda") * 0.1,
             "b": torch.randn(32, generator=g, device="cuda") * 0.1}
        x = torch.randn(8, 16, 32, generator=g, device="cuda")
        y = make_pipeline(mesh, lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                          2)(stack_stage_params([p]), x)
        torch.testing.assert_close(y, torch.tanh(x @ p["w"] + p["b"]),
                                   rtol=1e-5, atol=1e-5)
        piped = pose.init_params(0, device=dev, width=8, temporal_layers=1,
                                 pipeline_mesh=mesh)
        plain = pose.VideoPoseNet(width=8, temporal_layers=1)
        load_params(plain, pose.pp_params_to_plain(flax_params(piped)))
        clip = torch.randint(0, 256, (2, 4, 64, 64, 3), generator=g,
                             device="cuda", dtype=torch.uint8)
        with torch.no_grad():
            a, b = piped(clip), plain.to(dev)(clip)
        assert float((a - b).abs().max()) <= 1e-2 * max(
            float(b.abs().max()), 1.0)
    finally:
        dist.destroy_process_group()


def test_sharded_step_remat_and_resume_on_card(one_rank_mesh, tmp_path):
    from scanner_tpu_torch.models import pose
    from scanner_tpu_torch.models.checkpoint import TrainCheckpointer
    clip_shape = (2, 4, 64, 64, 3)
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for remat in (False, True):
            step, model, opt, (clip, target) = pose.make_sharded_train_step(
                one_rank_mesh, clip_shape=clip_shape, width=8, remat=remat)
            runs[remat] = [float(step(clip, target)) for _ in range(3)]
        ckpt = TrainCheckpointer(str(tmp_path / "ckpt"))
        ckpt.save(3, model, opt)
        want = float(step(clip, target))
        ref = pose.init_params(0, device="cuda", width=8)
        _, ref_step = pose.make_train_step(ref)
        first = float(ref_step(clip.to_local(), target.to_local()))
        step, model, opt, (clip, target) = pose.make_sharded_train_step(
            one_rank_mesh, clip_shape=clip_shape, width=8, remat=True)
        assert ckpt.restore(model, opt) == 3
        got = float(step(clip, target))
    finally:
        torch.backends.cudnn.deterministic = False
    assert runs[True] == runs[False] and runs[False][-1] < runs[False][0]
    assert abs(runs[False][0] - first) <= 1e-3 * abs(first)
    assert got == want
