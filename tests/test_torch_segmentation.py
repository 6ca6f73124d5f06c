"""Instance segmentation (roi_align, MaskTrunk, MaskHead,
InstanceSegmentor, paste_masks, InstanceSegment): the port against the
JAX package on the CPU, on the same parameters and seeded numpy inputs.

Tolerances:
  * float32: roi_align within rtol 1e-5 / atol 1e-5 (including boxes
    partly outside the feature map, clamped from the unclipped floor);
    modules within rtol 1e-4 / atol 1e-5 with random weights; with the
    shipped weights rtol 1e-4 / atol 1e-4: the trained 5x5 trunk and its
    GroupNorm carry float32 summation-order noise to about 5e-5 on mask
    logits of magnitude 5-8 (2.5e-5 on trunk features near 6.7);
  * bfloat16 (the op's dtype): module outputs within 2 % of the
    output's largest magnitude (torch_model_checks.assert_close_bf16);
    op rows on 40 64×64 shape scenes with
    the shipped weights: every JAX box met within IoU 0.9 on at least
    95 % of frames and a mean mask IoU >= 0.9 over the matched
    instances (the bounds `chip_smoke.py` holds the card to against the
    CPU).  As in test_torch_detection.py, the JAX side runs op by op;
  * paste_masks and unpack_instances: equal;
  * shipped weights through Client(device="cpu") on 12 stored scenes:
    recall >= 0.7, mask IoU >= 0.55 and the right shape kind ahead of the
    wrong one by 0.05, the bounds of tests/test_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanner_tpu.common import DeviceType
from scanner_tpu.graph.ops import KernelConfig as JConfig
from scanner_tpu.models import checkpoint as jckpt
from scanner_tpu.models import detection as jdet
from scanner_tpu.models import segmentation as jseg

import scanner_tpu_torch as st
import scanner_tpu_torch.models  # noqa: F401
from scanner_tpu_torch.graph.ops import KernelConfig as TConfig
from scanner_tpu_torch.models import seg_train as tdata
from scanner_tpu_torch.models import segmentation as tseg
from scanner_tpu_torch.models.convert import (load_params, shipped_weights,
                                              torch_state)

from torch_model_checks import (assert_matches, boxes_agree,
                                matched_mask_ious,
                                random_params, run_on_frames,
                                segment_quality,
                                stop_process_engine)  # noqa: F401

F32_TRAINED = dict(rtol=1e-4, atol=1e-4)
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _scenes(n, seed):
    rng = np.random.RandomState(seed)
    scenes = [tdata.render_shape_scene(rng) for _ in range(n)]
    return (np.stack([s[0] for s in scenes]),
            [(s[1], s[2]) for s in scenes])


def test_roi_align_matches_jax():
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 6, 5, 3).astype(np.float32)
    boxes = np.concatenate([
        np.asarray([[[0.0, 0.0, 1.0, 1.0], [0.2, 0.1, 0.7, 0.9],
                     [-0.2, 0.5, 1.3, 1.5], [0.4, 0.4, 0.4, 0.4]]]),
        rng.uniform(-0.3, 1.3, (1, 4, 4))]).astype(np.float32)
    for S in (4, 8):
        want = np.asarray(jseg.roi_align(jnp.asarray(feat),
                                         jnp.asarray(boxes), S))
        got = tseg.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                             S).numpy()
        assert got.shape == (2, 4, S, S, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mask_trunk_and_head_match_flax(dtype):
    jdt, tdt = DT[dtype]
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (2, 32, 24, 3)).astype(np.uint8)
    jm = jseg.MaskTrunk(width=8, dtype=jdt)
    p = random_params(jm, jnp.asarray(x), 0)
    tm = load_params(tseg.MaskTrunk(width=8, dtype=tdt),
                     jax.tree_util.tree_map(np.asarray, p))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).float().numpy()
    assert_matches(dtype, got, jm.apply(p, jnp.asarray(x)))
    r = rng.randn(2, 3, 8, 8, 8).astype(np.float32)
    jh = jseg.MaskHead(width=8, dtype=jdt)
    p = random_params(jh, jnp.asarray(r), 1)
    th = load_params(tseg.MaskHead(8, width=8, dtype=tdt),
                     jax.tree_util.tree_map(np.asarray, p))
    with torch.no_grad():
        got = th(torch.from_numpy(r))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 16, 16)
    assert_matches(dtype, got.numpy(), jh.apply(p, jnp.asarray(r)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_instance_segmentor_matches_flax(dtype):
    jdt, tdt = DT[dtype]
    rng = np.random.RandomState(2)
    x = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    rois = rng.uniform(0, 1, (2, tseg.TOP_K, 4)).astype(np.float32)
    jm = jseg.InstanceSegmentor(width=8, dtype=jdt)
    p = random_params(jm, jnp.asarray(x), 3)
    want = jm.apply(p, jnp.asarray(x), jnp.asarray(rois))
    tm = load_params(tseg.InstanceSegmentor(width=8, dtype=tdt),
                     jax.tree_util.tree_map(np.asarray, p))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(rois))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert_matches(dtype, a.numpy(), b)


def test_shipped_weights_load_whole_and_restore_at_f32():
    """seg_w8.npz fills the module (keys under params/backbone,
    det_head, mask_trunk, mask_head, as flax's setup() names them), and
    load_params of the JAX package's init_or_restore tree gives the JAX
    outputs at f32."""
    flat = dict(np.load(shipped_weights("seg_w8.npz")))
    assert len(torch_state(flat, tseg.InstanceSegmentor(width=8))) \
        == len(flat) == 78
    x = np.random.RandomState(3).randint(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    jm = jseg.InstanceSegmentor(width=8, dtype=jnp.float32)
    params = jckpt.init_or_restore(jm, jax.random.PRNGKey(3),
                                   jnp.zeros((1, 128, 128, 3), jnp.uint8),
                                   jckpt.shipped_weights("seg_w8.npz"))
    rois = np.random.RandomState(4).uniform(0, 1, (2, tseg.TOP_K, 4)) \
        .astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(rois))
    tm = load_params(tseg.InstanceSegmentor(width=8, dtype=torch.float32),
                     jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(rois))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TRAINED)


def test_unpack_and_paste_match_jax():
    rng = np.random.RandomState(5)
    row = rng.uniform(0, 1, (tseg.TOP_K, 6 + tseg.MASK_SIZE ** 2)) \
        .astype(np.float32)
    row[:, :4] = np.sort(row[:, :4].reshape(-1, 2, 2), axis=1) \
        .transpose(0, 2, 1).reshape(-1, 4)
    row[::3, 5] = 0.0
    a, b = tseg.unpack_instances(row), jseg.unpack_instances(row)
    for k in ("boxes", "scores", "masks"):
        np.testing.assert_array_equal(a[k], b[k])
    for h, w in [(64, 64), (37, 53)]:
        np.testing.assert_array_equal(
            tseg.paste_masks(a["boxes"], a["masks"], h, w),
            jseg.paste_masks(b["boxes"], b["masks"], h, w))


def test_op_matches_jax_on_shipped_weights():
    frames, _ = _scenes(40, 6)
    jk = jseg.InstanceSegment(JConfig(device=DeviceType.CPU), width=8,
                              score_thresh=0.3)
    anchors = jnp.asarray(jdet.make_anchors(4, 4))

    def fwd(mdl, images):
        cls, deltas = mdl.detect(images)
        packed, sel = jdet.pack_detections(cls, deltas, anchors, 0.3,
                                           top_k=jseg.TOP_K)
        mask = jax.nn.sigmoid(mdl.roi_masks(images, sel))
        return jnp.concatenate(
            [packed, mask.reshape(len(images), jseg.TOP_K, -1)], axis=-1)
    want = np.asarray(jk.model.apply(jk.params, jnp.asarray(frames),
                                     method=fwd))
    got = tseg.InstanceSegment(TConfig(device=DeviceType.CPU), width=8,
                               score_thresh=0.3).execute(frames)
    assert isinstance(got, np.ndarray) and got.shape == want.shape \
        == (40, tseg.TOP_K, 6 + tseg.MASK_SIZE ** 2)
    assert boxes_agree(want, got, tseg.unpack_instances) >= 0.95
    ious = matched_mask_ious(want, got)
    assert len(ious) >= 40 and np.mean(ious) >= 0.9


def test_shipped_weights_segment_through_client(tmp_path):
    """The shipped weights localize synthetic shapes AND recover their
    silhouettes: the right shape kind's mask beats the wrong kind's (a
    full-box mask cannot pass: IoU(box, inscribed ellipse) = pi/4)."""
    frames, truth = _scenes(12, 31)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        rows = run_on_frames(sc, st, "shapes", frames, "InstanceSegment",
                             "inst", width=8, score_thresh=0.3)
    finally:
        sc.stop()
    assert len(rows) == 12
    assert rows[0].shape == (tseg.TOP_K, 6 + tseg.MASK_SIZE ** 2)
    matched, total, iou_c, iou_w = segment_quality(rows, truth)
    assert total >= 12
    assert matched >= 0.7 * total, f"recall {matched}/{total}"
    assert iou_c >= 0.55, f"mask IoU too low: {iou_c:.2f}"
    assert iou_c > iou_w + 0.05, (iou_c, iou_w)


def test_infer_cost_flops_match_jax():
    """FLOPs of one call, the port's flop counter against XLA's cost
    analysis: within the bound of tests/test_torch_detection.py (5 %;
    measured 1.0016 on the CPU at 2 frames of 64 x 64, width 8)."""
    frames = np.random.RandomState(7).randint(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    want = jseg.InstanceSegment(JConfig(device=DeviceType.CPU),
                                width=8).infer_cost_flops(frames)
    got = tseg.InstanceSegment(TConfig(device=DeviceType.CPU),
                               width=8).infer_cost_flops(frames)
    assert want and got
    assert abs(got / want - 1.0) <= 0.05
