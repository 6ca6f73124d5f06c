"""The detection family (ObjectDetect, FaceDetect): the port against the
JAX package on the CPU, on the same parameters (converted by
scanner_tpu_torch.models.convert) and the same seeded numpy inputs.

Tolerances:
  * float32: box decode, packing and whole SSDDetector outputs within
    rtol 1e-4 / atol 1e-5 (the same f32 formulas, summed in another
    order); NMS on the same boxes and scores selects the same indices
    and scores, exactly;
  * bfloat16 (the ops' dtype): module outputs within 2 % of the
    output's largest magnitude (torch_model_checks.assert_close_bf16:
    the frameworks round at other places, and each one's bf16 output is
    1.5 % of that scale from its own float32 output); op
    rows on 40 64×64 scenes with the shipped weights: every JAX box met
    by a port box within IoU 0.9 on at least 95 % of frames (near-tied
    bf16 scores may reorder NMS on a frame, as between the card and the
    CPU).  The JAX side runs its model op by op (`apply`, then
    `pack_detections`): under `jit` XLA keeps excess precision inside
    fusions, and on these scenes the JAX package's own jitted op and its
    op-by-op run agree on only 85–90 % of frames by this measure;
  * shipped weights through Client(device="cpu") on 12 stored scenes:
    recall >= 0.7 at IoU 0.3, the bound of tests/test_models.py (which
    reads the scenes through the video codec; here they are stored
    frames).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scanner_tpu.models  # noqa: F401  (registers the JAX model ops)
from scanner_tpu.common import DeviceType
from scanner_tpu.graph.ops import KernelConfig as JConfig
from scanner_tpu.models import checkpoint as jckpt
from scanner_tpu.models import detection as jdet
from scanner_tpu.models import face as jface

import scanner_tpu_torch as st
import scanner_tpu_torch.models  # noqa: F401
from scanner_tpu_torch.engine.executor import LocalExecutor
from scanner_tpu_torch.graph.ops import KernelConfig as TConfig
from scanner_tpu_torch.models import detect_train as tdata
from scanner_tpu_torch.models import detection as tdet
from scanner_tpu_torch.models import face as tface
from scanner_tpu_torch.models.convert import (load_params, shipped_weights,
                                              torch_state)
from scanner_tpu_torch.util.profiler import Profiler

from torch_model_checks import (assert_matches, boxes_agree,
                                random_params, recall, run_on_frames,
                                stop_process_engine)  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _scenes(renderer, n, seed):
    rng = np.random.RandomState(seed)
    scenes = [renderer(rng) for _ in range(n)]
    return np.stack([s[0] for s in scenes]), [s[1] for s in scenes]


def test_make_anchors_matches_jax():
    for fh, fw in [(4, 4), (30, 40), (3, 5)]:
        np.testing.assert_array_equal(tdet.make_anchors(fh, fw),
                                      jdet.make_anchors(fh, fw))


def test_decode_boxes_matches_jax():
    rng = np.random.RandomState(0)
    anchors = jdet.make_anchors(4, 6)
    deltas = (rng.randn(3, len(anchors), 4) * 3).astype(np.float32)
    want = np.asarray(jdet.decode_boxes(jnp.asarray(anchors),
                                        jnp.asarray(deltas)))
    got = tdet.decode_boxes(torch.from_numpy(anchors),
                            torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("top_k", [32, 8])
def test_batched_nms_matches_jax(top_k):
    """Random boxes and scores, a row of exact ties (the first maximum
    wins in both), and a row whose scores are all -1 (index -1, score 0
    at every step)."""
    rng = np.random.RandomState(top_k)
    B, N = 4, 60
    yx = rng.uniform(0, 0.8, (B, N, 2))
    hw = rng.uniform(0.05, 0.4, (B, N, 2))
    boxes = np.concatenate([yx, np.minimum(yx + hw, 1.0)], -1) \
        .astype(np.float32)
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    scores[1, ::3] = 0.75
    scores[2] = -1.0
    jidx, jsc = jdet.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                 top_k=top_k)
    tidx, tsc = tdet.batched_nms(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), top_k=top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    assert (tidx[2] == -1).all() and (tsc[2] == 0).all()


def test_pack_and_unpack_match_jax():
    rng = np.random.RandomState(3)
    anchors = jdet.make_anchors(4, 4)
    cls = rng.randn(2, len(anchors), 2).astype(np.float32) * 2
    deltas = rng.randn(2, len(anchors), 4).astype(np.float32)
    cls[1] = [-9.0, 9.0]          # every anchor ties: first wins
    jp, jsel = jdet.pack_detections(jnp.asarray(cls), jnp.asarray(deltas),
                                    jnp.asarray(anchors), 0.3)
    tp, tsel = tdet.pack_detections(torch.from_numpy(cls),
                                    torch.from_numpy(deltas),
                                    torch.from_numpy(anchors), 0.3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **F32)
    np.testing.assert_allclose(tsel.numpy(), np.asarray(jsel), **F32)
    np.testing.assert_array_equal(tp[..., 5].numpy(), np.asarray(jp)[..., 5])
    for row in np.asarray(jp):
        a, b = tdet.unpack_detections(row), jdet.unpack_detections(row)
        for k in ("boxes", "scores"):
            np.testing.assert_array_equal(a[k], b[k])
    d = {"boxes": [[0, 0, 1, 1]], "scores": [0.5]}
    np.testing.assert_array_equal(tdet.unpack_detections(d)["boxes"],
                                  jdet.unpack_detections(d)["boxes"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_detector_matches_flax(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.RandomState(1).randint(0, 256, (2, 64, 48, 3)) \
        .astype(np.uint8)
    jm = jdet.SSDDetector(width=8, dtype=jdt)
    params = random_params(jm, jnp.asarray(x), 0)
    jcls, jbox = jm.apply(params, jnp.asarray(x))
    tm = load_params(tdet.SSDDetector(width=8, dtype=tdt),
                     jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        tcls, tbox = tm(torch.from_numpy(x))
    assert tcls.dtype == tbox.dtype == torch.float32
    assert_matches(dtype, tcls.numpy(), jcls)
    assert_matches(dtype, tbox.numpy(), jbox)


@pytest.mark.parametrize("name", ["detect_ssd_w8.npz", "face_ssd_w8.npz"])
def test_shipped_weights_load_whole(name):
    """Every key of the shipped file lands in the module: none missing,
    none mis-shaped, none left over."""
    flat = dict(np.load(shipped_weights(name)))
    state = torch_state(flat, tdet.SSDDetector(width=8))
    assert len(state) == len(flat) == 60


def test_restored_tree_matches_at_f32():
    """load_params of the JAX package's init_or_restore tree (the shipped
    file restored onto a flax template) gives the JAX outputs at f32."""
    x = np.random.RandomState(2).randint(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    jm = jdet.SSDDetector(width=8, dtype=jnp.float32)
    params = jckpt.init_or_restore(jm, jax.random.PRNGKey(0),
                                   jnp.zeros((1, 128, 128, 3), jnp.uint8),
                                   jckpt.shipped_weights("detect_ssd_w8.npz"))
    want = jm.apply(params, jnp.asarray(x))
    tm = load_params(tdet.SSDDetector(width=8, dtype=torch.float32),
                     jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


@pytest.mark.parametrize("op", ["ObjectDetect", "FaceDetect"])
def test_op_matches_jax_on_shipped_weights(op):
    renderer = tdata.render_rect_scene if op == "ObjectDetect" \
        else tdata.render_face_scene
    frames, _ = _scenes(renderer, 40, 5)
    jk = getattr(jdet if op == "ObjectDetect" else jface, op)(
        JConfig(device=DeviceType.CPU), width=8, score_thresh=0.3)
    tk = getattr(tdet if op == "ObjectDetect" else tface, op)(
        TConfig(device=DeviceType.CPU), width=8, score_thresh=0.3)
    cls, deltas = jk.model.apply(jk.params, jnp.asarray(frames))
    want, _ = jdet.pack_detections(cls, deltas,
                                   jnp.asarray(jdet.make_anchors(4, 4)), 0.3)
    want = np.asarray(want)
    got = tk.execute(frames)
    assert isinstance(got, np.ndarray) and got.shape == want.shape \
        == (40, tdet.TOP_K, 6)
    assert boxes_agree(want, got, tdet.unpack_detections) >= 0.95


@pytest.mark.parametrize("op,seed", [("ObjectDetect", 21),
                                     ("FaceDetect", 22)])
def test_shipped_weights_localize_through_client(tmp_path, op, seed):
    """The reference app semantics: the shipped weights by default at
    width 8 find the scenes' objects (recall >= 0.7 at IoU 0.3); the
    staged tensor path (the card's path, here on CPU tensors) stores the
    same rows."""
    renderer = tdata.render_rect_scene if op == "ObjectDetect" \
        else tdata.render_face_scene
    frames, truth = _scenes(renderer, 12, seed)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        rows = run_on_frames(sc, st, "scenes", frames, op, "dets",
                             width=8, score_thresh=0.3)
        assert len(rows) == 12 and rows[0].shape == (tdet.TOP_K, 6)
        hits, total = recall(rows, truth, tdet.unpack_detections)
        assert total >= 12
        assert hits >= 0.7 * total, f"recall {hits}/{total}"
        src = sc.io.Input([st.NamedStream(sc, "scenes")])
        col = getattr(sc.ops, op)(frame=src, width=8, score_thresh=0.3)
        ex = LocalExecutor(sc._db, Profiler(), torch.device("cpu"),
                           stage=True)
        ex.run([sc.io.Output(col, [st.NamedStream(sc, "dets_staged")])],
               st.PerfParams.manual(8, 16))
        staged = list(st.NamedStream(sc, "dets_staged").load())
        np.testing.assert_array_equal(np.stack(staged), np.stack(rows))
    finally:
        sc.stop()


def test_model_ops_refuse_several_devices():
    from scanner_tpu_torch.models.infer import DataParallelApply
    with pytest.raises(NotImplementedError, match="Queue A.7b"):
        DataParallelApply(torch.nn.Identity(), ["cpu", "cpu"])
    dp = DataParallelApply(torch.nn.Identity(), [])
    with pytest.raises(ValueError, match="model on cpu"):
        dp(torch.zeros(1, device="meta"))


# FLOPs of one call (the MFU probe): the port counts with
# torch.utils.flop_counter (convolutions and matrix products, 2 per
# multiply-add); the JAX package asks XLA's cost analysis, which also
# counts elementwise work (activations, casts, the decode) but folds
# some of it away.  On 2 frames of 64 x 64 at width 8 the two read
# within 2 % of each other (measured on the CPU: ObjectDetect and
# FaceDetect 1.0198, FaceEmbedding 0.9853, InstanceSegment 1.0016), so
# the bound is 5 %.
FLOPS_RATIO_BOUND = 0.05


@pytest.mark.parametrize("op", ["ObjectDetect", "FaceDetect"])
def test_infer_cost_flops_match_jax(op):
    frames = np.random.RandomState(5).randint(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    jmod, tmod = {"ObjectDetect": (jdet, tdet),
                  "FaceDetect": (jface, tface)}[op]
    want = getattr(jmod, op)(JConfig(device=DeviceType.CPU),
                             width=8).infer_cost_flops(frames)
    got = getattr(tmod, op)(TConfig(device=DeviceType.CPU),
                            width=8).infer_cost_flops(frames)
    assert want and got
    assert abs(got / want - 1.0) <= FLOPS_RATIO_BOUND
