"""The pose model family: the port against the JAX package on the CPU, on
the same parameters (converted by scanner_tpu_torch.models.convert) and
the same numpy inputs.

Tolerances:
  * float32 (dtype=float32 modules): rtol 1e-4, atol 1e-5.  Both
    packages compute the same f32 formulas and differ only in summation
    order (the whole VideoPoseNet agrees to about 1e-6);
  * bfloat16 (the default dtype): rtol 1e-2, atol 1e-2 of values of
    order one.  bf16 keeps 8 significant bits (one rounding is up to
    2^-9 relative), and the two frameworks may round at different places
    (fused bias adds, reductions); the largest difference seen is half an
    ulp of a value near 3 (0.0078, TemporalBlock);
  * two Adam train steps at f32: losses equal within rel 1e-4;
  * PoseDetect with the shipped weights (bf16, trained weights that
    amplify rounding more than random ones): the blob keypoint within
    one heatmap cell and every score within 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scanner_tpu.models  # noqa: F401  (registers the JAX model ops)
from scanner_tpu.common import DeviceType
from scanner_tpu.graph.ops import KernelConfig, registry as jregistry
from scanner_tpu.models import nets as jn
from scanner_tpu.models import pose as jpose

import scanner_tpu_torch as st
from scanner_tpu_torch.models import nets as tn
from scanner_tpu_torch.models import pose as tpose
from scanner_tpu_torch.models import pose_train as ttrain
from scanner_tpu_torch.models.convert import (load_npz, load_params,
                                              shipped_weights, torch_state)
from torch_model_checks import stop_process_engine  # noqa: F401

TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
SHIPPED = "pose_blobnet_w8.npz"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers,
    and torch's default of one thread per core oversubscribes the host
    (timing-sensitive tests in other workers feel it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# name -> (flax module, torch module, input, torch-side layout wrapper)
def _case(name, jdt, tdt, rng):
    if name == "resblock":
        x = rng.randn(2, 8, 8, 16).astype(np.float32)
        return (jn.ResBlock(16, dtype=jdt), tn.ResBlock(16, 16, 1, tdt), x,
                "nchw")
    if name == "resblock_stride2":
        x = rng.randn(2, 8, 8, 8).astype(np.float32)
        return (jn.ResBlock(16, stride=2, dtype=jdt),
                tn.ResBlock(8, 16, 2, tdt), x, "nchw")
    if name == "backbone":
        x = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        return jn.Backbone(width=8, dtype=jdt), tn.Backbone(8, dtype=tdt), \
            x, None
    if name == "moe":
        x = rng.randn(2, 4, 32).astype(np.float32)
        return jn.MoEMlp(dtype=jdt), tn.MoEMlp(32, dtype=tdt), x, None
    if name == "temporal":
        x = rng.randn(2, 4, 32).astype(np.float32)
        return (jn.TemporalBlock(dtype=jdt), tn.TemporalBlock(32, dtype=tdt),
                x, None)
    if name == "deconv":
        x = rng.randn(2, 3, 2, 32).astype(np.float32)
        return (jn.DeconvHead(dtype=jdt), tn.DeconvHead(32, dtype=tdt), x,
                None)
    x = rng.randint(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8)
    return (jpose.VideoPoseNet(width=8, dtype=jdt),
            tpose.VideoPoseNet(width=8, dtype=tdt), x, None)


MODULES = ["resblock", "resblock_stride2", "backbone", "moe", "temporal",
           "deconv", "videoposenet"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", MODULES)
def test_module_matches_flax(name, dtype):
    jdt, tdt = DT[dtype]
    rng = np.random.RandomState(MODULES.index(name))
    jm, tm, x, layout = _case(name, jdt, tdt, rng)
    xin = jnp.asarray(x) if x.dtype == np.uint8 else jnp.asarray(x, jdt)
    params = jm.init(jax.random.PRNGKey(1), xin)
    want = np.asarray(jax.jit(jm.apply)(params, xin), np.float32)
    load_params(tm, jax.tree_util.tree_map(np.asarray, params))
    tx = torch.from_numpy(x)
    if tx.dtype != torch.uint8:
        tx = tx.to(tdt)
    with torch.no_grad():
        if layout == "nchw":
            got = tm(_nchw(x).to(tdt)).permute(0, 2, 3, 1)
        else:
            got = tm(tx)
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_converter_loads_shipped_weights_and_names_bad_keys():
    path = shipped_weights(SHIPPED)
    flat = dict(np.load(path))
    assert len(flat) == 88
    model = tpose.VideoPoseNet(width=8)
    load_npz(model, path)
    assert len(list(model.parameters())) == 88
    w = flat["params/Backbone_0/Conv_0/kernel"]          # HWIO
    np.testing.assert_array_equal(
        model.Backbone_0.Conv_0.weight.detach().numpy(),
        w.transpose(3, 2, 0, 1))
    bad = dict(flat)
    bad["params/film/kernel"] = np.zeros((32, 31), np.float32)
    with pytest.raises(ValueError, match="params/film/kernel"):
        torch_state(bad, model)
    del bad["params/film/kernel"]
    with pytest.raises(KeyError, match="params/film/kernel"):
        torch_state(bad, model)
    with pytest.raises(ValueError, match="params/Backbone_0/Conv_0/kernel"):
        torch_state(flat, tpose.VideoPoseNet(width=16))


def test_two_train_steps_match_optax():
    """Two Adam steps at f32 from the same parameters on the same
    batches: the second loss depends on the first step's gradients and
    update, so the backward pass and the optimizer are pinned too."""
    rng = np.random.RandomState(0)
    batches = [ttrain.synth_batch(rng, 2, 4, 32)[:2] for _ in range(2)]
    jmodel, params = jpose.init_params(jax.random.PRNGKey(0),
                                       clip_shape=(1, 4, 32, 32, 3),
                                       width=8, dtype=jnp.float32)
    tmodel = tpose.VideoPoseNet(width=8, dtype=torch.float32)
    load_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    opt, jstep = jpose.make_train_step(jmodel)
    jstep = jax.jit(jstep)
    state = opt.init(params)
    _, tstep = tpose.make_train_step(tmodel)
    for clip, target in batches:
        params, state, jl = jstep(params, state, jnp.asarray(clip),
                                  jnp.asarray(target))
        tl = tstep(torch.from_numpy(clip), torch.from_numpy(target))
        assert float(tl) == pytest.approx(float(jl), rel=1e-4)


def test_heatmaps_to_keypoints_matches_jax():
    heat = np.random.RandomState(2).rand(12, 12, 17).astype(np.float32)
    np.testing.assert_array_equal(tpose.heatmaps_to_keypoints(heat),
                                  jpose.heatmaps_to_keypoints(heat))


def _blob_frames(n, seed=7):
    rng = np.random.RandomState(seed)
    x0, y0 = rng.uniform(8, ttrain.SIZE - 8, 2)
    frames, centers = [], []
    for t in range(n):
        cx = float(np.clip(x0 + 1.2 * t, 4, ttrain.SIZE - 4))
        cy = float(np.clip(y0 - 0.8 * t, 4, ttrain.SIZE - 4))
        frames.append(ttrain.render_blob_frame(ttrain.SIZE, ttrain.SIZE,
                                               cx, cy, rng))
        centers.append((cx, cy))
    return np.stack(frames), np.asarray(centers, np.float32)


def test_pose_detect_shipped_weights_match_jax(tmp_path):
    """PoseDetect(width=8) with the shipped weights through the port's
    Client(device="cpu") against the JAX PoseDetect on the same frames;
    the port localizes the blob under 5 px mean error
    (tests/test_models.py's bound)."""
    frames, centers = _blob_frames(12)
    jk = jregistry.get("PoseDetect").kernel_factory(
        KernelConfig(device=DeviceType.TPU), width=8)
    want = np.asarray(jk.execute(frames))                 # (N, K, 3)

    import scanner_tpu_torch.models  # noqa: F401  (registers PoseDetect)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        sc.new_table("blob", ["frame"], [[f] for f in frames],
                     codecs={"frame": "pickle"})
        poses = sc.ops.PoseDetect(
            frame=sc.io.Input([st.NamedStream(sc, "blob")]), width=8)
        out = st.NamedStream(sc, "poses")
        sc.run(sc.io.Output(poses, [out]), st.PerfParams.manual(8, 16),
               cache_mode=st.CacheMode.Overwrite, show_progress=False)
        got = np.stack(list(out.load()))
    finally:
        sc.stop()
    assert got.shape == want.shape == (12, 17, 3)
    assert np.abs(got[:, 0, :2] - want[:, 0, :2]).max() <= 1.0
    np.testing.assert_allclose(got[:, :, 2], want[:, :, 2], rtol=0,
                               atol=3e-2)
    err = np.hypot(got[:, 0, 0] * 4 - centers[:, 0],
                   got[:, 0, 1] * 4 - centers[:, 1])
    assert err.mean() < 5.0, f"mean error {err.mean():.2f}px"


def test_train_pose_runs_on_cpu_with_ring_attention():
    """train_pose on the CPU with the "cuda" ring (its plain path on CPU
    tensors): finite, decreasing loss over a few steps."""
    from scanner_tpu_torch.parallel import make_ring_attention
    model, loss = ttrain.train_pose(steps=3, batch=2, time=4, size=32,
                                    width=8, log_every=0,
                                    attn_fn=make_ring_attention(impl="cuda"),
                                    device="cpu")
    assert np.isfinite(loss)
    assert next(model.parameters()).device.type == "cpu"
