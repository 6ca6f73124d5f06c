"""The port's train loops and checkpointer (models/{pose_train,
detect_train,seg_train,checkpoint}.py) against the JAX package's, on the
CPU.

Each of train_pose, train_detector, train_embedding and train_segmenter
runs in both packages at size 32, width 8, batch 2 for 3 steps, from the
same initial parameters (the JAX loop's own flax init, captured and put
in place of the port loop's `_initial_*` helper through
convert.load_params) on the same batches (np.random.RandomState(seed) in
the reference's order).  Both run their models at float32: in bfloat16
(the models' default) the two packages round gradients at other places,
and Adam's first update, lr * g / (|g| + eps), is +-lr for any gradient
whatever its size, so a parameter whose gradient is rounding noise moves
by lr one way or the other, and the losses part from the second step on.
At float32:

  * per-step losses, read from each loop's log record at log_every=1,
    within rel 1e-3;
  * the trained parameters: 99 % of the entries within atol 1e-5 (the
    same f32 formulas summed in another order), every entry within
    6.06e-3.  A convolution's bias that a GroupNorm of one channel per
    group follows has a zero gradient in exact arithmetic; its rounding
    noise still drives Adam, whose step moves a parameter by at most
    ~1.01 lr over three steps (Cauchy-Schwarz on m_hat / sqrt(v_hat)),
    so such a bias may move 3 lr one way in one package and the other way
    in the other.  The normalisation removes it from every output, so the
    two trained models' outputs agree within rtol 1e-4 / atol 1e-5;
  * the port's exported `.npz` loads through the JAX package's
    import_params_npz, and both models' forward outputs on it agree
    within rtol 1e-4 / atol 1e-5 (torch_model_checks.assert_matches);
  * the JAX loop's orbax directory handed to the port's model op raises
    the ValueError that names the route (export_params_npz).

Then the TrainCheckpointer itself: save, restore bit for bit (parameters
and Adam state, and the next step after it), latest_step, pruning past
max_to_keep, a half-written step that stays invisible, the errors, and
the `.npz` export's layouts inverse to the converter's.  Last, each
trainer's command line for one step on the CPU, and the mp4 helpers
(libav) against the JAX package's ground truth.  About 80 s in one
process, most of it flax's first init and the JAX loops' compiles.
"""

import contextlib
import functools
import logging
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanner_tpu.common import DeviceType
from scanner_tpu.models import checkpoint as jckpt
from scanner_tpu.models import detect_train as jdt
from scanner_tpu.models import detection as jdet
from scanner_tpu.models import face as jface
from scanner_tpu.models import pose as jpose
from scanner_tpu.models import pose_train as jpt
from scanner_tpu.models import seg_train as jst
from scanner_tpu.models import segmentation as jseg

from scanner_tpu_torch.graph.ops import KernelConfig as TConfig
from scanner_tpu_torch.models import checkpoint as tckpt
from scanner_tpu_torch.models import convert
from scanner_tpu_torch.models import detect_train as tdt
from scanner_tpu_torch.models import detection as tdet
from scanner_tpu_torch.models import face as tface
from scanner_tpu_torch.models import pose as tpose
from scanner_tpu_torch.models import pose_train as tpt
from scanner_tpu_torch.models import seg_train as tst
from scanner_tpu_torch.models import segmentation as tseg
from torch_model_checks import assert_matches

SIZE, WIDTH, BATCH, STEPS = 32, 8, 2, 3
LOSS_RTOL, PARAM_ATOL, PARAM_SHARE = 1e-3, 1e-5, 0.99
PARAM_BOUND = 2 * STEPS * 1e-3 * 1.01   # two Adam runs apart, lr 1e-3
F32 = dict(dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def step_losses(logger):
    """The loss of each logged step of `logger` (its record's last
    argument, unformatted)."""
    losses = []

    class Keep(logging.Handler):
        def emit(self, record):
            losses.append(float(record.args[-1]))

    log = logging.getLogger(logger)
    handler, level = Keep(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        yield losses
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


@pytest.fixture()
def flax_init(monkeypatch):
    """The parameters of every flax init the JAX loop makes, in order."""
    inits = []
    real = fnn.Module.init

    def init(self, *args, **kw):
        params = real(self, *args, **kw)
        inits.append(jax.tree_util.tree_map(np.asarray, params))
        return params

    monkeypatch.setattr(fnn.Module, "init", init)
    return inits


def _run_both(monkeypatch, flax_init, jax_model, run_jax, helper,
              make_port, run_port):
    """Run the JAX loop with the flax module `jax_model` = (module, name)
    at float32, then the port's from the JAX loop's initial parameters;
    returns the JAX parameters."""
    mod, name = jax_model
    monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                     dtype=jnp.float32))
    with step_losses("scanner_tpu.train") as jl:
        run_jax()
    params = flax_init[0]

    def initial(seed, *args):
        model = make_port()
        convert.load_params(model, params)
        return model

    monkeypatch.setattr(*helper, initial)
    with step_losses("scanner_tpu_torch.train") as tl:
        run_port()
    assert len(jl) == len(tl) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    return params


def _params_close(got: dict, want: dict):
    assert set(got) == set(want)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert float(diff.max()) <= PARAM_BOUND, float(diff.max())
    share = float((diff <= PARAM_ATOL).mean())
    assert share >= PARAM_SHARE, share


def _flat_npz(path):
    with np.load(path) as data:
        return dict(data)


def _jax_reads_port_npz(npz, template, apply_jax, port_model, inputs,
                        jax_trained):
    """The port's `.npz` through the JAX package's import_params_npz:
    the JAX model on it gives the port model's outputs, and so does the
    JAX model on the JAX loop's own trained parameters."""
    tckpt.load_params(npz, port_model)
    with torch.no_grad():
        got = port_model(*[torch.from_numpy(x) for x in inputs])
    got = got if isinstance(got, tuple) else (got,)
    for params in (jckpt.import_params_npz(npz, template), jax_trained):
        want = apply_jax(params, *[jnp.asarray(x) for x in inputs])
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert_matches("f32", g.numpy(), np.asarray(w))


def _orbax_refused(op, ckpt):
    with pytest.raises(ValueError, match="export_params_npz"):
        op(TConfig(device=DeviceType.CPU), width=WIDTH, checkpoint_dir=ckpt)


def _frames(n=2, seed=9):
    return np.random.RandomState(seed).randint(
        0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


def test_train_pose_matches_jax(tmp_path, monkeypatch, flax_init):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(steps=STEPS, batch=BATCH, time=2, size=SIZE, width=WIDTH,
              log_every=1)
    params = _run_both(
        monkeypatch, flax_init, (jpt, "init_params"),
        lambda: jpt.train_pose(jdir, **kw), (tpt, "_initial_state"),
        lambda: tpose.VideoPoseNet(width=WIDTH, **F32),
        lambda: tpt.train_pose(tdir, **kw, device="cpu"))
    trained = tckpt.load_params(tdir, tpose.VideoPoseNet(width=WIDTH, **F32))
    jtrained = jckpt.load_params(jdir, params)
    _params_close(convert.flax_params(trained),
                  convert.flatten_params(jax.tree_util.tree_map(
                      np.asarray, jtrained)))
    npz = str(tmp_path / "pose.npz")
    tckpt.export_params_npz(trained, npz)
    clip = _frames(4).reshape(2, 2, SIZE, SIZE, 3)
    _jax_reads_port_npz(
        npz, params, jpose.VideoPoseNet(width=WIDTH, dtype=jnp.float32).apply,
        tpose.VideoPoseNet(width=WIDTH, **F32), [clip], jtrained)
    _orbax_refused(tpose.PoseDetect, jdir)


def test_train_detector_matches_jax(tmp_path, monkeypatch, flax_init):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jnpz, tnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    kw = dict(steps=STEPS, batch=BATCH, size=SIZE, width=WIDTH,
              log_every=1)
    params = _run_both(
        monkeypatch, flax_init, (jdet, "SSDDetector"),
        lambda: jdt.train_detector(jdir, export_npz=jnpz, **kw),
        (tdt, "_initial_detector"),
        lambda: tdet.SSDDetector(num_classes=2, width=WIDTH, **F32),
        lambda: tdt.train_detector(tdir, export_npz=tnpz, **kw,
                                   device="cpu"))
    _params_close(_flat_npz(tnpz), _flat_npz(jnpz))
    _jax_reads_port_npz(
        tnpz, params, jdet.SSDDetector(num_classes=2, width=WIDTH,
                                      dtype=jnp.float32).apply,
        tdet.SSDDetector(num_classes=2, width=WIDTH, **F32), [_frames()],
        jckpt.import_params_npz(jnpz, params))
    _orbax_refused(tdet.ObjectDetect, jdir)


def test_train_embedding_matches_jax(tmp_path, monkeypatch, flax_init):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jnpz, tnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    seed, dim, ids = 2, 128, 16
    kw = dict(steps=STEPS, batch=BATCH, size=SIZE, width=WIDTH, dim=dim,
              identities=ids, seed=seed, log_every=1)
    # the JAX loop's classifier: normal(split(PRNGKey(seed))[0]) * 0.05
    w_cls = np.array(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(seed))[0], (dim, ids)) * 0.05)

    def port_model():
        model = tdt.EmbeddingTraining(dim, WIDTH, ids, **F32)
        with torch.no_grad():
            model.w_cls.copy_(torch.from_numpy(w_cls))
        return model

    params = _run_both(
        monkeypatch, flax_init, (jface, "EmbeddingNet"),
        lambda: jdt.train_embedding(jdir, export_npz=jnpz, **kw),
        (tdt, "_initial_embedding"), port_model,
        lambda: tdt.train_embedding(tdir, export_npz=tnpz, **kw,
                                    device="cpu"))
    _params_close(_flat_npz(tnpz), _flat_npz(jnpz))
    _jax_reads_port_npz(tnpz, params,
                        jface.EmbeddingNet(dim=dim, width=WIDTH,
                                           dtype=jnp.float32).apply,
                        tface.EmbeddingNet(dim=dim, width=WIDTH, **F32),
                        [_frames()], jckpt.import_params_npz(jnpz, params))
    # the checkpoint also holds the classifier; FaceEmbedding restores
    # the net without it
    served = tface.FaceEmbedding(TConfig(device=DeviceType.CPU),
                                 width=WIDTH, checkpoint_dir=tdir)
    np.testing.assert_array_equal(
        served.execute(_frames()),
        tface.FaceEmbedding(TConfig(device=DeviceType.CPU), width=WIDTH,
                            checkpoint_dir=tnpz).execute(_frames()))
    _orbax_refused(tface.FaceEmbedding, jdir)


def test_train_segmenter_matches_jax(tmp_path, monkeypatch, flax_init):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jnpz, tnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    kw = dict(steps=STEPS, batch=BATCH, size=SIZE, width=WIDTH,
              log_every=1)
    params = _run_both(
        monkeypatch, flax_init, (jseg, "InstanceSegmentor"),
        lambda: jst.train_segmenter(jdir, export_npz=jnpz, **kw),
        (tst, "_initial_segmenter"),
        lambda: tseg.InstanceSegmentor(num_classes=2, width=WIDTH, **F32),
        lambda: tst.train_segmenter(tdir, export_npz=tnpz, **kw,
                                    device="cpu"))
    _params_close(_flat_npz(tnpz), _flat_npz(jnpz))
    rois = np.asarray([[[0.1, 0.2, 0.6, 0.7], [0.3, 0.1, 0.9, 0.5]]] * 2,
                      np.float32)
    _jax_reads_port_npz(
        tnpz, params, jseg.InstanceSegmentor(num_classes=2, width=WIDTH,
                                             dtype=jnp.float32).apply,
        tseg.InstanceSegmentor(num_classes=2, width=WIDTH, **F32),
        [_frames(), rois], jckpt.import_params_npz(jnpz, params))
    _orbax_refused(tseg.InstanceSegment, jdir)


# ---------------------------------------------------------------------------
# TrainCheckpointer
# ---------------------------------------------------------------------------

def _model_and_adam(seed):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(),
                                torch.nn.Linear(5, 3))
    return model, torch.optim.Adam(model.parameters(), lr=1e-3)


def _step(model, opt, x):
    opt.zero_grad(set_to_none=True)
    loss = model(x).square().mean()
    loss.backward()
    opt.step()
    return float(loss.detach())


def test_checkpointer_save_restore_latest_and_prune(tmp_path):
    model, opt = _model_and_adam(0)
    xs = torch.randn(6, 4, 6, generator=torch.Generator().manual_seed(1))
    ckpt = tckpt.TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ckpt.latest_step() is None
    for step in range(1, 5):
        _step(model, opt, xs[step])
        ckpt.save(step, model, opt)
    assert ckpt.latest_step() == 4
    assert sorted(os.listdir(ckpt.directory)) == ["3", "4"]
    fresh, fresh_opt = _model_and_adam(7)
    assert ckpt.restore(fresh, fresh_opt) == 4
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    want, got = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    for i in want:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(want[i][key], got[i][key])
    # the next step after the restore is the uninterrupted run's
    assert _step(fresh, fresh_opt, xs[5]) == _step(model, opt, xs[5])
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    older, _ = _model_and_adam(8)
    ckpt.restore_params(older, step=3)
    assert not torch.equal(older[0].weight, fresh[0].weight)
    with pytest.raises(FileNotFoundError, match="step 1"):
        ckpt.restore_params(older, step=1)
    ckpt.close()


def test_half_written_step_stays_invisible(tmp_path):
    model, opt = _model_and_adam(0)
    ckpt = tckpt.TrainCheckpointer(str(tmp_path / "ck"))
    ckpt.save(2, model, opt)
    # a save cut off before its rename, and a step directory whose files
    # were copied without the completion marker
    ckpt.save(5, model, opt)
    os.rename(os.path.join(ckpt.directory, "5"),
              os.path.join(ckpt.directory, ".tmp-5-cut"))
    os.makedirs(os.path.join(ckpt.directory, "9"))
    assert ckpt.latest_step() == 2
    with pytest.raises(FileNotFoundError, match="step 9"):
        ckpt.restore(model, opt, step=9)
    assert ckpt.restore(model, opt) == 2


def test_missing_checkpoints_raise(tmp_path):
    model, opt = _model_and_adam(0)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tckpt.TrainCheckpointer(str(empty)).restore(model, opt)
    with pytest.raises(FileNotFoundError):
        tckpt.load_params(str(tmp_path / "nowhere"), model)


FAMILIES = {
    "pose": (lambda: tpose.VideoPoseNet(width=8), "pose_blobnet_w8.npz"),
    "detector": (lambda: tdet.SSDDetector(width=8), "detect_ssd_w8.npz"),
    "embedding": (lambda: tdt.EmbeddingTraining(128, 8, 16),
                  "embed_w8.npz"),
    "segmenter": (lambda: tseg.InstanceSegmentor(width=8), "seg_w8.npz"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_is_the_converters_inverse(tmp_path, family):
    """export_params_npz writes flax keys and layouts: the keys and
    shapes of the family's shipped weight file, and loading the file
    back gives every parameter bit for bit (the embedding's
    training-only classifier is not exported)."""
    from scanner_tpu_torch.models.nets import init_module_
    make, shipped = FAMILIES[family]
    model = init_module_(make(), 3)
    npz = str(tmp_path / "w.npz")
    tckpt.export_params_npz(model, npz)
    flat = _flat_npz(npz)
    want = _flat_npz(tckpt.shipped_weights(shipped))
    assert set(flat) == set(want)
    assert all(flat[k].shape == want[k].shape for k in want)
    back = tckpt.import_params_npz(npz, make())
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(a, b) or name == "w_cls", name


# ---------------------------------------------------------------------------
# The command lines and the video helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli", ["pose_train", "detect_train", "seg_train"])
def test_command_lines_train_on_the_cpu(tmp_path, cli, capsys):
    """Each trainer's `main` runs one step on the CPU and writes its
    checkpoints and weight files where the reference's does."""
    out = str(tmp_path / "out")
    if cli == "pose_train":
        tpt.main([out, "--steps", "1", "--device", "cpu"])
        assert tckpt.TrainCheckpointer(out).latest_step() == 1
    elif cli == "detect_train":
        tdt.main([out, "--steps", "1", "--which", "embed", "--cpu"])
        assert tckpt.TrainCheckpointer(
            os.path.join(out, "embed_ckpt")).latest_step() == 1
        assert os.path.isfile(os.path.join(out, "embed_w8.npz"))
    else:
        tst.main([out, "--steps", "1", "--device", "cpu"])
        assert tckpt.TrainCheckpointer(
            os.path.join(out, "seg_ckpt")).latest_step() == 1
        assert os.path.isfile(os.path.join(out, "seg_w8.npz"))
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("helper", ["blob", "scene", "shape"])
def test_video_helpers_match_jax(tmp_path, helper):
    """The mp4 helpers (libav) return the JAX package's ground truth for
    the same seed and write a clip."""
    port, ref = {"blob": (tpt.synth_blob_video, jpt.synth_blob_video),
                 "scene": (tdt.synth_scene_video, jdt.synth_scene_video),
                 "shape": (tst.synth_shape_video, jst.synth_shape_video),
                 }[helper]
    got = port(str(tmp_path / "port.mp4"), num_frames=4)
    want = ref(str(tmp_path / "jax.mp4"), num_frames=4)
    if helper == "blob":
        np.testing.assert_array_equal(got, want)
    else:
        for g, w in zip(got, want):
            for a, b in zip(g if helper == "shape" else (g,),
                            w if helper == "shape" else (w,)):
                np.testing.assert_array_equal(a, b)
    assert os.path.getsize(str(tmp_path / "port.mp4")) > 0
