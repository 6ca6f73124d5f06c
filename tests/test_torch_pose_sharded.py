"""The pose model's sharded train step: the port on four gloo ranks on the
CPU (tests/torch_mesh_worker.py, mode "pose", spawned once for the
module) against its own one-process step and the JAX package's
make_sharded_train_step; param_shardings, the pp converters and the
step's rejections against the JAX package in this process.

Tolerances:
  * losses: rel 1e-2 (bf16 compute, test_torch_pose.py's bf16
    tolerance): the sharded step's three losses against the port's
    one-process make_train_step on the same global batch and weights,
    and its first loss with the JAX package's weights against JAX
    make_sharded_train_step's first loss on the same dp2 x tp2 mesh
    (one mesh only: the JAX step's first call compiles for ~10 s);
  * remat against no remat, the DCP resume against the uninterrupted
    step, and a sharded checkpoint read into the plain model: exact;
  * placements and the pp converters: exact.
"""

import os

import jax
import numpy as np
import pytest
import torch

from scanner_tpu.common import DeviceType
from scanner_tpu.models import pose as jpose
from scanner_tpu.parallel import mesh as jmesh

from scanner_tpu_torch.graph.ops import KernelConfig
from scanner_tpu_torch.models import convert, pose
from scanner_tpu_torch.models.checkpoint import load_params
from scanner_tpu_torch.parallel.mesh import make_mesh

from torch_mesh_worker import CLIP, STEPS, WIDTH, finish_ranks, start_ranks

REL = 1e-2
CASES = ["tp", "sp_ring", "sp_ulysses", "pp"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def _nested(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _batch():
    tshape = (CLIP[0], CLIP[1], CLIP[2] // 4, CLIP[3] // 4, 17)
    clip = (np.arange(np.prod(CLIP)) % 251).astype(np.uint8).reshape(CLIP)
    target = np.sin(np.arange(np.prod(tshape))).astype(np.float32) \
        .reshape(tshape)
    return torch.from_numpy(clip), torch.from_numpy(target)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks start first and run their own cases while this process
    runs the JAX step; they then wait for its weights."""
    work = str(tmp_path_factory.mktemp("mesh_pose"))
    src = os.path.join(work, "jax_params.npz")
    procs = start_ranks("pose", src, work)
    try:
        step, params, opt_state, (clip, target) = \
            jpose.make_sharded_train_step(
                jmesh.make_mesh({"dp": 2, "sp": 1, "tp": 2}),
                clip_shape=CLIP, width=WIDTH)
        weights = _flat(jax.device_get(params))
        _, _, jax_loss = step(params, opt_state, clip, target)
        tmp = os.path.join(work, "jax_params.tmp.npz")
        np.savez(tmp, **weights)
        os.replace(tmp, src)
    finally:
        ranks = finish_ranks(procs, work)
    ref = pose.init_params(0, device="cpu", width=WIDTH)
    _, ref_step = pose.make_train_step(ref)
    ref_losses = [float(ref_step(*_batch())) for _ in range(STEPS)]
    return dict(ranks=ranks, work=work, jax_loss=float(jax_loss),
                ref=ref_losses)


@pytest.mark.parametrize("case", CASES)
def test_sharded_losses_match_one_process(run, case):
    """dp2 x tp2, dp2 x sp2 (ring and Ulysses attention) and dp2 x pp2:
    every rank reports the same global loss, within rel 1e-2 of the
    port's one-process step, and the loss falls."""
    got = run["ranks"][0][case]
    for out in run["ranks"][1:]:
        np.testing.assert_array_equal(out[case], got)
    np.testing.assert_allclose(got, run["ref"], rtol=REL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("case", ["tp", "pp"])
def test_remat_gives_the_same_losses(run, case):
    for out in run["ranks"]:
        np.testing.assert_array_equal(out[f"{case}_remat"], out[case])


def test_first_loss_matches_jax_sharded_step(run):
    """The JAX package's initial weights through the port's dp2 x tp2
    step: the first loss against JAX make_sharded_train_step's."""
    for out in run["ranks"]:
        np.testing.assert_allclose(out["jax_weights_first"][0],
                                   run["jax_loss"], rtol=REL)


def test_dcp_resume_on_four_ranks(run):
    """Save after one dp2 x tp2 step, restore into a fresh model and Adam
    on the same four ranks: the next step's loss is the uninterrupted
    run's, bit for bit."""
    for out in run["ranks"]:
        assert int(out["restored_step"]) == 1
        uninterrupted, resumed = out["resume"]
        assert resumed == uninterrupted


@pytest.mark.parametrize("case", ["tp", "pp"])
def test_sharded_checkpoint_serves_through_the_plain_model(run, case):
    """A checkpoint of the sharded step (dp2 x tp2; dp2 x pp2, its
    stacked stages converted) restores into the plain one-device
    VideoPoseNet with the weights the ranks held, and PoseDetect serves
    it."""
    ckpt = os.path.join(run["work"], f"ckpt_{case}")
    with np.load(os.path.join(run["work"], f"{case}_params.npz")) as f:
        saved = pose.pp_params_to_plain(dict(f))
    plain = load_params(ckpt, pose.VideoPoseNet(width=WIDTH))
    got = convert.flax_params(plain)
    assert sorted(got) == sorted(saved)
    for key in got:
        np.testing.assert_array_equal(got[key], saved[key], err_msg=key)
    op = pose.PoseDetect(KernelConfig(device=DeviceType.CPU), width=WIDTH,
                         checkpoint_dir=ckpt)
    frames = np.random.RandomState(1).randint(
        0, 256, (2, 32, 32, 3)).astype(np.uint8)
    kp = op.execute(frames)
    with torch.no_grad():
        want = pose.apply_and_peaks(plain, torch.from_numpy(frames)[:, None])
    np.testing.assert_array_equal(kp, want.numpy())


MESHES = [{"dp": 2, "sp": 1, "tp": 2}, {"dp": 2, "sp": 2, "tp": 1, "ep": 2},
          {"dp": 2, "sp": 1, "tp": 1, "pp": 2}]

# flax dim -> torch dim of each kind of leaf (models/nets.py layouts)
_DIMS = {"Dense": {0: 1, 1: 0}, "Conv": {0: 2, 1: 3, 2: 1, 3: 0},
         "ConvTranspose": {0: 2, 1: 3, 2: 0, 3: 1}}


def _kind(model, name):
    mod = model.get_submodule(name.rsplit(".", 1)[0])
    kind = type(mod).__name__
    if name.startswith("PipelinedTemporalStack_0.stages."):
        stage = pose.TemporalBlock(8)
        sub = name[len("PipelinedTemporalStack_0.stages."):]
        kind = type(stage.get_submodule(sub.rsplit(".", 1)[0])).__name__ \
            if "." in sub else "TemporalBlock"
        return kind, True
    return kind, False


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items() if v > 1))
def test_param_shardings_match_jax(axes):
    """Every parameter's placements equal the JAX spec of its flax key
    (the JAX tree from jax.eval_shape: nothing compiles), mapped to the
    torch layout's dim."""
    from torch.distributed.tensor import Replicate, Shard

    jmesh_ = jmesh.make_mesh(axes)
    pp = axes.get("pp", 1) > 1
    jkw = dict(pipeline_mesh=jmesh_, temporal_layers=2) if pp else {}
    jmodel = jpose.VideoPoseNet(width=WIDTH, **jkw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1,) + CLIP[1:], np.uint8))
    jspecs = {"/".join(str(p.key) for p in path if hasattr(p, "key")):
              tuple(s.spec) for path, s in
              jax.tree_util.tree_flatten_with_path(
                  jpose.param_shardings(shapes, jmesh_))[0]}
    layout = make_mesh(axes, devices=["cpu"] * int(np.prod(
        list(axes.values()))))
    tmodel = pose.VideoPoseNet(width=WIDTH, pipeline_mesh=layout
                               if pp else None)
    got = pose.param_shardings(tmodel, layout)
    entries = list(convert._flax_entries(tmodel))
    assert sorted(got) == sorted(n for n, _ in tmodel.named_parameters())
    assert len(entries) == len(jspecs)
    names = list(layout.shape)
    for key, name, p, _, _ in entries:
        spec = jspecs[key] + (None,) * (p.dim() - len(jspecs[key]))
        kind, stacked = _kind(tmodel, name)
        want = [Replicate()] * len(names)
        for fdim, axis in enumerate(spec):
            if axis is None:
                continue
            if stacked and fdim > 0:
                tdim = 1 + _DIMS.get(kind, {}).get(fdim - 1, fdim - 1)
            else:
                tdim = fdim if stacked else _DIMS.get(kind, {}).get(fdim,
                                                                    fdim)
            want[names.index(axis)] = Shard(tdim)
        assert list(got[name].placements) == want, (key, spec)


def test_pp_converters_match_jax():
    """pp_params_to_plain / plain_params_to_pp on flax-keyed weights (the
    form convert.flax_params yields) against the JAX package's on the
    same tree; the round trip; the already-converted pass-through; no
    blocks to stack raises."""
    plain = convert.flax_params(pose.init_params(0, device="cpu",
                                                 width=WIDTH))
    to_pp = pose.plain_params_to_pp(plain)
    want = _flat(jpose.plain_params_to_pp(_nested(plain)))
    assert sorted(to_pp) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(to_pp[k], want[k], err_msg=k)
    back = pose.pp_params_to_plain(to_pp)
    want = _flat(jpose.pp_params_to_plain(_nested(to_pp)))
    assert sorted(back) == sorted(want) == sorted(plain)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
        np.testing.assert_array_equal(back[k], plain[k], err_msg=k)
    assert sorted(pose.plain_params_to_pp(to_pp)) == sorted(to_pp)
    assert sorted(pose.pp_params_to_plain(plain)) == sorted(plain)
    with pytest.raises(ValueError, match="no TemporalBlock_i"):
        pose.plain_params_to_pp({"params/film/kernel": np.zeros(2)})


def test_pipelined_model_loads_plain_weights():
    """A pipelined VideoPoseNet takes the plain weights through
    plain_params_to_pp, and gives them back unchanged."""
    plain = pose.init_params(0, device="cpu", width=WIDTH)
    layout = make_mesh({"dp": 1, "pp": 1}, devices=["cpu"])
    piped = pose.VideoPoseNet(width=WIDTH, pipeline_mesh=layout)
    convert.load_params(piped, pose.plain_params_to_pp(
        convert.flax_params(plain)))
    got = pose.pp_params_to_plain(convert.flax_params(piped))
    want = convert.flax_params(plain)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("axes,kw", [
    ({"dp": 1, "sp": 2, "tp": 2, "pp": 2}, {}),
    ({"dp": 2, "sp": 1, "tp": 2, "pp": 2}, {"temporal_layers": 3}),
    ({"dp": 2, "sp": 2, "tp": 2}, {"attn_scheme": "bogus"}),
], ids=["pp_with_sp", "temporal_layers", "scheme"])
def test_sharded_step_rejections_keep_jax_words(axes, kw):
    with pytest.raises(ValueError) as e:
        jpose.make_sharded_train_step(jmesh.make_mesh(axes),
                                      clip_shape=CLIP, width=WIDTH, **kw)
    layout = make_mesh(axes, devices=["cpu"] * 8)
    with pytest.raises(ValueError) as got:
        pose.make_sharded_train_step(layout, clip_shape=CLIP, width=WIDTH,
                                     **kw)
    assert str(got.value) == str(e.value)


def test_remat_keeps_the_forward_and_the_parameter_names():
    """remat=True recomputes on the backward pass: same outputs and
    gradients, same state dict names (so the .npz converter and
    PoseDetect load the same weights)."""
    clip, target = _batch()
    outs = []
    for remat in (False, True):
        m = pose.init_params(0, device="cpu", width=WIDTH, remat=remat)
        loss = ((m(clip[:1]) - target[:1]) ** 2).mean()
        loss.backward()
        outs.append((m.state_dict().keys(), loss.item(),
                     [p.grad.clone() for p in m.parameters()
                      if p.grad is not None]))
    assert list(outs[0][0]) == list(outs[1][0])
    assert outs[0][1] == outs[1][1]
    for a, b in zip(outs[0][2], outs[1][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
