"""Multi-style training in the port (the fused-IN plain versions with [N, C]
affines, the differentiable style gather of models/multistyle.py,
engines/multistyle.py's loss, steps and ``train``, ``fast_st train-multi``)
against the JAX package, on the CPU, at 32 px with S = 3 styles. JAX
parameters carry across with ``multistyle.params_from_jax`` and
``vgg.params_from_jax``; inputs come from numpy seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from styletransfer_tpu import ckpt as jckpt
from styletransfer_tpu import constants as jconstants
from styletransfer_tpu.clis import cli as jcli
from styletransfer_tpu.data import coco as jcoco
from styletransfer_tpu.engines import multistyle as jengine
from styletransfer_tpu.models import multistyle as jms
from styletransfer_tpu.models import vgg as jv
from styletransfer_tpu.ops.pallas import instance_norm as pin
from styletransfer_tpu_torch import ckpt as tckpt
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.clis import cli as tcli
from styletransfer_tpu_torch.data import coco as tcoco
from styletransfer_tpu_torch.engines import multistyle as engine
from styletransfer_tpu_torch.models import multistyle as ms
from styletransfer_tpu_torch.models import transformer as tt
from styletransfer_tpu_torch.models import vgg as tv
from styletransfer_tpu_torch.ops.cuda import fused_instance_norm as fin

SIZE = 32
S = 3
# The fused-IN plain version against jax.vjp of the JAX reference: the
# tolerances of tests/test_torch_fused_instance_norm.py (forward; gradients).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# Parameters after one train step against JAX's (tests/test_torch_training.py's
# F32_TOL: the stacked forward against JAX's pad-early one, about 1e-6 apart
# over 15 norms, then one Adam step of at most lr).
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
# Gradients of the whole loss as relative L2 per parameter
# (tests/test_torch_training.py's GRAD_REL_L2). Kinks make gradients jump
# where the two packages' forwards (about 1e-6 apart) fall on either side:
# a ReLU input within rounding of 0, or a VGG max-pool window whose two
# largest values lie within rounding of each other (the gradient then goes
# to the other one). No input here does.
GRAD_REL_L2 = 5e-5
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU ops here are small: one thread each, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tree():
    """A JAX multi-style tree whose styles' affines are drawn apart."""
    tree = jax.device_get(jms.init_params(jax.random.PRNGKey(3), num_styles=S))
    rng = np.random.default_rng(3)

    def perturb(path, leaf):
        if jms._is_affine_path(path):
            return (np.asarray(leaf) + rng.normal(0, 0.2, leaf.shape)).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.fixture(scope="module")
def jax_vgg():
    return jax.device_get(jv.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_vgg(jax_vgg):
    return tv.params_from_jax(jax_vgg, device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _styles(seed=5):
    return _x(seed, (S, SIZE, SIZE, 3)) * 0.5


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_key(name):
    return "".join(f"['{s}']" for s in name.split("."))


# --- The fused-IN plain versions with per-image affines ----------------------

def _in_data(seed, shape=(3, 6, 10, 16)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.random((shape[0], shape[-1])) + 0.5).astype(np.float32)
    bias = rng.standard_normal((shape[0], shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, res, scale, bias, g


@pytest.mark.parametrize("relu,with_res", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_plain_in_with_per_image_affines_matches_jax_vjp(relu, with_res):
    x, res, scale, bias, g = _in_data(1)
    r = res if with_res else None

    def ref(x_, s_, b_, r_):
        return pin.fused_instance_norm(x_, s_, b_, residual=r_, relu=relu)

    jr = jnp.asarray(res) if with_res else None
    want, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), jr)
    jdx, jds, jdb, jdr = vjp(jnp.asarray(g))
    t = torch.from_numpy
    out, mean, inv = fin.forward_plain(t(x), t(scale), t(bias), None if r is None else t(r),
                                       relu)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)
    dx, ds, db = fin.backward_plain(t(g), t(x), None if r is None else t(r), mean, inv,
                                    t(scale), t(bias), relu)
    assert ds.shape == db.shape == (3, 16)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **GRAD_TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), **GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **GRAD_TOL)
    if with_res:
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdr), **GRAD_TOL)


@pytest.mark.parametrize("relu", [False, True])
def test_plain_in_per_image_is_each_image_alone_and_rows_sum_to_the_shared_call(relu):
    x, res, scale, bias, g = (torch.from_numpy(a) for a in _in_data(2))
    out, mean, inv = fin.forward_plain(x, scale, bias, res, relu)
    dx, ds, db = fin.backward_plain(g, x, res, mean, inv, scale, bias, relu)
    for i in range(3):
        one = slice(i, i + 1)
        o1, m1, v1 = fin.forward_plain(x[one], scale[i], bias[i], res[one], relu)
        d1 = fin.backward_plain(g[one], x[one], res[one], m1, v1, scale[i], bias[i], relu)
        assert torch.equal(out[one], o1) and torch.equal(mean[one], m1)
        assert torch.equal(dx[one], d1[0])
        torch.testing.assert_close(ds[i], d1[1], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(db[i], d1[2], rtol=1e-6, atol=1e-6)
    # One affine for all images, given as [C] and as its row repeated: the
    # [N, C] rows add up to the [C] call's dscale and dbias.
    shared = (scale[0], bias[0])
    rows = tuple(t.expand(3, -1).contiguous() for t in shared)
    _, mean, inv = fin.forward_plain(x, *shared, res, relu)
    dx_c, ds_c, db_c = fin.backward_plain(g, x, res, mean, inv, *shared, relu)
    dx_r, ds_r, db_r = fin.backward_plain(g, x, res, mean, inv, *rows, relu)
    assert torch.equal(dx_c, dx_r)
    torch.testing.assert_close(ds_r.sum(0), ds_c, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(db_r.sum(0), db_c, rtol=1e-6, atol=1e-6)


# --- The style gather ---------------------------------------------------------

def test_the_gather_sums_each_styles_images_and_gives_unused_styles_zero(jax_tree):
    params = ms.params_from_jax(jax_tree, device="cpu")
    idx = [2, 0, 2, 0]
    net = ms.styled(params, ms.one_hot(idx, S, "cpu"))
    assert torch.equal(net.res3.in2.scale, params.res3.in2.scale[idx])
    assert net.up1_in.bias.is_contiguous() and net.up1_in.bias.shape == (4, 64)
    d = torch.from_numpy(_x(4, (4, 64)))
    (net.up1_in.bias * d).sum().backward()
    grad = params.up1_in.bias.grad
    assert torch.equal(grad[1], torch.zeros(64))
    torch.testing.assert_close(grad[0], d[1] + d[3], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(grad[2], d[0] + d[2], rtol=1e-6, atol=1e-7)
    assert params.up1_in.scale.grad is None or not params.up1_in.scale.grad.any()


# --- The loss and the steps against JAX --------------------------------------

def _grams(jax_vgg, port_vgg, styles):
    jgrams = jengine.stack_style_grams(jax_vgg, jnp.asarray(styles))
    grams = engine.stack_style_grams(port_vgg, torch.from_numpy(styles))
    for k in jgrams:
        np.testing.assert_allclose(grams[k].numpy(), np.asarray(jgrams[k]), rtol=1e-5,
                                   atol=1e-6)
    return jgrams, grams


def test_multistyle_loss_value_and_gradients_match_jax(jax_tree, jax_vgg, port_vgg):
    styles, batch = _styles(), _x(7, (3, SIZE, SIZE, 3))
    idx = np.array([0, 2, 0], np.int32)  # style 1 unused
    jgrams, grams = _grams(jax_vgg, port_vgg, styles)
    value_and_grad = jax.jit(jax.value_and_grad(jengine.multistyle_loss, has_aux=True),
                             static_argnums=(5, 6))
    (_, want), jgrads = value_and_grad(jax_tree, jnp.asarray(batch), jnp.asarray(idx), jax_vgg,
                                       jgrams, 1e5, 1.0)
    params = ms.params_from_jax(jax_tree, device="cpu")
    total, got = engine.multistyle_loss(params, torch.from_numpy(batch), idx, port_vgg, grams,
                                        1e5, 1.0)
    total.backward()
    for k in ("total", "style", "content", "tv"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    flat = _flat(jgrads)
    scale = max(np.linalg.norm(g) for g in flat.values())
    for name, p in params.named_parameters():
        w, g = flat[_port_key(name)], p.grad.numpy()
        if p.dim() == 2:  # an [S, C] affine: the unused style's row is exactly 0
            assert not np.any(g[1]) and not np.any(w[1]), name
        if np.linalg.norm(w) < 1e-6 * scale:
            # Biases that an instance norm cancels: zero up to rounding.
            assert np.linalg.norm(g) < 1e-6 * scale, name
            continue
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < GRAD_REL_L2, name


def test_one_train_step_and_the_eval_step_match_jax(jax_tree, jax_vgg, port_vgg):
    styles, batch = _styles(7), _x(8, (2, SIZE, SIZE, 3))
    idx = np.array([1, 1], np.int32)
    jgrams, grams = _grams(jax_vgg, port_vgg, styles)
    opt, jstep = jengine.make_train_step(jax_vgg, jgrams)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_tree)
    jparams, jopt, jm = jstep(jparams, opt.init(jparams), jnp.asarray(batch), jnp.asarray(idx))
    params = ms.params_from_jax(jax_tree, device="cpu")
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    optimizer = engine.fast.make_optimizer(params)
    m = engine.make_train_step(port_vgg, grams)(params, optimizer, torch.from_numpy(batch),
                                                idx)
    for k in ("total", "style", "content", "tv"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    flat = _flat(jax.device_get(jparams))
    # JAX's gradients: after one step optax's first moment is (1 - b1) * g.
    jgrad = {k: v / 0.1 for k, v in _flat(jax.device_get(jopt[0].mu)).items()}
    for name, p in params.named_parameters():
        key = _port_key(name)
        got, want, g = p.detach().numpy(), flat[key], jgrad[key]
        if p.dim() == 2:  # rows of styles the batch did not draw keep their values
            for s in (0, 2):
                assert torch.equal(p.detach()[s], before[name][s]), name
        # Adam's first step is about -lr * sign(g). Where g is rounding noise
        # (the biases that a norm cancels, or single elements within rounding
        # of 0) the step may take either sign: those within 2 lr.
        noise = np.abs(g) < 1e-6 * np.abs(g).max() if np.abs(g).max() >= 1e-6 * max(
            np.abs(v).max() for v in jgrad.values()) else np.ones(g.shape, bool)
        np.testing.assert_allclose(got[~noise], want[~noise], err_msg=name, **STEP_TOL)
        np.testing.assert_allclose(got[noise], want[noise], err_msg=name, rtol=0,
                                   atol=2 * LR)
    assert int(optimizer.state[params.in1.scale]["step"]) == 1

    jeval = jengine.make_eval_step(jax_vgg, jgrams)
    eidx = np.arange(2) % S
    want = float(jeval(jparams, jnp.asarray(batch), jnp.asarray(eidx)))
    got = float(engine.make_eval_step(port_vgg, grams)(params, torch.from_numpy(batch), eidx))
    np.testing.assert_allclose(got, want, rtol=1e-4)


# --- train ---------------------------------------------------------------------

def _tiny_loaders(package):
    coco = jcoco if package == "jax" else tcoco
    train = coco.DataLoader(coco.SyntheticDataset(8, SIZE), 2, seed=1, num_threads=2)
    test = coco.DataLoader(coco.SyntheticDataset(2, SIZE, seed_offset=8), 2, seed=0,
                           num_threads=2)
    return train, test


def _port_train(tmp_path, jax_tree, port_vgg, **kw):
    train, test = _tiny_loaders("port")
    args = dict(style_name="tiny", epochs=2, batch_size=2, vgg_params=port_vgg,
                params=ms.params_from_jax(jax_tree, device="cpu"), train_loader=train,
                test_loader=test, runs_dir=str(tmp_path / "runs"),
                models_path=str(tmp_path / "models"), max_steps_per_epoch=2,
                log_cadence=(1, 3, 100), seed=4, device="cpu")
    args.update(kw)
    return engine.train(_styles(), **args), train


def test_train_draws_the_jax_schedule_and_writes_what_jax_reads(
        tmp_path, monkeypatch, jax_tree, jax_vgg, port_vgg):
    drawn = {"jax": [], "port": []}
    real_step = engine.make_train_step

    def port_step(*args, **kw):
        step = real_step(*args, **kw)

        def recorded(params, optimizer, batch, style_idx):
            drawn["port"].append(np.asarray(style_idx).tolist())
            return step(params, optimizer, batch, style_idx)
        return recorded

    monkeypatch.setattr(engine, "make_train_step", port_step)
    params, _ = _port_train(tmp_path, jax_tree, port_vgg)

    # The JAX trainer with its step, eval and preview stubbed out: only its
    # draws of the style indices are compared here.
    def jax_step(*args, **kw):
        def step(params, opt_state, batch, idx):
            drawn["jax"].append(np.asarray(idx).tolist())
            return params, opt_state, {"total": jnp.float32(0.0)}
        return optax.adam(LR), step

    monkeypatch.setattr(jengine, "make_train_step", jax_step)
    monkeypatch.setattr(jengine, "make_eval_step", lambda *a, **k: lambda *b: 0.0)
    monkeypatch.setattr(jengine, "stylize", lambda p, x, i, compute_dtype=None: x)
    train, test = _tiny_loaders("jax")
    jengine.train(jnp.asarray(_styles()), style_name="tiny", epochs=2, batch_size=2,
                  vgg_params=jax_vgg, params=jax_tree, train_loader=train, test_loader=test,
                  seed=4, runs_dir=str(tmp_path / "jruns"),
                  models_path=str(tmp_path / "jmodels"), max_steps_per_epoch=2)
    assert len(drawn["port"]) == 4 and drawn["port"] == drawn["jax"]

    # The port's epoch checkpoint through the JAX command's loader.
    models = str(tmp_path / "models")
    template = jms.init_params(jax.random.PRNGKey(0), num_styles=S)
    loaded, epoch = jckpt.load_latest_transformer(jengine.MODEL_NAME, "tiny", template, models)
    assert epoch == 1
    want = _flat(tt.params_to_tree(params))
    got = _flat(jax.device_get(loaded))
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k])
    state = jckpt.load_step_state(template, optax.adam(LR).init(template), jengine.MODEL_NAME,
                                  "tiny", models, extra_keys=("batch_in_epoch",))
    assert state is None  # no --step-checkpoint-every
    assert len(os.listdir(tmp_path / "runs")) == 1


def test_train_reads_the_jax_checkpoints_and_resumes_a_step_state(
        tmp_path, jax_tree, port_vgg):
    models = str(tmp_path / "models")
    jckpt.save_epoch(jax_tree, jengine.MODEL_NAME, "tiny", 0, models)
    params, _ = _port_train(tmp_path, jax_tree, port_vgg, epochs=1, train_loader=None)
    want = _flat(jax_tree)
    for k, v in _flat(tt.params_to_tree(params)).items():
        np.testing.assert_array_equal(v, want[k])

    # A step state at batch 1 of epoch 1: the resumed run decodes none of
    # that epoch's first batch, takes its two steps and goes on to iteration
    # 5 and Adam count 5.
    start = ms.params_from_jax(jax_tree, device="cpu")
    opt_state = tckpt.adam_state_to_tree(start, engine.fast.make_optimizer(start))
    opt_state["0"]["count"] = np.asarray(3, np.int32)
    tckpt.save_step_state(start, opt_state, 1, 3, engine.MODEL_NAME, "tiny", models,
                          extra={"batch_in_epoch": 1})
    train, _ = _tiny_loaders("port")
    first = train._indices(epoch=1)[:2]
    loaded = []
    load = train.dataset.load
    train.dataset.load = lambda i: (loaded.append(i), load(i))[1]
    _port_train(tmp_path, jax_tree, port_vgg, train_loader=train, step_checkpoint_every=1)
    assert loaded and not set(loaded) & set(first)
    state = tckpt.load_step_state(engine.MODEL_NAME, "tiny", models,
                                  extra_keys=("batch_in_epoch",))
    assert (state["epoch"], state["iteration"]) == (2, 5)
    assert int(state["opt_state"]["0"]["count"]) == 5
    assert state["opt_state"]["0"]["mu"]["in1"]["scale"].shape == (S, 32)


def test_train_multi_clis_write_checkpoints_of_one_layout(tmp_path, monkeypatch, port_vgg):
    """Both ``train-multi`` commands with the same arguments. The port's
    trains for real on a tiny corpus; the JAX engine's ``train`` (exercised
    in tests/test_multistyle.py) is replaced by the write of its initial
    parameters, which is the epoch checkpoint's layout."""
    for name in ("a.png", "b.png"):
        Image.fromarray(np.random.default_rng(len(name)).integers(
            0, 256, (40, 36, 3), dtype=np.uint8)).save(tmp_path / name)
    monkeypatch.setattr(jconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    seen = {}

    def jax_train(stack, **kw):
        seen["jax"] = (stack.shape, kw)
        params = jms.init_params(jax.random.PRNGKey(0), num_styles=stack.shape[0])
        jckpt.save_epoch(params, jengine.MODEL_NAME, kw["style_name"], 0,
                         str(tmp_path / "jax_models"))

    monkeypatch.setattr(jengine, "train", jax_train)
    args = ["fast_st", "train-multi", "a.png", "b.png", "-n", "duo", "-e", "1", "-b", "2",
            "-sw", "10", "--step-checkpoint-every", "5", "--precision", "f32"]
    r = CliRunner().invoke(jcli, args)
    assert r.exit_code == 0, r.output + repr(r.exception)

    real_train = engine.train

    def port_train(stack, **kw):
        seen["port"] = (stack.shape, dict(kw))
        train, test = _tiny_loaders("port")
        return real_train(stack, **kw, vgg_params=port_vgg, train_loader=train,
                          test_loader=test, models_path=str(tmp_path / "port_models"),
                          max_steps_per_epoch=1, log_cadence=(1, 100, 100))

    monkeypatch.setattr(engine, "train", port_train)
    r = CliRunner().invoke(tcli, args + ["--device", "cpu"])
    assert r.exit_code == 0, r.output + repr(r.exception)
    (jshape, jkw), (tshape, tkw) = seen["jax"], seen["port"]
    assert jshape == tshape == (2, 256, 256, 3)
    assert tkw.pop("device") == "cpu"
    assert tkw == {k: jkw[k] for k in tkw}
    jtree = tckpt.load(os.path.join(tmp_path, "jax_models",
                                    "fast_multi_st_duo_epoch0.msgpack"))
    ttree = tckpt.load(os.path.join(tmp_path, "port_models",
                                    "fast_multi_st_duo_epoch0.msgpack"))
    shapes = [{k: v.shape for k, v in _flat(t).items()} for t in (jtree, ttree)]
    assert shapes[0] == shapes[1] and shapes[0]["['in1']['scale']"] == (2, 32)
