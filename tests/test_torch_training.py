"""fast_st training in the port (engines/fast.py, the stacked forward of
models/transformer.py, ckpt.py's step states) against the JAX package, on
the CPU, at small sizes. Parameters cross with ``params_from_jax``; inputs
come from numpy seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from styletransfer_tpu import ckpt as jckpt
from styletransfer_tpu.engines import fast as jfast
from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu.models import vgg as jv
from styletransfer_tpu_torch import ckpt as tckpt
from styletransfer_tpu_torch.data import coco as tcoco
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.models import transformer as tt
from styletransfer_tpu_torch.models import vgg as tv
from styletransfer_tpu_torch.ops.cuda import fused_instance_norm as fin

# f32 forward: the stacked forward against JAX's (both exact two-pass
# statistics) and against JAX's pad-early (one-pass): about 1e-6 apart,
# compounded over 15 norms (the tolerance of test_torch_transformer.py).
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16: both round activations to 8-bit mantissas at slightly different
# places (see test_torch_transformer.py).
BF16_ATOL = 0.06
# Gradients of the whole loss, as relative L2 error per parameter. Measured
# 2.7e-6 against JAX on these inputs; the ReLUs' kinks make gradients jump
# where a pre-activation lies within rounding of 0, which no input here does.
GRAD_REL_L2 = 5e-5


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jt.init_params(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def jax_vgg():
    return jax.device_get(jv.init_params(jax.random.PRNGKey(0)))


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
@pytest.mark.parametrize("bf16", [False, True])
def test_stacked_forward_matches_jax(jax_params, pad_mode, bf16):
    x = _x(0, (2, 32, 32, 3))
    jcd, tcd = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = np.asarray(jt._apply_stacked(jax_params, jnp.asarray(x), jcd, use_pallas=False,
                                        reflect=pad_mode == "reflect"))
    params = tt.params_from_jax(jax_params, device="cpu")
    got = tt.apply_stacked(params, torch.from_numpy(x), tcd, pad_mode=pad_mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if bf16:
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=BF16_ATOL)
    else:
        np.testing.assert_allclose(got.detach().numpy(), want, **F32_TOL)


def test_stacked_forward_matches_the_pad_early_forward(jax_params):
    x = torch.from_numpy(_x(1, (2, 32, 32, 3)))
    params = tt.params_from_jax(jax_params, device="cpu")
    with torch.no_grad():
        stacked = tt.apply_stacked(params, x)
    np.testing.assert_allclose(stacked.numpy(), tt.apply(params, x).numpy(), **F32_TOL)


def _loss_inputs(seed, jax_vgg):
    rng = np.random.default_rng(seed)
    style = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    batch = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    port_vgg = tv.params_from_jax(jax_vgg, device="cpu")
    return style, batch, port_vgg


def test_loss_fn_value_and_gradients_match_jax(jax_params, jax_vgg):
    style, batch, port_vgg = _loss_inputs(7, jax_vgg)
    jgrams = jv.style_gram_targets(jax_vgg, jnp.asarray(style))
    value_and_grad = jax.jit(jax.value_and_grad(jfast.loss_fn, has_aux=True),
                             static_argnums=(4, 5))
    (_, want), jgrads = value_and_grad(jax_params, jnp.asarray(batch), jax_vgg, jgrams,
                                       1e5, 1.0)
    params = tt.params_from_jax(jax_params, device="cpu")
    grams = tv.style_gram_targets(port_vgg, torch.from_numpy(style))
    total, got = fast.loss_fn(params, torch.from_numpy(batch), port_vgg, grams, 1e5, 1.0)
    total.backward()
    for k in ("total", "style", "content", "tv"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    flat = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_leaves_with_path(jgrads)}
    scale = max(np.linalg.norm(g) for g in flat.values())
    for name, p in params.named_parameters():
        w = flat["".join(f"['{s}']" for s in name.split("."))]
        g = p.grad.numpy()
        if np.linalg.norm(w) < 1e-6 * scale:
            # Biases that an instance norm cancels: zero up to rounding.
            assert np.linalg.norm(g) < 1e-6 * scale, name
            continue
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < GRAD_REL_L2, name


def test_train_steps_reproduce_the_golden_totals(jax_params, jax_vgg):
    """tests/test_golden.py::test_train_step_golden through the port: the
    same seeds, three steps of loss, backward and Adam. (Its JAX totals come
    from the pad-early forward; this runs the stacked one.)"""
    style, batch, port_vgg = _loss_inputs(42, jax_vgg)
    params = tt.params_from_jax(jax_params, device="cpu")
    grams = tv.style_gram_targets(port_vgg, torch.from_numpy(style))
    step = fast.make_train_step(port_vgg, grams)
    opt = fast.make_optimizer(params)
    totals = [float(step(params, opt, torch.from_numpy(batch))["total"]) for _ in range(3)]
    np.testing.assert_allclose(totals, [296.224274, 1236.626465, 224.133560], rtol=1e-3)
    param_l1 = sum(float(p.detach().abs().sum()) for p in params.parameters())
    np.testing.assert_allclose(param_l1, 27308.205078, rtol=1e-3)


def test_remat_step_equals_the_plain_step(jax_params, jax_vgg):
    style, batch, port_vgg = _loss_inputs(7, jax_vgg)
    grams = tv.style_gram_targets(port_vgg, torch.from_numpy(style))
    out = []
    for remat in (False, True):
        params = tt.params_from_jax(jax_params, device="cpu")
        opt = fast.make_optimizer(params)
        before = fin.fwd_launches
        m = fast.make_train_step(port_vgg, grams, remat=remat)(params, opt,
                                                               torch.from_numpy(batch))
        assert fin.fwd_launches == before  # CPU tensors: plain versions, no kernel
        out.append((m, tt.params_to_tree(params)))
    (m0, p0), (m1, p1) = out
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(jax.tree_util.tree_leaves(p0), jax.tree_util.tree_leaves(p1)):
        np.testing.assert_array_equal(a, b)


def test_eval_step_matches_jax(jax_params, jax_vgg):
    style, batch, port_vgg = _loss_inputs(8, jax_vgg)
    jgrams = jv.style_gram_targets(jax_vgg, jnp.asarray(style))
    want = jfast.make_eval_step(jax_vgg, jgrams)(jax_params, jnp.asarray(batch))
    grams = tv.style_gram_targets(port_vgg, torch.from_numpy(style))
    got = fast.make_eval_step(port_vgg, grams)(tt.params_from_jax(jax_params, device="cpu"),
                                               torch.from_numpy(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_make_optimizer_is_optax_adam():
    """Three steps with the same gradients: torch Adam and optax adam agree
    (gradients well away from 0, where the first step is about -lr*sign)."""
    rng = np.random.default_rng(9)
    w0 = {"conv1": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32)}}
    grads = [rng.standard_normal((3, 3, 2, 4)).astype(np.float32) for _ in range(3)]
    opt = optax.adam(1e-3)
    jp, st = jax.tree_util.tree_map(jnp.asarray, w0), None
    st = opt.init(jp)
    for g in grads:
        upd, st = opt.update({"conv1": {"kernel": jnp.asarray(g)}}, st, jp)
        jp = optax.apply_updates(jp, upd)
    module = torch.nn.ModuleDict({"conv1": torch.nn.ParameterDict(
        {"kernel": torch.nn.Parameter(torch.from_numpy(w0["conv1"]["kernel"].copy()))})})
    topt = fast.make_optimizer(module)
    for g in grads:
        module.conv1["kernel"].grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(module.conv1["kernel"].detach().numpy(),
                               np.asarray(jp["conv1"]["kernel"]), rtol=1e-6, atol=1e-7)


def test_adam_state_round_trips_with_optax(jax_params):
    """optax state -> torch Adam -> optax state, and one more step in each
    agrees."""
    rng = np.random.default_rng(10)
    opt = optax.adam(1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params)
    st = opt.init(jp)
    grads = [jax.tree_util.tree_map(lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                                          jnp.float32), jp)
             for _ in range(3)]
    for g in grads[:2]:
        upd, st = opt.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"0": {"count": st[0].count, "mu": st[0].mu, "nu": st[0].nu}, "1": {}}))

    params = tt.params_from_jax(jax.device_get(jp), device="cpu")
    topt = fast.make_optimizer(params)
    tckpt.adam_state_from_tree(params, topt, tree)
    back = tckpt.adam_state_to_tree(params, topt)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert back["0"]["count"].dtype == np.int32 and int(back["0"]["count"]) == 2

    upd, st = opt.update(grads[2], st, jp)
    jp = optax.apply_updates(jp, upd)
    flat = {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_leaves_with_path(grads[2])}
    for name, p in params.named_parameters():
        p.grad = torch.from_numpy(flat["".join(f"['{s}']" for s in name.split("."))].copy())
    topt.step()
    for a, b in zip(jax.tree_util.tree_leaves(tt.params_to_tree(params)),
                    jax.tree_util.tree_leaves(jax.device_get(jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_adam_state_before_any_step_is_zero(jax_params):
    params = tt.params_from_jax(jax_params, device="cpu")
    tree = tckpt.adam_state_to_tree(params, fast.make_optimizer(params))
    assert int(tree["0"]["count"]) == 0 and tree["1"] == {}
    assert not any(np.any(a) for a in jax.tree_util.tree_leaves(tree["0"]["mu"]))


def _tiny_run(tmp_path, jax_params, jax_vgg, **kw):
    """static_train at 32 px: 16 synthetic train images in batches of 2, a
    4-image test split, seeded VGG and style."""
    train = tcoco.DataLoader(tcoco.SyntheticDataset(16, 32), 2, seed=1, num_threads=2)
    test = tcoco.DataLoader(tcoco.SyntheticDataset(4, 32, seed_offset=16), 2, seed=0,
                            num_threads=2)
    args = dict(style_name="tiny", epochs=1, batch_size=2, vgg_params=tv.params_from_jax(
        jax_vgg, device="cpu"), params=tt.params_from_jax(jax_params, device="cpu"),
        train_loader=train, test_loader=test, runs_dir=str(tmp_path / "runs"),
        models_path=str(tmp_path / "models"), max_steps_per_epoch=2, device="cpu")
    args.update(kw)
    return fast.static_train(_x(11, (1, 32, 32, 3)), **args), train


def test_static_train_writes_what_the_jax_package_reads(tmp_path, jax_params, jax_vgg):
    params, _ = _tiny_run(tmp_path, jax_params, jax_vgg, step_checkpoint_every=1)
    models = str(tmp_path / "models")
    path = jckpt.existing_checkpoint_path("fast_st", "tiny", 0, models)
    assert path == tckpt.existing_checkpoint_path("fast_st", "tiny", 0, models)
    template = jt.init_params(jax.random.PRNGKey(0))
    loaded = jax.device_get(jckpt.load(path, template))
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(tt.params_to_tree(params))):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(jax.tree_util.tree_leaves(loaded)[0],
                           jax.tree_util.tree_leaves(jax_params)[0])  # it trained
    # The step state after the epoch, read by the JAX trainer's loader.
    state = jckpt.load_step_state(template, optax.adam(1e-3).init(template), "fast_st",
                                  "tiny", models, extra_keys=("batch_in_epoch",))
    assert (int(state["epoch"]), int(state["iteration"])) == (1, 2)
    assert int(state["extra"]["batch_in_epoch"]) == 0
    assert int(state["opt_state"][0].count) == 2
    logs = os.listdir(tmp_path / "runs")
    assert len(logs) == 1 and logs[0].startswith("events.out.tfevents")


def test_static_train_resumes_a_step_state_at_its_loader_position(
        tmp_path, jax_params, jax_vgg):
    """A state at batch 3 of epoch 0 (as a stopped run leaves it): the
    resumed run decodes none of the first three batches' images, and its
    iteration and Adam count go on from 3."""
    models = str(tmp_path / "models")
    params = tt.params_from_jax(jax_params, device="cpu")
    opt_state = tckpt.adam_state_to_tree(params, fast.make_optimizer(params))
    opt_state["0"]["count"] = np.asarray(3, np.int32)
    tckpt.save_step_state(params, opt_state, 0, 3, "fast_st", "tiny", models,
                          extra={"batch_in_epoch": 3})
    loaded = []
    train = tcoco.DataLoader(tcoco.SyntheticDataset(16, 32), 2, seed=1, num_threads=2)
    first_slots = train._indices(epoch=0)[:6]
    load = train.dataset.load
    train.dataset.load = lambda i: (loaded.append(i), load(i))[1]
    _tiny_run(tmp_path, jax_params, jax_vgg, train_loader=train, step_checkpoint_every=1)
    assert loaded and not set(loaded) & set(first_slots)
    state = tckpt.load_step_state("fast_st", "tiny", models, extra_keys=("batch_in_epoch",))
    assert (state["epoch"], state["iteration"]) == (1, 5)
    assert int(state["opt_state"]["0"]["count"]) == 5


def test_static_train_skips_an_epoch_whose_checkpoint_exists(tmp_path, jax_params, jax_vgg):
    models = str(tmp_path / "models")
    jckpt.save_epoch(jax_params, "fast_st", "tiny", 0, models)
    before = fin.fwd_launches
    params, train = _tiny_run(tmp_path, jax_params, jax_vgg, train_loader=None)
    assert fin.fwd_launches == before
    for a, b in zip(jax.tree_util.tree_leaves(tt.params_to_tree(params)),
                    jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_array_equal(a, b)


def test_load_step_state_fills_what_an_older_state_lacks(tmp_path, jax_params):
    """A state written before ``arrays`` and ``batch_in_epoch`` existed."""
    params = tt.params_from_jax(jax_params, device="cpu")
    path = tckpt.step_state_path("fast_st", "old", str(tmp_path))
    tckpt.save({"params": params, "opt_state": tckpt.adam_state_to_tree(
        params, fast.make_optimizer(params)), "epoch": np.int64(2),
        "iteration": np.int64(40), "extra": {}}, path)
    state = tckpt.load_step_state("fast_st", "old", str(tmp_path),
                                  extra_keys=("batch_in_epoch",))
    assert state["extra"] == {"batch_in_epoch": 0} and state["arrays"] == {}
    assert (state["epoch"], state["iteration"]) == (2, 40)
    assert tckpt.load_step_state("fast_st", "missing", str(tmp_path)) is None


def test_train_cli_passes_its_options(monkeypatch, tmp_path):
    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli

    style_dir = tmp_path / "styles"
    style_dir.mkdir()
    Image = pytest.importorskip("PIL.Image")
    Image.fromarray(np.zeros((40, 30, 3), np.uint8)).save(style_dir / "wave.png")
    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    seen = {}
    monkeypatch.setattr(fast, "static_train", lambda img, **kw: seen.update(kw, img=img))
    result = CliRunner().invoke(cli, ["fast_st", "train", "styles/wave.png", "-e", "2", "-b",
                                      "3", "-sw", "10", "--precision", "bf16",
                                      "--step-checkpoint-every", "5", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert seen["img"].shape == (1, 256, 256, 3)
    assert {k: seen[k] for k in ("style_name", "epochs", "batch_size", "style_weight",
                                 "precision", "step_checkpoint_every", "device")} == {
        "style_name": "wave.png", "epochs": 2, "batch_size": 3, "style_weight": 10,
        "precision": "bf16", "step_checkpoint_every": 5, "device": "cpu"}
