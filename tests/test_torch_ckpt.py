"""Checkpoints cross between the packages: the port reads what JAX
``ckpt.save`` wrote, JAX reads what the port wrote, and both pick the same
latest file."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from styletransfer_tpu import ckpt as jckpt
from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu_torch import ckpt as tckpt
from styletransfer_tpu_torch.models import transformer as tt


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jt.init_params(jax.random.PRNGKey(1)))


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_port_loads_what_jax_saved(tmp_path, jax_params):
    path = str(tmp_path / "fast_st_a_epoch0.msgpack")
    jckpt.save(jax_params, path)
    _assert_trees_equal(tckpt.load(path), jax_params)


@pytest.mark.parametrize("as_module", [True, False])
def test_jax_loads_what_the_port_saved(tmp_path, jax_params, as_module):
    path = str(tmp_path / "fast_st_a_epoch0.msgpack")
    params = tt.params_from_jax(jax_params, device="cpu")
    tckpt.save(params if as_module else tt.params_to_tree(params), path)
    template = jt.init_params(jax.random.PRNGKey(0))
    _assert_trees_equal(jax.device_get(jckpt.load(path, template)), jax_params)
    assert not any(n.startswith("fast_st_a_epoch0.msgpack.tmp") for n in os.listdir(tmp_path))


def test_scalars_and_bf16_arrays_cross(tmp_path):
    tree = {"a": {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)},
            "step": np.int64(7), "x": np.float32(0.5)}
    path = str(tmp_path / "t.msgpack")
    jckpt.save(tree, path)
    got = tckpt.load(path)
    np.testing.assert_array_equal(got["a"]["w"], np.arange(6, dtype=np.float32).reshape(2, 3))
    assert got["a"]["w"].dtype == np.float32  # numpy has no bfloat16: widened exactly
    assert got["step"] == 7 and got["x"] == np.float32(0.5)
    tckpt.save({"step": np.int64(7), "v": np.ones(3, np.float32)}, path)
    back = jckpt.load(path, {"step": np.int64(0), "v": np.zeros(3, np.float32)})
    assert np.asarray(back["step"]).shape == () and int(back["step"]) == 7
    np.testing.assert_array_equal(back["v"], np.ones(3, np.float32))


@pytest.mark.parametrize("names", [
    ["fast_st_wave_epoch2.msgpack", "fast_st_wave_epoch10.msgpack"],
    ["fast_st_wave_epoch3.pth", "fast_st_wave_epoch3.msgpack", "fast_st_wave_epoch1.pth"],
    ["fast_st_wave_epoch4.pth", "fast_st_wave_epoch3.msgpack"],
    ["fast_st_wave_epoch1.msgpack", "fast_st_wave_step_state.msgpack",
     "fast_st_wavy_epoch9.msgpack", "fast_st_other_epoch5.msgpack", "notes.txt"],
    ["fast_st_wave_epoch1.msgpack", "fast_st_wave_epoch2.orbax/"],
])
def test_find_latest_picks_the_same_file_as_jax(tmp_path, names):
    for n in names:
        if n.endswith("/"):
            (tmp_path / n).mkdir()
        else:
            (tmp_path / n).write_bytes(b"")
    assert tckpt.find_latest("fast_st", "wave", str(tmp_path)) == \
        jckpt.find_latest("fast_st", "wave", str(tmp_path))


def test_find_latest_raises_like_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="No weights"):
        tckpt.find_latest("fast_st", "wave", str(tmp_path / "missing"))


def test_load_latest_transformer(tmp_path, jax_params):
    jckpt.save_epoch(jax_params, "fast_st", "wave", 3, str(tmp_path))
    params, epoch = tckpt.load_latest_transformer("fast_st", "wave", str(tmp_path),
                                                  device="cpu")
    assert epoch == 3
    _assert_trees_equal(tt.params_to_tree(params), jax_params)


def _save_pth(params_tree, path):
    """A reference checkpoint as the original code wrote it: torch.save of
    the state dict (OIHW tensors under nn.Sequential keys)."""
    import torch

    torch.save(tt.export_torch_state_dict(params_tree), str(path))


def test_pth_checkpoints_wait_for_a_later_slice(tmp_path, jax_params):
    """(The name predates .pth and .orbax loading.) A models directory
    holding only a reference .pth loads through the layout converter, as the
    JAX package loads it; a later .orbax epoch then wins."""
    _save_pth(jax_params, tmp_path / "fast_st_wave_epoch1.pth")
    params, epoch = tckpt.load_latest_transformer("fast_st", "wave", str(tmp_path), device="cpu")
    assert epoch == 1
    _assert_trees_equal(tt.params_to_tree(params), jax_params)
    want, jepoch = jckpt.load_latest_transformer("fast_st", "wave",
                                                 jt.init_params(jax.random.PRNGKey(0)),
                                                 str(tmp_path))
    assert jepoch == 1
    _assert_trees_equal(tckpt.load(str(tmp_path / "fast_st_wave_epoch1.pth")),
                        jax.device_get(want))
    # A newer epoch the JAX package wrote as .orbax is the one loaded.
    newer = jax.device_get(jt.init_params(jax.random.PRNGKey(5)))
    jckpt.save(newer, str(tmp_path / "fast_st_wave_epoch2.orbax"))
    params, epoch = tckpt.load_latest_transformer("fast_st", "wave", str(tmp_path), device="cpu")
    assert epoch == 2
    _assert_trees_equal(tt.params_to_tree(params), newer)


def test_msgpack_wins_over_pth_at_equal_epochs(tmp_path, jax_params):
    other = jax.device_get(jt.init_params(jax.random.PRNGKey(9)))
    _save_pth(other, tmp_path / "fast_st_wave_epoch3.pth")
    jckpt.save_epoch(jax_params, "fast_st", "wave", 3, str(tmp_path))
    params, epoch = tckpt.load_latest_transformer("fast_st", "wave", str(tmp_path), device="cpu")
    assert epoch == 3
    _assert_trees_equal(tt.params_to_tree(params), jax_params)
    _save_pth(other, tmp_path / "fast_st_wave_epoch4.pth")  # a later .pth wins
    params, epoch = tckpt.load_latest_transformer("fast_st", "wave", str(tmp_path), device="cpu")
    assert epoch == 4
    _assert_trees_equal(tt.params_to_tree(params), other)


def test_load_torch_state_dict_matches_jax(tmp_path, jax_params):
    path = tmp_path / "net.pth"
    _save_pth(jax_params, path)
    got, want = tckpt.load_torch_state_dict(str(path)), jckpt.load_torch_state_dict(str(path))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_step_state_carry_arrays_cross(tmp_path, jax_params, writer):
    """The video trainer's carry frames ride the step state's ``arrays``:
    either package reads what the other wrote."""
    import optax
    import torch

    carry = {"old_content": np.arange(24, dtype=np.float32).reshape(1, 2, 4, 3),
             "old_stylized": -np.ones((1, 2, 4, 3), np.float32)}
    opt_state = optax.adam(1e-3).init(jax_params)
    extra = {"batch_in_epoch": 2, "chunk_in_batch": 5}
    if writer == "jax":
        jckpt.save_step_state(jax_params, opt_state, 1, 30, "video_st", "w", str(tmp_path),
                              extra=extra, arrays=carry)
    else:
        params = tt.params_from_jax(jax_params, device="cpu")
        tree = {"0": {"count": np.asarray(0, np.int32), "mu": jax_params, "nu": jax_params},
                "1": {}}
        tckpt.save_step_state(params, tree, 1, 30, "video_st", "w", str(tmp_path), extra=extra,
                              arrays={k: torch.from_numpy(v) for k, v in carry.items()})
    keys = ("old_content", "old_stylized")
    got = tckpt.load_step_state("video_st", "w", str(tmp_path), extra_keys=tuple(extra),
                                array_keys=keys)
    jgot = jckpt.load_step_state(jax_params, opt_state, "video_st", "w", str(tmp_path),
                                 extra_keys=tuple(extra), array_keys=keys)
    assert got["extra"] == extra and {k: int(v) for k, v in jgot["extra"].items()} == extra
    for k in keys:
        np.testing.assert_array_equal(got["arrays"][k], carry[k])
        np.testing.assert_array_equal(jgot["arrays"][k], carry[k])
    assert tckpt.load_step_state("video_st", "w", str(tmp_path))["arrays"] == {}


def test_epoch_checkpoint_checks_agree_with_jax(tmp_path, jax_params):
    models = str(tmp_path)
    assert not tckpt.epoch_checkpoint_exists("fast_st", "wave", 0, models)
    path = tckpt.save_epoch(tt.params_from_jax(jax_params, device="cpu"), "fast_st", "wave", 0,
                            models)
    assert path == jckpt.checkpoint_path("fast_st", "wave", 0, models)
    (tmp_path / "fast_st_wave_epoch1.orbax").mkdir()
    for epoch in (0, 1, 2):
        assert tckpt.existing_checkpoint_path("fast_st", "wave", epoch, models) == \
            jckpt.existing_checkpoint_path("fast_st", "wave", epoch, models)
        assert tckpt.epoch_checkpoint_exists("fast_st", "wave", epoch, models) == \
            jckpt.epoch_checkpoint_exists("fast_st", "wave", epoch, models)


def test_port_resumes_a_step_state_the_jax_trainer_wrote(tmp_path, jax_params):
    import optax
    import torch

    opt = optax.adam(1e-3)
    st = opt.init(jax_params)
    grads = jax.tree_util.tree_map(lambda a: jnp.ones_like(a) * 0.5, jax_params)
    _, st = opt.update(grads, st, jax_params)
    jckpt.save_step_state(jax_params, st, 3, 70, "fast_st", "wave", str(tmp_path),
                          extra={"batch_in_epoch": 9})
    state = tckpt.load_step_state("fast_st", "wave", str(tmp_path),
                                  extra_keys=("batch_in_epoch", "other"))
    assert (state["epoch"], state["iteration"]) == (3, 70)
    assert state["extra"] == {"batch_in_epoch": 9, "other": 0}
    _assert_trees_equal(state["params"], jax_params)
    params = tt.params_from_jax(state["params"], device="cpu")
    topt = torch.optim.Adam(params.parameters())
    tckpt.adam_state_from_tree(params, topt, state["opt_state"])
    adam = topt.state[params.res2.conv1.kernel]
    assert float(adam["step"]) == 1
    np.testing.assert_allclose(adam["exp_avg"].numpy(), 0.05, rtol=1e-6)
    np.testing.assert_allclose(adam["exp_avg_sq"].numpy(), 0.00025, rtol=1e-5)


@pytest.mark.parametrize("fails", ["write", "rename"])
def test_a_failed_save_leaves_no_temporary_file(tmp_path, monkeypatch, fails):
    """The JAX ``_atomic_write`` leaves ``<path>.tmp.<pid>.<tid>`` behind when
    the write or the rename raises; the port's ``save`` removes it, and the
    error reaches the caller."""
    import builtins

    params = tt.params_to_tree(tt.init_params(seed=0, device="cpu"))
    real_open = builtins.open

    class _FailingFile:
        def __init__(self, f):
            self.f = f

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

        def write(self, data):
            self.f.write(data[:10])
            raise OSError("disk full")

    def failing_open(path, mode="r", *args, **kwargs):
        f = real_open(path, mode, *args, **kwargs)
        return _FailingFile(f) if ".tmp." in str(path) and "w" in mode else f

    def failing_replace(src, dst):
        raise OSError("rename refused")

    def saved(save, sub):
        d = tmp_path / sub
        d.mkdir()
        with monkeypatch.context() as m:
            if fails == "write":
                m.setattr(builtins, "open", failing_open)
            else:
                m.setattr(os, "replace", failing_replace)
            with pytest.raises(OSError, match="disk full|rename refused"):
                save(params, str(d / "fast_st_a_epoch0.msgpack"))
        return sorted(os.listdir(d))

    jax_left = saved(jckpt.save, "jax")
    assert len(jax_left) == 1 and ".tmp." in jax_left[0]  # the fault, in JAX
    assert saved(tckpt.save, "port") == []
