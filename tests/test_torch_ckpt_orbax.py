"""The port's Orbax checkpoints (``ckpt_orbax.py``, ``STX_CKPT_BACKEND=orbax``)
against orbax and tensorstore: the port reads what the JAX package's
``ckpt.save`` wrote and the JAX package reads what the port wrote, bit for
bit; the OCDBT key listing and raw values against tensorstore's ``ocdbt``
kvstore; a damaged node named in the error; the backend's paths, preference,
overwrite and failed save beside the JAX functions; and ``convert-image``
from a models directory whose newest epoch JAX wrote as ``.orbax``."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import tensorstore as ts
from click.testing import CliRunner
from PIL import Image

from styletransfer_tpu import ckpt as jckpt
from styletransfer_tpu.engines import fast as jfast
from styletransfer_tpu.models import multistyle as jmulti
from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu_torch import ckpt as tckpt
from styletransfer_tpu_torch import ckpt_orbax
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.clis import cli as tcli
from styletransfer_tpu_torch.models import transformer as tt

SIZE = 32
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures",
                       "seeded.orbax")


def _multistyle_tree():
    """Four styles whose affine rows differ (a broadcast init would hide a
    row mix-up)."""
    tree = jax.device_get(jmulti.init_params(jax.random.PRNGKey(3), 4))
    rng = np.random.default_rng(4)
    return jax.tree_util.tree_map(
        lambda v: (v + rng.standard_normal(v.shape)).astype(np.float32) if v.ndim == 2 else v,
        tree)


TREES = {
    "transform_3ch": lambda: jax.device_get(jt.init_params(jax.random.PRNGKey(1))),
    "video_6ch": lambda: jax.device_get(jt.init_video_params(jax.random.PRNGKey(2))),
    "multistyle": _multistyle_tree,
}


@pytest.fixture(scope="module")
def trees():
    return {name: make() for name, make in TREES.items()}


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory, trees):
    """Each tree written by the JAX package's ckpt.save as ``.orbax``."""
    d = tmp_path_factory.mktemp("jax_orbax")
    paths = {}
    for name, tree in trees.items():
        paths[name] = str(d / f"{name}.orbax")
        jckpt.save(tree, paths[name])
    return paths


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _tensorstore_items(path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}"}).result()
    return dict(sorted((k, bytes(kv.read(k).result().value)) for k in kv.list().result()))


@pytest.mark.parametrize("name", list(TREES))
def test_port_loads_what_jax_saved(jax_written, trees, name):
    _assert_trees_equal(tckpt.load(jax_written[name]), trees[name])


@pytest.mark.parametrize("name", list(TREES))
def test_jax_loads_what_the_port_saved(tmp_path, trees, name):
    path = str(tmp_path / f"{name}.orbax")
    tckpt.save(trees[name], path)
    template = jax.tree_util.tree_map(np.zeros_like, trees[name])
    _assert_trees_equal(jax.device_get(jckpt.load(path, template)), trees[name])
    assert os.listdir(tmp_path) == [f"{name}.orbax"]


def test_jax_loads_a_module_the_port_saved(tmp_path, trees):
    params = tt.params_from_jax(trees["transform_3ch"], device="cpu")
    path = str(tmp_path / "net.orbax")
    tckpt.save(params, path)
    template = jax.tree_util.tree_map(np.zeros_like, trees["transform_3ch"])
    _assert_trees_equal(jax.device_get(jckpt.load(path, template)), trees["transform_3ch"])


@pytest.mark.parametrize("source", ["jax", "port", "fixture"])
def test_key_listing_and_values_match_tensorstore(tmp_path, jax_written, trees, source):
    if source == "jax":
        path = jax_written["transform_3ch"]
    elif source == "port":
        path = str(tmp_path / "p.orbax")
        ckpt_orbax.save(trees["transform_3ch"], path)
    else:
        path = FIXTURE
    got = ckpt_orbax.read_kvstore(path)
    want = _tensorstore_items(path)
    assert list(got) == list(want) and got == want


def test_interior_nodes_and_old_generations_match_tensorstore(tmp_path):
    """A database tensorstore wrote with small nodes (interior levels), small
    inline values, and more generations than the manifest holds inline."""
    base = f"file://{tmp_path}/db"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": base, "config": {
        "compression": {"id": "zstd", "level": 3}, "max_decoded_node_bytes": 200,
        "max_inline_value_bytes": 10}}).result()
    txn = ts.Transaction()
    for i in range(60):
        kv.with_transaction(txn)[f"prefix/key{i:03d}"] = bytes([i]) * (i % 20 + 1)
    txn.commit_async().result()
    for j in range(20):
        kv[f"gen{j}"] = b"x" * j
    del kv["prefix/key007"]
    got = ckpt_orbax.read_kvstore(str(tmp_path / "db"))
    assert got == _tensorstore_items(str(tmp_path / "db")) and len(got) == 79


def test_the_committed_fixture_holds_the_seeded_arrays():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fixture", os.path.join(os.path.dirname(FIXTURE), "..", "..", "scripts",
                                "torch_orbax_fixture_arrays.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _assert_trees_equal(tckpt.load(FIXTURE), module.fixture_arrays())


@pytest.mark.parametrize("target", ["root_node", "manifest"])
def test_a_flipped_byte_is_named_in_the_error(tmp_path, jax_written, target):
    path = str(tmp_path / "c.orbax")
    shutil.copytree(jax_written["transform_3ch"], path)
    if target == "manifest":
        victim, name = os.path.join(path, "manifest.ocdbt"), "manifest.ocdbt"
    else:
        victim = os.path.join(path, "d", os.listdir(os.path.join(path, "d"))[0])
        name = f"d/{os.path.basename(victim)}"
    data = bytearray(open(victim, "rb").read())
    data[len(data) // 2] ^= 0x10
    open(victim, "wb").write(bytes(data))
    with pytest.raises(ValueError, match=name.replace(".", r"\.")) as err:
        tckpt.load(path)
    assert "CRC-32C mismatch" in str(err.value)


def test_a_value_past_the_end_of_its_data_file_is_named(tmp_path):
    """The root's leaf refers into the per-process database's data files; a
    file cut short is named with the bytes it lacks."""
    path = str(tmp_path / "c.orbax")
    shutil.copytree(FIXTURE, path)
    data_dir = os.path.join(path, "ocdbt.process_0", "d")
    victim = max(os.listdir(data_dir), key=lambda f: os.path.getsize(os.path.join(data_dir, f)))
    with open(os.path.join(data_dir, victim), "r+b") as f:
        f.truncate(1000)
    with pytest.raises(ValueError, match=f"ocdbt.process_0/d/{victim}: bytes .* past its end"):
        tckpt.load(path)


def test_other_dtypes_raise_naming_them(tmp_path):
    with pytest.raises(ValueError, match="a.w: dtype int64"):
        ckpt_orbax.save({"a": {"w": np.arange(3)}}, str(tmp_path / "x.orbax"))
    assert os.listdir(tmp_path) == []
    jckpt.save({"a": {"w": np.arange(3, dtype=np.int32)}}, str(tmp_path / "j.orbax"))
    with pytest.raises(ValueError, match="a.w: dtype '<i4'"):
        tckpt.load(str(tmp_path / "j.orbax"))


@pytest.mark.parametrize("backend", [None, "msgpack", "orbax"])
def test_backend_paths_and_preference_match_jax(tmp_path, monkeypatch, trees, backend):
    if backend is None:
        monkeypatch.delenv("STX_CKPT_BACKEND", raising=False)
    else:
        monkeypatch.setenv("STX_CKPT_BACKEND", backend)
    models = str(tmp_path)
    args = ("fast_st", "wave")
    for epoch in (0, 1, 2):
        assert tckpt.checkpoint_path(*args, epoch, models) == \
            jckpt.checkpoint_path(*args, epoch, models)
    tree = trees["transform_3ch"]
    tckpt.save(tree, str(tmp_path / "fast_st_wave_epoch0.msgpack"))
    tckpt.save(tree, str(tmp_path / "fast_st_wave_epoch0.orbax"))
    tckpt.save(tree, str(tmp_path / "fast_st_wave_epoch1.orbax"))
    for epoch in (0, 1, 2):
        assert tckpt.existing_checkpoint_path(*args, epoch, models) == \
            jckpt.existing_checkpoint_path(*args, epoch, models)
        assert tckpt.epoch_checkpoint_exists(*args, epoch, models) == \
            jckpt.epoch_checkpoint_exists(*args, epoch, models)
    want = "orbax" if backend == "orbax" else "msgpack"
    assert tckpt.existing_checkpoint_path(*args, 0, models).endswith(want)
    assert tckpt.find_latest(*args, models) == jckpt.find_latest(*args, models)
    tckpt.save(tree, str(tmp_path / "fast_st_wave_epoch1.msgpack"))
    assert tckpt.find_latest(*args, models) == jckpt.find_latest(*args, models)
    assert tckpt.find_latest(*args, models)[0].endswith("epoch1.msgpack")
    path = tckpt.save_epoch(tree, *args, 5, models)
    assert path == jckpt.checkpoint_path(*args, 5, models) and os.path.exists(path)
    # Step states stay msgpack under either backend.
    assert tckpt.step_state_path(*args, models) == jckpt.step_state_path(*args, models)


def test_a_bad_backend_raises_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("STX_CKPT_BACKEND", "zarr")
    for module in (tckpt, jckpt):
        with pytest.raises(ValueError, match="STX_CKPT_BACKEND must be 'msgpack' or 'orbax'"):
            module.checkpoint_path("fast_st", "wave", 0, str(tmp_path))
        with pytest.raises(ValueError, match="STX_CKPT_BACKEND"):
            module.existing_checkpoint_path("fast_st", "wave", 0, str(tmp_path))


def test_a_save_overwrites_an_epoch_as_jax_does(tmp_path, trees):
    """JAX saves with force=True; the port's save replaces the directory,
    and neither leaves anything beside it."""
    a, b = trees["transform_3ch"], trees["video_6ch"]
    for save, load in ((jckpt.save, tckpt.load), (tckpt.save, tckpt.load)):
        path = str(tmp_path / "e.orbax")
        save(a, path)
        save(b, path)
        _assert_trees_equal(load(path), b)
        assert os.listdir(tmp_path) == ["e.orbax"]
        shutil.rmtree(path)


def test_a_failed_save_leaves_the_old_epoch_and_no_temporary(tmp_path, trees, monkeypatch):
    path = str(tmp_path / "e.orbax")
    tckpt.save(trees["transform_3ch"], path)

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_orbax, "_manifest", broken)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save(trees["video_6ch"], path)
    assert os.listdir(tmp_path) == ["e.orbax"]
    _assert_trees_equal(tckpt.load(path), trees["transform_3ch"])
    monkeypatch.undo()
    monkeypatch.setattr(os, "rename", broken)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save(trees["video_6ch"], str(tmp_path / "new.orbax"))
    assert os.listdir(tmp_path) == ["e.orbax"]


def test_metadata_files_are_orbax_s(tmp_path, trees, jax_written):
    path = str(tmp_path / "p.orbax")
    tckpt.save(trees["transform_3ch"], path)
    for name in ("_METADATA", "_CHECKPOINT_METADATA"):
        with open(os.path.join(path, name)) as f:
            got = json.load(f)
        with open(os.path.join(jax_written["transform_3ch"], name)) as f:
            want = json.load(f)
        assert sorted(got) == sorted(want)
        if name == "_METADATA":
            assert got == want
        else:
            assert got["item_handlers"] == want["item_handlers"]


def test_load_latest_transformer_from_a_jax_orbax_epoch(tmp_path, trees):
    jckpt.save(trees["transform_3ch"], str(tmp_path / "fast_st_wave_epoch4.orbax"))
    tckpt.save(trees["video_6ch"], str(tmp_path / "fast_st_wave_epoch3.msgpack"))
    params, epoch = tckpt.load_latest_transformer("fast_st", "wave", str(tmp_path),
                                                  device="cpu")
    assert epoch == 4
    _assert_trees_equal(tt.params_to_tree(params), trees["transform_3ch"])


def test_convert_image_from_a_jax_orbax_epoch(tmp_path, monkeypatch, trees):
    """The slice end to end: the port's convert-image serves the newest
    epoch, an .orbax directory the JAX package wrote, within one step of
    the JAX package's own output from it."""
    models = tmp_path / "data" / "models"
    jckpt.save(jax.device_get(jt.init_params(jax.random.PRNGKey(9))),
               str(models / "fast_st_tst_epoch1.msgpack"))
    jckpt.save(trees["transform_3ch"], str(models / "fast_st_tst_epoch2.orbax"))
    (tmp_path / "imgs").mkdir()
    img = np.random.default_rng(5).integers(0, 256, size=(40, 36, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "imgs" / "pic.png")
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    result = CliRunner().invoke(tcli, ["fast_st", "convert-image", "imgs/pic.png", "tst",
                                       "--size", str(SIZE), "--device", "cpu"])
    assert result.exit_code == 0, result.output
    got = np.asarray(Image.open(tmp_path / "results" / "converted_fast_st_tst.png"))
    want_path = jfast.process_image(str(tmp_path / "imgs" / "pic.png"), "tst",
                                    out_dir=str(tmp_path / "jax"), models_path=str(models),
                                    size=SIZE)
    want = np.asarray(Image.open(want_path))
    assert got.shape == (SIZE, SIZE, 3)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
