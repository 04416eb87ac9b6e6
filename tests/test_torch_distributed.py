"""Data-parallel training in the port (parallel/distributed.py and the
trainers' global batch) on the CPU: two gloo ranks, each a subprocess of the
port, against the port's one-process step and the JAX package's step on the
same global batch; lockstep, the collective resume decisions and the carry
sidecars across two ranks; the loaders' shards, the global-batch option and
the CLI wiring in one process.

Every group of ranks runs under a time limit and is killed when it runs
out, so a hang fails the test."""

import json
import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from styletransfer_tpu.data import coco as jcoco
from styletransfer_tpu.data import video as jvideo_data
from styletransfer_tpu.engines import fast as jfast
from styletransfer_tpu.engines import multistyle as jms
from styletransfer_tpu.engines import video as jvideo
from styletransfer_tpu.models import vgg as jv
from styletransfer_tpu_torch.data import coco as tcoco
from styletransfer_tpu_torch.data import video as tvideo_data
from styletransfer_tpu_torch.models import transformer as tt
from styletransfer_tpu_torch.parallel import distributed, dryrun, mesh, prefetch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A group of two ranks at 32 px takes about 10-20 s here; a hang fails at
# this limit instead of holding the test run.
GROUP_TIMEOUT_S = 120
LR = 1e-3
# The loss components of the two ranks (their all-reduced means) against
# one process and JAX: measured within 5e-7.
METRIC_RTOL = 1e-5
# The video scan's frames after the first, against JAX: each follows an Adam
# step whose elements of rounding-noise gradient moved by +-lr in either
# package (ROADMAP Queue 3 item 3), about 1e-5 apart; test_torch_video.py's
# frame-loss limit against JAX.
LATER_FRAME_RTOL = 1e-4
# Each gradient as relative L2 error (test_torch_training.py's limit);
# measured 1.4e-6 against one process.
GRAD_REL_L2 = 5e-5
# The parameters after one Adam step, where the gradient is clear of
# rounding (test_torch_multistyle_train.py's limit).
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _popen(cmd):
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def _join(proc, timeout):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the ranks did not end within {timeout} s")
    return out.decode(errors="replace")


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    """The two-rank dry run, started at once (the tests compute their
    references while it runs); ``join()`` gives each rank's results."""
    out = tmp_path_factory.mktemp("dryrun")
    proc = _popen([sys.executable, "-m", "styletransfer_tpu_torch.parallel.dryrun",
                   "--ranks", "2", "--device", "cpu", "--threads", "1", "--out", str(out),
                   "--timeout", str(GROUP_TIMEOUT_S)])
    done = {}

    def join():
        if not done:
            log = _join(proc, GROUP_TIMEOUT_S + 30)
            assert proc.returncode == 0, log[-6000:]
            done["summary"] = json.loads(log.strip().splitlines()[-1])["dryrun"]
            done["ranks"] = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
        return done

    yield join
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


@pytest.fixture(scope="module")
def one_process(dry_run):
    """The initial parameters and the inputs, and the port's one-process
    steps on the whole global batch."""
    inp = dryrun.inputs(2)
    init = dryrun.models("cpu")
    ref = dryrun.run_steps(dryrun.models("cpu"), inp, slice(None), torch.device("cpu"))
    return init, inp, ref


def _vgg_tree(port_vgg):
    return {n: {k: v.numpy() for k, v in p.items()} for n, p in port_vgg.items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree):
    """A JAX tree by the port's parameter names."""
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_step(trainer, init, inp):
    """JAX's step on the whole global batch: ``(metrics, gradients,
    parameters after)`` by the port's names. The gradients come from Adam's
    first moment after one update, (1 - b1) g."""
    vgg_tree = _vgg_tree(init["vgg"])
    if trainer == "fast":
        grams = jv.style_gram_targets(vgg_tree, jnp.asarray(inp["style"]))
        opt, step = jfast.make_train_step(vgg_tree, grams)
        p = _jnp(tt.params_to_tree(init["fast"]))
        p, state, m = step(p, opt.init(p), jnp.asarray(inp["batch"]))
        return ({k: np.asarray(v) for k, v in m.items()}, _flat(jax.device_get(state[0].mu)),
                _flat(jax.device_get(p)))
    if trainer == "multi":
        grams = jms.stack_style_grams(vgg_tree, jnp.asarray(inp["styles"]))
        opt, step = jms.make_train_step(vgg_tree, grams)
        p = _jnp(tt.params_to_tree(init["multi"]))
        p, state, m = step(p, opt.init(p), jnp.asarray(inp["batch"]),
                           jnp.asarray(inp["idx"], jnp.int32))
        return ({k: np.asarray(v) for k, v in m.items()}, _flat(jax.device_get(state[0].mu)),
                _flat(jax.device_get(p)))
    grams = jv.style_gram_targets(vgg_tree, jnp.asarray(inp["style"]))
    opt, scan = jvideo.make_scan_train_step(vgg_tree, grams)
    p = _jnp(tt.params_to_tree(init["video"]))
    frames = jnp.asarray(inp["frames"])
    mask = jvideo.freeze_mask(p, False)
    p, state, c, s, first = scan(p, opt.init(p), frames[:1], jnp.asarray([True]), frames[0],
                                 frames[0], mask)
    mu = _flat(jax.device_get(state[0].mu))
    p, state, _, _, rest = scan(p, state, frames[1:], jnp.asarray([True, False]), c, s, mask)
    return ({k: np.concatenate([np.asarray(first[k]), np.asarray(rest[k])]) for k in first},
            mu, _flat(jax.device_get(p)))


def _assert_metrics(got, want, tag, label, later_rtol=METRIC_RTOL):
    for k in ("total", "style", "content", "tv") + (("temporal",) if tag == "video" else ()):
        g, w = np.atleast_1d(got[f"{tag}.metric.{k}"]), np.atleast_1d(want[k])
        np.testing.assert_allclose(g[:1], w[:1], rtol=METRIC_RTOL, atol=1e-12,
                                   err_msg=f"{label}: {k}")
        np.testing.assert_allclose(g[1:], w[1:], rtol=later_rtol, atol=1e-12,
                                   err_msg=f"{label}: {k}, later frames")


def _assert_grads(got, want, label):
    """Each gradient within GRAD_REL_L2; a gradient that is rounding noise
    (a bias that an instance norm cancels) stays so."""
    scale = max(np.linalg.norm(w) for w in want.values())
    for name, w in want.items():
        g = got[name]
        if np.linalg.norm(w) < 1e-6 * scale:
            assert np.linalg.norm(g) < 1e-6 * scale, f"{label}: {name}"
            continue
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < GRAD_REL_L2, f"{label}: {name}"


def _assert_params(got, want, grads, steps, label):
    """Adam's first step is about -lr sign(g): where g is rounding noise it
    may take either sign, so those elements are held to 2 lr a step (the
    video scan's two steps: every element), the rest to STEP_TOL."""
    top = max(np.abs(g).max() for g in grads.values())
    for name, w in want.items():
        g = grads[name]
        noise = (np.abs(g) < 1e-6 * np.abs(g).max() if np.abs(g).max() >= 1e-6 * top
                 else np.ones(g.shape, bool))
        if steps > 1:
            noise[...] = True
        np.testing.assert_allclose(got[name][~noise], w[~noise], err_msg=f"{label}: {name}",
                                   **STEP_TOL)
        np.testing.assert_allclose(got[name][noise], w[noise], rtol=0, atol=2 * LR * steps,
                                   err_msg=f"{label}: {name}")


def _by_kind(results, tag, kind):
    prefix = f"{tag}.{kind}."
    return {k[len(prefix):]: v for k, v in results.items() if k.startswith(prefix)}


@pytest.mark.subprocess
@pytest.mark.parametrize("trainer", ["fast", "multi", "video"])
def test_two_ranks_match_one_process_and_jax(dry_run, one_process, trainer):
    """Two gloo ranks, each with half of a global batch of 4 (the video
    scan: 3 frames of 4 clips, the third padded), against the port's
    one-process step on all 4 and JAX's step on the same global batch."""
    init, inp, ref = one_process
    jm, jmu, jparams = _jax_step(trainer, init, inp)
    ranks = dry_run()["ranks"]
    steps = 2 if trainer == "video" else 1
    for r, got in enumerate(ranks):
        _assert_metrics(got, {k[len(trainer) + 8:]: v for k, v in ref.items()
                              if k.startswith(f"{trainer}.metric.")}, trainer,
                        f"rank {r} vs one process")
        _assert_metrics(got, jm, trainer, f"rank {r} vs JAX", LATER_FRAME_RTOL)
        grads = _by_kind(got, trainer, "grad")
        _assert_grads(grads, _by_kind(ref, trainer, "grad"), f"rank {r} vs one process")
        _assert_grads(grads, {k: v / 0.1 for k, v in jmu.items()}, f"rank {r} vs JAX")
        params = _by_kind(got, trainer, "param")
        _assert_params(params, _by_kind(ref, trainer, "param"), _by_kind(ref, trainer, "grad"),
                       steps, f"rank {r} vs one process")
        _assert_params(params, jparams, _by_kind(ref, trainer, "grad"), steps,
                       f"rank {r} vs JAX")


@pytest.mark.subprocess
def test_ranks_hold_bit_identical_params_and_metrics(dry_run):
    done = dry_run()
    r0, r1 = done["ranks"]
    keys = [k for k in r0 if ".param." in k or ".metric." in k]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert done["summary"]["ranks"] == 2


@pytest.mark.subprocess
def test_gatys_lanes_placed_over_two_slots_equal_the_lanes_unplaced(dry_run):
    """Adam lanes are independent problems: split over two device slots,
    each with its own Gram targets, they are the unplaced lanes."""
    r0 = dry_run()["ranks"][0]
    assert r0["gatys.placed.losses"].shape == (2, dryrun.GATYS_STEPS)
    np.testing.assert_allclose(r0["gatys.placed.losses"], r0["gatys.alone.losses"], rtol=1e-5)
    np.testing.assert_allclose(r0["gatys.placed.pixels"], r0["gatys.alone.pixels"], atol=1e-5)


# --- lockstep, resume agreement and carry sidecars over two ranks -------------

_WORKER = textwrap.dedent(r'''
    import json, os, sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from styletransfer_tpu_torch import ckpt
    from styletransfer_tpu_torch.data import video as vdata
    from styletransfer_tpu_torch.engines import video
    from styletransfer_tpu_torch.models import transformer, vgg
    from styletransfer_tpu_torch.parallel import distributed

    out = sys.argv[1]
    rank, world = distributed.initialize(device="cpu")
    res = {"rank": rank, "world": world}

    # Uneven work: rank 0 has 3 items, rank 1 has 5; both see 3, and the
    # group is still aligned afterwards.
    res["seen"] = list(distributed.lockstep(range(3 if rank == 0 else 5)))
    res["after"] = distributed.agree_min(len(res["seen"]) + 10 * rank)

    state = {"epoch": 1, "iteration": 7, "extra": {"batch_in_epoch": 2}}
    other = {"epoch": 1, "iteration": 7 + rank, "extra": {"batch_in_epoch": 2}}
    res["resume"] = {
        "same": distributed.agree_resume_state(state) is state,
        "mismatched": distributed.agree_resume_state(other) is None,
        "one_missing": distributed.agree_resume_state(state if rank == 0 else None) is None,
        "extra_differs": distributed.agree_resume_state(
            {"epoch": 1, "iteration": 7, "extra": {"batch_in_epoch": rank}}) is None,
        "positions": [distributed.positions_agree(1, 2), distributed.positions_agree(1, rank)],
        "agree": [video._all_processes_agree(True), video._all_processes_agree(rank == 0),
                  video._all_processes_agree(False)],
    }

    gb = distributed.global_batch()
    x = torch.tensor(2.0 + rank, requires_grad=True)
    y = gb.sum(x * x)
    y.backward()
    res["global_sum"] = [float(y), float(x.grad), gb.mean_float(float(rank))]

    # Under NCCL the control collectives run on a gloo side group over CPU
    # tensors. The CPU has no NCCL, so the default group's backend is named
    # so here, and the side group forms and carries them.
    real_backend = distributed.dist.get_backend
    distributed.dist.get_backend = lambda group=None: "nccl"
    try:
        res["control"] = {
            "seen": list(distributed.lockstep(range(2 if rank == 0 else 4))),
            "min": distributed.agree_min(5 + rank),
            "positions": [distributed.positions_agree(3), distributed.positions_agree(rank)],
            "mean": gb.mean_float(float(rank)),
        }
    finally:
        distributed.dist.get_backend = real_backend
    side = distributed._control
    res["control"]["side"] = [side is not None, side is not None and real_backend(side),
                              side is not None and side.size()]

    models = os.path.join(out, "sidecars")
    local = np.arange(2 * 3 * 3 * 3, dtype=np.float32).reshape(2, 3, 3, 3) + 1000 * rank
    path = ckpt.save_carry_shards({"old_content": torch.from_numpy(local),
                                   "old_stylized": local * 2}, 7, "video_st", "s", models)
    keys = ("old_content", "old_stylized")
    loaded = ckpt.load_carry_shards(7, "video_st", "s", models, array_keys=keys)
    res["sidecar"] = {
        "name": os.path.basename(path),
        "round_trip": bool(np.array_equal(loaded["old_content"], local)
                           and np.array_equal(loaded["old_stylized"], local * 2)),
        "stale": ckpt.load_carry_shards(8, "video_st", "s", models, array_keys=keys) is None,
        "missing_key": ckpt.load_carry_shards(7, "video_st", "s", models,
                                              array_keys=keys + ("other",)) is None,
    }

    # video_train over 4 synthetic 32 px clips, one per rank and video
    # batch; rank 1's clips are a frame longer, so each video batch's last
    # chunk steps the one frame both ranks have.
    class Clips:
        def __iter__(self):
            for seed in (rank, 2 + rank):
                yield [vdata.SyntheticFrameReader(seed, 5 + rank, 32)]

    class Stop(Exception):
        pass

    style = np.random.default_rng(40).standard_normal((1, 32, 32, 3)).astype(np.float32)
    vgg_params = vgg.init_params(0, device="cpu")
    steps = []
    real_step = video.make_scan_train_step

    def counting(*a, **kw):
        opt, step = real_step(*a, **kw)
        return opt, lambda *s: steps.append(int(np.sum(s[3]))) or step(*s)

    video.make_scan_train_step = counting

    def train(name):
        del steps[:]
        params = video.video_train(
            style, style_name="tiny", epochs=1, batch_size=2, vgg_params=vgg_params,
            params=transformer.init_video_params(2, device="cpu"), video_loader=Clips(),
            chunk_size=2, runs_dir=os.path.join(out, "runs", name),
            models_path=os.path.join(out, name), step_checkpoint_every=2, device="cpu")
        return torch.cat([p.detach().reshape(-1) for p in params.parameters()]).numpy(), list(steps)

    save = ckpt.save_step_state

    def cut(name):
        def save_then_stop(*args, **kw):
            path = save(*args, **kw)
            if args[3] == 7:
                raise Stop
            return path
        ckpt.save_step_state = save_then_stop
        try:
            train(name)
        except Stop:
            pass
        finally:
            ckpt.save_step_state = save

    flat = {}
    flat["whole"], res["whole_steps"] = train("whole")
    cut("cut")
    flat["resumed"], res["resumed_steps"] = train("cut")
    cut("lost")
    if rank == 1:
        os.remove(ckpt.carry_shard_path("video_st", "tiny", os.path.join(out, "lost")))
    flat["fallback"], res["fallback_steps"] = train("lost")
    np.savez(os.path.join(out, f"rank{rank}.npz"), **flat)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.shutdown()
''')


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("group")
    worker = out / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ranks = distributed.launch_local([sys.executable, str(worker), str(out)], 2,
                                     GROUP_TIMEOUT_S, env=env, cwd=ROOT)
    for r, (code, log) in enumerate(ranks):
        assert code == 0, f"rank {r}:\n{log[-6000:]}"
    return ([json.loads((out / f"rank{r}.json").read_text()) for r in range(2)],
            [dict(np.load(out / f"rank{r}.npz")) for r in range(2)])


@pytest.mark.subprocess
def test_lockstep_stops_every_rank_at_the_shortest_shard(group):
    res, _ = group
    assert [r["seen"] for r in res] == [[0, 1, 2], [0, 1, 2]]
    assert [r["after"] for r in res] == [3, 3]  # the group is still aligned


@pytest.mark.subprocess
def test_resume_positions_are_agreed_by_every_rank(group):
    """agree_resume_state keeps a state only when every rank loaded the same
    position; a mismatch, a rank without a state or another batch offset
    drops it on every rank together."""
    res, _ = group
    for r in res:
        assert r["resume"] == {"same": True, "mismatched": True, "one_missing": True,
                               "extra_differs": True, "positions": [True, False],
                               "agree": [True, False, False]}, r["rank"]


@pytest.mark.subprocess
def test_global_sum_is_the_same_everywhere_and_its_gradient_counts_world_times(group):
    res, _ = group
    for r in res:
        y, grad, mean = r["global_sum"]
        assert y == 4.0 + 9.0 and mean == 0.5
        # d(y)/dx = 2x, times the world size (the ranks' gradients are averaged).
        assert grad == 2 * (2.0 + r["rank"]) * 2


@pytest.mark.subprocess
def test_control_collectives_run_on_a_gloo_side_group_under_nccl(group):
    """lockstep, agree_min, positions_agree and mean_float give the same
    answers on the side group, which holds both ranks on gloo."""
    res, _ = group
    for r in res:
        assert r["control"] == {"seen": [0, 1], "min": 5, "positions": [True, False],
                                "mean": 0.5, "side": [True, "gloo", 2]}, r["rank"]


@pytest.mark.subprocess
def test_carry_sidecars_are_per_rank_and_stamped(group):
    res, _ = group
    assert [r["sidecar"]["name"] for r in res] == [
        "video_st_s_step_carry_p0of2.msgpack", "video_st_s_step_carry_p1of2.msgpack"]
    for r in res:
        assert r["sidecar"]["round_trip"] and r["sidecar"]["stale"]
        assert r["sidecar"]["missing_key"]


@pytest.mark.subprocess
def test_video_resume_from_the_sidecars_is_the_whole_run(group):
    """Stopped after the step state at frame 7 (video batch 1, after its
    first chunk), resumed from each rank's sidecar: the last two chunks
    only, ending with the uninterrupted run's parameters on both ranks.
    Each video batch's last chunk steps the one frame that both ranks have."""
    res, flat = group
    for r, f in zip(res, flat):
        assert r["whole_steps"] == [2, 2, 1, 2, 2, 1]
        assert r["resumed_steps"] == [2, 1]
        np.testing.assert_array_equal(f["resumed"], f["whole"])
    np.testing.assert_array_equal(flat[0]["whole"], flat[1]["whole"])


@pytest.mark.subprocess
def test_video_resume_with_a_sidecar_missing_restarts_the_batch_on_every_rank(group):
    """Rank 1's sidecar is gone: both ranks restart video batch 1 from its
    start together (no hang), and stay bit-identical."""
    res, flat = group
    assert [r["fallback_steps"] for r in res] == [[2, 2, 1], [2, 2, 1]]
    np.testing.assert_array_equal(flat[0]["fallback"], flat[1]["fallback"])
    assert np.isfinite(flat[0]["fallback"]).all()
    assert not np.array_equal(flat[0]["fallback"], flat[0]["whole"])


# --- one process ----------------------------------------------------------------

def test_lockstep_single_process_passthrough():
    assert list(distributed.lockstep(iter("abc"))) == ["a", "b", "c"]
    assert list(distributed.lockstep([])) == []


def test_without_settings_a_run_is_one_process(monkeypatch):
    for name in ("STX_COORDINATOR_ADDRESS", "STX_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert not distributed.is_configured()
    assert distributed.initialize(device="cpu") == (0, 1)
    assert distributed.process_info() == (0, 1)
    assert distributed.local_batch_size(8) == 8
    assert distributed.global_batch() is None
    assert distributed.agree_min(3) == 3 and distributed.positions_agree(1, 2)


def test_torchrun_variables_stand_for_the_stx_ones(monkeypatch):
    for name in ("STX_COORDINATOR_ADDRESS", "STX_NUM_PROCESSES", "STX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert distributed.is_configured()
    assert [distributed._env(n) for n in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                                          "PROCESS_ID")] == ["10.0.0.1:29500", "4", "3"]
    monkeypatch.setenv("STX_PROCESS_ID", "1")
    assert distributed._env("PROCESS_ID") == "1"


@pytest.mark.parametrize("kwargs,error", [
    (dict(coordinator_address="127.0.0.1:{port}", num_processes=2, process_id=1),
     torch.distributed.DistError),
    (dict(coordinator_address="no-port-here", num_processes=2, process_id=0), ValueError),
    (dict(coordinator_address="127.0.0.1:{port}", process_id=0), ValueError),
    (dict(coordinator_address="127.0.0.1:{port}", num_processes=2, process_id=2), ValueError),
])
def test_initialize_raises_when_the_group_cannot_be_formed(monkeypatch, kwargs, error):
    """No fallback (the JAX initialize logs a failure and carries on): a
    coordinator that does not answer, a malformed address or a missing
    setting raises, and no group is left behind."""
    for name in ("STX_NUM_PROCESSES", "STX_PROCESS_ID", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    port = distributed.free_port()
    kwargs = {k: v.format(port=port) if isinstance(v, str) else v for k, v in kwargs.items()}
    with pytest.raises(error):
        distributed.initialize(device="cpu", timeout_s=1, **kwargs)
    assert not torch.distributed.is_initialized()


def test_initialize_refuses_nccl_on_the_cpu():
    with pytest.raises(ValueError, match="nccl"):
        distributed.initialize("127.0.0.1:1", 2, 0, device="cpu", backend="nccl")


@pytest.mark.parametrize("count,index", [(2, 0), (2, 1), (3, 2)])
def test_loader_shards_are_disjoint_cover_the_corpus_and_match_jax(count, index):
    """The strided split of both packages, side by side: the same indices
    for the same seed and epoch, disjoint across ranks, together the whole
    corpus."""
    def loader(coco, i):
        return coco.DataLoader(coco.SyntheticDataset(11, 8), batch_size=2, seed=7,
                               shard_index=i, shard_count=count)

    for epoch in (0, 3):
        got = loader(tcoco, index)._indices(epoch)
        assert got == loader(jcoco, index)._indices(epoch)
        assert len(loader(tcoco, index)) == len(loader(jcoco, index)) == len(got) // 2
        every = [i for r in range(count) for i in loader(tcoco, r)._indices(epoch)]
        assert sorted(every) == list(range(11))


def test_get_coco_loader_shards_both_splits(tmp_path):
    test0, train0 = tcoco.get_coco_loader(batch_size=2, test_limit=8, train_limit=16,
                                          image_dir=str(tmp_path), shard_index=0, shard_count=2)
    test1, train1 = tcoco.get_coco_loader(batch_size=2, test_limit=8, train_limit=16,
                                          image_dir=str(tmp_path), shard_index=1, shard_count=2)
    assert not set(train0._indices()) & set(train1._indices())
    assert not set(test0._indices()) & set(test1._indices())
    assert len(train0) == len(train1) == 4


@pytest.mark.parametrize("batch", [1, 2])
def test_video_dataset_shards_match_jax_and_never_clamp(batch):
    """Sharded, the batch is never clamped to the rank's clips (every rank's
    local batch has one size): a short shard yields fewer batches."""
    for index in (0, 1):
        kw = dict(videos=list(range(5)), batch_size=batch, shard_index=index, shard_count=2)
        got = tvideo_data.VideoDataset(**kw)
        want = jvideo_data.VideoDataset(**kw)
        assert got.video_batches == want.video_batches
        assert got.batch_size == batch
    assert tvideo_data.VideoDataset(videos=[0, 1, 2], batch_size=2, shard_index=1,
                                    shard_count=2).video_batches == []


def test_resolve_global_batch_semantics(monkeypatch):
    """tests/test_parallel.py::test_resolve_global_batch_semantics for the
    port: 'auto' is -b per rank, an integer overrides, nonsense raises; in
    one process 'auto' is -b itself."""
    assert mesh.resolve_global_batch(4, None) == 4
    assert mesh.resolve_global_batch(4, "") == 4
    assert mesh.resolve_global_batch(4, "auto") == 4
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 8))
    assert mesh.resolve_global_batch(4, "auto") == 32
    assert mesh.resolve_global_batch(2, "AUTO") == 16
    assert mesh.resolve_global_batch(4, "16") == 16
    with pytest.raises(ValueError):
        mesh.resolve_global_batch(4, "0")
    with pytest.raises(ValueError):
        mesh.resolve_global_batch(4, "lots")


@pytest.mark.parametrize("command", [("fast_st", "train"), ("fast_st", "train-multi"),
                                     ("video_st", "train")])
def test_distributed_and_global_batch_reach_the_trainers(monkeypatch, tmp_path, command):
    """--distributed joins the group before the trainer runs, and
    --global-batch auto hands the trainer -b times the world size."""
    from PIL import Image

    from styletransfer_tpu_torch import constants
    from styletransfer_tpu_torch.clis import cli
    from styletransfer_tpu_torch.engines import fast, multistyle, video

    monkeypatch.setattr(constants, "PROJECT_ROOT_PATH", str(tmp_path))
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8)
                    ).save(tmp_path / "style.png")
    seen = {}

    def joined(**kw):
        seen["initialize"] = kw
        return 1, 8

    monkeypatch.setattr(distributed, "initialize", joined)
    monkeypatch.setattr(distributed, "process_info", lambda: (1, 8))
    engine, name = {("fast_st", "train"): (fast, "static_train"),
                    ("fast_st", "train-multi"): (multistyle, "train"),
                    ("video_st", "train"): (video, "video_train")}[command]
    monkeypatch.setattr(engine, name, lambda style, **kw: seen.update(kw))
    result = CliRunner().invoke(cli, [*command, "style.png", "-b", "4", "-e", "1",
                                      "--distributed", "--global-batch", "auto",
                                      "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert seen["initialize"] == {"device": "cpu"}
    assert seen["batch_size"] == 32


def test_prefetch_resolves_the_current_gpu_before_its_thread_starts(monkeypatch):
    """A thread's current GPU is its own: "cuda" is resolved to the
    caller's (a distributed rank's) before the producer thread starts."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert prefetch.resolve_index("cuda") == torch.device("cuda", 3)
    assert prefetch.resolve_index("cuda:1") == torch.device("cuda", 1)
    assert prefetch.resolve_index("cpu") == torch.device("cpu")


def test_one_process_on_a_multi_gpu_host_says_how_to_use_the_rest(monkeypatch, caplog):
    import logging

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with caplog.at_level(logging.WARNING, logger="StyleTransfer"):
        mesh.warn_single_process_training(torch.device("cuda"), 1)
        mesh.warn_single_process_training(torch.device("cuda"), 4)
    messages = [r.getMessage() for r in caplog.records]
    assert len(messages) == 1
    assert "3 device(s) idle" in messages[0] and "--nproc-per-node 4" in messages[0]
