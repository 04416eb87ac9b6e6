"""Which training steps replay from a CUDA graph (``engines/fast.py::make_step``
on ``utils/aot.py::GradGraphs``), on the CPU.

A stand-in for the graphs that takes every step it is given, running the
step's gradients eagerly, shows the rule ``make_step`` follows: a plain
step goes to the graphs, and a step with ``shards``, with ``remat`` or
under ``record_spans()`` does not. The real graphs leave a CPU step to the
eager code, and their counters stay 0 here. The graph on the card, against
the eager step: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from styletransfer_tpu_torch.data import coco
from styletransfer_tpu_torch.engines import fast
from styletransfer_tpu_torch.engines import multistyle as ms_engine
from styletransfer_tpu_torch.models import transformer, vgg
from styletransfer_tpu_torch.parallel import distributed
from styletransfer_tpu_torch.utils import aot, profiling

SIZE = 32
STEPS = 3


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    vgg_params = vgg.init_params(seed=0, device="cpu")
    style = torch.from_numpy(rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32))
    batch = torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8))
    return vgg_params, vgg.style_gram_targets(vgg_params, style), batch


@pytest.fixture
def stand_in(monkeypatch):
    """Every GradGraphs made from here on: stand-ins that take each step."""
    made = []

    class EveryStep:
        def __init__(self, grad_fn, name):
            self.grad_fn, self.calls = grad_fn, 0
            made.append(self)

        def __call__(self, params, *inputs):
            self.calls += 1
            return self.grad_fn(params, *inputs)

    monkeypatch.setattr(aot, "GradGraphs", EveryStep)
    return made


@pytest.fixture
def counters():
    """The training graphs' counters before the test; checks after it that
    no graph was captured or replayed."""
    before = aot.train_captures, aot.train_replays
    yield
    assert (aot.train_captures, aot.train_replays) == before


def _train(step, batch, steps=STEPS):
    params = transformer.init_params(seed=5, device="cpu")
    opt = fast.make_optimizer(params)
    losses = [step(params, opt, batch)["total"] for _ in range(steps)]
    moments = [opt.state[p]["exp_avg"] for p in params.parameters()]
    return torch.stack(losses), list(params.parameters()), moments


def test_a_plain_step_goes_to_the_graphs_and_takes_the_eager_steps_values(
        inputs, stand_in, counters):
    """The graphed path's host code (gradients set to None by the captured
    function, Adam after it, the metrics handed back) gives the eager
    step's losses, parameters and Adam moments bit for bit."""
    vgg_params, grams, batch = inputs
    graphed = _train(fast.make_train_step(vgg_params, grams), batch)
    (graphs,) = stand_in
    assert graphs.calls == STEPS
    with profiling.record_spans():
        eager = _train(fast.make_train_step(vgg_params, grams), batch)
    assert stand_in[1].calls == 0
    for got, want in zip(graphed, eager):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_the_step_stays_eager_on_the_cpu(inputs, counters):
    """The real graphs take no CPU step, nor a step whose inputs are not
    all tensors (train-multi's style indices as a host array)."""
    vgg_params, grams, batch = inputs
    losses, params, _ = _train(fast.make_train_step(vgg_params, grams), batch, steps=2)
    assert torch.isfinite(losses).all() and all(p.grad is not None for p in params)
    graphs = aot.GradGraphs(lambda params, *a: {}, "test")
    assert graphs(params[0], batch) is None
    assert graphs(params[0], batch, np.zeros(2, np.int64)) is None


def test_the_step_stays_eager_with_shards(inputs, stand_in, counters):
    """A GlobalBatch runs its all-reduce in the step, even in a group of
    one: no graph is made for such a step."""
    vgg_params, grams, batch = inputs
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{distributed.free_port()}",
                            world_size=1, rank=0)
    try:
        shards = distributed.global_batch()
        assert shards is not None and shards.world == 1
        losses, _, _ = _train(fast.make_train_step(vgg_params, grams, shards=shards), batch,
                              steps=2)
    finally:
        dist.destroy_process_group()
    assert torch.isfinite(losses).all()
    assert stand_in == []


def test_the_step_stays_eager_under_record_spans(inputs, stand_in, counters):
    """While spans record, the step is the eager one, with its spans; the
    next step after the recording goes to the graphs again."""
    vgg_params, grams, batch = inputs
    step = fast.make_train_step(vgg_params, grams)
    (graphs,) = stand_in
    params = transformer.init_params(seed=5, device="cpu")
    opt = fast.make_optimizer(params)
    with profiling.record_spans() as rec:
        step(params, opt, batch)
    assert graphs.calls == 0
    names = {s.name for s in rec.spans}
    assert {"train.step", "train.backward", "train.optimizer"} <= names
    step(params, opt, batch)
    assert graphs.calls == 1


def test_a_remat_step_stays_eager(inputs, stand_in, counters):
    vgg_params, grams, batch = inputs
    losses, _, _ = _train(fast.make_train_step(vgg_params, grams, remat=True), batch, steps=1)
    assert torch.isfinite(losses).all()
    assert stand_in == []


def test_train_multi_hands_the_step_its_indices_as_a_tensor(inputs, monkeypatch, tmp_path):
    """The graphs take only tensor inputs: train-multi's loop draws its
    style indices on the host and gives the step a tensor of them on the
    batch's device."""
    vgg_params, _, _ = inputs
    seen = []
    real = ms_engine.make_train_step

    def recording_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def recorded(params, optimizer, batch, style_idx):
            seen.append(style_idx)
            return step(params, optimizer, batch, style_idx)
        return recorded

    monkeypatch.setattr(ms_engine, "make_train_step", recording_step)

    train = coco.DataLoader(coco.SyntheticDataset(4, SIZE), 2, seed=1, num_threads=2)
    test = coco.DataLoader(coco.SyntheticDataset(2, SIZE, seed_offset=4), 2, seed=0,
                           num_threads=2)
    styles = np.random.default_rng(8).standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    ms_engine.train(styles, style_name="tiny", epochs=1, batch_size=2, vgg_params=vgg_params,
                    train_loader=train, test_loader=test, runs_dir=str(tmp_path / "runs"),
                    models_path=str(tmp_path / "models"), log_cadence=(1, 100, 100), seed=4,
                    device="cpu")
    assert len(seen) == 2
    assert all(isinstance(i, torch.Tensor) and i.dtype == torch.long and i.shape == (2,)
               and i.device.type == "cpu" for i in seen)
