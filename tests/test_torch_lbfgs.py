"""The port's torch-contract L-BFGS (``ops/lbfgs.py``) against the JAX
``lbfgs_torch`` it ports and against ``torch.optim.LBFGS`` itself, on the
nonconvex quartic of ``tests/test_lbfgs.py``, with the same tolerances:
single problems in both history forms, history wraparound, the tolerance
breaks, and N independent lanes (against N single runs and JAX's vmapped
``compact_shift``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.ops.lbfgs import lbfgs_torch as jax_lbfgs
from styletransfer_tpu_torch.ops.lbfgs import lbfgs_torch

N = 50
MODES = ["two_loop", "compact"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU ops here are small: one thread each, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)).astype(np.float32) * 0.3
    b = rng.standard_normal(N).astype(np.float32)
    x0 = rng.standard_normal(N).astype(np.float32)

    def torch_loss(x):  # x [..., N] -> [...]
        z = x @ torch.from_numpy(A).T - torch.from_numpy(b)
        return (z ** 2).sum(-1) + 0.1 * (x ** 4).sum(-1) + torch.sin(x).sum(-1)

    def jax_loss(x):
        z = jnp.asarray(A) @ x - jnp.asarray(b)
        return (z ** 2).sum() + 0.1 * (x ** 4).sum() + jnp.sin(x).sum()

    return torch_loss, jax_loss, x0


def _loss_and_grad(torch_loss):
    """The port's closure over lanes [L, n]: per-lane losses, and the
    gradient of their sum (each lane's own gradient)."""
    def fn(x):
        x = x.detach().requires_grad_()
        loss = torch_loss(x)
        (grad,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), grad
    return fn


def _run_reference(torch_loss, x0, steps, **kwargs):
    xt = torch.tensor(x0.copy(), requires_grad=True)
    opt = torch.optim.LBFGS([xt], **kwargs)
    losses = []
    for _ in range(steps):
        def closure():
            opt.zero_grad()
            loss = torch_loss(xt)
            loss.backward()
            return loss
        losses.append(float(opt.step(closure).detach()))
    return xt.detach().numpy(), losses, opt


@pytest.mark.parametrize("mode", MODES)
def test_trajectory_matches_torch_and_jax(mode):
    torch_loss, jax_loss, x0 = _problem(0)
    xt, tlosses, _ = _run_reference(torch_loss, x0, steps=5)
    x, losses = lbfgs_torch(_loss_and_grad(torch_loss), torch.from_numpy(x0), steps=5,
                            history_math=mode)
    assert x.shape == (N,) and losses.shape == (5,)
    np.testing.assert_allclose(losses.numpy(), tlosses, rtol=1e-4)
    np.testing.assert_allclose(float(torch_loss(x)), float(torch_loss(torch.from_numpy(xt))),
                               rtol=1e-5)
    np.testing.assert_allclose(x.numpy(), xt, atol=1e-3)
    xj, jlosses = jax_lbfgs(jax.value_and_grad(jax_loss), jnp.asarray(x0), steps=5,
                            history_math=mode)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-3)


def test_inner_iteration_count_matches_torch():
    """One outer step runs torch's inner iterations: after a single step the
    trajectories agree, which needs the same 20 fixed-step updates."""
    torch_loss, _, x0 = _problem(1)
    xt, tlosses, opt = _run_reference(torch_loss, x0, steps=1)
    assert int(opt.state[opt._params[0]]["n_iter"]) > 1
    x, losses = lbfgs_torch(_loss_and_grad(torch_loss), torch.from_numpy(x0), steps=1)
    np.testing.assert_allclose(float(losses[0]), tlosses[0], rtol=1e-5)
    np.testing.assert_allclose(x.numpy(), xt, atol=5e-3)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("history_size", [2, 5])
def test_history_wraps_past_history_size(mode, history_size):
    torch_loss, _, x0 = _problem(4)
    xt, tlosses, _ = _run_reference(torch_loss, x0, steps=4, history_size=history_size)
    x, losses = lbfgs_torch(_loss_and_grad(torch_loss), torch.from_numpy(x0), steps=4,
                            history_size=history_size, history_math=mode)
    np.testing.assert_allclose(losses.numpy(), tlosses, rtol=1e-3)
    np.testing.assert_allclose(float(torch_loss(x)), float(torch_loss(torch.from_numpy(xt))),
                               rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_converged_problem_stops_moving(mode):
    """At a near-stationary point the tolerance breaks fire and x stays put;
    later outer steps are no-ops, as in torch."""
    x0 = torch.full((8,), 3.0) + 1e-9
    evals = []

    def loss_and_grad(x):
        evals.append(1)
        return ((x - 3.0) ** 2).sum(-1), 2 * (x - 3.0)

    x, losses = lbfgs_torch(loss_and_grad, x0, steps=3, history_math=mode)
    np.testing.assert_allclose(x.numpy(), x0.numpy(), atol=1e-7)
    assert float(losses[-1]) == pytest.approx(float(losses[0]))
    assert len(evals) == 1  # no lane stepped: every closure after the first is skipped


@pytest.mark.parametrize("mode", MODES)
def test_quadratic_converges_in_one_outer_step(mode):
    rng = np.random.default_rng(3)
    Q = rng.standard_normal((N, N)).astype(np.float32)
    Q = Q @ Q.T / N + np.eye(N, dtype=np.float32)
    c = rng.standard_normal(N).astype(np.float32)
    x0 = rng.standard_normal(N).astype(np.float32)

    def torch_loss(x):
        return 0.5 * ((x @ torch.from_numpy(Q)) * x).sum(-1) - x @ torch.from_numpy(c)

    xt, _, _ = _run_reference(torch_loss, x0, steps=1)
    x, _ = lbfgs_torch(_loss_and_grad(torch_loss), torch.from_numpy(x0), steps=1,
                       history_math=mode)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(Q, c), atol=1e-3)
    np.testing.assert_allclose(x.numpy(), xt, atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_lanes_equal_single_runs_and_jax_compact_shift(mode):
    """N = 3 lanes in one call: each follows its own run (history, step
    size, breaks). The third starts from a converged point, where its breaks
    fire in the first iterations of every step while the others go on."""
    torch_loss, jax_loss, x0 = _problem(5)
    starts = np.stack([x0, x0 * 0.5 + 0.3, x0])
    lg = _loss_and_grad(torch_loss)
    converged, _ = lbfgs_torch(lg, torch.from_numpy(x0), steps=12, history_math=mode)
    starts[2] = converged.numpy()
    x, losses = lbfgs_torch(lg, torch.from_numpy(starts), steps=4, history_math=mode)
    assert x.shape == (3, N) and losses.shape == (3, 4)
    for i in range(3):
        # The objective's product runs as a matrix product over the lanes and
        # as a vector product alone: f32 reassociation, amplified over four
        # steps, hence the tolerances of the torch comparison above.
        xi, li = lbfgs_torch(lg, torch.from_numpy(starts[i]), steps=4, history_math=mode)
        np.testing.assert_allclose(losses[i].numpy(), li.numpy(), rtol=1e-4)
        np.testing.assert_allclose(x[i].numpy(), xi.numpy(), atol=1e-3)
    run = functools.partial(jax_lbfgs, jax.value_and_grad(jax_loss), steps=4,
                            history_math="compact_shift", branchless=True)
    xj, jl = jax.vmap(run)(jnp.asarray(starts))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-3)
    for i in range(3):
        np.testing.assert_allclose(float(torch_loss(x[i])), float(jax_loss(xj[i])), rtol=1e-4)


def test_unknown_history_math_raises():
    with pytest.raises(ValueError, match="history_math"):
        lbfgs_torch(lambda x: (x.sum(-1), torch.ones_like(x)), torch.zeros(3), 1,
                    history_math="compact_shift")
