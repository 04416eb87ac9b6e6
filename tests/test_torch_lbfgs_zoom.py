"""The port's ``lbfgs_zoom`` (``ops/lbfgs.py``) and zoom line search
(``ops/linesearch.py``) against ``optax.lbfgs()`` and
``optax.scale_by_zoom_linesearch``, driven as the JAX engine's
``_run_lbfgs`` drives them (``optax.value_and_grad_from_state``), on the
nonconvex quartic of ``tests/test_torch_lbfgs.py`` and on a convex
quadratic: per-step values, line-search iteration counts and step sizes,
lanes against each lane alone and against ``jax.vmap``, and the safe and
unsafe steps of a search that fails."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from styletransfer_tpu_torch.ops import lbfgs, linesearch

N = 50
STEPS = 6
# Values per step against optax: the closures and dot products sum in
# another order (torch against XLA), and the trajectories carry that f32
# rounding for a few steps. The step sizes come out of the same decisions
# on values that agree to this, so they are held to it too.
VALUE_RTOL = 1e-4
STEP_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU ops here are small: one thread each, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quartic(seed):
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


def _quadratic(seed):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((N, N)).astype(np.float32)
    Q = Q @ Q.T / N + np.eye(N, dtype=np.float32)
    c = rng.standard_normal(N).astype(np.float32)
    x0 = (3.0 * rng.standard_normal(N)).astype(np.float32)

    def torch_loss(x):
        return 0.5 * ((x @ torch.from_numpy(Q)) * x).sum(-1) - x @ torch.from_numpy(c)

    def jax_loss(x):
        return 0.5 * x @ (jnp.asarray(Q) @ x) - x @ jnp.asarray(c)

    return torch_loss, jax_loss, x0


PROBLEMS = {"quartic": _quartic, "quadratic": _quadratic}


def _loss_and_grad(torch_loss):
    def fn(x):
        x = x.detach().requires_grad_()
        loss = torch_loss(x)
        (grad,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), grad
    return fn


def _lanes_closure(fns):
    """A closure over lanes whose lane i is ``fns[i]`` evaluated as a batch
    of one, so that it computes the bits of the lane run alone."""
    def fn(x):
        x = x.detach().requires_grad_()
        loss = torch.cat([f(x[i:i + 1]) for i, f in enumerate(fns)])
        (grad,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), grad
    return fn


def _optax_run(jax_loss, x0, steps):
    """``optax.lbfgs()`` as JAX ``engines/gatys.py::_run_lbfgs`` runs it;
    returns x and, per step, the value and the line search's iteration
    count."""
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(jax_loss)

    @jax.jit
    def step(x, state):
        value, grad = value_and_grad(x, state=state)
        updates, state = opt.update(grad, state, x, value=value, grad=grad, value_fn=jax_loss)
        ls = state[-1]
        return optax.apply_updates(x, updates), state, value, ls.info.num_linesearch_steps

    x, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    values, counts = [], []
    for _ in range(steps):
        x, state, value, count = step(x, state)
        values.append(float(value))
        counts.append(int(count))
    return np.asarray(x), np.asarray(values), counts


def _port_run(torch_loss, x0, steps):
    lbfgs.zoom_log.clear()
    x, values = lbfgs.lbfgs_zoom(_loss_and_grad(torch_loss), torch.from_numpy(x0), steps)
    counts = [int(c[0]) for c, _ in lbfgs.zoom_log]
    return x, values, counts


@pytest.mark.parametrize("name,seed", [("quartic", 0), ("quartic", 1), ("quadratic", 2)])
def test_steps_follow_optax_lbfgs(name, seed):
    torch_loss, jax_loss, x0 = PROBLEMS[name](seed)
    xj, jvalues, jcounts = _optax_run(jax_loss, x0, STEPS)
    x, values, counts = _port_run(torch_loss, x0, STEPS)
    assert x.shape == (N,) and values.shape == (STEPS,)
    np.testing.assert_allclose(values.numpy(), jvalues, rtol=VALUE_RTOL)
    assert counts == jcounts
    assert values[-1] < values[0] and np.isfinite(x.numpy()).all()
    np.testing.assert_allclose(float(torch_loss(x)), float(jax_loss(jnp.asarray(xj))),
                               rtol=VALUE_RTOL)


def test_step_sizes_follow_optax_linesearch():
    """Each step's line search, started from optax's own point and direction,
    takes optax's number of iterations and lands on its step size."""
    torch_loss, jax_loss, x0 = _quartic(3)
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(jax_loss)
    @jax.jit
    def step(x, state):
        value, grad = value_and_grad(x, state=state)
        precond, _ = optax.scale_by_lbfgs().update(grad, state[0], x)
        updates, state = opt.update(grad, state, x, value=value, grad=grad, value_fn=jax_loss)
        return optax.apply_updates(x, updates), state, -precond

    x, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    closure = _loss_and_grad(torch_loss)
    for _ in range(STEPS):
        xt = torch.from_numpy(np.array(x))[None]
        x, state, direction = step(x, state)
        ls = state[-1]
        ut = torch.from_numpy(np.array(direction))[None]
        v, g = closure(xt)
        found = linesearch.zoom_linesearch(closure, xt, ut, v.numpy(), g, (g * ut).sum(1))
        assert int(found.count[0]) == int(ls.info.num_linesearch_steps)
        np.testing.assert_allclose(found.stepsize[0], float(ls.learning_rate), rtol=STEP_RTOL)
        np.testing.assert_allclose(found.value[0], float(ls.value), rtol=VALUE_RTOL)


@pytest.mark.parametrize("name", ["quartic", "quadratic"])
def test_lanes_are_each_their_problem_alone_and_follow_vmapped_optax(name):
    problems = [PROBLEMS[name](seed) for seed in (4, 5, 6)]
    torch_loss, jax_loss, _ = problems[0]
    x0 = np.stack([p[2] for p in problems])
    if name == "quartic":  # one objective, three starts
        lanes = [torch_loss] * 3
    else:
        lanes = [p[0] for p in problems]

    lbfgs.zoom_log.clear()
    x, values = lbfgs.lbfgs_zoom(_lanes_closure(lanes), torch.from_numpy(x0), STEPS)
    counts = np.stack([c for c, _ in lbfgs.zoom_log])  # [steps, lanes]
    assert x.shape == (3, N) and values.shape == (3, STEPS)
    for i, fn in enumerate(lanes):
        xi, vi, ci = _port_run(fn, x0[i], STEPS)
        torch.testing.assert_close(x[i], xi, rtol=0, atol=0)
        torch.testing.assert_close(values[i], vi, rtol=0, atol=0)
        assert list(counts[:, i]) == ci
    if name == "quartic":
        opt = optax.lbfgs()
        vag = optax.value_and_grad_from_state(jax_loss)

        def run(x):
            def step(carry, _):
                x, state = carry
                value, grad = vag(x, state=state)
                updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                            value_fn=jax_loss)
                return (optax.apply_updates(x, updates), state), value
            return jax.lax.scan(step, (x, opt.init(x)), None, length=STEPS)[1]

        jvalues = jax.jit(jax.vmap(run))(jnp.asarray(x0))
        np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=VALUE_RTOL)


def _optax_linesearch(jax_loss, x, u):
    ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=20, initial_guess_strategy="one")
    value, grad = jax.value_and_grad(jax_loss)(x)
    _, state = ls.update(u, ls.init(x), x, value=value, grad=grad, value_fn=jax_loss)
    return state


def test_a_non_descent_direction_takes_optax_unsafe_step():
    """Uphill, no step decreases the value: the search runs out its 20
    iterations and ``_try_safe_step``, with no safe step, keeps the last."""
    torch_loss, jax_loss, x0 = _quartic(7)
    closure = _loss_and_grad(torch_loss)
    v, g = closure(torch.from_numpy(x0)[None])
    u = 0.1 * g  # the gradient itself: slope > 0
    state = _optax_linesearch(jax_loss, jnp.asarray(x0), jnp.asarray(u[0].numpy()))
    found = linesearch.zoom_linesearch(closure, torch.from_numpy(x0)[None], u, v.numpy(), g,
                                       (g * u).sum(1))
    assert int(state.info.num_linesearch_steps) == 20 == int(found.count[0])
    np.testing.assert_allclose(found.stepsize[0], float(state.learning_rate), rtol=STEP_RTOL)
    np.testing.assert_allclose(found.value[0], float(state.value), rtol=VALUE_RTOL)
    assert found.value[0] > v.numpy()[0]  # it went uphill


def test_a_kink_takes_optax_safe_step():
    """|x| along -sign(x) in one coordinate: the slope is -1 before the kink
    and +1 after it, so the curvature condition never holds; the search
    fails and takes its best step of sufficient decrease."""
    x0 = np.asarray([0.3, -0.45], np.float32)

    def closure(x):
        return x.abs().sum(1), torch.sign(x)

    def jax_loss(x):
        return jnp.abs(x).sum()

    u = torch.from_numpy(np.asarray([[-1.0, 0.0]], np.float32))
    xt = torch.from_numpy(x0)[None]
    v, g = closure(xt)
    state = _optax_linesearch(jax_loss, jnp.asarray(x0), jnp.asarray(u[0].numpy()))
    found = linesearch.zoom_linesearch(closure, xt, u, v.numpy(), g, (g * u).sum(1))
    assert int(found.count[0]) == int(state.info.num_linesearch_steps)
    assert float(state.info.curvature_error) > 0  # optax too ended on a failed search
    assert 0 < found.stepsize[0] < 0.3  # short of the kink: a safe step
    np.testing.assert_allclose(found.stepsize[0], float(state.learning_rate), rtol=STEP_RTOL)
    np.testing.assert_allclose(found.value[0], float(state.value), rtol=VALUE_RTOL)
    assert found.value[0] < v.numpy()[0]
    torch.testing.assert_close(found.grad, torch.from_numpy(np.array(state.grad))[None])


def test_a_lane_that_stopped_keeps_its_state():
    """Two lanes whose searches take different iteration counts: the one
    that stops first holds its step, value and gradient while the other
    goes on, as under ``jax.vmap``."""
    torch_loss, _, x0 = _quartic(8)
    closure = _lanes_closure([torch_loss, torch_loss])
    x = torch.from_numpy(np.stack([x0, x0]))
    v, g = closure(x)
    u = torch.stack([-g[0], g[1] * 0.1])  # lane 0 downhill, lane 1 uphill (20 iterations)
    both = linesearch.zoom_linesearch(closure, x, u, v.numpy(), g, (g * u).sum(1))
    alone = linesearch.zoom_linesearch(closure, x[:1], u[:1], v.numpy()[:1], g[:1],
                                       (g[:1] * u[:1]).sum(1))
    assert int(both.count[1]) == 20 > int(both.count[0]) == int(alone.count[0])
    assert both.stepsize[0] == alone.stepsize[0] and both.value[0] == alone.value[0]
    torch.testing.assert_close(both.grad[0], alone.grad[0], rtol=0, atol=0)


def test_cubic_and_quadratic_minima_match_optax_and_give_nan_without_one():
    from optax._src import linesearch as olinesearch

    rng = np.random.default_rng(9)
    args = rng.standard_normal((7, 256)).astype(np.float32)  # 9 cubics without a minimum
    with np.errstate(all="ignore"):
        got_c = linesearch._cubicmin(*args)
        got_q = linesearch._quadmin(*args[:5])
    want_c = jax.vmap(olinesearch._cubicmin)(*map(jnp.asarray, args))
    want_q = jax.vmap(olinesearch._quadmin)(*map(jnp.asarray, args[:5]))
    assert np.isnan(got_c).any()
    np.testing.assert_array_equal(np.isnan(got_c), np.isnan(np.asarray(want_c)))
    np.testing.assert_allclose(got_c, np.asarray(want_c), rtol=1e-5)
    np.testing.assert_allclose(got_q, np.asarray(want_q), rtol=1e-5)
