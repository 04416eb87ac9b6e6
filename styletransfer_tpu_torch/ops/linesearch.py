"""The zoom line search of optax's L-BFGS, over independent lanes.

The port of ``optax.scale_by_zoom_linesearch`` (optax
``_src/linesearch.py``: ``zoom_linesearch`` and its ``update_fn``) with the
settings ``optax.lbfgs()`` gives it: at most 20 iterations, the first trial
step 1 (``initial_guess_strategy="one"``), no largest step, ``tol=0``,
``slope_rtol=1e-4``, ``curv_rtol=0.9``, ``approx_dec_rtol=1e-6``,
``stepsize_precision=1e-5`` and ``increase_factor=2``. It looks for a step
t along a direction u from x that satisfies the strong Wolfe conditions
(sufficient decrease, with Hager and Zhang's approximate form near a
minimum, and small curvature): first it grows t until an interval holds
such a step (Nocedal and Wright, Algorithm 3.5), then it zooms into the
interval by cubic or quadratic interpolation or bisection (Algorithm 3.6).
When the iterations run out, it takes the best step of sufficient decrease
it saw (``_try_safe_step``).

The work is split where it costs least. The vectors stay on the device:
each iteration evaluates the closure at ``x + t * u`` for every lane and
the slope ``<g, u>``, and the lanes' gradients are selected there with
``torch.where``. The state machine is per-lane scalars, about a hundred
operations an iteration, which as one-element device ops would each be a
kernel launch; it runs on the host in numpy float32, the dtype optax
computes it in. An iteration reads one ``[2, N]`` tensor back (each lane's
value and slope; the first also reads the slopes at t = 0) and writes one
``[4, N]`` tensor to the device (the next trial steps and the last
iteration's selections).

Lanes are a leading ``[N]`` dimension of independent searches, as
``jax.vmap`` of the ``while_loop`` runs them: the loop goes on while any
lane is neither done nor failed, and a lane that has stopped keeps its
state (its closure is evaluated at t = 0 and discarded).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

LossAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5  # optax's stepsize_precision
INCREASE_FACTOR = 2.0
TOL = 0.0

_F32 = np.float32


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa) with slope fpa at a,
    (b, fb) and (c, fc); NaN where none exists (the caller then falls back).
    optax's ``_cubicmin``, term for term (``x ** 3`` as ``x * (x * x)``, as
    XLA's integer power computes it)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa) with slope fpa
    at a and (b, fb) (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


class State(NamedTuple):
    """Each lane's scalars of optax's ``ZoomLinesearchState`` (numpy
    float32 [N], ``count`` int32, the flags bool); the gradients live on
    the device."""

    count: np.ndarray
    stepsize: np.ndarray
    value: np.ndarray
    slope: np.ndarray
    value_init: np.ndarray
    slope_init: np.ndarray
    decrease_error: np.ndarray
    curvature_error: np.ndarray
    interval_found: np.ndarray
    done: np.ndarray
    failed: np.ndarray
    low: np.ndarray
    value_low: np.ndarray
    slope_low: np.ndarray
    high: np.ndarray
    value_high: np.ndarray
    slope_high: np.ndarray
    cubic_ref: np.ndarray
    value_cubic_ref: np.ndarray
    safe_stepsize: np.ndarray
    safe_value: np.ndarray


def init_state(value: np.ndarray, slope: np.ndarray) -> State:
    """optax's ``init_fn`` for each lane's value and slope at t = 0."""
    value, slope = value.astype(_F32), slope.astype(_F32)
    zero = np.zeros_like(value)
    inf = np.full_like(value, np.inf)
    false = np.zeros(value.shape, bool)
    return State(
        count=np.zeros(value.shape, np.int32), stepsize=zero, value=value, slope=slope,
        value_init=value, slope_init=slope, decrease_error=inf, curvature_error=inf,
        interval_found=false, done=false, failed=false, low=zero, value_low=value,
        slope_low=slope, high=zero, value_high=value, slope_high=slope, cubic_ref=zero,
        value_cubic_ref=value, safe_stepsize=zero, safe_value=value)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    """The sufficient-decrease violation (Armijo, or Hager and Zhang's
    approximate form where the value is within ``approx_dec_rtol`` of the
    start); NaN counts as infinite."""
    decrease_error = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * np.abs(value_init)
    approx = np.maximum(approx, delta_values)
    decrease_error = np.minimum(approx, decrease_error)
    decrease_error = np.maximum(decrease_error, _F32(0.0))
    return np.where(np.isnan(decrease_error), _F32(np.inf), decrease_error)


def _curvature_error(slope_step, slope_init):
    """The small-curvature violation; NaN counts as infinite."""
    curvature_error = np.abs(slope_step) - CURV_RTOL * np.abs(slope_init)
    curvature_error = np.maximum(curvature_error, _F32(0.0))
    return np.where(np.isnan(curvature_error), _F32(np.inf), curvature_error)


def _zoom_point(s: State):
    """The zoom phase's next trial step: the cubic's minimum if it lies well
    inside the interval, else the quadratic's, else the midpoint."""
    delta = np.abs(s.high - s.low)
    left = np.minimum(s.high, s.low)
    right = np.maximum(s.high, s.low)
    cubic_chk = 0.2 * delta
    quad_chk = 0.1 * delta
    middle_cubic = _cubicmin(s.low, s.value_low, s.slope_low, s.high, s.value_high,
                             s.cubic_ref, s.value_cubic_ref)
    use_cubic = (middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk)
    middle_quad = _quadmin(s.low, s.value_low, s.slope_low, s.high, s.value_high)
    use_quad = ~use_cubic & (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk)
    use_bisection = ~use_cubic & ~use_quad
    middle = np.where(use_cubic, middle_cubic, s.cubic_ref)
    middle = np.where(use_quad, middle_quad, middle)
    return np.where(use_bisection, (s.low + s.high) / 2.0, middle)


def propose(s: State) -> np.ndarray:
    """Each lane's next trial step: the first guess (1), twice the last
    step while the interval is searched, or the zoom point."""
    with np.errstate(all="ignore"):
        search = np.where(s.count == 0, _F32(1.0), INCREASE_FACTOR * s.stepsize)
        return np.where(s.interval_found, _zoom_point(s), search).astype(_F32)


def _search(s: State, t, value, slope, dec, err):
    """optax's ``_search_interval`` after its evaluation at ``t``. Returns
    the new state and where the safe step moved to ``t``."""
    safe = dec <= TOL
    set_high = (dec > 0.0) | ((value >= s.value) & (s.count > 0))
    set_low = (slope >= 0.0) & ~set_high
    low = np.where(set_low, t, s.stepsize)
    value_low = np.where(set_low, value, s.value)
    slope_low = np.where(set_low, slope, s.slope)
    high = np.where(set_low, s.stepsize, t)
    value_high = np.where(set_low, s.value, value)
    slope_high = np.where(set_low, s.slope, slope)
    done = err <= TOL
    new = s._replace(
        interval_found=set_high | set_low | done, done=done,
        failed=(s.count + 1 >= MAX_LINESEARCH_STEPS) & ~done, low=low, value_low=value_low,
        slope_low=slope_low, high=high, value_high=value_high, slope_high=slope_high,
        cubic_ref=low, value_cubic_ref=value_low,
        safe_stepsize=np.where(safe, t, s.safe_stepsize),
        safe_value=np.where(safe, value, s.safe_value))
    return new, safe


def _zoom(s: State, t, value, slope, dec, err):
    """optax's ``_zoom_into_interval`` after its evaluation at ``t`` (the
    zoom point). Returns the new state and where the safe step moved."""
    too_small = np.abs(s.high - s.low) <= INTERVAL_THRESHOLD
    update_safe = (dec <= TOL) & (value < s.safe_value)
    safe_stepsize = np.where(update_safe, t, s.safe_stepsize)
    done = err <= TOL
    set_high_to_middle = (dec > 0.0) | (value >= s.value_low)
    set_high_to_low = (slope * (s.high - s.low) >= 0.0) & ~set_high_to_middle
    set_low_to_middle = ~set_high_to_middle
    high = np.where(set_high_to_middle, t, s.high)
    value_high = np.where(set_high_to_middle, value, s.value_high)
    slope_high = np.where(set_high_to_middle, slope, s.slope_high)
    high = np.where(set_high_to_low, s.low, high)
    value_high = np.where(set_high_to_low, s.value_low, value_high)
    slope_high = np.where(set_high_to_low, s.slope_low, slope_high)
    ref_high = set_high_to_middle | set_high_to_low
    failed = ((s.count + 1 >= MAX_LINESEARCH_STEPS) | (too_small & (safe_stepsize > 0.0))) & ~done
    new = s._replace(
        done=done, failed=failed,
        low=np.where(set_low_to_middle, t, s.low),
        value_low=np.where(set_low_to_middle, value, s.value_low),
        slope_low=np.where(set_low_to_middle, slope, s.slope_low),
        high=high, value_high=value_high, slope_high=slope_high,
        cubic_ref=np.where(ref_high, s.high, s.low),
        value_cubic_ref=np.where(ref_high, s.value_high, s.value_low),
        safe_stepsize=safe_stepsize,
        safe_value=np.where(update_safe, value, s.safe_value))
    return new, update_safe


def accept(s: State, t: np.ndarray, value: np.ndarray,
           slope: np.ndarray) -> Tuple[State, np.ndarray]:
    """optax's ``step_fn`` for the lanes still searching, given each lane's
    value and slope at its trial step ``t``; the lanes that had stopped keep
    their state. Returns the state and the gradient selections ``[3, N]``
    bool: take the new gradient, move the safe gradient to it, and (a lane
    that failed) fall back to the safe gradient."""
    active = ~(s.done | s.failed)
    value, slope = value.astype(_F32), slope.astype(_F32)
    with np.errstate(all="ignore"):
        dec = _decrease_error(t, value, slope, s.value_init, s.slope_init)
        curv = _curvature_error(slope, s.slope_init)
        err = np.maximum(dec, curv)
        searched, safe_s = _search(s, t, value, slope, dec, err)
        zoomed, safe_z = _zoom(s, t, value, slope, dec, err)
    zooming = s.interval_found
    new = State(*(np.where(zooming, z, a) for z, a in zip(zoomed, searched)))
    new = new._replace(count=s.count + 1, stepsize=t, value=value, slope=slope,
                       decrease_error=dec, curvature_error=curv)
    safe_moved = np.where(zooming, safe_z, safe_s)
    # _try_safe_step: a failed search takes its best step of sufficient
    # decrease, or, with none, its last step (or the safe one when that was
    # outside the domain).
    use_safe = new.failed & ((new.safe_stepsize > 0.0) | np.isinf(new.decrease_error))
    new = new._replace(stepsize=np.where(use_safe, new.safe_stepsize, new.stepsize),
                       value=np.where(use_safe, new.safe_value, new.value))
    new = State(*(np.where(active, n, o) for n, o in zip(new, s)))
    return new, np.stack([active, active & safe_moved, active & use_safe])


class Result(NamedTuple):
    stepsize: np.ndarray  # [N] float32, the step to take along u
    value: np.ndarray  # [N] float32, the value there
    grad: torch.Tensor  # [N, n], the gradient there (on the device)
    count: np.ndarray  # [N] int32, the iterations (closure evaluations) taken


def zoom_linesearch(loss_and_grad_fn: LossAndGrad, x: torch.Tensor, u: torch.Tensor,
                    value: np.ndarray, grad: torch.Tensor,
                    slope_init: torch.Tensor) -> Result:
    """One zoom line search per lane from ``x`` [N, n] along ``u`` [N, n],
    with each lane's value at x (host, ``value`` [N]), gradient ``grad``
    and slope ``slope_init = <grad, u>`` (device, [N]; read back with the
    first evaluation). ``loss_and_grad_fn(x [N, n]) -> (loss [N], grad [N,
    n])`` is the closure over all lanes at once."""
    device = x.device
    g_cur = g_safe = grad
    g_new = None
    select = np.zeros((3, x.shape[0]), bool)
    s = None
    while s is None or not (s.done | s.failed).all():
        t = propose(s) if s is not None else np.ones(x.shape[0], _F32)
        if s is not None:
            t = np.where(s.done | s.failed, _F32(0.0), t)
        sent = torch.from_numpy(np.concatenate([t[None], select.astype(_F32)])).to(device)
        if g_new is not None:
            g_cur, g_safe = _select(g_new, g_cur, g_safe, sent[1:] > 0.5)
        v, g_new = loss_and_grad_fn(x + sent[0].unsqueeze(1) * u)
        g_new = g_new.float()
        rows = [v.float(), (g_new * u).sum(dim=1)]
        if s is None:
            rows.append(slope_init.float())
        read = torch.stack(rows).cpu().numpy()
        if s is None:
            s = init_state(value, read[2])
        s, select = accept(s, t, read[0], read[1])
    sent = torch.from_numpy(select).to(device)
    g_cur, _ = _select(g_new, g_cur, g_safe, sent)
    return Result(s.stepsize, s.value, g_cur, s.count)


def _select(g_new, g_cur, g_safe, select):
    """The gradient selections of :func:`accept`, on the device."""
    take, safe_moved, use_safe = (m.unsqueeze(1) for m in select)
    g_safe = torch.where(safe_moved, g_new, g_safe)
    g_cur = torch.where(take, g_new, g_cur)
    return torch.where(use_safe, g_safe, g_cur), g_safe
