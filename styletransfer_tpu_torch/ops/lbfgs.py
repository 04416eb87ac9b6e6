"""L-BFGS over independent lanes: torch's contract, and optax's with the
zoom line search.

The port of ``styletransfer_tpu/ops/lbfgs.py``: ``torch.optim.LBFGS`` with
the reference's settings (``lr=1``, ``max_iter=20``, ``history_size=100``,
``tolerance_grad=1e-7``, ``tolerance_change=1e-9``, no line search), so each
outer step (one ``LBFGS.step(closure)``) is up to 20 fixed-step inner
iterations with a history that persists across steps. The CLI's ``-s 300``
is up to ~6,000 closure evaluations.

The semantics are the JAX module's:
- ``(loss, grad)`` is carried from one evaluation to the next, so an outer
  step does not evaluate the closure again at the point it starts from;
- each outer step starts with the optimality check ``max|g| <= tolerance_grad``;
- the first iteration steps ``min(1, 1/|g|_1) * lr``, later ones ``lr``;
- a pair (s, y) enters the history only when ``y.s > 1e-10``;
- the four breaks (directional derivative, gradient, step size, loss
  change) are per-lane masks.

Lanes are a leading ``[N]`` dimension: N independent problems, each with its
own history, step size and breaks, as N separate torch runs. The history
lives on the device, and its dots and products run in full f32 (the caller
keeps TF32 off). ``history_math``:
- ``"two_loop"``: torch's recursion over a ring buffer;
- ``"compact"``: the Byrd-Nocedal compact form (``_compact_solve``), the same
  operator. The history stays in a ring buffer; the small [H, H] matrices are
  permuted into oldest-first order for the triangular solves, so no [H, n]
  buffer is ever shifted. This per-lane form is what JAX's ``compact`` and
  ``compact_shift`` both compute.

The host reads one flag per inner iteration: whether any lane takes a step.
When none does, every lane has broken off this outer step, and the closure
(whose result every lane would discard) and the remaining inner iterations,
which would change nothing, are skipped.

``lbfgs_zoom`` is the JAX engine's other optimizer, ``optax.lbfgs()``: a
memory of 10 pairs and the zoom line search of ``ops/linesearch.py``, one
update per outer step. Its vector work (the two-loop recursion over the
ring, the closure, the slopes) stays on the device; the line search's
per-lane scalars run on the host, with one read from the device per
line-search iteration.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from styletransfer_tpu_torch.ops import linesearch

LossAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane dot products of [N, n] rows."""
    return (a * b).sum(dim=-1)


def _bmv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-lane matrix-vector products: [N, r, c] x [N, c] -> [N, r]."""
    return torch.bmm(a, v.unsqueeze(-1)).squeeze(-1)


def _set_rows(buf: torch.Tensor, lanes: torch.Tensor, slot: torch.Tensor,
              value: torch.Tensor, mask: torch.Tensor) -> None:
    """``buf[i, slot[i]] = value[i]`` in place, for the lanes where ``mask``."""
    m = mask.view(-1, *([1] * (value.dim() - 1)))
    buf[lanes, slot] = torch.where(m, value, buf[lanes, slot])


class _TwoLoop:
    """torch's two-loop recursion over a ring buffer of (s, y, rho)."""

    def __init__(self, N: int, n: int, H: int, like: torch.Tensor):
        self.H = H
        self.S = like.new_zeros((N, H, n))
        self.Y = like.new_zeros((N, H, n))
        self.rho = like.new_zeros((N, H))
        self.k = torch.zeros(N, dtype=torch.long, device=like.device)  # inserts per lane

    def direction(self, grad, y, s, ys, insert, H_diag, bound: int) -> torch.Tensor:
        H, lanes = self.H, torch.arange(grad.shape[0], device=grad.device)
        pos = self.k % H
        _set_rows(self.S, lanes, pos, s, insert)
        _set_rows(self.Y, lanes, pos, y, insert)
        one = torch.ones_like(ys)
        _set_rows(self.rho, lanes, pos, one / torch.where(insert, ys, one), insert)
        self.k = self.k + insert.long()
        k1, num_old = self.k, torch.clamp(self.k, max=H)
        # ``bound`` >= every lane's num_old (the host counts the iterations
        # that could have inserted); slots past num_old are masked.
        q = -grad
        als = []
        for tt in range(bound):
            idx = (k1 - 1 - tt) % H
            al = torch.where(tt < num_old, self.rho[lanes, idx] * _dot(self.S[lanes, idx], q),
                             torch.zeros_like(ys))
            q = q - al.unsqueeze(-1) * self.Y[lanes, idx]
            als.append(al)
        r = q * H_diag.unsqueeze(-1)
        if bound:
            al_rev = torch.stack(als)  # [bound, N]: al_rev[tt] of the tt-th newest pair
            for jj in range(bound):
                idx = (k1 - num_old + jj) % H
                be = self.rho[lanes, idx] * _dot(self.Y[lanes, idx], r)
                al_j = al_rev[torch.clamp(num_old - 1 - jj, 0, bound - 1), lanes]
                coef = torch.where(jj < num_old, al_j - be, torch.zeros_like(be))
                r = r + coef.unsqueeze(-1) * self.S[lanes, idx]
        return r


class _Compact:
    """The Byrd-Nocedal compact form (Nocedal & Wright, Thm 7.4), the
    operator of JAX's ``_compact_solve``:

        H = gI + [S' gY'] [[R^-T (D + g Y'Y) R^-1, -R^-T], [-R^-1, 0]] [S'; gY']

    with R = triu(S'^T Y'), D = diag(R), g = H_diag, over the stored pairs
    oldest first. ``SY[i, j] = s_i . y_j`` and ``YY[i, j] = y_i . y_j`` are
    kept by slot and updated by one column (and row) per insert."""

    def __init__(self, N: int, n: int, H: int, like: torch.Tensor):
        self.H = H
        self.S = like.new_zeros((N, H, n))
        self.Y = like.new_zeros((N, H, n))
        self.SY = like.new_zeros((N, H, H))
        self.YY = like.new_zeros((N, H, H))
        self.k = torch.zeros(N, dtype=torch.long, device=like.device)

    def direction(self, grad, y, s, ys, insert, H_diag, bound: int) -> torch.Tensor:
        H, N = self.H, grad.shape[0]
        lanes = torch.arange(N, device=grad.device)
        pos = self.k % H
        _set_rows(self.S, lanes, pos, s, insert)
        _set_rows(self.Y, lanes, pos, y, insert)
        sy_col = _bmv(self.S, y)  # s_i . y_new for every slot (the new diagonal is ys)
        yy_col = _bmv(self.Y, y)
        m = insert.view(N, 1)
        self.SY[lanes, :, pos] = torch.where(m, sy_col, self.SY[lanes, :, pos])
        self.YY[lanes, :, pos] = torch.where(m, yy_col, self.YY[lanes, :, pos])
        self.YY[lanes, pos, :] = torch.where(m, yy_col, self.YY[lanes, pos, :])
        self.k = self.k + insert.long()
        num_old = torch.clamp(self.k, max=H)

        # Oldest-first order: entry j of lane i sits in slot perm[i, j]. Slots
        # past num_old were never written (zeros), so masked entries stay 0.
        j = torch.arange(H, device=grad.device)
        perm = (self.k.unsqueeze(1) - num_old.unsqueeze(1) + j) % H
        valid = j < num_old.unsqueeze(1)
        rows = perm.unsqueeze(2).expand(N, H, H)
        cols = perm.unsqueeze(1).expand(N, H, H)
        SY = self.SY.gather(1, rows).gather(2, cols)
        YY = self.YY.gather(1, rows).gather(2, cols)
        zero = torch.zeros_like(valid, dtype=grad.dtype)
        one = torch.ones_like(zero)
        vmask2 = valid.unsqueeze(2) & valid.unsqueeze(1)
        R = torch.where(vmask2, torch.triu(SY), torch.zeros_like(SY)) + torch.diag_embed(
            torch.where(valid, zero, one))
        D = torch.where(valid, torch.diagonal(SY, dim1=1, dim2=2), zero)
        p = torch.where(valid, _bmv(self.S, grad).gather(1, perm), zero)
        q = torch.where(valid, _bmv(self.Y, grad).gather(1, perm), zero)
        g = H_diag.unsqueeze(1)
        u = torch.linalg.solve_triangular(R, p.unsqueeze(-1), upper=True).squeeze(-1)
        v = D * u + g * _bmv(YY, u) - g * q
        w = torch.linalg.solve_triangular(R.transpose(1, 2), v.unsqueeze(-1),
                                          upper=False).squeeze(-1)
        # Back to slot order for the [n, H] products.
        w_slot = torch.zeros_like(w).scatter(1, perm, w)
        u_slot = torch.zeros_like(u).scatter(1, perm, u)
        Hg = (H_diag.unsqueeze(1) * grad + _bmv(self.S.transpose(1, 2), w_slot)
              - H_diag.unsqueeze(1) * _bmv(self.Y.transpose(1, 2), u_slot))
        return -Hg


_HISTORY = {"two_loop": _TwoLoop, "compact": _Compact}


def lbfgs_torch(
    loss_and_grad_fn: LossAndGrad,
    x0: torch.Tensor,
    steps: int,
    lr: float = 1.0,
    max_iter: int = 20,
    tolerance_grad: float = 1e-7,
    tolerance_change: float = 1e-9,
    history_size: int = 100,
    history_math: str = "two_loop",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``steps`` torch-``LBFGS.step(closure)`` calls.

    ``x0`` is one flat problem ``[n]`` or N independent lanes ``[N, n]``;
    ``loss_and_grad_fn(x [N, n]) -> (loss [N], grad [N, n])`` is the closure
    over all lanes at once (a single problem is lane 0 of N = 1). Returns
    ``(x_final, losses)`` shaped like ``x0`` and ``[steps]`` (``[N, steps]``
    for lanes): ``losses[..., i]`` is the loss at entry to outer step ``i``
    (torch's return value of each ``.step``)."""
    if history_math not in _HISTORY:
        raise ValueError(f"unknown history_math {history_math!r}; use two_loop or compact")
    single = x0.dim() == 1
    x = (x0.unsqueeze(0) if single else x0).float()
    N, n = x.shape
    loss, grad = loss_and_grad_fn(x)
    loss, grad = loss.float(), grad.float()
    hist = _HISTORY[history_math](N, n, history_size, x)
    prev_grad = torch.zeros_like(x)
    prev_loss = torch.zeros_like(loss)
    t = torch.zeros_like(loss)
    d = torch.zeros_like(x)
    H_diag = torch.ones_like(loss)
    n_glob = torch.zeros(N, dtype=torch.long, device=x.device)  # torch's state["n_iter"]
    inner_runs = 0  # an upper bound on every lane's history inserts
    losses = []
    for _ in range(steps):
        losses.append(loss)
        broke = grad.abs().amax(dim=1) <= tolerance_grad  # entry optimality check
        for _ in range(max_iter):
            active = ~broke
            n_glob1 = n_glob + active.long()
            first = n_glob1 == 1  # torch: d = -g, empty history, H_diag = 1
            y = grad - prev_grad
            s = d * t.unsqueeze(1)
            ys = _dot(y, s)
            insert = active & ~first & (ys > 1e-10)
            yy = _dot(y, y)
            H_diag1 = torch.where(first, torch.ones_like(ys),
                                  torch.where(insert, ys / torch.where(insert, yy, 1.0), H_diag))
            inner_runs += 1
            d1 = hist.direction(grad, y, s, ys, insert, H_diag1, min(inner_runs, history_size))
            t1 = torch.where(first, torch.clamp(1.0 / grad.abs().sum(dim=1), max=1.0) * lr,
                             torch.full_like(t, lr))
            break_gtd = _dot(grad, d1) > -tolerance_change
            step_taken = active & ~break_gtd
            prev_loss1, prev_grad1 = loss, grad
            prev_grad = torch.where(active.unsqueeze(1), prev_grad1, prev_grad)
            prev_loss = torch.where(active, prev_loss1, prev_loss)
            t = torch.where(active, t1, t)
            d = torch.where(active.unsqueeze(1), d1, d)
            H_diag = torch.where(active, H_diag1, H_diag)
            n_glob = n_glob1
            if not bool(step_taken.any()):
                # Every lane has broken off: the rest of the outer step would
                # change nothing.
                break
            x1 = torch.where(step_taken.unsqueeze(1), x + t1.unsqueeze(1) * d1, x)
            loss1, grad1 = loss_and_grad_fn(x1)
            loss1, grad1 = loss1.float(), grad1.float()
            opt_cond = grad1.abs().amax(dim=1) <= tolerance_grad
            small_step = (d1 * t1.unsqueeze(1)).abs().amax(dim=1) <= tolerance_change
            small_change = (loss1 - prev_loss1).abs() < tolerance_change
            broke = broke | break_gtd | (step_taken & (opt_cond | small_step | small_change))
            x = torch.where(step_taken.unsqueeze(1), x1, x)
            loss = torch.where(step_taken, loss1, loss)
            grad = torch.where(step_taken.unsqueeze(1), grad1, grad)
    out = torch.stack(losses, dim=1) if losses else loss.new_zeros((N, 0))
    if single:
        return x[0], out[0]
    return x, out



# The memory of optax.lbfgs() (``memory_size=10``), which the JAX engine's
# lbfgs-zoom takes as it is.
ZOOM_MEMORY = 10

# One record per outer step of every lbfgs_zoom run since the list was last
# emptied: (each lane's line-search iterations [N], host reads).
zoom_log: List[Tuple[np.ndarray, int]] = []


def _precondition(grad, S, Y, rho, gamma, memory_idx: int) -> torch.Tensor:
    """optax's ``_precondition_by_lbfgs`` per lane: the two-loop recursion
    over every slot of the ring, newest to oldest and back, with the empty
    slots' zero weights included as optax includes them."""
    m = S.shape[1]
    order = [(memory_idx + j) % m for j in range(m)]
    q, alphas = grad, {}
    for idx in reversed(order):
        alphas[idx] = rho[:, idx] * _dot(S[:, idx], q)
        q = q + (-alphas[idx]).unsqueeze(1) * Y[:, idx]
    r = gamma.unsqueeze(1) * q
    for idx in order:
        beta = rho[:, idx] * _dot(Y[:, idx], r)
        r = r + (alphas[idx] - beta).unsqueeze(1) * S[:, idx]
    return r


def lbfgs_zoom(
    loss_and_grad_fn: LossAndGrad,
    x0: torch.Tensor,
    steps: int,
    memory_size: int = ZOOM_MEMORY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` updates of ``optax.lbfgs()``, driven as the JAX engine's
    ``_run_lbfgs`` drives it (``optax.value_and_grad_from_state``).

    Each step: the L-BFGS direction of ``optax.scale_by_lbfgs`` (a ring of
    ``memory_size`` pairs (s, y) with weights ``1 / <y, s>``, the identity
    scaled by ``<y, s> / <y, y>`` of the last pair, or by ``min(1,
    1/|g|)`` at the first step), negated, then the zoom line search along it
    (``ops/linesearch.py``), whose last value and gradient start the next
    step without another closure (a lane whose value is not finite gets a
    new one, as ``value_and_grad_from_state`` gives it).

    ``x0`` is one flat problem ``[n]`` or N independent lanes ``[N, n]``;
    ``loss_and_grad_fn(x [N, n]) -> (loss [N], grad [N, n])`` is the closure
    over all lanes at once. Returns ``(x_final, losses)`` shaped like ``x0``
    and ``[steps]`` (``[N, steps]`` for lanes): ``losses[..., i]`` is the
    value at the start of step ``i``."""
    single = x0.dim() == 1
    x = (x0.unsqueeze(0) if single else x0).float()
    N, n = x.shape
    S = x.new_zeros((N, memory_size, n))
    Y = x.new_zeros((N, memory_size, n))
    rho = x.new_zeros((N, memory_size))
    prev_x, prev_g = torch.zeros_like(x), torch.zeros_like(x)
    value = np.full(N, np.inf, np.float32)
    grad = torch.zeros_like(x)
    losses = []
    for k in range(steps):
        reads = 0
        redo = ~np.isfinite(value)
        if redo.any():
            v, g = loss_and_grad_fn(x)
            again = torch.from_numpy(redo).to(x.device).unsqueeze(1)
            grad = torch.where(again, g.float(), grad)
            value = np.where(redo, v.float().cpu().numpy(), value)
            reads += 1
        losses.append(value.copy())
        if k > 0:
            ds, dy = x - prev_x, grad - prev_g
            ys = _dot(dy, ds)
            slot = (k - 1) % memory_size
            S[:, slot], Y[:, slot] = ds, dy
            rho[:, slot] = torch.where(ys == 0.0, torch.zeros_like(ys), 1.0 / ys)
            yy = _dot(dy, dy)
            gamma = torch.where(yy > 0.0, ys / yy, torch.ones_like(ys))
        else:
            gamma = torch.clamp(1.0 / grad.square().sum(dim=1).sqrt(), max=1.0)
        u = -1.0 * _precondition(grad, S, Y, rho, gamma, k % memory_size)
        prev_x, prev_g = x, grad
        found = linesearch.zoom_linesearch(loss_and_grad_fn, x, u, value, grad, _dot(u, grad))
        t = torch.from_numpy(found.stepsize).to(x.device)
        x = x + t.unsqueeze(1) * u
        value, grad = found.value, found.grad
        zoom_log.append((found.count, reads + int(found.count.max())))
    out = (torch.from_numpy(np.stack(losses, axis=1)) if losses
           else torch.zeros((N, 0))).to(x.device)
    if single:
        return x[0], out[0]
    return x, out
