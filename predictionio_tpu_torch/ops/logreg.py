"""Multiclass logistic regression.

Counterpart of ``predictionio_tpu/ops/logreg.py`` (it replaces the
reference Classification template's call into MLlib
``LogisticRegressionWithLBFGS``).  Full-batch softmax cross-entropy with an
L2 term, a row mask removing padding from the loss, trained on the device
for a fixed iteration budget.  Each of the JAX package's ``lax.scan``
loops is a Python loop here with the same update order, the gradients from
``torch.autograd``.

The optimizers are optax's, written out as plain torch functions so a run
follows the JAX one step for step:

- ``adam``: ``optax.adam`` (``optax/_src/transform.py:scale_by_adam``):
  b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected
  moments, then the step scaled by ``-learning_rate``;
- ``lbfgs``: ``optax.lbfgs()`` of optax 0.2.6 (``optax/_src/alias.py:
  lbfgs``), the chain of ``scale_by_lbfgs`` (``optax/_src/transform.py``:
  memory 10, ``scale_init_precond``, the two-loop recursion of
  ``_precondition_by_lbfgs``), ``scale(-1)`` and
  ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` (``optax/_src/linesearch.py``: the
  interval search and zoom of ``zoom_linesearch`` with its defaults, slope
  rtol 1e-4, curvature rtol 0.9, approximate-decrease rtol 1e-6, stepsize
  precision 1e-5, increase factor 2), and the value and gradient reused
  from the line search's last point, as ``optax.value_and_grad_from_state``
  does.  ``torch.optim.LBFGS`` is another algorithm (its own line search
  and history rules) and is not used.

The line search's scalars (step sizes, values, slopes, errors) are float32
on the host, in the order optax computes them; its vectors stay on the
device.

Over a mesh of ranks (JAX :52-66) the examples are padded to a multiple of
dp and each rank holds its contiguous rows; every evaluation sums the
loss's data term and its gradient over the ranks in one all-reduce
(``parallel.distributed.all_reduce_sum``) before the L2 term is added, so
Adam, L-BFGS and its line search see the same values in every rank, and W
and b come out equal in every rank.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.parallel.distributed import all_reduce_sum

Tree = Tuple[torch.Tensor, ...]
_F32 = np.float32

# optax.lbfgs() of optax 0.2.6
LBFGS_MEMORY = 10
LINESEARCH_STEPS = 20
_SLOPE_RTOL = _F32(1e-4)
_CURV_RTOL = _F32(0.9)
_APPROX_DEC_RTOL = _F32(1e-6)
_INTERVAL_THRESHOLD = _F32(1e-5)
_INCREASE = _F32(2.0)
_TOL = _F32(0.0)
# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# -- pytree arithmetic over tuples of tensors (optax.tree) -------------------


def _vdot(a: Tree, b: Tree) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _add_scale(a: Tree, s, b: Tree) -> Tree:
    return tuple(x + s * y for x, y in zip(a, b))


def _scale(s, a: Tree) -> Tree:
    return tuple(s * x for x in a)


def _sub(a: Tree, b: Tree) -> Tree:
    return tuple(x - y for x, y in zip(a, b))


def _sq_norm(a: Tree) -> torch.Tensor:
    return sum(torch.sum(x * x) for x in a)


def _f32(t) -> np.float32:
    return _F32(t.item() if torch.is_tensor(t) else t)


def value_and_grad(fn: Callable[[Tree], torch.Tensor], params: Tree):
    """(value, grads) of a scalar ``fn`` at ``params``, detached."""
    p = tuple(t.detach().requires_grad_(True) for t in params)
    with torch.enable_grad():
        v = fn(p)
        g = torch.autograd.grad(v, p)
    return v.detach(), tuple(gi.detach() for gi in g)


# -- Adam ----------------------------------------------------------------------


class Adam:
    """``optax.adam(learning_rate)`` on a tuple of tensors."""

    def __init__(self, params: Tree, learning_rate: float,
                 b1: float = ADAM_B1, b2: float = ADAM_B2, eps: float = ADAM_EPS):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.count = 0
        self.mu = tuple(torch.zeros_like(p) for p in params)
        self.nu = tuple(torch.zeros_like(p) for p in params)

    def update(self, grads: Tree) -> Tree:
        """The additive update for ``grads`` (``params + update``)."""
        # (1 - decay) is taken in double and rounded once, as JAX does
        b1, b2, r1, r2 = (_F32(v) for v in (self.b1, self.b2, 1 - self.b1, 1 - self.b2))
        self.mu = tuple(r1 * g + b1 * m for g, m in zip(grads, self.mu))
        self.nu = tuple(r2 * (g * g) + b2 * v for g, v in zip(grads, self.nu))
        self.count += 1
        c1 = _F32(1) - b1 ** _F32(self.count)
        c2 = _F32(1) - b2 ** _F32(self.count)
        return tuple(
            (m / c1) / (torch.sqrt(v / c2) + _F32(self.eps)) * _F32(-self.lr)
            for m, v in zip(self.mu, self.nu))


Evaluate = Callable[[Tree], Tuple[torch.Tensor, Tree]]


def _evaluator(fn: Callable[[Tree], torch.Tensor], vg: Optional[Evaluate]) -> Evaluate:
    """``vg`` where given (a reduced evaluation), else autograd of ``fn``."""
    return vg if vg is not None else (lambda p: value_and_grad(fn, p))


def adam_run(loss_fn: Callable[[Tree], torch.Tensor], params: Tree, learning_rate: float,
             iterations: int, vg: Optional[Evaluate] = None) -> Tuple[Tree, torch.Tensor]:
    """``iterations`` Adam steps: (final params, the loss before each step).
    ``vg(params)`` → (value, grads) replaces autograd of ``loss_fn``."""
    evaluate = _evaluator(loss_fn, vg)
    opt = Adam(params, learning_rate)
    losses = []
    for _ in range(iterations):
        value, grads = evaluate(params)
        params = tuple(p + u for p, u in zip(params, opt.update(grads)))
        losses.append(value)
    return params, torch.stack(losses) if losses else torch.empty(0)


# -- L-BFGS with the zoom line search (optax.lbfgs) -------------------------------


class _LBFGSMemory:
    """``scale_by_lbfgs``'s state: the last ``memory`` parameter and
    gradient differences and their weights, written round-robin."""

    def __init__(self, params: Tree, memory: int):
        self.m = memory
        self.count = 0
        self.params = tuple(torch.zeros_like(p) for p in params)
        self.updates = tuple(torch.zeros_like(p) for p in params)
        self.dw: List[Tree] = [tuple(torch.zeros_like(p) for p in params)] * memory
        self.du: List[Tree] = [tuple(torch.zeros_like(p) for p in params)] * memory
        dev = params[0].device
        self.rho: List[torch.Tensor] = [torch.zeros((), dtype=torch.float32, device=dev)] * memory

    def precondition(self, grads: Tree, params: Tree) -> Tree:
        """``scale_by_lbfgs.update_fn``: record the newest differences, then
        the two-loop product of the inverse-Hessian estimate and ``grads``."""
        m, count = self.m, self.count
        memory_idx, prev_idx = count % m, (count - 1) % m
        dev = grads[0].device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if count > 0:
            dw, du = _sub(params, self.params), _sub(grads, self.updates)
            v = _vdot(du, dw)
            weight = torch.where(v == 0.0, zero, 1.0 / v)
        else:
            dw = tuple(torch.zeros_like(p) for p in params)
            du = tuple(torch.zeros_like(p) for p in params)
            weight = zero
        self.dw = list(self.dw)
        self.du = list(self.du)
        self.rho = list(self.rho)
        self.dw[prev_idx], self.du[prev_idx], self.rho[prev_idx] = dw, du, weight
        if count > 0:
            num, den = _vdot(du, dw), _sq_norm(du)
            scale = torch.where(den > 0.0, num / den, torch.ones((), device=dev))
        else:
            norm = torch.sqrt(_sq_norm(grads))
            scale = torch.minimum(torch.ones((), device=dev), 1.0 / norm)
        indices = [(memory_idx + j) % m for j in range(m)]
        vec = grads
        alphas = [zero] * m
        for j in reversed(range(m)):          # the right product, newest first
            i = indices[j]
            alpha = self.rho[i] * _vdot(self.dw[i], vec)
            vec = _add_scale(vec, -alpha, self.du[i])
            alphas[j] = alpha
        vec = _scale(scale, vec)
        for j in range(m):                    # the left product, oldest first
            i = indices[j]
            beta = self.rho[i] * _vdot(self.du[i], vec)
            vec = _add_scale(vec, alphas[j] - beta, self.dw[i])
        self.count += 1
        self.params, self.updates = params, grads
        return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """``linesearch._cubicmin`` in float32: the critical point of the cubic
    through (a, fa), (b, fb), (c, fc) with slope fpa at a (NaN if none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc ** 2 * v0 + (-(db ** 2)) * v1) / denom
    B = ((-(dc ** 3)) * v0 + db ** 3 * v1) / denom
    radical = B * B - _F32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (_F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """``linesearch._quadmin`` in float32."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (_F32(2.0) * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope - _F32(2 * 1e-4 - 1.0) * slope_init
    delta = value - value_init - _APPROX_DEC_RTOL * np.abs(value_init)
    err = np.minimum(np.maximum(approx, delta), err)
    err = np.maximum(err, _F32(0.0))
    return _F32(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(slope_init), _F32(0.0))
    return _F32(np.inf) if np.isnan(err) else err


def zoom_linesearch(fn: Callable[[Tree], torch.Tensor], params: Tree, updates: Tree,
                    value, grads: Tree, max_steps: int = LINESEARCH_STEPS,
                    vg: Optional[Evaluate] = None):
    """``scale_by_zoom_linesearch``'s search along ``updates`` from
    ``params`` with the initial guess 1: (stepsize, value, gradient) of the
    accepted point, the same decisions as optax's, step for step."""
    evaluate = _evaluator(fn, vg)

    def on_line(stepsize):
        v, g = evaluate(_add_scale(params, float(stepsize), updates))
        return _f32(v), g, _f32(_vdot(g, updates))

    value_init = _f32(value)
    slope_init = _f32(_vdot(updates, grads))
    s = dict(count=0, stepsize=_F32(0.0), value=value_init, grad=grads, slope=slope_init,
             dec=_F32(np.inf), curv=_F32(np.inf), interval_found=False, done=False,
             failed=False, low=_F32(0.0), value_low=value_init, slope_low=slope_init,
             high=_F32(0.0), value_high=value_init, slope_high=slope_init,
             cubic_ref=_F32(0.0), value_cubic_ref=value_init, safe_stepsize=_F32(0.0),
             safe_value=value_init, safe_grad=grads)
    with np.errstate(all="ignore"):
        while not (s["done"] or s["failed"]):
            if s["interval_found"]:
                _zoom_step(s, on_line, value_init, slope_init, max_steps)
            else:
                _search_step(s, on_line, value_init, slope_init, max_steps)
            if s["failed"]:   # _try_safe_step
                if s["safe_stepsize"] > 0.0 or np.isinf(s["dec"]):
                    s["stepsize"], s["value"], s["grad"] = (
                        s["safe_stepsize"], s["safe_value"], s["safe_grad"])
    return s["stepsize"], s["value"], s["grad"]


def _search_step(s, on_line, value_init, slope_init, max_steps):
    """``zoom_linesearch._search_interval`` (Nocedal and Wright, 3.5)."""
    it = s["count"]
    prev = (s["stepsize"], s["value"], s["slope"])
    new = s["stepsize"] * _INCREASE if it > 0 else _F32(1.0)
    v, g, sl = on_line(new)
    dec, curv = _decrease_error(new, v, sl, value_init, slope_init), _curvature_error(sl, slope_init)
    err = np.maximum(dec, curv)
    if dec <= _TOL:
        s["safe_stepsize"], s["safe_value"], s["safe_grad"] = new, v, g
    high_to_new = bool(dec > 0.0) or bool(v >= prev[1] and it > 0)
    low_to_new = bool(sl >= 0.0) and not high_to_new
    if low_to_new:
        (s["low"], s["value_low"], s["slope_low"]), (s["high"], s["value_high"],
                                                     s["slope_high"]) = (new, v, sl), prev
    else:
        (s["low"], s["value_low"], s["slope_low"]), (s["high"], s["value_high"],
                                                     s["slope_high"]) = prev, (new, v, sl)
    done = bool(err <= _TOL)
    s.update(count=it + 1, stepsize=new, value=v, grad=g, slope=sl, dec=dec, curv=curv,
             interval_found=high_to_new or low_to_new or done, done=done,
             failed=(it + 1 >= max_steps) and not done, cubic_ref=s["low"],
             value_cubic_ref=s["value_low"])


def _zoom_step(s, on_line, value_init, slope_init, max_steps):
    """``zoom_linesearch._zoom_into_interval`` (Nocedal and Wright, 3.6)."""
    it = s["count"]
    low, vlow, slow = s["low"], s["value_low"], s["slope_low"]
    high, vhigh, shigh = s["high"], s["value_high"], s["slope_high"]
    delta = np.abs(high - low)
    left, right = np.minimum(high, low), np.maximum(high, low)
    too_small = bool(delta <= _INTERVAL_THRESHOLD)
    mc = _cubicmin(low, vlow, slow, high, vhigh, s["cubic_ref"], s["value_cubic_ref"])
    use_cubic = bool(mc > left + _F32(0.2) * delta) and bool(mc < right - _F32(0.2) * delta)
    mq = _quadmin(low, vlow, slow, high, vhigh)
    use_quad = not use_cubic and bool(mq > left + _F32(0.1) * delta) \
        and bool(mq < right - _F32(0.1) * delta)
    middle = mc if use_cubic else mq if use_quad else (low + high) / _F32(2.0)
    v, g, sl = on_line(middle)
    dec, curv = _decrease_error(middle, v, sl, value_init, slope_init), \
        _curvature_error(sl, slope_init)
    err = np.maximum(dec, curv)
    if dec <= _TOL and v < s["safe_value"]:
        s["safe_stepsize"], s["safe_value"], s["safe_grad"] = middle, v, g
    done = bool(err <= _TOL)
    high_to_middle = bool(dec > 0.0) or bool(v >= vlow)
    high_to_low = bool(sl * (high - low) >= 0.0) and not high_to_middle
    new_high = (middle, v, sl) if high_to_middle else (high, vhigh, shigh)
    if high_to_low:
        new_high = (low, vlow, slow)
    new_low = (low, vlow, slow) if high_to_middle else (middle, v, sl)
    cubic = (high, vhigh) if (high_to_middle or high_to_low) else (low, vlow)
    failed = (it + 1 >= max_steps or (too_small and s["safe_stepsize"] > 0.0)) and not done
    s.update(count=it + 1, stepsize=middle, value=v, grad=g, slope=sl, dec=dec, curv=curv,
             done=done, failed=failed, low=new_low[0], value_low=new_low[1],
             slope_low=new_low[2], high=new_high[0], value_high=new_high[1],
             slope_high=new_high[2], cubic_ref=cubic[0], value_cubic_ref=cubic[1])


def lbfgs_run(loss_fn: Callable[[Tree], torch.Tensor], params: Tree, iterations: int,
              memory: int = LBFGS_MEMORY,
              vg: Optional[Evaluate] = None) -> Tuple[Tree, torch.Tensor]:
    """``iterations`` steps of ``optax.lbfgs()``: (final params, the loss
    before each step).  ``vg(params)`` → (value, grads) replaces autograd
    of ``loss_fn``."""
    evaluate = _evaluator(loss_fn, vg)
    mem = _LBFGSMemory(params, memory)
    value = grads = None
    losses = []
    for _ in range(iterations):
        if value is None or not np.isfinite(_f32(value)):
            value, grads = evaluate(params)
        direction = _scale(-1.0, mem.precondition(grads, params))
        step, ls_value, ls_grad = zoom_linesearch(loss_fn, params, direction, value, grads,
                                                  vg=vg)
        losses.append(value if torch.is_tensor(value) else torch.tensor(value))
        params = tuple(p + u for p, u in zip(params, _scale(float(step), direction)))
        value, grads = torch.tensor(ls_value, device=params[0].device), ls_grad
    return params, torch.stack([lo.to(params[0].device) for lo in losses]) if losses \
        else torch.empty(0)


# -- logistic regression ----------------------------------------------------------


def _data_sum(params: Tree, x, y, mask) -> torch.Tensor:
    """The masked sum of the softmax cross-entropy over the rows held."""
    w, b = params
    logits = x @ w + b
    shifted = logits - logits.max(dim=-1, keepdim=True).values.detach()
    ll = torch.logsumexp(shifted, dim=-1) - shifted.gather(-1, y[:, None])[:, 0]
    return torch.sum(ll * mask)


def _loss_fn(params: Tree, x, y, mask, l2) -> torch.Tensor:
    w, _ = params
    ll = _data_sum(params, x, y, mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return ll + l2 * torch.sum(w * w)


def _mesh_value_and_grad(x, y, mask, l2, mesh) -> Evaluate:
    """The loss and its gradient over every rank's rows: this rank's data
    term and gradient, summed over the ranks in one all-reduce, divided by
    the rows of all ranks, plus the L2 term (and its gradient 2·l2·w)."""
    n = all_reduce_sum(torch.sum(mask).reshape(1), mesh)
    denom = torch.clamp_min(n[0], 1.0)

    def vg(params: Tree):
        s, gs = value_and_grad(lambda p: _data_sum(p, x, y, mask), params)
        flat = all_reduce_sum(torch.cat([s.reshape(1), *(g.reshape(-1) for g in gs)]), mesh)
        parts = flat.split([1, *(p.numel() for p in params)])
        w = params[0]
        value = parts[0][0] / denom + l2 * torch.sum(w * w)
        grads = tuple(g.view_as(p) / denom for g, p in zip(parts[1:], params))
        return value, (grads[0] + 2 * l2 * w, *grads[1:])

    return vg


def _logreg_run(x, y, mask, w0, b0, l2, *, optimizer: str, learning_rate: float,
                iterations: int, mesh=None):
    """The training loop on tensors (the JAX package's ``_logreg_run``):
    ((W, b), the loss before each step).  With a ``mesh`` the tensors are
    this rank's rows and every evaluation is summed over the ranks."""
    objective = lambda p: _loss_fn(p, x, y, mask, l2)  # noqa: E731
    vg = _mesh_value_and_grad(x, y, mask, l2, mesh) if mesh is not None else None
    if optimizer == "lbfgs":
        return lbfgs_run(objective, (w0, b0), iterations, vg=vg)
    return adam_run(objective, (w0, b0), learning_rate, iterations, vg=vg)


def logreg_train(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    l2: float = 1e-4,
    iterations: int = 100,
    optimizer: str = "lbfgs",
    learning_rate: float = 0.1,
    mesh=None,
    seed: int = 0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(W [d, C], b [C]) as host arrays, trained on ``device`` (default
    ``"cuda"``) from zeros.  ``seed`` is accepted for the signature (the
    start is deterministic).  With a ``mesh`` of ranks the examples are
    padded to a multiple of dp and each rank trains on its rows, the
    evaluations summed over the ranks; every rank returns the same W, b."""
    del seed
    if optimizer not in ("lbfgs", "adam"):
        raise ValueError(f"unknown optimizer {optimizer!r} (lbfgs|adam)")
    dev = resolve_device(device)
    n, d = np.shape(x)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int64)
    mask = np.ones(n, np.float32)
    if mesh is not None:
        from predictionio_tpu_torch.parallel.sharding import (
            pad_to_multiple,
            shard_rows,
            stage_global,
        )

        dp = mesh.shape["dp"]
        x, y, mask = (pad_to_multiple(a, dp) for a in (x, y, mask))
        xt, yt, mt = (stage_global(a, shard_rows(mesh, "dp", a.ndim), dev)
                      for a in (x, y, mask))
    else:
        xt, yt, mt = (torch.as_tensor(a).to(dev) for a in (x, y, mask))
    w0 = torch.zeros((d, n_classes), dtype=torch.float32, device=dev)
    b0 = torch.zeros(n_classes, dtype=torch.float32, device=dev)
    (w, b), _ = _logreg_run(xt, yt, mt, w0, b0, _F32(l2), optimizer=optimizer,
                            learning_rate=float(learning_rate), iterations=int(iterations),
                            mesh=mesh)
    return w.cpu().numpy(), b.cpu().numpy()


def logreg_predict_proba(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Class probabilities [n, C] of ``x`` on the weights' device."""
    return torch.softmax(x @ w + b, dim=-1)


def logreg_predict(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> np.ndarray:
    """Predicted class ids (host) of ``x``."""
    return torch.argmax(logreg_predict_proba(w, b, x), dim=-1).cpu().numpy()


# -- binary logistic regression over categorical ids (lead scoring) ---------------


def _gather_logreg_run(w0, b0, flat_idx, valid, y, l2, lr, iterations: int) -> Tree:
    """Adam on z = Σ_a w[id_a] + b with the sigmoid cross-entropy (the JAX
    package's ``_gather_logreg_run``)."""
    safe = torch.clamp_min(flat_idx, 0)

    def loss_fn(params):
        w, b = params
        z = torch.where(valid, w[safe], 0.0).sum(dim=0) + b          # [N]
        ll = -y * F.logsigmoid(z) - (1.0 - y) * F.logsigmoid(-z)
        return ll.mean() + l2 * torch.sum(w * w)

    params, _ = adam_run(loss_fn, (w0, b0), lr, iterations)
    return params


def logreg_gather_train(
    attr_idx: np.ndarray,     # int32 [A, N], -1 = attribute missing
    dims: Sequence[int],      # per-attribute dictionary sizes
    y: np.ndarray,            # [N] binary labels
    l2: float = 1e-3,
    iterations: int = 200,
    learning_rate: float = 0.1,
    device=None,
) -> Tuple[List[np.ndarray], float]:
    """Binary logistic regression over categorical ids without a one-hot
    design matrix: z = Σ_a w_a[id_a] + b by embedding gathers, memory
    O(N·A + Σdims).  Returns (per-attribute weight tables, bias) as host
    values, trained on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    dims = [max(int(d), 1) for d in dims]
    offsets = np.concatenate([[0], np.cumsum(dims)]).astype(np.int64)
    attr_idx = np.asarray(attr_idx)
    flat = np.where(attr_idx >= 0, attr_idx + offsets[:-1][:, None], -1).astype(np.int64)
    w, b = _gather_logreg_run(
        torch.zeros(int(offsets[-1]), dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.as_tensor(flat).to(dev), torch.as_tensor(attr_idx >= 0).to(dev),
        torch.as_tensor(np.asarray(y, np.float32)).to(dev), _F32(l2),
        float(learning_rate), int(iterations))
    w = w.cpu().numpy()
    tables = [w[offsets[a]:offsets[a + 1]].copy() for a in range(len(dims))]
    return tables, float(b)
