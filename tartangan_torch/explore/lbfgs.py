"""L-BFGS with a zoom line search, as ``optax.lbfgs(learning_rate)`` computes it.

``optax.lbfgs`` (optax 0.2.6, ``_src/alias.py``) chains three transforms,
and ``LBFGS.update`` runs them in that order on one tensor of parameters:

1. ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``
   (``_src/transform.py``): the memory of parameter and gradient
   differences is updated with the fresh pair, then the gradient is
   preconditioned by the two-loop recursion; the initial inverse Hessian is
   gamma I with gamma = <dg, dw> / <dg, dg>, and min(1, 1 / |g|) at the
   first step;
2. ``scale_by_learning_rate(learning_rate)``: times -learning_rate;
3. ``scale_by_zoom_linesearch(max_linesearch_steps=20,
   initial_guess_strategy='one')`` (``_src/linesearch.py``): a step size
   that meets the strong Wolfe conditions (sufficient decrease with
   slope_rtol 1e-4, or Hager and Zhang's approximate decrease with
   approx_dec_rtol 1e-6; curvature with curv_rtol 0.9), found by an
   interval search that doubles the step from 1, then a zoom by cubic,
   quadratic or bisection steps (interval threshold 1e-5). Where it fails,
   the best step with sufficient decrease is taken if there is one.

Every scalar is a 0-d float32 tensor on the parameters' device and every
choice a ``torch.where``, in the order optax computes them, so the iterates
follow optax's in float32. The line search's loop reads its flags on the
host once a trial. ``torch.optim.LBFGS`` is another algorithm (its own strong
Wolfe search, several evaluations a ``step``) and is not used.

``value_and_grad_fn(params) -> (value, grad)`` is the objective at a trial
point; every trial costs one call.
"""
from __future__ import annotations

import dataclasses

import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _where(cond, xs, ys):
    return [torch.where(cond, x, y) for x, y in zip(xs, ys)]


@dataclasses.dataclass
class LBFGSState:
    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor   # (memory, *shape)
    diff_updates: torch.Tensor  # (memory, *shape)
    weights: torch.Tensor       # (memory,)
    num_linesearch_steps: int = 0  # the last line search's trials


class _Search:
    """The zoom line search's state (``ZoomLinesearchState``)."""

    def __init__(self, params, updates, value, grad):
        f32 = dict(dtype=torch.float32, device=params.device)

        def s(x):
            return torch.as_tensor(x, **f32)

        self.count = 0
        self.params, self.updates = params, updates
        self.stepsize_guess = s(1.0)
        slope = _vdot(updates, grad)
        value = s(value)
        self.stepsize, self.value, self.grad, self.slope = \
            s(0.0), value, grad, slope
        self.value_init, self.slope_init = value, slope
        inf = s(float("inf"))
        self.decrease_error = self.curvature_error = self.error = inf
        false = torch.zeros((), dtype=torch.bool, device=params.device)
        self.interval_found = self.done = self.failed = false
        self.low, self.value_low, self.slope_low = s(0.0), value, slope
        self.high, self.value_high, self.slope_high = s(0.0), value, slope
        self.cubic_ref, self.value_cubic_ref = s(0.0), value
        self.safe_stepsize, self.safe_value, self.safe_grad = \
            s(0.0), value, grad


def _value_and_slope(fn, params, stepsize, updates):
    value, grad = fn(params + stepsize * updates)
    return value.to(torch.float32), grad, _vdot(grad, updates)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - APPROX_DEC_RTOL * value_init.abs()
    err = torch.minimum(torch.maximum(approx, delta), err)
    err = torch.clamp(err, min=0.0)
    return torch.where(err.isnan(), torch.full_like(err, float("inf")), err)


def _curvature_error(slope, slope_init):
    err = torch.clamp(slope.abs() - CURV_RTOL * slope_init.abs(), min=0.0)
    return torch.where(err.isnan(), torch.full_like(err, float("inf")), err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    x1 = fb - fa - C * db
    x2 = fc - fa - C * dc
    A = (dc ** 2 * x1 + (-(db ** 2)) * x2) / denom
    B = ((-(dc ** 3)) * x1 + db ** 3 * x2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _search_interval(st: _Search, fn):
    """Algorithm 3.5 of Nocedal and Wright."""
    new_stepsize = st.stepsize_guess if st.count == 0 \
        else INCREASE_FACTOR * st.stepsize
    value, grad, slope = _value_and_slope(fn, st.params, new_stepsize,
                                          st.updates)
    dec = _decrease_error(new_stepsize, value, slope, st.value_init,
                          st.slope_init)
    curv = _curvature_error(slope, st.slope_init)
    error = torch.maximum(dec, curv)
    safe = dec <= TOL
    st.safe_stepsize, st.safe_value, st.safe_grad = _where(
        safe, [new_stepsize, value, grad],
        [st.safe_stepsize, st.safe_value, st.safe_grad])
    set_high = (dec > 0.0) | ((value >= st.value) & (st.count > 0))
    set_low = (slope >= 0.0) & ~set_high
    default = [st.stepsize, st.value, st.slope, new_stepsize, value, slope]
    candidate = [new_stepsize, value, slope, st.stepsize, st.value, st.slope]
    (st.low, st.value_low, st.slope_low,
     st.high, st.value_high, st.slope_high) = _where(set_low, candidate,
                                                     default)
    st.interval_found = set_high | set_low | (error <= TOL)
    st.done = error <= TOL
    st.failed = torch.as_tensor(st.count + 1 >= MAX_LINESEARCH_STEPS,
                                device=error.device) & ~st.done
    st.count += 1
    st.stepsize, st.value, st.grad, st.slope = new_stepsize, value, grad, slope
    st.decrease_error, st.curvature_error, st.error = dec, curv, error
    st.cubic_ref, st.value_cubic_ref = st.low, st.value_low


def _zoom(st: _Search, fn):
    """Algorithm 3.6 of Nocedal and Wright."""
    low, value_low, slope_low = st.low, st.value_low, st.slope_low
    high, value_high, slope_high = st.high, st.value_high, st.slope_high
    delta = (high - low).abs()
    left = torch.minimum(high, low)
    right = torch.maximum(high, low)
    cubic_chk = 0.2 * delta
    quad_chk = 0.1 * delta
    too_small = delta <= INTERVAL_THRESHOLD
    cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                      st.cubic_ref, st.value_cubic_ref)
    use_cubic = (cubic > left + cubic_chk) & (cubic < right - cubic_chk)
    quad = _quadmin(low, value_low, slope_low, high, value_high)
    use_quad = ~use_cubic & (quad > left + quad_chk) & (quad < right - quad_chk)
    use_bisection = ~use_cubic & ~use_quad
    middle = torch.where(use_cubic, cubic, st.cubic_ref)
    middle = torch.where(use_quad, quad, middle)
    middle = torch.where(use_bisection, (low + high) / 2.0, middle)

    value, grad, slope = _value_and_slope(fn, st.params, middle, st.updates)
    dec = _decrease_error(middle, value, slope, st.value_init, st.slope_init)
    curv = _curvature_error(slope, st.slope_init)
    error = torch.maximum(dec, curv)
    update_safe = (dec <= TOL) & (value < st.safe_value)
    st.safe_stepsize, st.safe_value, st.safe_grad = _where(
        update_safe, [middle, value, grad],
        [st.safe_stepsize, st.safe_value, st.safe_grad])
    st.done = error <= TOL
    set_high_to_middle = (dec > 0.0) | (value >= value_low)
    set_high_to_low = (slope * (high - low) >= 0.0) & ~set_high_to_middle
    set_low_to_middle = ~set_high_to_middle
    new_high = _where(set_high_to_middle, [middle, value, slope],
                      [high, value_high, slope_high])
    st.high, st.value_high, st.slope_high = _where(
        set_high_to_low, [low, value_low, slope_low], new_high)
    st.low, st.value_low, st.slope_low = _where(
        set_low_to_middle, [middle, value, slope],
        [low, value_low, slope_low])
    st.cubic_ref, st.value_cubic_ref = _where(
        set_high_to_middle | set_high_to_low, [high, value_high],
        [low, value_low])
    presumably_failed = torch.as_tensor(
        st.count + 1 >= MAX_LINESEARCH_STEPS, device=error.device) \
        | (too_small & (st.safe_stepsize > 0.0))
    st.failed = presumably_failed & ~st.done
    st.count += 1
    st.stepsize, st.value, st.grad, st.slope = middle, value, grad, slope
    st.decrease_error, st.curvature_error, st.error = dec, curv, error


def _try_safe_step(st: _Search):
    """Where the search failed, the best step with sufficient decrease, if
    there is one."""
    take_safe = st.failed & ((st.safe_stepsize > 0.0)
                             | st.decrease_error.isinf())
    st.stepsize, st.value, st.grad = _where(
        take_safe, [st.safe_stepsize, st.safe_value, st.safe_grad],
        [st.stepsize, st.value, st.grad])


class LBFGS:
    """``optax.lbfgs(learning_rate)`` on one tensor: ``init(params)`` and
    ``update(grads, state, params, value=, value_and_grad_fn=)`` ->
    (updates, state); new params = params + updates."""

    def __init__(self, learning_rate: float | None = None):
        self.learning_rate = learning_rate

    def init(self, params: torch.Tensor) -> LBFGSState:
        zeros = torch.zeros((MEMORY_SIZE,) + tuple(params.shape),
                            dtype=params.dtype, device=params.device)
        return LBFGSState(
            count=0, params=torch.zeros_like(params),
            updates=torch.zeros_like(params), diff_params=zeros,
            diff_updates=zeros.clone(),
            weights=torch.zeros(MEMORY_SIZE, dtype=torch.float32,
                                device=params.device))

    @staticmethod
    def _precondition(updates, state: LBFGSState, gamma):
        """The two-loop recursion (``_precondition_by_lbfgs``): the oldest
        slot is ``count % memory``."""
        m = MEMORY_SIZE
        memory_idx = state.count % m
        indices = [(memory_idx + i) % m for i in range(m)]
        rhos, dw, du = state.weights, state.diff_params, state.diff_updates
        vec = updates
        alphas = [None] * m
        for j in reversed(range(m)):
            i = indices[j]
            alphas[j] = rhos[i] * _vdot(dw[i], vec)
            vec = vec + (-alphas[j]) * du[i]
        vec = gamma * vec
        for j in range(m):
            i = indices[j]
            beta = rhos[i] * _vdot(du[i], vec)
            vec = vec + (alphas[j] - beta) * dw[i]
        return vec

    def _scale_by_lbfgs(self, grads, state: LBFGSState, params):
        prev_idx = (state.count - 1) % MEMORY_SIZE
        diff_params = params - state.params
        diff_updates = grads - state.updates
        vdot = _vdot(diff_updates, diff_params)
        weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
        if state.count == 0:
            diff_params = torch.zeros_like(diff_params)
            diff_updates = torch.zeros_like(diff_updates)
            weight = torch.zeros_like(weight)
        state.diff_params = state.diff_params.clone()
        state.diff_updates = state.diff_updates.clone()
        state.weights = state.weights.clone()
        state.diff_params[prev_idx] = diff_params
        state.diff_updates[prev_idx] = diff_updates
        state.weights[prev_idx] = weight
        # gamma of the initial inverse Hessian gamma I (scale_init_precond)
        numerator = _vdot(diff_updates, diff_params)
        denominator = _vdot(diff_updates, diff_updates)
        gamma = torch.where(denominator > 0.0, numerator / denominator,
                            torch.ones_like(numerator))
        if state.count == 0:
            norm = torch.sqrt(_vdot(grads, grads))
            gamma = torch.minimum(torch.ones_like(norm), 1.0 / norm)
        precond = self._precondition(grads, state, gamma)
        state.count += 1
        state.params, state.updates = params, grads
        return precond

    def update(self, grads: torch.Tensor, state: LBFGSState,
               params: torch.Tensor, *, value: torch.Tensor,
               value_and_grad_fn):
        updates = self._scale_by_lbfgs(grads, state, params)
        lr = -1.0 if self.learning_rate is None else -self.learning_rate
        updates = lr * updates
        st = _Search(params, updates, value, grads)
        while True:
            done, failed, found = torch.stack(
                [st.done, st.failed, st.interval_found]).tolist()
            if done or failed:
                break
            (_zoom if found else _search_interval)(st, value_and_grad_fn)
            _try_safe_step(st)
        state.num_linesearch_steps = st.count
        return st.stepsize * updates, state
