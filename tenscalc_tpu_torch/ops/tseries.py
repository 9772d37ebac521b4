"""Time-series calculus (port of ``tenscalc_tpu/ops/tseries.py``).

A time series of n-vectors is an ``[n, N]`` array, one sample per
column; ``ts`` is a scalar sampling period or an ``[N]`` vector of
times.  Integrals, derivatives, the cumulative integral, the ODE
constraint builder, and the columnwise vector and quaternion helpers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..expr import Constraint, Expr, constant, lift


def _is_scalar_ts(ts) -> bool:
    if isinstance(ts, Expr):
        return ts.ndim == 0
    if isinstance(ts, torch.Tensor):
        return ts.numel() == 1
    return np.ndim(ts) == 0 or np.size(ts) == 1


def _trapezoid_weights(ts_, N: int, scalar: bool, like: torch.Tensor):
    if scalar:
        half = torch.full((1,), 0.5, dtype=like.dtype, device=like.device)
        ones = torch.ones(N - 2, dtype=like.dtype, device=like.device)
        return ts_ * torch.cat([half, ones, half])
    t = torch.ravel(ts_)
    return 0.5 * torch.cat([t[1:2] - t[0:1], t[2:] - t[:-2], t[-1:] - t[-2:-1]])


def tsIntegral(x, ts):
    """Trapezoidal integral over the last axis."""
    scalar = _is_scalar_ts(ts)

    def impl(x_, ts_):
        w = _trapezoid_weights(ts_, x_.shape[-1], scalar, x_)
        return torch.tensordot(x_, w, dims=([x_.dim() - 1], [0]))

    return lift(impl)(x, ts)


def tsDerivative(x, ts):
    """Piecewise-quadratic time derivative: the centred 3-point stencil
    inside (for any grid), one-sided quadratic stencils at the ends.
    Output shape = input shape."""
    scalar = _is_scalar_ts(ts)

    def impl(x_, ts_):
        if scalar:
            h = ts_
            first = (-1.5 * x_[..., 0] + 2.0 * x_[..., 1] - 0.5 * x_[..., 2]) / h
            inner = (x_[..., 2:] - x_[..., :-2]) / (2.0 * h)
            last = (0.5 * x_[..., -3] - 2.0 * x_[..., -2] + 1.5 * x_[..., -1]) / h
            return torch.cat([first[..., None], inner, last[..., None]], dim=-1)
        t = torch.ravel(ts_)
        t0, t1, t2 = t[:-2], t[1:-1], t[2:]
        c0 = (t1 - t2) / ((t0 - t2) * (t0 - t1))
        c1 = (t0 + t2 - 2 * t1) / ((t1 - t2) * (t0 - t1))
        c2 = (t0 - t1) / ((t0 - t2) * (t2 - t1))
        inner = c0 * x_[..., :-2] + c1 * x_[..., 1:-1] + c2 * x_[..., 2:]
        a, b, c = t[0], t[1], t[2]
        f0 = ((2 * a - b - c) / ((a - c) * (a - b)) * x_[..., 0]
              + (c - a) / ((b - c) * (a - b)) * x_[..., 1]
              + (a - b) / ((a - c) * (b - c)) * x_[..., 2])
        a, b, c = t[-3], t[-2], t[-1]
        fN = ((c - b) / ((a - b) * (a - c)) * x_[..., -3]
              + (c - a) / ((b - a) * (b - c)) * x_[..., -2]
              + (2 * c - a - b) / ((c - a) * (c - b)) * x_[..., -1])
        return torch.cat([f0[..., None], inner, fN[..., None]], dim=-1)

    return lift(impl)(x, ts)


def tsDerivative2(x, ts):
    """Second time derivative (the quadratic's through three samples)."""
    scalar = _is_scalar_ts(ts)

    def impl(x_, ts_):
        if scalar:
            inv = 1.0 / (ts_ * ts_)
            core = x_[..., :-2] - 2.0 * x_[..., 1:-1] + x_[..., 2:]
            first = (x_[..., 0] - 2.0 * x_[..., 1] + x_[..., 2])[..., None]
            last = (x_[..., -3] - 2.0 * x_[..., -2] + x_[..., -1])[..., None]
            return inv * torch.cat([first, core, last], dim=-1)
        t = torch.ravel(ts_)
        t0, t1, t2 = t[:-2], t[1:-1], t[2:]
        c0 = 2.0 / ((t0 - t1) * (t0 - t2))
        c1 = 2.0 / ((t1 - t0) * (t1 - t2))
        c2 = 2.0 / ((t2 - t0) * (t2 - t1))
        core = c0 * x_[..., :-2] + c1 * x_[..., 1:-1] + c2 * x_[..., 2:]
        return torch.cat([core[..., :1], core, core[..., -1:]], dim=-1)

    return lift(impl)(x, ts)


def tsIntegrate(x, x0, ts, method: str = "euler"):
    """Cumulative integral time series from ``x0`` (Euler or
    trapezoidal)."""
    if method not in ("euler", "trapesoidal", "trapezoidal"):
        raise ValueError(f"tsIntegrate: unknown method {method!r}")
    scalar = _is_scalar_ts(ts)

    def impl(x_, x0_, ts_):
        x0c = torch.reshape(torch.as_tensor(x0_, dtype=x_.dtype, device=x_.device),
                            tuple(x_.shape[:-1]) + (1,))
        if method == "euler":
            steps = x_[..., :-1]
        else:
            steps = x_[..., :-1] + x_[..., 1:]
        if scalar:
            scale = ts_ if method == "euler" else ts_ / 2.0
            acc = scale * torch.cumsum(steps, dim=-1)
        else:
            t = torch.ravel(ts_)
            dt = t[1:] - t[:-1]
            acc = torch.cumsum(dt * steps if method == "euler" else 0.5 * dt * steps, dim=-1)
        return torch.cat([x0c, x0c + acc], dim=-1)

    return lift(impl)(x, x0, ts)


def tsODE(x, uZOH, uC, ts, fun, method: str = "forwardEuler") -> Constraint:
    """An equality constraint encoding ``dot x = fun(x, uZOH, uC, t)``
    (forward Euler, backward Euler or the midpoint rule).  ``fun`` takes
    expressions (or tensors) with the time axis last."""
    if method == "forwardEuler":
        lhs = x[..., 1:]
        rhs = x[..., :-1] + _scale_time(
            _dts(ts),
            fun(x[..., :-1],
                uZOH[..., :-1] if uZOH is not None else None,
                uC[..., :-1] if uC is not None else None,
                _times(ts, x, start=0)))
        return lhs == rhs
    if method == "backwardEuler":
        lhs = x[..., 1:]
        rhs = x[..., :-1] + _scale_time(
            _dts(ts),
            fun(x[..., 1:],
                uZOH[..., :-1] if uZOH is not None else None,
                uC[..., 1:] if uC is not None else None,
                _times(ts, x, start=1)))
        return lhs == rhs
    if method == "midPoint":
        lhs = tsDerivative(x, ts)[..., :-1]
        rhs = fun(x, uZOH, uC, _times(ts, x, start=1))[..., :-1]
        return lhs == rhs
    raise ValueError(f"tsODE: method {method!r} not implemented")


def _dts(ts):
    if _is_scalar_ts(ts):
        return ts
    return lift(lambda t: torch.ravel(t)[1:] - torch.ravel(t)[:-1])(ts)


def _times(ts, x, start: int):
    N = x.shape[-1]
    if _is_scalar_ts(ts):
        k = np.arange(start, N - 1 + start, dtype=np.float64)
        if isinstance(ts, Expr):
            return lift(lambda t: t * torch.as_tensor(k, dtype=t.dtype, device=t.device))(ts)
        return constant(float(ts) * k)
    if start == 0:
        return lift(lambda t: torch.ravel(t)[:-1])(ts)
    return lift(lambda t: torch.ravel(t)[1:])(ts)


def _scale_time(dt, v):
    """A time series times the step dt (a scalar or an [N-1] vector)."""
    if isinstance(dt, Expr) and dt.ndim > 0:
        return lift(lambda d, v_: d * v_)(dt, v)
    return dt * v


# ---------------------------------------------------------------------------
# vector and quaternion helpers (scalar part first)
# ---------------------------------------------------------------------------

def _cross(a, b):
    return torch.linalg.cross(a, b, dim=0)


def tsCross(x1, x2, ts=None):
    """Columnwise cross product of 3-vector time series."""
    return lift(_cross)(x1, x2)


def tsDot(x1, x2, ts=None):
    """Columnwise dot product: [N]."""
    return lift(lambda a, b: torch.sum(a * b, dim=0))(x1, x2)


def _qdot(a, b):
    if a.shape[0] == 4 and b.shape[0] == 4:
        a0, av = a[0:1], a[1:4]
        b0, bv = b[0:1], b[1:4]
        s = a0 * b0 - torch.sum(av * bv, dim=0, keepdim=True)
        v = a0 * bv + b0 * av + _cross(av, bv)
        return torch.cat([s, v], dim=0)
    if a.shape[0] == 4 and b.shape[0] == 3:
        a0, av = a[0:1], a[1:4]
        s = -torch.sum(av * b, dim=0, keepdim=True)
        v = a0 * b + _cross(av, b)
        return torch.cat([s, v], dim=0)
    if a.shape[0] == 3 and b.shape[0] == 4:
        b0, bv = b[0:1], b[1:4]
        s = -torch.sum(a * bv, dim=0, keepdim=True)
        v = b0 * a + _cross(a, bv)
        return torch.cat([s, v], dim=0)
    raise ValueError("tsQdot: inputs must be time series of 3- or 4-vectors")


def tsQdot(q1, q2, ts=None):
    """Columnwise quaternion product: full x full, full x pure (3) and
    pure x full."""
    return lift(_qdot)(q1, q2)


def tsQdotStar(q1, q2, ts=None):
    """Columnwise conj(q1) * q2."""
    return tsQdot(lift(lambda a: torch.cat([a[0:1], -a[1:4]], dim=0))(q1), q2)


def _rotate(q_, x_, inverse: bool):
    q0, qv = q_[0:1], -q_[1:4] if inverse else q_[1:4]
    t = 2.0 * _cross(qv, x_)
    return x_ + q0 * t + _cross(qv, t)


def tsRotation(q, x, ts=None):
    """Rotate the 3-vector series x by the unit-quaternion series q:
    q x conj(q)."""
    return lift(lambda q_, x_: _rotate(q_, x_, False))(q, x)


def tsRotationT(q, x, ts=None):
    """The inverse rotation conj(q) x q."""
    return lift(lambda q_, x_: _rotate(q_, x_, True))(q, x)
