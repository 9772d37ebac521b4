"""Time-series calculus (port of ``tenscalc_tpu/ops/tseries.py``).

Only the trapezoidal integral that the MPC flagship uses is ported; the
other helpers are ROADMAP item M15.  A time series of n-vectors is an
``[n, N]`` array, one sample per column; ``ts`` is a scalar sampling
period or an ``[N]`` vector of times.
"""

from __future__ import annotations

import numpy as np
import torch

from ..expr import Expr, lift


def _is_scalar_ts(ts) -> bool:
    if isinstance(ts, Expr):
        return ts.ndim == 0
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


def _deferred(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP item M15)"
        )

    fn.__name__ = name
    return fn


tsDerivative = _deferred("tsDerivative")
tsDerivative2 = _deferred("tsDerivative2")
tsIntegrate = _deferred("tsIntegrate")
tsODE = _deferred("tsODE")
