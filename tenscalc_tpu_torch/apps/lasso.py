"""Lasso regression solver (port of ``tenscalc_tpu/apps/lasso.py``), the
analog of lib/TClasso.m.

Fits f(x) = c + x·w by
    minimize  sum_i (f(x_i) - y_i)^2 + l1weight * sum_i |w_i|
using the reference's epigraph reformulation of the l1 term: an
auxiliary variable absW with constraints -absW <= W <= absW and
objective term l1weight*sum(absW) (TClasso.m:351-359).

The solver runs on the card unless ``device='cpu'``.  At 200 features
the condensed KKT has 2 n_features + 1 = 401 rows and no band worth
planning, so ``kkt_backend='auto'`` resolves to the fleet dense LDL^T:
one fit runs K8 (factor and first solve) and K7 on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..expr import variable
from ..ipm.options import SolverOptions
from ..ops.fns import norm2


class Lasso:
    def __init__(
        self,
        n_features: int,
        n_points: int,
        add_constant: bool = True,
        name: str = "lasso",
        options: Optional[SolverOptions] = None,
        device=None,
        **option_kwargs,
    ):
        """``options`` and ``option_kwargs`` go to
        :func:`tenscalc_tpu_torch.optimize`, with ``device`` (the card
        when None)."""
        from ..api import optimize

        self.n_features = n_features
        self.n_points = n_points
        self.add_constant = add_constant

        X = variable(f"{name}_X", (n_points, n_features))
        y = variable(f"{name}_y", (n_points,))
        l1weight = variable(f"{name}_l1weight", ())
        W = variable(f"{name}_W", (n_features,))
        absW = variable(f"{name}_absW", (n_features,))
        self._names = dict(X=X.name, y=y.name, l1=l1weight.name,
                           W=W.name, absW=absW.name)

        e = X @ W - y
        opt_vars = [W]
        if add_constant:
            c = variable(f"{name}_c", ())
            e = e + c
            opt_vars.append(c)
            self._names["c"] = c.name
        opt_vars.append(absW)

        J = norm2(e) + l1weight * absW.sum()
        constraints = [W <= absW, W >= -absW]

        outputs = {"W": W, "J": J}
        if add_constant:
            outputs["c"] = opt_vars[1]

        self.solver = optimize(
            objective=J,
            optimizationVariables=opt_vars,
            constraints=constraints,
            parameters=[X, y, l1weight],
            outputExpressions=outputs,
            options=options,
            device=device,
            **option_kwargs,
        )

    def fit(self, X, y, l1weight: float, mu0: float = 1.0, max_iter: int = 200):
        """One fit from a strictly feasible init (W = 0, absW = 1, c the
        mean of y); returns the solver's :class:`Solution`, whose outputs
        are numpy arrays."""
        X = np.asarray(X, float)
        y = np.asarray(y, float)
        if X.shape != (self.n_points, self.n_features):
            raise ValueError(
                f"X must be ({self.n_points}, {self.n_features}), got {X.shape}"
            )
        # strictly feasible init: |W0| < absW0
        W0 = np.zeros(self.n_features)
        absW0 = np.ones(self.n_features)
        init = {self._names["W"]: W0, self._names["absW"]: absW0}
        if self.add_constant:
            init[self._names["c"]] = float(np.mean(y))
        sol = self.solver.solve(
            {
                self._names["X"]: X,
                self._names["y"]: y,
                self._names["l1"]: float(l1weight),
            },
            init=init,
            mu0=mu0,
            max_iter=max_iter,
        )
        return sol
