"""Computation-graph export (port of ``tenscalc_tpu/cgexport.py``): the
analog of the reference's lib/@csparse/saveVectorized.m /
saveScalarized.m / lib/CGregistration.m, which serialize the csparse
dataflow graph (.cg/.cgc/.cgio/.cgs files) for external consumers
(doc/computationgraphs.tex:84-190).

The JAX package traces its whole solve, a ``lax.while_loop``, into one
jaxpr.  The port's IPM loop is Python with an exit test read on the
host, so it cannot be exported as one program.  What has fixed shapes
is exported with ``torch.export.export``, one program each, at zero
inputs of the problem's shapes and dtype on the CPU (each first traced
to ATen operations by ``make_fx``, which differentiates through the
``torch.func`` transforms that ``torch.export`` does not trace):

* ``f``, ``F`` and ``G`` of (u, parameters), and their derivatives: the
  objective's gradient and Hessian, the constraints' Jacobians;
* one iterate's KKT assembly (:func:`.ipm.solver.dense_kkt`: the
  options' dense Newton matrix at (u, nu, lam, addU, addEq)).

It writes:

* ``<stem>.fx.txt``    — each exported program's ATen graph, in order;
* ``<stem>.meta.json`` — problem metadata: variable/parameter names and
  shapes, dimensions, options, and the ATen operation counts over the
  programs (``primitive_counts``, the analog of the CGregistration
  op-code table).

``include_hlo`` (the JAX package's StableHLO module) has no counterpart
here: it is accepted and writes nothing.
"""

from __future__ import annotations

import collections
import json
from pathlib import Path

import torch
from torch.func import grad, jacfwd
from torch.fx.experimental.proxy_tensor import make_fx

from .ipm.solver import dense_kkt


def _programs(solver):
    """(name, function of positional tensors, example inputs) of each
    exported program."""
    dt = solver.opts.torch_dtype
    nU, nF, nG = solver.nU, solver.nF, solver.nG
    names = [p.name for p in solver.parameters]
    pvals = [torch.zeros(p.shape, dtype=dt) for p in solver.parameters]
    fns = solver._fns
    u = torch.zeros(nU, dtype=dt)

    def env(ps):
        return dict(zip(names, ps))

    progs = [
        ("f", lambda u, *ps: fns.f(u, env(ps))),
        ("grad_f", lambda u, *ps: grad(lambda v: fns.f(v, env(ps)))(u)),
        ("hess_f", lambda u, *ps: jacfwd(grad(lambda v: fns.f(v, env(ps))))(u)),
    ]
    if nF:
        progs += [("F", lambda u, *ps: fns.F(u, env(ps))),
                  ("jac_F", lambda u, *ps: jacfwd(lambda v: fns.F(v, env(ps)))(u))]
    if nG:
        progs += [("G", lambda u, *ps: fns.G(u, env(ps))),
                  ("jac_G", lambda u, *ps: jacfwd(lambda v: fns.G(v, env(ps)))(u))]
    out = [(name, fn, (u, *pvals)) for name, fn in progs]
    assemble = dense_kkt(fns, nU, nF, nG, solver.opts)

    def kkt(u, nu, lam, addU, addEq, *ps):
        return assemble(u, nu, lam, addU, addEq, env(ps), torch.ones_like(lam),
                        torch.ones((), dtype=dt))

    scalar = torch.full((), 1e-9, dtype=dt)
    out.append(("kkt_assembly", kkt,
                (u, torch.zeros(nG, dtype=dt), torch.ones(nF, dtype=dt), scalar, scalar,
                 *pvals)))
    return out


def export_computation_graph(solver, stem, include_hlo: bool = True) -> dict:
    """Serialize the solver's fixed-shape programs; returns the metadata.
    ``include_hlo`` is kept for the JAX package's signature and writes
    nothing (PyTorch has no StableHLO module of these programs)."""
    stem = Path(stem)
    stem.parent.mkdir(parents=True, exist_ok=True)
    counts: collections.Counter = collections.Counter()
    texts = []
    for name, fn, args in _programs(solver):
        ep = torch.export.export(make_fx(fn)(*args), args, strict=False)
        for node in ep.graph.nodes:
            if node.op == "call_function":
                counts[getattr(node.target, "__name__", str(node.target))] += 1
        texts.append(f"# {name}\n{ep.graph_module.print_readable(print_output=False)}")
    (stem.parent / (stem.name + ".fx.txt")).write_text("\n".join(texts))

    meta = {
        "format": "tenscalc_tpu_torch-cg-v1",
        "nU": solver.nU,
        "nF": solver.nF,
        "nG": solver.nG,
        "variables": {v.name: list(v.shape) for v in solver.variables},
        "parameters": {p.name: list(p.shape) for p in solver.parameters},
        "options": {
            k: v
            for k, v in solver.opts.__dict__.items()
            if isinstance(v, (bool, int, float, str))
        },
        "primitive_counts": dict(counts),
        "kkt_plan": (
            {
                "block": int(solver.kkt_plan.block),
                "n_blocks": int(solver.kkt_plan.n_blocks),
                "bandwidth": int(solver.kkt_plan.bandwidth),
            }
            if getattr(solver, "kkt_plan", None) is not None
            else None
        ),
    }
    (stem.parent / (stem.name + ".meta.json")).write_text(json.dumps(meta, indent=2))
    return meta
