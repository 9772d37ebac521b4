"""The port's seven tutorials (``tenscalc_tpu_torch/examples/tutorial_*``)
against the JAX package's (``examples/tutorial_*``) on the CPU, in float64
on both sides, at the JAX tests' sizes (tutorial_fim at S = 2000, seed 1;
tutorial_nn1 at 120 batches; tutorial_nn_extended at 60; the extended
FIM over four chunks of 256, as tests/test_compute_object.py streams it)
and the defaults elsewhere (tutorial_nn: 400 steps): the outputs, and
every loss of the training runs, within 1e-8 relative."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu_torch as ttc  # noqa: E402
from examples import tutorial_fim as jfim  # noqa: E402
from examples import tutorial_fim_extended as jfime  # noqa: E402
from examples import tutorial_lq as jlq  # noqa: E402
from examples import tutorial_lq_extended as jlqe  # noqa: E402
from examples import tutorial_nn as jnn  # noqa: E402
from examples import tutorial_nn1 as jnn1  # noqa: E402
from examples import tutorial_nn_extended as jnne  # noqa: E402
from tenscalc_tpu_torch.examples import tutorial_fim as tfim  # noqa: E402
from tenscalc_tpu_torch.examples import tutorial_fim_extended as tfime  # noqa: E402
from tenscalc_tpu_torch.examples import tutorial_lq as tlq  # noqa: E402
from tenscalc_tpu_torch.examples import tutorial_lq_extended as tlqe  # noqa: E402
from tenscalc_tpu_torch.examples import tutorial_nn as tnn  # noqa: E402
from tenscalc_tpu_torch.examples import tutorial_nn1 as tnn1  # noqa: E402
from tenscalc_tpu_torch.examples import tutorial_nn_extended as tnne  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-8


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=0)


def test_tutorial_lq():
    close(tlq.main(device="cpu"), jlq.main())


def test_tutorial_lq_extended():
    t, j = tlqe.main(verbose=False, device="cpu"), jlqe.main(verbose=False)
    for k in ("J0", "J1", "J2", "u2", "ustar"):
        close(t[k], j[k])
    np.testing.assert_allclose(t["u2"], t["ustar"], atol=1e-8)


def test_tutorial_fim():
    close(tfim.main(S=2000, seed=1, device="cpu"), jfim.main(S=2000, seed=1))


def test_tutorial_fim_extended():
    close(tfime.main(S=1024, chunk=256, verbose=False, device="cpu"),
          jfime.main(S=1024, chunk=256, verbose=False))


def test_tutorial_nn():
    tp, tl = tnn.main(verbose=False, device="cpu")
    jp, jl = jnn.main(verbose=False)
    close(tl, jl)
    for k in jp:
        close(tp[k], jp[k])


def test_tutorial_nn1():
    close(tnn1.main(n_batches=120, verbose=False, device="cpu"),
          jnn1.main(n_batches=120, verbose=False))


def test_tutorial_nn_extended():
    tl, ta = tnne.main(n_batches=60, verbose=False, device="cpu")
    jl, ja = jnne.main(n_batches=60, verbose=False)
    close(tl, jl)
    close(ta, ja)
