"""One pose-fitting step of fit type '12' (honerf_torch.fit.single, with the contact and
penetration terms),
plain versions on the CPU, against the JAX package on the same seeded
inputs, weights and pose (near the start), small nets, f32: every loss
term, the six pose gradients and the poses after Adam.  The port's
autograd field against JAX's make_single_fit_step(fused_fine=False)
within 2e-4 of max(1, max |want|); the port's 'full' mode (the plain
versions of K2 and the frozen K3, the card's default) against the same
within 1e-3 (the JAX suite's bound for its fused fine pass against XLA,
tests/test_fused_fine_full.py); so are the f32 modes 'pallas' (K5 / the
frozen K6) and 'full_nocolor' (K2 / the frozen K3 without the color
net), the same JAX step held against each (its trace and compile take
~20 s on a CPU).  JAX's step has no Pallas interpret switch, so its fused
path does not run here.  JAX's gradients are read
from its Adam state (mu = 0.1 g after one step), the port's from the
pose tensors' .grad.  Fit type '1': test_torch_fit_step.py.
"""

import functools

import numpy as np
import pytest
import torch

from honerf_torch.fit import single as TS
from torch_fit_common import close, frame, jax_step, port_step, setup

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_reference():
    return jax_step(setup(), "12", frame())


def test_fit_step12_matches_jax():
    s = setup()
    b = frame()
    jm, jg, jpose = jax_reference()
    for fine, tol in ((None, 2e-4), ("full", 1e-3)):
        tm, tg, tpose = port_step(s, "12", b, fine)
        assert set(tm) == set(jm), fine
        for k in jm:
            close(tm[k], jm[k], tol)
        for k in TS.POSE_KEYS:
            close(tg[k], jg[k], tol)
            close(tpose[k], jpose[k], tol)
        # the render loss moves the pose, not only the regularizers
        assert np.abs(tg["joint_angle"]).max() > 0 and np.abs(tg["obj_trans"]).max() > 0
    assert jm["penet_loss"] > 0 or jm["contact_loss"] > 0


@pytest.mark.parametrize("mode", ["pallas", "full_nocolor"])
def test_fit_step12_mode_matches_jax(mode):
    jm, jg, jpose = jax_reference()
    tm, tg, tpose = port_step(setup(), "12", frame(), mode)
    assert set(tm) == set(jm)
    for k in jm:
        close(tm[k], jm[k], 1e-3)
    for k in TS.POSE_KEYS:
        close(tg[k], jg[k], 1e-3)
        close(tpose[k], jpose[k], 1e-3)
    assert np.abs(tg["joint_angle"]).max() > 0 and np.abs(tg["obj_trans"]).max() > 0
