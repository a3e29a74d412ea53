"""honerf_torch HALO chain and transforms against the JAX package, on the
same seeded joints (tolerance 5e-4, the HALO tolerance of test_hand.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.data.synthetic import canonical_hand_joints, posed_hand_example
from honerf_tpu.hand import bone_transforms_from_mano_joints as jax_bones
from honerf_tpu.hand import transform_to_canonical as jax_canon
from honerf_tpu.utils import transforms as JT
from honerf_torch.hand import bone_transforms_from_mano_joints, convert_joints
from honerf_torch.hand import transform_to_canonical
from honerf_torch.utils import transforms as TT

torch.set_num_threads(1)
ATOL = 5e-4


def _joints(kind):
    if kind == "canonical":
        return canonical_hand_joints(0.3)
    if kind == "perturbed":
        rng = np.random.default_rng(3)
        return (canonical_hand_joints(0.3)
                + rng.normal(0, 0.004, (21, 3))).astype(np.float32)
    return posed_hand_example()[0]


@pytest.mark.parametrize("kind", ["canonical", "perturbed", "posed"])
def test_bone_transforms_match_jax(kind):
    j = _joints(kind)
    want = np.asarray(jax_bones(jnp.asarray(j)[None]))
    got = bone_transforms_from_mano_joints(torch.as_tensor(j)[None]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_canonical_transform_matches_jax():
    j = _joints("posed")
    from honerf_tpu.hand import convert_joints as jconv

    kps = jconv(jnp.asarray(j)[None], "mano", "biomech")
    want_kp, want_T = jax_canon(kps, jnp.ones((1,)))
    got_kp, got_T = transform_to_canonical(
        convert_joints(torch.as_tensor(j)[None], "mano", "biomech"), torch.ones(1))
    np.testing.assert_allclose(got_kp.numpy(), np.asarray(want_kp), atol=ATOL)
    np.testing.assert_allclose(got_T.numpy(), np.asarray(want_T), atol=ATOL)


def test_transforms_match_jax():
    rng = np.random.default_rng(1)
    a6 = rng.normal(size=(5, 6)).astype(np.float32)
    ang = rng.normal(size=(5,)).astype(np.float32)
    ax = rng.normal(size=(5, 3)).astype(np.float32)
    v1, v2 = rng.normal(size=(2, 5, 3)).astype(np.float32)
    pairs = [
        (TT.rot6d_to_matrix(torch.as_tensor(a6)), JT.rot6d_to_matrix(jnp.asarray(a6))),
        (TT.rodrigues(torch.as_tensor(ang), torch.as_tensor(ax)),
         JT.rodrigues(jnp.asarray(ang), jnp.asarray(ax))),
        (TT.angle_between(torch.as_tensor(v1), torch.as_tensor(v2)),
         JT.angle_between(jnp.asarray(v1), jnp.asarray(v2))),
        (TT.alignment_matrix(torch.as_tensor(v1), torch.as_tensor(v2)),
         JT.alignment_matrix(jnp.asarray(v1), jnp.asarray(v2))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_safe_norm_has_finite_gradient_at_zero():
    """The safe-norm form keeps the gradient finite at a zero vector."""
    v = torch.zeros(3, requires_grad=True)
    TT.normalize(v).sum().backward()
    assert torch.isfinite(v.grad).all()


def test_invert_rigid_matches_jax():
    from honerf_tpu.hand.api import _invert_rigid_4x4 as jax_inv
    from honerf_torch.hand.api import _invert_rigid_4x4

    bt = np.array(jax_bones(jnp.asarray(_joints("posed"))[None])[0])
    got = _invert_rigid_4x4(torch.as_tensor(bt)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_inv(jnp.asarray(bt))), atol=1e-6)
    np.testing.assert_allclose(got @ bt, np.broadcast_to(np.eye(4), bt.shape), atol=ATOL)
