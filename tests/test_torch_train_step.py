"""One hand train step of the port from a train state carried over from
the JAX package (train_state_from_jax after two JAX steps: params, Adam
moments, update count) against the JAX package's next step: metrics,
grad_norm and the updated params.  f32 (the autograd field path), a
grad clip of 50 that binds, the warmup's learning rate.

refine_pose is off here: with it on, both frameworks' f32 bt_inv differ
by ~1e-5 and the stiff random field turns that into ~1e-2 gradient
differences on small leaves (test_torch_train.py), which Adam's
normalisation then shows as updates that differ by up to ~1 lr.  The
pose-refinement path is compared on its own there.

The fixture (net_params(SMALL, seed=7, background=0.5)) is one where the
step is well conditioned at its samples.  The fine samples' z come from
the inverse-CDF up-sampling, whose f32 rounding differs between the two
frameworks by up to ~3e-6 on some CPUs; at the parity tests' own field
(seed 0, +0.2 background) JAX's own grad_norm moves by up to ~1e-3 under
a random z change of that size (the port there read 9.1e-4 from JAX,
against the rtol of 1e-4).  test_fixture_is_well_conditioned holds JAX's
own step at the fixture under such a change; at the parity tests' field
both steps are compared on JAX's fine samples
(test_step_at_shared_fine_samples_matches_jax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import honerf_tpu.render.neus as JN
import honerf_torch.render.neus as TN
from honerf_tpu.models.fields import init_se3_refine
from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.train import offline as JO
from honerf_torch.render.neus import RenderConfig
from honerf_torch.train import offline as TO
from honerf_torch.train.checkpoints import train_state_from_jax
from test_torch_parity import SMALL, configs, jax_batch, net_params, torch_batch, train_batch

torch.set_num_threads(1)

RC = dict(n_samples=8, n_importance=8, up_sample_steps=2, perturb=0.0)
HYPER = dict(learning_rate=1e-3, warm_up_end=5.0, end_iter=100, vgg_weight=0.0,
             refine_pose=False, grad_clip=50.0, batch_size=36)
# the third update runs at lr 1e-3 * 2/5 (warmup)
LR = 4e-4
# net_params of the well-conditioned fixture, and of the parity tests'
# field, where the step is compared on shared fine samples
WELL = dict(seed=7, background=0.5)
PARITY = dict(seed=0, background=0.2)
# the largest gap between the two frameworks' fine-sample z seen on a CPU
Z_GAP = 2.9e-6


def _leaves(jtree, ttree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        out.append((jax.tree_util.keystr(path), np.asarray(leaf), node.detach().numpy()))
    return out


def _carried(fixture):
    """(a maker of fresh JAX steps, the JAX state after two steps, the
    port's state carried over from it, the batch as numpy)."""
    jcfg, jccfg, _, _ = configs(SMALL, "f32")
    jp, _ = net_params(SMALL, **fixture)
    params = dict(jp, se3_refine=init_se3_refine(2, "hand"))
    jt = JO.TrainHyper(**HYPER)

    def make():
        return jax.jit(JO.make_hand_train_step(jcfg, jccfg, JRenderConfig(**RC), jt))

    jstep = make()
    b = train_batch()
    state = JO.init_train_state(params, jt)
    for _ in range(2):
        state, _ = jstep(state, jax_batch(b), jax.random.PRNGKey(0))
    tstate = train_state_from_jax(state, TO.TrainHyper(**HYPER), device="cpu")
    assert tstate["step"] == 2
    return make, state, tstate, b


def _port_step(tstate, b):
    _, _, tcfg, tccfg = configs(SMALL, "f32")
    tstep = TO.make_hand_train_step(tcfg, tccfg, RenderConfig(**RC), TO.TrainHyper(**HYPER))
    tstate, got = tstep(tstate, torch_batch(b))
    assert tstate["step"] == 3
    return tstate, got


def _assert_step_matches(want_state, want, tstate, got):
    assert set(got) == set(want)
    assert float(want["grad_norm"]) > HYPER["grad_clip"]  # the clip binds
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    for name, w, g in _leaves(want_state["params"], tstate["params"]):
        np.testing.assert_allclose(g, w, atol=0.05 * LR, rtol=0, err_msg=name)


def test_step_from_carried_state_matches_jax():
    make, state, tstate, b = _carried(WELL)
    want_state, want = make()(state, jax_batch(b), jax.random.PRNGKey(0))
    tstate, got = _port_step(tstate, b)
    _assert_step_matches(want_state, want, tstate, got)


def test_step_at_shared_fine_samples_matches_jax(monkeypatch):
    """At the parity tests' own field both steps render at JAX's fine
    samples: JAX's step records the z of its up-sampling, and the port's
    step takes them in place of its own."""
    make, state, tstate, b = _carried(PARITY)
    hier_j, seen = JN.hierarchical_z_vals, []

    def record(*a, **k):
        z = hier_j(*a, **k)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), z)
        return z

    monkeypatch.setattr(JN, "hierarchical_z_vals", record)
    want_state, want = make()(state, jax_batch(b), jax.random.PRNGKey(0))
    jax.block_until_ready(want)
    assert len(seen) == 1
    monkeypatch.setattr(TN, "hierarchical_z_vals", lambda *a, **k: torch.tensor(seen[0]))
    tstate, got = _port_step(tstate, b)
    _assert_step_matches(want_state, want, tstate, got)


@pytest.mark.parametrize("pattern", [0, 1])
def test_fixture_is_well_conditioned(monkeypatch, pattern):
    """JAX's own step at the fixture with its fine samples' z moved by a
    seeded random gap of up to Z_GAP: every metric moves by less than the
    rtol of 1e-4 (at the parity tests' field grad_norm moves by up to
    ~1e-3 under such a gap; tests/torch_carried_probe.py prints both)."""
    make, state, _, b = _carried(WELL)
    want_state, want = make()(state, jax_batch(b), jax.random.PRNGKey(0))
    hier_j = JN.hierarchical_z_vals

    def moved(*a, **k):
        z = hier_j(*a, **k)
        gap = np.random.default_rng(pattern).uniform(-Z_GAP, Z_GAP, z.shape)
        return z + jnp.asarray(gap, jnp.float32)

    monkeypatch.setattr(JN, "hierarchical_z_vals", moved)
    _, got = make()(state, jax_batch(b), jax.random.PRNGKey(0))
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) < 1e-4 * abs(w), k
