"""The conditioning probe behind tests/test_torch_train_step.py (a helper,
not a test): at a fixture's carried state, how far the JAX package's own
train step moves when the fine samples' z move by the gap between the two
frameworks' inverse-CDF up-sampling, and how the port's step compares.

    JAX_PLATFORMS=cpu python tests/torch_carried_probe.py "{'seed': 7, 'background': 0.5}"

Prints, relative to JAX's step: the port's grad_norm and worst metric, the
largest z gap between the two frameworks here; then JAX's own step with its
fine z moved by the port's gap, by seeded uniform gaps of up to Z_GAP on
the samples where the two differ (six patterns) and on every sample, and by
the port's gap scaled to Z_GAP; last the port's step fed JAX's fine z.
"""

import ast
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import honerf_tpu.render.neus as JN  # noqa: E402
import honerf_torch.render.neus as TN  # noqa: E402
from test_torch_parity import jax_batch  # noqa: E402
from test_torch_train_step import HYPER, TO, Z_GAP, _carried, _port_step  # noqa: E402
from honerf_torch.train.checkpoints import train_state_from_jax  # noqa: E402


def _rel(got, want):
    return max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-30)
               for k in want)


def probe(fixture):
    make, state, _, b = _carried(fixture)
    hier_j, hier_t, seen = JN.hierarchical_z_vals, TN.hierarchical_z_vals, {}
    key = jax.random.PRNGKey(0)

    def jstep(delta=None):
        def moved(*a, **k):
            z = hier_j(*a, **k)
            if delta is None:
                jax.debug.callback(lambda v: seen.__setitem__("jax", np.asarray(v)), z)
                return z
            return z + jnp.asarray(delta, jnp.float32)

        JN.hierarchical_z_vals = moved
        try:
            out = make()(state, jax_batch(b), key)[1]
            jax.block_until_ready(out)
            return out
        finally:
            JN.hierarchical_z_vals = hier_j

    def tstep(z=None):
        def fixed(*a, **k):
            out = hier_t(*a, **k) if z is None else torch.tensor(z)
            seen.setdefault("port", out.detach().numpy().copy())
            return out

        TN.hierarchical_z_vals = fixed
        try:
            fresh = train_state_from_jax(state, TO.TrainHyper(**HYPER), device="cpu")
            return _port_step(fresh, b)[1]
        finally:
            TN.hierarchical_z_vals = hier_t

    want = jstep()
    got = tstep()
    gap = seen["port"] - seen["jax"]
    gn = float(want["grad_norm"])
    print(f"fixture {fixture}: JAX grad_norm {gn:.6f}, the port's {float(got['grad_norm']):.6f} "
          f"(relative {abs(float(got['grad_norm']) - gn) / gn:.3e}; worst metric "
          f"{_rel(got, want):.3e}); the largest z gap here {np.abs(gap).max():.3e}")
    print(f"  JAX moved by the port's gap: {_rel(jstep(gap), want):.3e}")
    rng = np.random.default_rng(0)
    mask = gap != 0
    for i in range(6):
        d = rng.uniform(-Z_GAP, Z_GAP, gap.shape).astype(np.float32) * mask
        print(f"  JAX moved by a random gap of up to {Z_GAP:g} where they differ ({i}): "
              f"{_rel(jstep(d), want):.3e}")
    d = rng.uniform(-Z_GAP, Z_GAP, gap.shape).astype(np.float32)
    print(f"  JAX moved by a random gap on every sample: {_rel(jstep(d), want):.3e}")
    if np.abs(gap).max() > 0:
        print(f"  JAX moved by the port's gap scaled to {Z_GAP:g}: "
              f"{_rel(jstep(gap * (Z_GAP / np.abs(gap).max())), want):.3e}")
    print(f"  the port fed JAX's fine z: {_rel(tstep(seen['jax']), want):.3e}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    probe(ast.literal_eval(sys.argv[1]) if len(sys.argv) > 1 else {})
