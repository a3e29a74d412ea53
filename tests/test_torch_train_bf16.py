"""The hand loss's gradient through the bf16 kernel path: the port's
plain versions of K1/K2/K3 against the JAX package's Pallas kernels in
interpret mode; tolerance and setup in test_torch_train.py."""

from test_torch_train import check_hand_loss_grads


def test_hand_loss_gradient_matches_jax_bf16(monkeypatch):
    check_hand_loss_grads("bf16", monkeypatch)
