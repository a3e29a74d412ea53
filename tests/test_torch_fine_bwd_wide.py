"""The fine pass's backward against jax.vjp with the full 1386-channel
embedding (a narrow trunk); tolerances and their reasons in
test_torch_fine_bwd.py."""

import pytest

from test_torch_fine_bwd import check_against_jax
from test_torch_parity import WIDE_EMB


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_bwd_matches_jax_vjp_wide_embedding(dtype):
    check_against_jax(WIDE_EMB, "wide_emb", dtype)
