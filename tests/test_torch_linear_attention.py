"""K2 port: nope_tpu_torch.ops.linear_attention against the JAX plain
composition and the Pallas kernel in interpret mode."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nope_tpu.ops.experimental.linear_attention import (
    linear_attention_inner as jax_kernel,
    linear_attention_inner_xla as jax_plain,
)
from nope_tpu_torch.ops import linear_attention as la

torch.set_num_threads(1)

HEADS, DH = 4, 32


@pytest.mark.parametrize("b,n", [(2, 64), (3, 16)])
def test_plain_matches_jax_and_pallas_interpret(b, n):
    rng = np.random.default_rng(n)
    qkv = (rng.normal(size=(b, n, 3 * HEADS * DH)) * 2).astype(np.float32)
    got = la.linear_attention_inner(torch.from_numpy(qkv), HEADS, DH).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_plain(jnp.asarray(qkv), HEADS, DH))
        kernel = np.asarray(jax_kernel(jnp.asarray(qkv), HEADS, DH, block_b=1, interpret=True))
    assert got.shape == (b, n, HEADS * DH)
    # the repo's K2 tolerance (float32 softmax and two small contractions)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)


def test_bad_width_raises_and_cpu_does_not_count():
    with pytest.raises(ValueError, match="qkv width"):
        la.linear_attention_inner(torch.zeros(1, 4, 100), HEADS, DH)
    la.linear_attention_inner(torch.zeros(1, 4, 3 * HEADS * DH), HEADS, DH)
    assert la.linear_attention_inner.launches == 0
