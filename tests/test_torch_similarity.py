"""K1 port: nope_tpu_torch.ops.similarity against the JAX plain function
and the Pallas kernel in interpret mode, plus retrieval and dispatch."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nope_tpu.ops import similarity as jsim
from nope_tpu.ops.experimental import pallas_similarity
from nope_tpu_torch.ops import similarity as sim

torch.set_num_threads(1)


def _data(seed=0, b=3, n=20, h=8, w=8, c=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, w, c)).astype(np.float32)
    t = rng.normal(size=(b, n, h, w, c)).astype(np.float32)
    return q, t


def test_plain_matches_jax_and_pallas_interpret():
    q, t = _data()
    got = sim.reference_similarity(torch.from_numpy(q), torch.from_numpy(t)).numpy()
    want = np.asarray(jsim.reference_similarity(jnp.asarray(q), jnp.asarray(t)))
    kernel = np.asarray(
        pallas_similarity.reference_similarity_pallas(jnp.asarray(q), jnp.asarray(t), interpret=True)
    )
    assert got.dtype == np.float32 and got.shape == (3, 20)
    # float32 sums over 64 pixels in another order: the repo's K1 tolerance
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-4)


def test_bank_with_leading_dim_one_broadcasts():
    q, t = _data(b=4)
    one = torch.from_numpy(t[:1])
    got = sim.reference_similarity(torch.from_numpy(q), one).numpy()
    want = np.asarray(jsim.reference_similarity(
        jnp.asarray(q), jnp.broadcast_to(jnp.asarray(t[:1]), t.shape)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="leading dim"):
        sim.reference_similarity(torch.from_numpy(q), torch.from_numpy(t[:2]))


def test_bf16_plain_computes_in_float32():
    q, t = _data()
    qb, tb = torch.from_numpy(q).bfloat16(), torch.from_numpy(t).bfloat16()
    got = sim.reference_similarity(qb, tb)
    assert got.dtype == torch.float32
    want = sim.reference_similarity(qb.float(), tb.float())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("metric", ["l2", "l2_true", "cosine"])
def test_retrieve_matches_jax(metric):
    q, t = _data(seed=1)
    s_t, i_t = sim.retrieve(torch.from_numpy(q), torch.from_numpy(t), k=5, metric=metric)
    with jax.default_matmul_precision("highest"):
        s_j, i_j = jsim.retrieve(jnp.asarray(q), jnp.asarray(t), k=5, metric=metric)
    # l2_true expands ‖q-t‖² (cancellation at |q|²~256): relative 1e-5
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_cpu_call_does_not_count_a_launch():
    q, t = _data()
    before = sim.reference_similarity.launches
    sim.reference_similarity(torch.from_numpy(q), torch.from_numpy(t))
    assert sim.reference_similarity.launches == before == 0
