"""K3 port: nope_tpu_torch.ops.fused_resnet against the JAX plain block
and the Pallas kernel in interpret mode, and its autograd gradients
against JAX's VJP."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nope_tpu.ops.experimental.fused_resnet import resnet_block_pallas, resnet_block_reference
from nope_tpu_torch.ops import fused_resnet as fr
from nope_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _params(rng, cin, co, with_res):
    """Numpy params in the JAX layout (HWIO, (Cin, Co) residual)."""
    p = {
        "w1": rng.normal(size=(3, 3, cin, co)) * 0.1,
        "b1": rng.normal(size=(co,)) * 0.1,
        "g1": rng.uniform(0.5, 1.5, (co,)),
        "be1": rng.normal(size=(co,)) * 0.1,
        "w2": rng.normal(size=(3, 3, co, co)) * 0.1,
        "b2": rng.normal(size=(co,)) * 0.1,
        "g2": rng.uniform(0.5, 1.5, (co,)),
        "be2": rng.normal(size=(co,)) * 0.1,
    }
    if with_res:
        p["res_w"] = rng.normal(size=(cin, co)) * 0.1
        p["res_b"] = rng.normal(size=(co,)) * 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}


def _to_torch(p):
    """JAX layout → the port's: HWIO → OIHW, (Cin, Co) → (Co, Cin, 1, 1)."""
    out = {k: torch.from_numpy(v) for k, v in p.items()}
    for k in ("w1", "w2"):
        out[k] = torch.from_numpy(np.ascontiguousarray(np.transpose(p[k], (3, 2, 0, 1))))
    if "res_w" in p:
        out["res_w"] = torch.from_numpy(np.ascontiguousarray(p["res_w"].T))[:, :, None, None]
    return out


CASES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("with_res,with_emb", CASES)
def test_plain_matches_jax_and_pallas_interpret(with_res, with_emb):
    rng = np.random.default_rng(int(with_res) * 2 + int(with_emb))
    cin, co = (16, 24) if with_res else (24, 24)
    x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
    emb = rng.normal(size=(2, co)).astype(np.float32) if with_emb else None
    p = _params(rng, cin, co, with_res)
    got = fr.resnet_block(
        torch.from_numpy(x), None if emb is None else torch.from_numpy(emb), _to_torch(p)
    ).numpy()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    je = None if emb is None else jnp.asarray(emb)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(resnet_block_reference(jnp.asarray(x), je, jp))
        kernel = np.asarray(resnet_block_pallas(jnp.asarray(x), je, jp, interpret=True))
    assert got.shape == (2, 8, 8, co)
    # the repo's K3 tolerance (float32 convs summed in another order)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("with_res,with_emb", [(True, True), (False, False)])
def test_gradients_match_jax_vjp(with_res, with_emb):
    rng = np.random.default_rng(7)
    cin, co = (16, 24) if with_res else (24, 24)
    x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
    emb = rng.normal(size=(2, co)).astype(np.float32) if with_emb else None
    g = rng.normal(size=(2, 8, 8, co)).astype(np.float32)
    p = _params(rng, cin, co, with_res)

    tp = {k: v.requires_grad_(True) for k, v in _to_torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    te = None if emb is None else torch.from_numpy(emb).requires_grad_(True)
    out = fr.fused_resnet_block(tx, te, tp)
    out.backward(torch.from_numpy(g))

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    with jax.default_matmul_precision("highest"):
        if emb is None:
            _, vjp = jax.vjp(lambda x_, p_: resnet_block_reference(x_, None, p_), jnp.asarray(x), jp)
            gx, gp = vjp(jnp.asarray(g))
            ge = None
        else:
            _, vjp = jax.vjp(resnet_block_reference, jnp.asarray(x), jnp.asarray(emb), jp)
            gx, ge, gp = vjp(jnp.asarray(g))

    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-4, rtol=1e-4)
    if emb is not None:
        np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), atol=1e-4, rtol=1e-4)
    want = {k: np.asarray(v) for k, v in gp.items()}
    got = {k: v.grad.numpy() for k, v in tp.items()}
    for k in ("w1", "w2"):
        got[k] = np.transpose(got[k], (2, 3, 1, 0))
    if with_res:
        got["res_w"] = got["res_w"][:, :, 0, 0].T
    for k in p:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4, err_msg=k)


def test_channel_change_requires_res_and_cpu_does_not_count():
    rng = np.random.default_rng(0)
    p = _to_torch(_params(rng, 16, 24, with_res=False))
    with pytest.raises(ValueError, match="res_w"):
        fr.resnet_block(torch.zeros(1, 4, 4, 16), None, p)
    before = profiling.counters()
    fr.resnet_block(torch.zeros(1, 4, 4, 24), None, _to_torch(_params(rng, 24, 24, False)))
    routes = ("k3.tensor_core_launches", "k3.tf32x3_launches", "k3.cuda_core_launches")
    assert all(profiling.counters().get(k, 0) == before.get(k, 0) for k in routes)
