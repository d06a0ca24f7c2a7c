"""Continuous pose refinement of the port (``nope_tpu_torch.tasks.refinement``)
against ``nope_tpu.tasks.refinement`` on the same weights and inputs (CPU:
the ops run their plain versions, JAX at "highest" matmul precision):
the gradient of the summed objective with respect to the 6-d pose, the
single- and multi-start refiners, Adam against ``optax.adam``, the
frozen parameters, and K2's autograd Function."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nope_tpu.geometry import rotations as jrot
from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.tasks import refinement as jref
from nope_tpu.tasks.pose_conditional import PoseConditionalTask as JaxTask
from nope_tpu.tasks.pose_conditional import TaskConfig as JaxTaskConfig
from nope_tpu_torch.models.unet import PoseUNet
from nope_tpu_torch.ops import fused_resnet as fr
from nope_tpu_torch.ops import linear_attention as la
from nope_tpu_torch.tasks import refinement as ref
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
from tests.torch_port_helpers import IMG, LATENT_HW, UNET, VAE, seeded_port_modules

HI = functools.partial(jax.default_matmul_precision, "highest")
B = 3


@pytest.fixture(scope="module")
def models():
    unet, vae, params = seeded_port_modules(31)
    jtask = JaxTask(JaxPoseUNet(**UNET), JaxVAE(**VAE), JaxTaskConfig(half_precision_eval=False))
    task = PoseConditionalTask(unet, vae, TaskConfig(half_precision_eval=False))
    return jtask, params, task


def _rotations(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    with HI():
        return np.array(jrot.quaternion_to_matrix(q / np.linalg.norm(q, axis=-1, keepdims=True)))


def _latents(seed, n=B):
    return (0.5 * np.random.default_rng(seed).normal(size=(n, LATENT_HW, LATENT_HW, 4))).astype(np.float32)


def _assert_gradient_well_posed(g):
    """Adam's first step is close to lr·sign(g): a component near zero
    would make the comparison a test of rounding, not of the gradient."""
    g = np.abs(np.asarray(g))
    assert (g >= 1e-3 * g.max(axis=1, keepdims=True)).all(), g


def _torch_grad(task, ref_lat, target, r6, objective="l2"):
    dist = ref._per_sample_objective(objective)
    leaf = torch.tensor(r6, requires_grad=True)
    with ref.frozen(task.unet):
        d = dist(task.predict_latent(torch.as_tensor(ref_lat), leaf).float(), torch.as_tensor(target))
        (g,) = torch.autograd.grad(d.sum(), leaf)
    return g.numpy()


def _assert_init_well_posed(task, ref_lat, target, init_R):
    """The precondition of every refinement test, at its inits."""
    _assert_gradient_well_posed(_torch_grad(task, ref_lat, target, np.asarray(jrot.matrix_to_rotation_6d(init_R))))


@pytest.mark.parametrize("objective", ["l2", "l1", "quirk"])
def test_pose_gradient_matches_jax_grad(models, objective):
    jtask, params, task = models
    ref_lat, target = _latents(1), _latents(2)
    r6 = np.asarray(jrot.matrix_to_rotation_6d(_rotations(3, B)))
    dist = jref._per_sample_objective(objective)

    def total(r6):
        return jnp.sum(dist(jtask.predict_latent(params, ref_lat, r6).astype(jnp.float32), target))

    with HI():
        want = np.asarray(jax.jit(jax.grad(total))(r6))
    _assert_gradient_well_posed(want)
    got = _torch_grad(task, ref_lat, target, r6, objective)
    # max|Δ| over max|g|, per sample: float32 sums in another order
    rel = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    assert rel.max() <= 1e-4, rel
    assert all(p.grad is None and p.requires_grad for p in task.unet.parameters())


def _kept(refined_R, init_R):
    """Samples that kept their refined pose: a sample that fell back
    returns its init through the same Gram-Schmidt, bit for bit."""
    back = np.asarray(jrot.rotation_6d_to_matrix(jrot.matrix_to_rotation_6d(init_R)))
    return ~np.all(np.asarray(refined_R) == back, axis=(1, 2))


@pytest.fixture(scope="module")
def refine_inputs(models):
    """A target the model predicts at known poses, inits ~25° away."""
    jtask, params, task = models
    ref_lat = _latents(4)
    truth = _rotations(5, B)
    with HI():
        target = np.array(jtask.predict_latent(params, ref_lat, jrot.matrix_to_rotation_6d(truth)))
    init = np.einsum("bij,bjk->bik", _rotations(6, B), truth).astype(np.float32)
    init = np.array(jrot.rotation_6d_to_matrix(  # nearby: blend the 6d and re-orthonormalise
        0.75 * jrot.matrix_to_rotation_6d(truth) + 0.25 * jrot.matrix_to_rotation_6d(init)))
    _assert_init_well_posed(task, ref_lat, target, init)
    return ref_lat, target, init


def test_pose_refiner_matches_jax(models, refine_inputs):
    jtask, params, task = models
    ref_lat, target, init = refine_inputs
    with HI():
        want_R, want_d = jax.jit(jref.make_pose_refiner(jtask, steps=4))(params, target, ref_lat, init)
    got_R, got_d = ref.make_pose_refiner(task, steps=4)(*(torch.from_numpy(a) for a in (target, ref_lat, init)))
    assert got_R.shape == (B, 3, 3) and got_d.shape == (B,) and got_d.dtype == torch.float32
    np.testing.assert_array_equal(_kept(got_R.numpy(), init), _kept(want_R, init))
    assert _kept(want_R, init).any()  # refinement moved some sample
    np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), atol=1e-4)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-4)
    assert all(p.grad is None and p.requires_grad for p in task.unet.parameters())


def test_fallback_keeps_the_init(models, refine_inputs):
    """A learning rate that overshoots makes the objective worse: every
    sample falls back to its init and its init's distance."""
    _, _, task = models
    ref_lat, target, init = (torch.from_numpy(a) for a in refine_inputs)
    R, d = ref.make_pose_refiner(task, steps=2, lr=5.0)(target, ref_lat, init)
    _, d0 = ref.make_pose_refiner(task, steps=0)(target, ref_lat, init)
    back = ref.rotation_6d_to_matrix(ref.matrix_to_rotation_6d(init))
    worse = d == d0
    assert worse.any()
    assert torch.equal(R[worse], back[worse])


def test_multistart_refiner_matches_jax(models, refine_inputs):
    jtask, params, task = models
    ref_lat, target, init = refine_inputs
    # start 0 at the init, start 1 farther out: (B, 2, 3, 3)
    far = np.einsum("bij,bjk->bik", _rotations(7, B), init).astype(np.float32)
    inits = np.stack([init, far], axis=1)
    _assert_init_well_posed(task, ref_lat, target, far)
    with HI():
        want_R, want_d, want_sel = jax.jit(jref.make_multistart_refiner(jtask, steps=4))(params, target, ref_lat, inits)
    got_R, got_d, got_sel = ref.make_multistart_refiner(task, steps=4)(
        *(torch.from_numpy(a) for a in (target, ref_lat, inits)))
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
    np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), atol=1e-4)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-4)


def test_refine_pose_encodes_then_refines(models):
    jtask, params, task = models
    rng = np.random.default_rng(8)
    query, reference = (rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    init = _rotations(9, 2)
    _assert_init_well_posed(task, task.encode(torch.from_numpy(reference)), task.encode(torch.from_numpy(query)), init)
    with HI():
        want_R, want_d = jax.jit(functools.partial(jref.refine_pose, jtask, steps=2))(params, query, reference, init)
    got_R, got_d = ref.refine_pose(task, *(torch.from_numpy(a) for a in (query, reference, init)), steps=2)
    np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), atol=1e-4)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-4)


def test_adam_matches_optax():
    """The plain-tensor Adam against optax.adam(lr) on a fixed sequence of
    gradients, including zeros and a sign flip."""
    rng = np.random.default_rng(10)
    grads = rng.normal(size=(6, 4, 6)).astype(np.float32) * np.logspace(-4, 1, 6, dtype=np.float32)[:, None, None]
    grads[2, 0] = 0.0
    grads[3] *= -1
    x0 = rng.normal(size=(4, 6)).astype(np.float32)
    opt = optax.adam(2e-2)
    want, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    got, tstate = torch.from_numpy(x0), ref.adam_init(torch.from_numpy(x0))
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, want)
        want = optax.apply_updates(want, updates)
        update, tstate = ref.adam_update(torch.from_numpy(g), tstate, 2e-2)
        got = got + update
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert int(tstate[0]) == len(grads)


def test_refiner_refuses_other_representations():
    task = PoseConditionalTask(PoseUNet(**UNET, rot_representation_dim=4), None)
    with pytest.raises(ValueError, match="optimises the 6d rotation representation; this U-Net conditions on dim 4"):
        ref.make_pose_refiner(task)
    with pytest.raises(ValueError, match="unknown refinement objective"):
        ref.make_pose_refiner(PoseConditionalTask(PoseUNet(**UNET), None), objective="l3")


def test_frozen_takes_no_weight_gradient(models, monkeypatch):
    """K3's recompute backward is asked for no parameter's gradient while
    the refiner runs, and every flag comes back afterwards."""
    _, _, task = models
    seen = []
    plain = fr.resnet_block_plain

    def spy(x, emb, params, groups=8, eps=1e-5):
        if torch.is_grad_enabled():  # the recompute inside _ResnetBlockFn.backward
            seen.append([p.requires_grad for p in params.values()] + [x.requires_grad])
        return plain(x, emb, params, groups, eps)

    monkeypatch.setattr(fr, "resnet_block_plain", spy)
    task.unet.pose_mlp[0].weight.requires_grad_(False)  # a flag already off stays off
    try:
        before = fr._ResnetBlockFn.recomputes, la._LinearAttentionFn.recomputes
        ref.make_pose_refiner(task, steps=1)(*(torch.from_numpy(_latents(s)) for s in (11, 12)),
                                             torch.from_numpy(_rotations(13, B)))
        assert fr._ResnetBlockFn.recomputes - before[0] == 14 and la._LinearAttentionFn.recomputes - before[1] == 4
        assert len(seen) == 14 and not any(any(flags[:-1]) for flags in seen)
        assert not seen[-1][-1]  # backward reaches the first block last: its input has no pose in it
        assert all(p.grad is None for p in task.unet.parameters())
        assert not task.unet.pose_mlp[0].weight.requires_grad
        assert all(p.requires_grad for n, p in task.unet.named_parameters() if n != "pose_mlp.0.weight")
    finally:
        task.unet.pose_mlp[0].weight.requires_grad_(True)


# -- K2's gradient ---------------------------------------------------------------


def test_linear_attention_gradcheck():
    """The Function's backward (the plain recompute) against finite
    differences, in float64 on the plain path."""
    qkv = torch.randn(2, 5, 3 * 2 * 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    qkv.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: la._LinearAttentionFn.apply(t, 2, 3), (qkv,))
    out = la.linear_attention(qkv, 2, 3)
    assert out.grad_fn is not None and "LinearAttentionFn" in type(out.grad_fn).__name__
    (g,) = torch.autograd.grad(out.square().sum(), qkv)
    (want,) = torch.autograd.grad(la.linear_attention_inner_plain(qkv, 2, 3).square().sum(), qkv)
    torch.testing.assert_close(g, want, rtol=1e-12, atol=1e-12)


def test_linear_attention_takes_no_node_without_a_gradient(monkeypatch):
    def refuse(*args):
        raise AssertionError("the autograd Function ran where no gradient can flow")

    monkeypatch.setattr(la._LinearAttentionFn, "apply", refuse)
    qkv = torch.randn(2, 16, 384, requires_grad=True)
    with torch.no_grad():
        out = la.linear_attention(qkv, 4, 32)
    assert out.grad_fn is None
    out = la.linear_attention(qkv.detach(), 4, 32)
    assert out.grad_fn is None
    torch.testing.assert_close(out, la.linear_attention_inner_plain(qkv.detach(), 4, 32))
