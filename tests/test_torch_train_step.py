"""The port's train step (``nope_tpu_torch/training/train_state.py``)
against the JAX package's ``make_train_step`` on the same weights and
batches (CPU: K3 and K2 run their plain versions): losses, parameter
deltas, the grad-trace norms and the EMA over 3 AdamW steps in float32
(two datasets, one on the float wire, one on the uint8 wire), the
bfloat16 step's loss, and K3's weight packs across steps."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.tasks.pose_conditional import PoseConditionalTask as JaxTask
from nope_tpu.training import optim as jax_optim
from nope_tpu.training import train_state as jax_ts
from nope_tpu_torch.geometry import rotations as rot
from nope_tpu_torch.ops import fused_resnet as fr
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask
from nope_tpu_torch.training import optim, train_state
from tests.torch_port_helpers import IMG, UNET, VAE, seeded_port_modules

HI = functools.partial(jax.default_matmul_precision, "highest")
STEPS, B, LR, EMA = 3, 2, 1e-3, 0.9
OPT = dict(base_lr=LR, warm_up_steps=0, weight_decay=5e-4)


def _batch(rng, gen, uint8):
    mats = rot.random_rotations(B, gen)
    if uint8:
        images = [rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8) for _ in range(2)]
    else:
        images = [rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32) for _ in range(2)]
    return {"query": images[0], "reference": images[1],
            "relativeR": rot.matrix_to_rotation_6d(mats).numpy(),
            "relativeR_inv": rot.matrix_to_rotation_6d(mats.transpose(-1, -2)).numpy()}


def _batches(seed, names_uint8):
    rng, gen = np.random.default_rng(seed), torch.Generator().manual_seed(seed)
    return [{name: _batch(rng, gen, u8) for name, u8 in names_uint8} for _ in range(STEPS)]


def _jax_run(params, batches, half, grad_trace=False, ema_decay=0.0):
    task = JaxTask(JaxPoseUNet(**UNET), JaxVAE(**VAE))
    tx = jax_optim.make_optimizer(**OPT)
    copy_tree = lambda t: jax.tree.map(lambda x: jnp.array(x, copy=True), t)  # noqa: E731
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), copy_tree(params["unet"]), params["vae"],
                              tx.init(params["unet"]))
    step = jax_ts.make_train_step(task, tx, half_precision=half, grad_trace=grad_trace, ema_decay=ema_decay)
    ema = copy_tree(params["unet"])
    metrics, unets, emas = [], [], []
    with HI():
        for b in batches:
            jb = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in b.items()}
            if ema_decay:
                state, m, ema = step(state, jb, ema)
                emas.append(jax.tree.map(np.asarray, ema))
            else:
                state, m = step(state, jb)
            metrics.append({k: float(v) for k, v in m.items()})
            unets.append(jax.tree.map(np.asarray, state.unet_params))
    return metrics, unets, emas


def _port_run(unet, vae, batches, half, grad_trace=False, ema_decay=0.0):
    unet, vae = copy.deepcopy(unet), copy.deepcopy(vae)
    task = PoseConditionalTask(unet, vae)
    state = train_state.create_train_state(task, optim.make_optimizer(unet.parameters(), **OPT))
    step = train_state.make_train_step(task, half_precision=half, grad_trace=grad_trace, ema_decay=ema_decay)
    ema = copy.deepcopy(unet).requires_grad_(False)
    metrics, unets, emas = [], [], []
    for b in batches:
        if ema_decay:
            state, m, ema = step(state, b, ema)
            emas.append({k: v.clone() for k, v in ema.state_dict().items()})
        else:
            state, m = step(state, b)
        if not unets:
            state.first_grads = {n: p.grad.clone() for n, p in unet.named_parameters()}
        metrics.append(train_state.to_numpy_metrics(m))
        unets.append({k: v.detach().clone() for k, v in unet.state_dict().items()})
    return metrics, unets, emas, state


def _jax_view(port_sd):
    """A port U-Net state dict as JAX params (``nope_tpu.training.port``)."""
    from nope_tpu.training import port

    return port.port_pose_unet({k: v.numpy() for k, v in port_sd.items()}, dim_mults=UNET["dim_mults"])


@pytest.fixture(scope="module")
def fp32_runs():
    unet, vae, params = seeded_port_modules(3)
    batches = _batches(5, [("float", False), ("wire", True)])
    j = _jax_run(params, batches, half=False, grad_trace=True, ema_decay=EMA)
    p = _port_run(unet, vae, batches, half=False, grad_trace=True, ema_decay=EMA)
    return {"jax": j, "port": p, "params": params, "vae": vae, "start_sd": copy.deepcopy(unet.state_dict())}


def test_fp32_losses_match_jax(fp32_runs):
    (jm, _, _), (pm, _, _, state) = fp32_runs["jax"], fp32_runs["port"]
    assert state.step == STEPS
    for want, got in zip(jm, pm):
        for key in ("loss/train_avg", "loss/train_float", "loss/train_wire"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert jm[0]["loss/train_avg"] != jm[-1]["loss/train_avg"]  # the steps moved the weights


def decided(first_grads):
    """Per U-Net parameter, as JAX params: the elements whose first
    gradient is at least 1e-4 of its tensor's largest.  AdamW's first
    update is g/(|g|+eps), about sign(g): where |g| is within float32
    rounding of zero, the two packages' sums, taken in other orders, may
    give it either sign (the L1 loss's gradient is itself a sign), and
    the update is then ±lr in either package."""
    return jax.tree.map(lambda g: np.abs(g) >= 1e-4 * np.abs(g).max(), _jax_view(first_grads))


def _deltas(port_tree, jax_tree, start):
    """(Δ_port, Δ_jax) from the shared start, as JAX-shaped trees."""
    d = lambda a, b: np.asarray(a) - np.asarray(b)  # noqa: E731
    return jax.tree.map(d, _jax_view(port_tree), start), jax.tree.map(d, jax_tree, start)


def test_fp32_parameter_deltas_match_jax(fp32_runs):
    """The U-Net's weight deltas from the shared start.  After the first
    step, max|Δ_port − Δ_jax| / max|Δ_jax| <= 1e-3 over the elements whose
    update the arithmetic decides (all but ~0.15% here, ``decided``).
    Adam's later steps divide by √v̂ where m̂ may have cancelled, so the
    gradients' float32 differences (~2e-5 of their largest) move single
    elements further: over all 3 steps the relative L2 distance of the
    deltas is <= 1e-3, and at most 1e-3 of the elements differ by more
    than 1e-3 of max|Δ_jax|."""
    start = jax.tree.map(np.asarray, fp32_runs["params"]["unet"])
    mask = decided(fp32_runs["port"][3].first_grads)
    leaves = jax.tree.leaves(mask)
    assert sum(int(m.sum()) for m in leaves) / sum(m.size for m in leaves) >= 0.995
    d_port, d_jax = _deltas(fp32_runs["port"][1][0], fp32_runs["jax"][1][0], start)
    num = max(float(np.abs(a - b)[m].max()) for a, b, m in
              zip(jax.tree.leaves(d_port), jax.tree.leaves(d_jax), leaves))
    assert num / max(float(np.abs(b).max()) for b in jax.tree.leaves(d_jax)) <= 1e-3
    for got, want in zip(fp32_runs["port"][1], fp32_runs["jax"][1]):
        d_port, d_jax = (np.concatenate([x.ravel() for x in jax.tree.leaves(t)]) for t in _deltas(got, want, start))
        assert np.linalg.norm(d_port - d_jax) <= 1e-3 * np.linalg.norm(d_jax)
        assert np.mean(np.abs(d_port - d_jax) > 1e-3 * np.abs(d_jax).max()) <= 1e-3


def test_vae_takes_no_gradient(fp32_runs):
    state = fp32_runs["port"][3]
    assert all(p.grad is None and not p.requires_grad for p in state.vae.parameters())
    for k, v in state.vae.state_dict().items():
        assert torch.equal(v, fp32_runs["vae"].state_dict()[k]), k


def test_grad_trace_norms_match_jax(fp32_runs):
    (jm, _, _), (pm, _, _, _) = fp32_runs["jax"], fp32_runs["port"]
    keys = [f"{p}/{g}" for p in ("gnorm", "unorm") for g in (*train_state.GRAD_TRACE_GROUPS, "global")]
    for want, got in zip(jm, pm):
        assert set(keys) <= set(got) and set(got) == set(want)
        for key in keys:
            assert want[key] > 0, key
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def test_grad_trace_groups_are_jax_groups(fp32_runs):
    """Each parameter falls in the group JAX puts its Flax path in: the
    element counts per group agree."""
    unet = fp32_runs["port"][3].unet
    groups = train_state._grad_trace_groups(unet)
    assert set(groups) == {n for n, _ in unet.named_parameters()}
    counts = {g: 0 for g in train_state.GRAD_TRACE_GROUPS}
    for n, p in unet.named_parameters():
        counts[groups[n]] += p.numel()
    jax_counts = {g: 0 for g in train_state.GRAD_TRACE_GROUPS}
    for path, leaf in jax.tree_util.tree_flatten_with_path(fp32_runs["params"]["unet"])[0]:
        jax_counts[jax_ts._grad_trace_group(path)] += np.size(leaf)
    assert counts == jax_counts and all(counts.values())


def test_ema_matches_jax(fp32_runs):
    """The EMA stream: exactly the closed form β·ema + (1−β)·params on the
    port's own post-update weights, and JAX's within rtol 1e-5, atol
    1e-3·max|Δ_jax| (the weights' agreement, which the EMA's weights,
    summing to 1, carry) wherever the two packages' weights agree at
    every step (all but the <= 1e-3 share of elements
    ``test_fp32_parameter_deltas_match_jax`` allows)."""
    (_, junets, jema), (_, punets, pema, _) = fp32_runs["jax"], fp32_runs["port"]
    start = jax.tree.map(np.asarray, fp32_runs["params"]["unet"])
    agree = jax.tree.map(lambda x: np.ones(x.shape, bool), start)
    for got, want in zip(punets, junets):
        d_port, d_jax = _deltas(got, want, start)
        top = max(float(np.abs(x).max()) for x in jax.tree.leaves(d_jax))  # grows with the steps
        agree = jax.tree.map(lambda m, a, b: m & (np.abs(a - b) <= 1e-3 * top), agree, d_port, d_jax)
    leaves = jax.tree.leaves(agree)
    assert sum(int(m.sum()) for m in leaves) / sum(m.size for m in leaves) >= 0.999
    for got, want in zip(pema, jema):
        for a, b, m in zip(jax.tree.leaves(_jax_view(got)), jax.tree.leaves(want), leaves):
            np.testing.assert_allclose(np.asarray(a)[m], np.asarray(b)[m], rtol=1e-5, atol=1e-3 * top)
    ema = {k: v.clone() for k, v in fp32_runs["start_sd"].items()}
    for got, params in zip(pema, punets):
        ema = {k: v * EMA + params[k] * (1.0 - EMA) for k, v in ema.items()}
        for k in ema:
            torch.testing.assert_close(got[k], ema[k], rtol=1e-6, atol=0)


def test_bf16_step_loss_matches_jax():
    """half_precision: bf16 forward and backward over the f32 masters, in
    both packages; one dataset on the float wire."""
    unet, vae, params = seeded_port_modules(4)
    batches = _batches(6, [("ds", False)])
    jm, _, _ = _jax_run(params, batches, half=True)
    pm, _, _, state = _port_run(unet, vae, batches, half=True)
    for want, got in zip(jm, pm):
        for key in ("loss/train_avg", "loss/train_ds"):
            assert abs(got[key] - want[key]) <= 2e-2 * abs(want[key]), (key, got[key], want[key])
    assert all(p.dtype == torch.float32 for p in state.unet.parameters())
    assert all(p.dtype == torch.float32 for p in state.opt.inner.state[state.opt.params[0]].values()
               if torch.is_tensor(p) and p.dim())


def test_bf16_vae_copy_made_once_and_after_a_load():
    """The frozen VAE's bf16 copy is made at the first step and again only
    when its weights change in place (a warm start)."""
    half = train_state._HalfCopy()
    _, vae, _ = seeded_port_modules(4)
    first = half(vae)
    assert half(vae) is first and first.encoder.conv_in.weight.dtype == torch.bfloat16
    with torch.no_grad():
        vae.load_state_dict({k: v * 2 for k, v in vae.state_dict().items()})
    second = half(vae)
    assert second is not first
    torch.testing.assert_close(second.encoder.conv_in.weight.float(), (2 * first.encoder.conv_in.weight).float())


@pytest.mark.parametrize("half", [False, True])
def test_k3_packs_stay_bounded_and_fresh(monkeypatch, half):
    """Each K3 launch packs its conv weights (as the CUDA route does; here a
    spy packs and runs the plain block): over 4 steps the pack table holds
    at most one U-Net's conv weights, and every pack a forward reads is
    the weight as it stands then, never an earlier step's."""
    plain = fr.resnet_block
    stale = []

    def packing_block(x, emb, params, groups=8, eps=1e-5):
        for k in ("w1", "w2", "res_w"):
            if k in params:
                w = params[k]
                pack = fr.packed_weight(w, "co_k")
                want = w.detach().permute(0, 2, 3, 1).reshape(w.shape[0], -1)
                stale.append(not torch.equal(pack, want))
        return plain(x, emb, params, groups, eps)

    monkeypatch.setattr(fr, "resnet_block", packing_block)
    unet, vae, _ = seeded_port_modules(5)
    task = PoseConditionalTask(unet, vae)
    state = train_state.create_train_state(task, optim.make_optimizer(unet.parameters(), **OPT))
    step = train_state.make_train_step(task, half_precision=half)
    n_conv = sum(1 for b in unet.modules() if isinstance(b, torch.nn.Conv2d))
    before = len(fr._PACKS)
    sizes = []
    for b in _batches(7, [("ds", False)]) + _batches(8, [("ds", False)])[:1]:
        step(state, b)
        sizes.append(len(fr._PACKS) - before)
    assert stale and not any(stale)
    assert max(sizes) <= n_conv and sizes[-1] == sizes[0], sizes


def test_state_shardings_name_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 12"):
        train_state.make_train_step(None, state_shardings=object())
