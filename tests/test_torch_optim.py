"""The port's optimizer (``nope_tpu_torch/training/optim.py``) against the
JAX package's optax chain: the lr schedule with its warm-up and
milestone quirks, AdamW and SGD updates, global-norm clipping,
skip-spike updates and the parameter EMA."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nope_tpu.training import optim as jax_optim
from nope_tpu_torch.training import optim

torch.set_num_threads(1)

STEPS = np.arange(0, 3001)
RTOL, ATOL = 1e-5, 1e-8


@pytest.mark.parametrize("warm_up", [0, 1, 500])
@pytest.mark.parametrize("milestones,steps_per_epoch", [
    ((10, 30, 50, 100), None),   # no steps_per_epoch: no milestones at all
    ((10, 30, 50, 100), 40),     # milestone 10 (step 400) inside the 500-step warm-up: lost
    ((1, 3, 20), 100),           # before, inside and after the warm-up
    ((2, 7), 300),
])
def test_lr_schedule_matches_jax(warm_up, milestones, steps_per_epoch):
    want = jax_optim.make_lr_schedule(5e-5, warm_up, milestones, 0.5, steps_per_epoch)
    got = optim.make_lr_schedule(5e-5, warm_up, milestones, 0.5, steps_per_epoch)
    jax_vals = np.asarray(jax.vmap(want)(jnp.asarray(STEPS)), np.float32)
    port_vals = np.asarray([got(s) for s in STEPS], np.float32)
    np.testing.assert_array_equal(port_vals, jax_vals)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}


def _run_both(kw, grads_seq):
    """Apply the same gradient sequence through optax and the port from the
    same parameters; return both parameter trajectories."""
    params = _tree(0)
    tx = jax_optim.make_optimizer(**kw)
    state = tx.init(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = optim.make_optimizer(list(tp.values()), **kw)
    out_j, out_t = [], []
    for g in grads_seq:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        out_j.append({k: np.asarray(v) for k, v in jp.items()})
        out_t.append({k: p.detach().numpy().copy() for k, p in tp.items()})
    return out_j, out_t


@pytest.mark.parametrize("name", ["AdamW", "SGD"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_updates_match_optax(name, clip):
    """5 steps through the warm-up (w=3: lr 0, lr/3, 2lr/3, then (w-1)/w·lr),
    AdamW's decoupled decay and eps on √v̂, SGD with decayed weights and
    momentum 0.9; with clip, optax's clip_by_global_norm (the norms
    straddle the limit)."""
    kw = dict(optim_name=name, base_lr=1e-2, weight_decay=5e-2, warm_up_steps=3, clip_grad_norm=clip)
    grads = [{k: v * s for k, v in _tree(10 + i).items()} for i, s in enumerate([0.1, 3.0, 0.2, 5.0, 0.3])]
    out_j, out_t = _run_both(kw, grads)
    p0 = _tree(0)
    for j, t in zip(out_j, out_t):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, atol=ATOL)
    # the updates are not vacuous: the last step moved every parameter
    assert all(np.abs(out_t[-1][k] - p0[k]).min() > 0 for k in p0)


def test_clip_factor_is_optax():
    """Clipping scales by c / max(‖g‖, c), not by c / (‖g‖ + 1e-6)."""
    g = {k: v * 7.0 for k, v in _tree(3).items()}
    want, _ = optax.clip_by_global_norm(1.0).update({k: jnp.asarray(v) for k, v in g.items()}, None)
    ts = [torch.tensor(g[k]) for k in g]
    norm = optim.global_norm(ts)
    torch._foreach_mul_(ts, torch.tensor(1.0) / torch.maximum(norm, torch.tensor(1.0)))
    for k, t in zip(g, ts):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)


@pytest.mark.parametrize("scales,want", [
    ([1, 1, 1, 1, 5e4, 1, 1, 3e2, 1], [4, 7]),
    ([5e4, 1, 1], []),  # inside the warm-up nothing is skipped
])
def test_skip_spike_matches_jax(scales, want):
    """The same steps skipped; on a skip the parameters, Adam's moments and
    step count and the norm EMA stay; otherwise the same updates."""
    factor, ema, warm = 10.0, 0.9, 3
    tx = jax_optim.skip_spike_updates(optax.adam(1e-2), factor=factor, norm_ema=ema, warmup_steps=warm)
    jp = {"w": jnp.zeros(4)}
    state = tx.init(jp)
    w = torch.zeros(4)
    inner = torch.optim.Adam([w], lr=1e-2, betas=(0.9, 0.999), eps=1e-8, foreach=True)
    opt = optim.Optimizer([w], inner, lambda step: 1e-2,
                          skip_spike=optim.SkipSpike(factor=factor, norm_ema=ema, warmup_steps=warm))
    skipped_j, skipped_t = [], []
    for s in scales:
        g = np.full(4, s, np.float32) * np.array([1, -1, 0.5, 2], np.float32)
        before_inner = [np.asarray(x) for x in jax.tree.leaves(state["inner"])]
        ema_before = float(state["gnorm_ema"])
        upd, state = tx.update({"w": jnp.asarray(g)}, state)
        jp = optax.apply_updates(jp, upd)
        skipped_j.append(float(optax.global_norm(upd)) == 0.0)
        if skipped_j[-1]:
            for a, b in zip(jax.tree.leaves(state["inner"]), before_inner):
                np.testing.assert_array_equal(np.asarray(a), b)
            assert float(state["gnorm_ema"]) == ema_before
        w_before = w.detach().clone()
        moments = {k: v.clone() for k, v in inner.state[w].items()} if inner.state else {}
        t_ema = opt.skip_spike.gnorm_ema.clone()
        w.grad = torch.tensor(g)
        applied = opt.step()
        skipped_t.append(not applied)
        if not applied:
            assert torch.equal(w, w_before)
            assert {k: v for k, v in inner.state[w].items()}.keys() == moments.keys()
            for k, v in moments.items():
                assert torch.equal(inner.state[w][k], v)
            assert torch.equal(opt.skip_spike.gnorm_ema, t_ema)
        np.testing.assert_allclose(float(opt.skip_spike.gnorm_ema), float(state["gnorm_ema"]), rtol=1e-6)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]), rtol=1e-5, atol=1e-7)
    assert skipped_t == skipped_j
    assert [i for i, s in enumerate(skipped_j) if s] == want


def test_make_optimizer_wraps_the_chain_in_skip_spike():
    """make_optimizer's skip_spike_factor wraps clip + AdamW; the schedule's
    count does not advance on a skipped step, as optax's inner state."""
    opt = optim.make_optimizer([torch.zeros(4, requires_grad=True)], base_lr=1e-3, warm_up_steps=1,
                               clip_grad_norm=1.0, skip_spike_factor=10.0)
    (p,) = opt.params
    for _ in range(205):  # past the wrapper's warm-up of 200
        p.grad = torch.ones(4)
        assert opt.step()
    count = opt.count
    p.grad = torch.full((4,), 5e4)
    before = p.detach().clone()
    assert not opt.step()
    assert torch.equal(p, before) and opt.count == count


def test_optimizer_state_round_trips():
    opt = optim.make_optimizer([torch.ones(3, requires_grad=True)], warm_up_steps=2, skip_spike_factor=5.0)
    for _ in range(3):
        opt.params[0].grad = torch.ones(3)
        opt.step()
    sd = opt.state_dict()
    other = optim.make_optimizer([torch.ones(3, requires_grad=True)], warm_up_steps=2, skip_spike_factor=5.0)
    other.load_state_dict(sd)
    assert other.count == 3 and other.skip_spike.count == 3
    assert torch.equal(other.skip_spike.gnorm_ema, opt.skip_spike.gnorm_ema)
    with pytest.raises(ValueError, match="skip-spike"):
        optim.make_optimizer([torch.ones(3, requires_grad=True)]).load_state_dict(sd)


def test_ema_update_matches_jax():
    ema, new = _tree(1), _tree(2)
    want = jax_optim.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                                {k: jnp.asarray(v) for k, v in new.items()}, beta=0.9)
    got = [torch.tensor(ema[k]) for k in ema]
    optim.ema_update(got, [torch.tensor(new[k]) for k in new], beta=0.9)
    for k, t in zip(ema, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=1e-6)
