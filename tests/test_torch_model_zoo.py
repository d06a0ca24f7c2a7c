"""The model zoo of the port against nope_tpu's on the same weights and
inputs (CPU: the ops run their plain versions): the remaining blocks,
the LDM and ADM U-Nets, the LDM encoder with its four heads, the
schedules, the weight converters both ways and the oracles' state dicts.
The variants whole: ``tests/test_torch_model_zoo_variants.py``.

Weights are the port's seeded init with the zero-initialised layers
overwritten by seeded noise (so no mapping hides behind a zero), carried
to JAX by ``nope_tpu.training.port``.  Tolerance: max abs 5e-4 and rel
1e-3 (``tests/test_variant_parity.py``), JAX at "highest" precision."""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nope_tpu.models import adm_unet as jadm
from nope_tpu.models import blocks as jblocks
from nope_tpu.models import ldm_encoder as jenc
from nope_tpu.models import ldm_unet as jldm
from nope_tpu.models import schedules as jsched
from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.training import port
from nope_tpu_torch import weights
from nope_tpu_torch.models import adm_unet, blocks, ldm_encoder, ldm_unet, schedules
from nope_tpu_torch.models.factory import init_weights
from nope_tpu_torch.models.unet import PoseUNet
from tests.oracles.torch_adm_unet import TorchADMPoseUNet
from tests.oracles.torch_ldm_unet import TorchLDMPoseUNet
from tests.torch_port_helpers import assert_trees_equal, to_numpy_tree

torch.set_num_threads(1)
HI = functools.partial(jax.default_matmul_precision, "highest")
ATOL, RTOL = 5e-4, 1e-3

# the tiny configurations of tests/test_factory.py
LDM = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2, 1), channel_mult=(1, 2),
           num_head_channels=16, context_dim=24)
ADM = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
           num_head_channels=16)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@torch.no_grad()
def noise_zero_layers(module, seed):
    """Overwrite the zero-initialised layers with seeded LeCun-normal noise."""
    gen = _gen(seed)
    for m in module.modules():
        if getattr(m, "zero_init", False):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=gen)
            m.bias.normal_(0.0, 0.1, generator=gen)
    return module


def seeded(module, seed):
    return noise_zero_layers(init_weights(module, _gen(seed)), seed + 1).eval()


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def nchw_to_jax(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def assert_close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _prefixed(module, prefix="m"):
    return {f"{prefix}.{k}": v for k, v in to_numpy_tree(module.state_dict()).items()}


# -- blocks -----------------------------------------------------------------------

def test_conditional_resnet_block_matches_jax():
    rng = np.random.default_rng(0)
    mod = seeded(blocks.ConditionalResnetBlock(8, 16, time_emb_dim=12, classes_emb_dim=4, groups=4), 0)
    x, t, c = (rng.normal(size=s).astype(np.float32) for s in ((2, 8, 6, 6), (2, 12), (2, 4)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c)).numpy()
    params = port._resnet_block(_prefixed(mod), "m")
    with HI():
        want = jblocks.ConditionalResnetBlock(16, groups=4).apply(
            {"params": _jnp_tree(params)}, nchw_to_jax(x), jnp.asarray(t), jnp.asarray(c))
    assert_close(got, np.transpose(np.asarray(want), (0, 3, 1, 2)))


def test_dual_conditional_resnet_block_matches_jax():
    rng = np.random.default_rng(1)
    mod = seeded(blocks.DualConditionalResnetBlock(8, 8, 12, 4, ref_dim=6, groups=4), 1)
    x, ref, t, c = (rng.normal(size=s).astype(np.float32) for s in ((2, 8, 6, 6), (2, 6, 6, 6), (2, 12), (2, 4)))
    with torch.no_grad():
        got = mod(*(torch.from_numpy(a) for a in (x, ref, t, c))).numpy()
    sd = _prefixed(mod)
    params = port._resnet_block(sd, "m")
    params["mlp_ref"] = {"proj": port._conv(sd, "m.mlp_ref.proj"), "norm": port._norm(sd, "m.mlp_ref.norm")}
    with HI():
        want = jblocks.DualConditionalResnetBlock(8, groups=4).apply(
            {"params": _jnp_tree(params)}, nchw_to_jax(x), nchw_to_jax(ref), jnp.asarray(t), jnp.asarray(c))
    assert_close(got, np.transpose(np.asarray(want), (0, 3, 1, 2)))


@pytest.mark.parametrize("dim", [16, 17])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 7, 250, 999], np.float32)
    got = blocks.timestep_embedding(torch.from_numpy(t), dim).numpy()
    want = np.asarray(jblocks.timestep_embedding(jnp.asarray(t), dim))
    assert got.shape == (5, dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("axis,stable", [(-1, False), (1, False), (-1, True)])
def test_channel_layer_norm_matches_jax(axis, stable):
    x = np.random.default_rng(2).normal(size=(2, 5, 7)).astype(np.float32) + 3.0
    mod = blocks.ChannelLayerNorm(x.shape[axis], axis=axis, stable=stable)
    with torch.no_grad():
        mod.g.copy_(torch.linspace(0.5, 1.5, x.shape[axis]))
        got = mod(torch.from_numpy(x)).numpy()
    want = jblocks.ChannelLayerNorm(axis=axis, stable=stable).apply(
        {"params": {"g": jnp.asarray(mod.g.detach().numpy())}}, jnp.asarray(x))
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_imagen_cross_attention_matches_jax(masked):
    rng = np.random.default_rng(3)
    mod = blocks.ImagenCrossAttention(12, context_dim=10, heads=2, dim_head=8).eval()
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 0.3))
    x, ctx = rng.normal(size=(2, 5, 12)).astype(np.float32), rng.normal(size=(2, 4, 10)).astype(np.float32)
    mask = np.array([[True, True, False, True], [False, True, True, True]]) if masked else None
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(ctx), None if mask is None else torch.from_numpy(mask)).numpy()
    t = {k: v.detach().numpy() for k, v in mod.state_dict().items()}
    params = {"norm": {"g": t["norm.g"]}, "to_q": {"kernel": t["to_q.weight"].T},
              "to_kv": {"kernel": t["to_kv.weight"].T},
              "null_kv": t["null_kv"], "q_scale": t["q_scale"], "k_scale": t["k_scale"],
              "to_out": {"kernel": t["to_out.0.weight"].T}, "out_norm": {"g": t["to_out.1.g"]}}
    with HI():
        want = jblocks.ImagenCrossAttention(heads=2, dim_head=8).apply(
            {"params": _jnp_tree(params)}, jnp.asarray(x), jnp.asarray(ctx),
            None if mask is None else jnp.asarray(mask))
    assert_close(got, np.asarray(want))


def test_pose_unet_strided_samplers_match_jax():
    """``PoseUNet(use_hard_up_down=False)``: the strided conv4x4/2 and the
    transposed conv4x4/2 against JAX's Downsample / Upsample, with the
    weights both ways through the port tool."""
    kw = dict(u_net_dim=16, channels=4, dim_mults=(1, 2), resnet_block_groups=8)
    mod = seeded(PoseUNet(**kw, use_hard_up_down=False), 4)
    sd = to_numpy_tree(mod.state_dict())
    params = port.port_pose_unet(sd, dim_mults=(1, 2), use_hard_up_down=False)
    assert_trees_equal(to_numpy_tree(weights.unet_state_dict_from_jax(params, use_hard_up_down=False)), sd)
    rng = np.random.default_rng(4)
    x, pose = rng.normal(size=(2, 4, 8, 8)).astype(np.float32), rng.normal(size=(2, 6)).astype(np.float32)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(pose)).numpy()
    with HI():
        want = JaxPoseUNet(**kw, use_hard_up_down=False).apply(
            {"params": _jnp_tree(params)}, nchw_to_jax(x), jnp.asarray(pose))
    assert_close(got, np.transpose(np.asarray(want), (0, 3, 1, 2)))


# -- LDM and ADM U-Nets -----------------------------------------------------------

def _ldm(pose_mlp_name="single_layer", twice=False, **extra):
    cfg = {**LDM, **extra}
    port_mod = ldm_unet.LDMPoseUNet(in_channels=4, out_channels=4, pose_mlp_name=pose_mlp_name,
                                    injecting_condition_twice=twice, **cfg)
    jax_mod = jldm.LDMPoseUNet(in_channels=4, out_channels=4, pose_mlp_name=pose_mlp_name,
                               injecting_condition_twice=twice, transformer_depth=cfg.get("transformer_depth", 1),
                               **{k: v for k, v in cfg.items() if k != "transformer_depth"})
    to_jax = functools.partial(port.port_ldm_unet, channel_mult=cfg["channel_mult"],
                               num_res_blocks=cfg["num_res_blocks"],
                               attention_resolutions=cfg["attention_resolutions"],
                               transformer_depth=cfg.get("transformer_depth", 1),
                               pose_mlp_name=pose_mlp_name, injecting_condition_twice=twice)
    return port_mod, jax_mod, to_jax, weights.openai_unet_state_dict_from_jax


def _adm(resblock_updown=True, use_scale_shift_norm=True):
    port_mod = adm_unet.ADMPoseUNet(in_channels=4, out_channels=4, resblock_updown=resblock_updown,
                                    use_scale_shift_norm=use_scale_shift_norm, **ADM)
    jax_mod = jadm.ADMPoseUNet(in_channels=4, out_channels=4, resblock_updown=resblock_updown,
                               use_scale_shift_norm=use_scale_shift_norm, **ADM)
    to_jax = functools.partial(port.port_adm_unet, channel_mult=ADM["channel_mult"],
                               num_res_blocks=ADM["num_res_blocks"],
                               attention_resolutions=ADM["attention_resolutions"], resblock_updown=resblock_updown)
    return port_mod, jax_mod, to_jax, weights.openai_unet_state_dict_from_jax


# the defaults (LDM; ADM with resblock up/down and FiLM) run whole in
# tests/test_torch_model_zoo_variants.py
UNETS = {
    "ldm_twice": lambda: _ldm(twice=True),
    "ldm_two_layers_depth2": lambda: _ldm("two_layers", transformer_depth=2),
    "ldm_posenc_ctx20": lambda: _ldm("posEncoding", context_dim=20),
    "adm_conv_samplers_no_scale_shift": lambda: _adm(False, use_scale_shift_norm=False),
}


@pytest.mark.parametrize("name", sorted(UNETS))
def test_unet_matches_jax_and_round_trips(name):
    port_mod, jax_mod, to_jax, from_jax = UNETS[name]()
    seed = sorted(UNETS).index(name)
    mod = seeded(port_mod, 10 + seed)
    sd = to_numpy_tree(mod.state_dict())
    params = to_jax(sd)
    # JAX params → the port's state dict → the port tool: bitwise both ways
    back = to_numpy_tree(from_jax(params))
    assert_trees_equal(back, sd)
    assert_trees_equal(to_jax(back), params)
    rng = np.random.default_rng(seed)
    x, pose = rng.normal(size=(2, 4, 8, 8)).astype(np.float32), rng.normal(size=(2, 6)).astype(np.float32)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(pose)).numpy()
    with HI():
        want = jax.jit(jax_mod.apply)({"params": _jnp_tree(params)}, nchw_to_jax(x), jnp.asarray(pose))
    assert got.shape == (2, 4, 8, 8)
    assert_close(got, np.transpose(np.asarray(want), (0, 3, 1, 2)))


def test_ldm_oracle_state_dict_loads_strict():
    oracle = TorchLDMPoseUNet(**{k: v for k, v in LDM.items()}).eval()
    mod = ldm_unet.LDMPoseUNet(in_channels=4, out_channels=4, **LDM).eval()
    with torch.no_grad():
        for p in oracle.parameters():
            p.normal_(0, 0.05, generator=_gen(20))
    mod.load_state_dict(oracle.state_dict(), strict=True)
    rng = np.random.default_rng(20)
    x, pose = torch.from_numpy(rng.normal(size=(2, 4, 8, 8)).astype(np.float32)), torch.randn(2, 6, generator=_gen(21))
    with torch.no_grad():
        # the oracle's LayerNorms take torch's epsilon (1e-5), the port Flax's (1e-6)
        np.testing.assert_allclose(mod(x, pose).numpy(), oracle(x, pose).numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("updown", [True, False])
def test_adm_oracle_state_dict_loads_strict(updown):
    oracle = TorchADMPoseUNet(resblock_updown=updown, **ADM).eval()
    mod = adm_unet.ADMPoseUNet(in_channels=4, out_channels=4, resblock_updown=updown, **ADM).eval()
    with torch.no_grad():
        for p in oracle.parameters():
            p.normal_(0, 0.05, generator=_gen(22))
    mod.load_state_dict(oracle.state_dict(), strict=True)
    x, pose = torch.randn(2, 4, 8, 8, generator=_gen(23)), torch.randn(2, 6, generator=_gen(24))
    with torch.no_grad():
        np.testing.assert_allclose(mod(x, pose).numpy(), oracle(x, pose).numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pool,updown,ssn", [("adaptive", False, False), ("attention", True, True),
                                             ("spatial", False, True), ("spatial_v2", True, False)])
def test_ldm_encoder_unet_matches_jax_and_round_trips(pool, updown, ssn):
    kw = dict(out_channels=5, model_channels=32, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
              num_head_channels=16, use_scale_shift_norm=ssn, resblock_updown=updown, pool=pool)
    mod = seeded(ldm_encoder.LDMEncoderUNet(in_channels=4, image_size=8, **kw), 30)
    sd = to_numpy_tree(mod.state_dict())
    params = port.port_ldm_encoder_unet(sd, channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(2,),
                                        resblock_updown=updown, pool=pool)
    assert_trees_equal(to_numpy_tree(weights.ldm_encoder_unet_state_dict_from_jax(params)), sd)
    jax_mod = jenc.LDMEncoderUNet(**kw)
    x = np.random.default_rng(31).normal(size=(3, 4, 8, 8)).astype(np.float32)
    t = np.array([3, 250, 999], np.float32)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    with HI():
        want = jax.jit(jax_mod.apply)({"params": _jnp_tree(params)}, nchw_to_jax(x), jnp.asarray(t))
    assert got.shape == (3, 5)
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("schedule", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_schedules_bitwise(schedule):
    got = schedules.make_beta_schedule(schedule, 1000)
    np.testing.assert_array_equal(got, jsched.make_beta_schedule(schedule, 1000))
    alphacums = np.cumprod(1.0 - got)
    for method in ("uniform", "quad"):
        steps = schedules.make_ddim_timesteps(method, 50, 1000)
        np.testing.assert_array_equal(steps, jsched.make_ddim_timesteps(method, 50, 1000))
        for a, b in zip(schedules.make_ddim_sampling_parameters(alphacums, steps[:-1], 0.5),
                        jsched.make_ddim_sampling_parameters(alphacums, steps[:-1], 0.5)):
            np.testing.assert_array_equal(a, b)

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    np.testing.assert_array_equal(schedules.betas_for_alpha_bar(100, alpha_bar),
                                  jsched.betas_for_alpha_bar(100, alpha_bar))


def test_model_zoo_imports_no_jax_in_a_fresh_process():
    """The new modules import and every variant builds with jax and
    nope_tpu unimportable."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    code = textwrap.dedent(
        """
        import sys, types
        for name in ("jax", "jaxlib", "flax", "nope_tpu"):
            sys.modules[name] = None
        import torch
        from nope_tpu_torch import weights
        from nope_tpu_torch.models import (adm_unet, blocks, factory, ldm_encoder, ldm_unet, resnet, schedules,
                                           template_encoder)
        ns = types.SimpleNamespace
        u = dict(u_net_dim=8, dim_mults=(1, 2), rot_representation_dim=6, pose_mlp_name="single_layer",
                 resnet_block_groups=4, double_bottleneck=True, model_channels=32, num_res_blocks=1,
                 attention_resolutions=(2, 1), channel_mult=(1, 2), num_head_channels=16, context_dim=24,
                 transformer_depth=1, injecting_condition_twice=False, gd_attention_resolutions=(2,),
                 gd_channel_mult=(1, 2), num_heads=4, use_scale_shift_norm=True, resblock_updown=True)
        torch.set_num_threads(1)
        for variant, kind in (("vae_cin_ldm", "vae"), ("vae_guidedDiffusion", "vae"), ("template_base", "template"),
                              ("vae_base", "template_tiny")):
            cfg = ns(u_net=ns(variant=variant, **u),
                     encoder=ns(kind=kind, latent_dim=4 if kind == "vae" else 8, block_out_channels=(8, 8, 8, 8),
                                layers_per_block=1, norm_groups=4, using_KL=False, descriptor_size=8,
                                normalize=False),
                     optim_config=ns(loss_type="l1", use_inv_deltaR=True),
                     testing_config=ns(similarity_metric="l2", retrieval_k=5, half_precision_eval=False))
            task = factory.build_task(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
            assert task.encode(torch.zeros(1, 32, 32, 3)).shape[-1] == cfg.encoder.latent_dim
        assert "jax" not in {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
        print("ok")
        """
    )
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_group_norms_stay_on_the_gradients_device():
    """A grad-trace group no parameter falls in (the LDM's and ADM's
    ``cond_mlp``) is a zero on the gradients' device, so the metrics stack
    in one host read on the card too."""
    from nope_tpu_torch.training.train_state import GRAD_TRACE_GROUPS, _group_norms

    out = _group_norms({"w": torch.ones(3, device="meta")}, {"w": "conv"}, "gnorm")
    assert set(out) == {f"gnorm/{g}" for g in (*GRAD_TRACE_GROUPS, "global")}
    assert all(v.device.type == "meta" for v in out.values())
    cpu = _group_norms({"w": torch.full((4,), 2.0)}, {"w": "attn"}, "gnorm")
    assert float(cpu["gnorm/attn"]) == 4.0 and float(cpu["gnorm/cond_mlp"]) == 0.0 and float(cpu["gnorm/global"]) == 4.0
