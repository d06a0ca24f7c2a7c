"""The yardstick's counts: the FLOPs of each model at full width, and
K3's operations, bytes and bound as ``chip_smoke.py`` counts them."""

import importlib.util

import pytest
import torch

from perfbench import harness, inputs, tracing, work


def _cfg(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name, gflop", [("vae_base", 35.04), ("vae_cin_ldm", 114.07)])
def test_unet_flops_per_item_at_full_width(name, gflop):
    mods = inputs.meta_modules(_cfg(name), "reference")
    assert work.unet_flops_per_item(mods["unet"], 4, 32) / 1e9 == pytest.approx(gflop, abs=0.005)


def test_sd_vae_encode_flops_per_image():
    mods = inputs.meta_modules(_cfg("vae_base"), "reference")
    assert work.encode_flops_per_image(mods["vae"], 256) / 1e9 == pytest.approx(272.72, abs=0.005)


def _flagship_blocks():
    """(h, w, cin, co, res, emb) of the 22 ResnetBlock calls of one forward."""
    unet = inputs.meta_modules(_cfg("vae_base"), "reference")["unet"]
    shapes = []
    for m in unet.modules():
        if type(m).__name__ == "ResnetBlock":
            m.register_forward_pre_hook(lambda mod, args: shapes.append(tracing._k3_shape(mod, args[0])))
    unet(torch.zeros(1, 4, 32, 32, device="meta"), torch.zeros(1, 6, device="meta"))
    return shapes


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bench", harness.ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("batch, bound_ms", [(26, None), (341, None), (3328, 83.050)])
def test_k3_work_and_bound_equal_chip_smokes(batch, bound_ms):
    cs = _chip_smoke()
    blocks = _flagship_blocks()
    assert len(blocks) == 22
    total = 0.0
    for shape in blocks:
        mine = work.k3_work(shape, batch)
        assert mine == cs.k3_work(shape, batch)
        assert work.bound(*mine) == cs.bound(*mine)
        total += work.bound(*mine)[0]
    if bound_ms is not None:  # PERF.md's bound of the 22 blocks at 3,328 items
        assert total == pytest.approx(bound_ms, abs=5e-4)
