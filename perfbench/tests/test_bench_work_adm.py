"""The ADM's yardstick: its FLOPs an item at full width, and
``work_adm.res_work`` against a direct count over the 42 res blocks of
one forward."""

import pytest
import torch
import torch.nn.functional as F

from perfbench import harness, inputs, work, work_adm


def _unet(side):
    return inputs.meta_modules(harness.load_json(harness.HERE / "configs" / "vae_guidedDiffusion.json"), side)["unet"]


@pytest.mark.parametrize("side", ["reference", "program"])
def test_adm_flops_per_item_at_full_width(side):
    assert work.unet_flops_per_item(_unet(side), 4, 32) / 1e9 == pytest.approx(34.907, abs=0.0005)


def _blocks():
    """(shape, block) of the 42 res blocks of one forward, shape as the
    program's ``adm.res`` span reads it."""
    unet, out = _unet("program"), []
    for m in unet.modules():
        if type(m).__name__ == "ADMResBlock":
            m.register_forward_pre_hook(lambda mod, args: out.append((mod._facts(args[0])["shape"], mod)))
    unet(torch.zeros(1, 4, 32, 32, device="meta"), torch.zeros(1, 6, device="meta"))
    return out


def test_res_work_counts_the_in_image_taps_of_each_block():
    blocks = _blocks()
    assert len(blocks) == 42 and sum(1 for shape, _ in blocks if shape[5]) == 10
    for (h, w, cin, co, film, resample), block in blocks:
        h2, w2 = {"up": (2 * h, 2 * w), "down": (h // 2, w // 2), "": (h, w)}[resample]
        taps = int(F.conv2d(torch.ones(1, 1, h2, w2), torch.ones(1, 1, 3, 3), padding=1).sum())
        conv1, conv2 = block.in_layers[2], block.out_layers[3]
        assert (conv1.in_channels, conv1.out_channels, conv2.out_channels) == (cin, co, co) and film
        skip = h2 * w2 * cin * co if cin != co else 0
        tc, f32, nbytes = work_adm.res_work((h, w, cin, co, film, resample), 3)
        assert tc == 2.0 * 3 * (taps * (cin + co) * co + skip)
        assert f32 > 0 and nbytes > 2 * 3 * (h * w * cin + h2 * w2 * co)


def test_the_least_time_of_a_forwards_res_blocks_at_1984_items():
    least = sum(work.bound(*work_adm.res_work(shape, 1984))[0] for shape, _ in _blocks())
    assert least == pytest.approx(61.951, abs=5e-4)  # ms: 31.2 ms per 1,000 items
