"""The frozen reference against the program at small sizes on the CPU
(where the program's kernels run their plain versions), on one seeded
state dict loaded into both: every configuration of ``BENCHMARK.json``
at its ``toy_sizes/<config>.json``."""

import numpy as np
import pytest
import torch

from perfbench import harness, inputs
from perfbench.reference import task as ref
from perfbench.tests import toy


def _both(name):
    cfg = toy.config(name)
    device = torch.device("cpu")
    prog_mods, ref_mods = inputs.meta_modules(cfg, "program"), inputs.meta_modules(cfg, "reference")
    state = inputs.state_for(cfg, 5, device)
    drawn_over_program = inputs.seeded_state(prog_mods, 5, device)
    assert list(state) == sorted(state) == list(drawn_over_program)
    for key, value in state.items():  # the draw does not depend on which side's modules it runs over
        assert torch.equal(value, drawn_over_program[key]), key
    prog, want = inputs.load(prog_mods, state, device), inputs.load(ref_mods, state, device, frozen=True)
    for built in (prog, want):  # both sides hold exactly the drawn tensors
        loaded = {f"{part}.{k}": v for part, m in built.items() for k, v in m.state_dict().items()}
        assert loaded.keys() == state.keys()
        assert all(torch.equal(loaded[k], state[k]) for k in state)
    return cfg, prog, want


@pytest.mark.parametrize("name", [c["name"] for c in harness.spec()["configs"]])
def test_the_reference_unet_and_encoder_equal_the_programs(name):
    cfg, prog, want = _both(name)
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(3, cfg["img_size"], cfg["img_size"], 3, generator=gen) * 2 - 1
    with torch.no_grad():
        got_lat = prog["vae"].encode_image(images)
        want_lat = want["vae"].encode_image(images)
        torch.testing.assert_close(got_lat, want_lat, rtol=1e-5, atol=1e-5)
        pose = torch.randn(3, 6, generator=gen)
        got = prog["unet"](got_lat.permute(0, 3, 1, 2), pose)
        torch.testing.assert_close(got, want["unet"](want_lat.permute(0, 3, 1, 2), pose), rtol=1e-4, atol=1e-4)


def test_the_task_arithmetic_equals_the_programs():
    from nope_tpu_torch.geometry.rotations import rotation_6d_to_matrix
    from nope_tpu_torch.ops.similarity import reference_similarity_plain, top_k
    from nope_tpu_torch.tasks.metrics import GeodesicError

    gen = torch.Generator().manual_seed(1)
    q, bank = torch.randn(4, 4, 4, 4, generator=gen), torch.randn(4, 9, 4, 4, 4, generator=gen)
    sim = ref.l2_similarity(q, bank)
    torch.testing.assert_close(sim, reference_similarity_plain(q, bank))
    sim[:, 3] = sim[:, 5]  # a tie: the lower index first on both sides
    assert torch.equal(ref.top_k(sim, 5), top_k(sim, 5))
    d6 = torch.randn(8, 6, generator=gen)
    torch.testing.assert_close(ref.rotation_6d_to_matrix(d6), rotation_6d_to_matrix(d6))
    grid = inputs.template_grid("full")
    pred, gt = torch.from_numpy(grid[:30]), torch.from_numpy(grid[5:35])
    sym = torch.from_numpy(np.arange(30) % 3)
    want, _ = GeodesicError()(pred, gt, sym)
    torch.testing.assert_close(ref.geodesic_error_deg(pred, gt, sym), want, rtol=0, atol=2e-3)


def test_the_weight_draw_does_not_depend_on_the_order_modules_register_parameters():
    def model(order):
        m = torch.nn.Module()
        for name in order:
            m.add_module(name, torch.nn.Linear(3, 4) if name == "a" else torch.nn.Conv2d(4, 2, 3))
        return m

    first = inputs.seeded_state({"m": model("ab")}, 9, torch.device("cpu"))
    second = inputs.seeded_state({"m": model("ba")}, 9, torch.device("cpu"))
    assert first.keys() == second.keys()
    assert all(torch.equal(first[k], second[k]) for k in first)
