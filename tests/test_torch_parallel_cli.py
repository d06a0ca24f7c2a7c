"""The training entry points on 2 gloo ranks (CPU, the tiny model of
``tests/test_torch_train_cli.py``, whose root and warm start this module
shares): ``cli.train.main`` data-parallel with a checkpoint at step 2,
a second ``main`` resumed from it through the shared directory, a ZeRO-1
run, and ``cli.pretrain_vae.main``, against one process's run.  The
ranks (``tests/torch_parallel_ranks.train_cli_rank``) import torch only."""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from nope_tpu_torch.cli import train as train_cli
from nope_tpu_torch.parallel.launch import Ranks
from tests.test_torch_train_cli import TINY, _overrides, train_root, warm_start  # noqa: F401 (fixtures)
from tests.torch_parallel_ranks import train_cli_rank

torch.set_num_threads(1)
STEPS = 4
FIT = ["trainer.checkpoint_every_n_steps=2", "trainer.val_check_interval=4"]


def _train_args(root, save_dir, warm, name, extra=()):
    return ["--max-steps", str(STEPS), "--device", "cpu", *_overrides(root, save_dir, warm, name), *FIT, *extra]


@pytest.fixture(scope="module")
def runs(train_root, warm_start, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("two_rank_cli")
    pretrain = ["--steps", "2", "--device", "cpu", *TINY, f"data.datasets.shapeNet.root_dir={train_root}",
                "data.datasets.shapeNet.img_size=32"]
    ckpt = "checkpoints/ckpt_00000002.pt"
    plan = [
        ("train", _train_args(train_root, out, warm_start, "dp")),
        ("copy", (str(out / "dp" / ckpt), str(out / "resumed" / ckpt))),
        ("train", _train_args(train_root, out, warm_start, "resumed")),
        ("train", _train_args(train_root, out, warm_start, "zero1", ["machine.zero1=true"])),
        ("pretrain", pretrain + ["--out", str(out / "vae.bin")]),
    ]
    group = Ranks(train_cli_rank, 2, (plan,), timeout=300)
    state, _ = train_cli.main(_train_args(train_root, out, warm_start, "single"))
    read = lambda name: [json.loads(line) for line in open(osp.join(out, name, "metrics.jsonl"))]  # noqa: E731
    return {"ranks": group.join(), "single": state, "read": read, "dir": out}


def _losses(records):
    return {r["step"]: r["loss/train_avg"] for r in records if "loss/train_avg" in r}


def test_two_rank_train_matches_one_process(runs):
    """1 pair a rank against 2 in one process: the losses within rel 1e-5,
    the same weights on both ranks, the weights within rel 1e-3 (L2) of
    one process's; the validation of step 4 merged across the ranks."""
    (r0, r1), single = (r["runs"][0] for r in runs["ranks"]), runs["single"]
    assert r0["step"] == r1["step"] == single.step == STEPS
    assert r0["mesh"] == {"data": 2, "template": 1}
    np.testing.assert_array_equal(r0["params"], r1["params"])
    want = torch.cat([p.detach().reshape(-1) for p in single.unet.parameters()]).numpy()
    assert np.linalg.norm(r0["params"] - want) <= 1e-3 * np.linalg.norm(want)
    got, ref = _losses(runs["read"]("dp")), _losses(runs["read"]("single"))
    assert sorted(got) == sorted(ref) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([got[s] for s in ref], list(ref.values()), rtol=1e-5)
    val = [r for r in runs["read"]("dp") if any(k.startswith("val/") for k in r)]
    want_val = [r for r in runs["read"]("single") if any(k.startswith("val/") for k in r)]
    assert len(val) == len(want_val) == 1
    assert val[0]["val/shapeNet/num_images"] == want_val[0]["val/shapeNet/num_images"]


def test_two_rank_resume_from_the_shared_checkpoint(runs):
    """The second run found rank 0's step-2 checkpoint in the shared
    directory, both ranks restored it, and steps 3-4 took the
    uninterrupted run's losses and weights (bitwise)."""
    for r in runs["ranks"]:
        dp, resumed = r["runs"][0], r["runs"][2]
        assert resumed["step"] == STEPS
        np.testing.assert_array_equal(resumed["params"], dp["params"])
    got, want = _losses(runs["read"]("resumed")), _losses(runs["read"]("dp"))
    assert sorted(got) == [3, 4] and all(got[s] == want[s] for s in got)


def test_two_rank_zero1_train_matches_replicated(runs):
    for r in runs["ranks"]:
        z, dp = r["runs"][3], r["runs"][0]
        assert z["sharded"] and not dp["sharded"]
        np.testing.assert_array_equal(z["params"], dp["params"])
    assert _losses(runs["read"]("zero1")) == _losses(runs["read"]("dp"))


def test_two_rank_pretrain_vae(runs):
    """Data-parallel VAE pretraining: 2 steps on both ranks, the same
    finite weights on both, and rank 0's ``--out`` holds them.  Each
    rank draws the posterior noise of its own rows, so the weights are
    not one process's bitwise."""
    a, b = (r["runs"][4] for r in runs["ranks"])
    assert a["step"] == b["step"] == 2
    saved = torch.load(runs["dir"] / "vae.bin", weights_only=True)
    assert set(saved) == set(a["state"]) == set(b["state"])
    for k, v in saved.items():
        assert torch.equal(a["state"][k], v) and torch.equal(b["state"][k], v), k
        assert torch.isfinite(v).all(), k


def test_ranks_import_torch_only(runs):
    assert [r["foreign"] for r in runs["ranks"]] == [[], []]
