"""The port's trainer side (``nope_tpu_torch/training/{checkpoint,trainer}.py``)
on the CPU at a tiny size: checkpoint round trips, deterministic resume
of the data and loss streams, the EMA stream and the monitored best
export across a resume, the steps/s divisor, media grids and the
one-device guard.  The metrics keys against the JAX trainer's are held
in ``test_torch_train_cli.py``, where both CLIs run."""

import copy
import json
import os.path as osp

import numpy as np
import pytest
import torch

from nope_tpu_torch.configs import load_config
from nope_tpu_torch.data.pipeline import DataLoader, collate
from nope_tpu_torch.geometry import rotations as rot
from nope_tpu_torch.models.factory import build_task
from nope_tpu_torch.training import checkpoint, optim, trainer as trainer_mod
from nope_tpu_torch.training.checkpoint import CheckpointManager
from nope_tpu_torch.training.train_state import create_train_state
from nope_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

IMG = 32
TINY = [
    "model.img_size=32",
    "model.u_net.u_net_dim=8",
    "model.u_net.dim_mults=1,2",
    "model.u_net.resnet_block_groups=4",
    "model.encoder.block_out_channels=8,8,8,8",
    "model.encoder.layers_per_block=1",
    "model.encoder.norm_groups=4",
    "model.optim_config.warm_up_steps=2",
    "machine.batch_size=2",
    "trainer.num_sanity_val_steps=0",
    "trainer.media_every_n_steps=0",
    "trainer.log_every_n_steps=1",
]


class EpochKeyedPairs:
    """Items depend on (epoch, index), and record both: a resume must put
    back the shuffle order and the dataset's set_epoch stream."""

    def __init__(self, n=8):
        self.n, self._epoch = n, 0

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __getitem__(self, i):
        seed = 1000 * self._epoch + int(i)
        rng = np.random.default_rng(seed)
        mat = rot.random_rotations(1, torch.Generator().manual_seed(seed))
        return {
            "query": rng.uniform(-1, 1, (IMG, IMG, 3)).astype(np.float32),
            "reference": rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8),
            "relativeR": rot.matrix_to_rotation_6d(mat)[0].numpy(),
            "relativeR_inv": rot.matrix_to_rotation_6d(mat.transpose(-1, -2))[0].numpy(),
            "_idx": np.asarray([self._epoch, i], np.int64),
        }


def _trainer(save_dir, extra=(), val_fn=None, log=None, n=8):
    cfg = load_config(None, TINY + [f"save_dir={save_dir}", "name_exp=run"] + list(extra))

    def logging_collate(items):
        batch = collate(items)
        ids = batch.pop("_idx")
        if log is not None:
            log.append(ids.tolist())
        return batch

    loaders = {"ds": DataLoader(EpochKeyedPairs(n), batch_size=2, num_workers=1, prefetch=1,
                                collate_fn=logging_collate)}
    task = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(cfg.trainer.seed))
    return Trainer(cfg, task, loaders, val_fn=val_fn), cfg


def _records(cfg):
    return [json.loads(line) for line in open(osp.join(cfg.save_dir, "metrics.jsonl"))]


def _state(seed=0, skip=0.0):
    cfg = load_config(None, TINY)
    task = build_task(cfg.model, torch.device("cpu"), torch.Generator().manual_seed(seed))
    opt = optim.make_optimizer(task.unet.parameters(), warm_up_steps=1, skip_spike_factor=skip)
    return create_train_state(task, opt)


def _step_once(state, seed):
    gen = torch.Generator().manual_seed(seed)
    for p in state.unet.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    state.opt.step()
    state.step += 1


def _assert_state_equal(a, b):
    for x, y in ((a.unet, b.unet), (a.vae, b.vae)):
        for (k, v), w in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(v, w), k
    sa, sb = a.opt.state_dict(), b.opt.state_dict()
    assert sa["count"] == sb["count"]
    if sa["skip_spike"] is not None:
        assert sa["skip_spike"]["count"] == sb["skip_spike"]["count"]
        assert torch.equal(sa["skip_spike"]["gnorm_ema"], sb["skip_spike"]["gnorm_ema"])
    for i, st in sa["inner"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["inner"]["state"][i][k]), (i, k)
    assert a.step == b.step


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    state = _state(skip=5.0)
    for s in range(3):
        _step_once(state, s)
    ema = copy.deepcopy(state.unet)
    with torch.no_grad():
        for p in ema.parameters():
            p.mul_(0.5)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=3)
    assert mgr.save(3, state, ema_params=ema)
    (tmp_path / "ckpt" / ".ckpt_00000006.pt.tmp").write_bytes(b"a save cut short")  # ignored
    assert mgr.latest_step() == 3
    fresh = _state(seed=1, skip=5.0)
    fresh_ema = copy.deepcopy(fresh.unet)
    restored, got_ema = mgr.restore_with_ema(fresh, fresh_ema)
    _assert_state_equal(restored, state)
    for v, w in zip(got_ema.state_dict().values(), ema.state_dict().values()):
        assert torch.equal(v, w)
    # the restored optimizer continues exactly as the original would
    _step_once(state, 9)
    _step_once(restored, 9)
    _assert_state_equal(restored, state)


def test_checkpoint_cadence_and_max_to_keep(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=2, max_to_keep=2)
    saved = []
    for step in range(1, 8):
        state.step = step
        saved.append(mgr.save(step, state))
    assert saved == [False, True, False, True, False, True, False]
    assert mgr.all_steps() == [4, 6]
    assert not mgr.save(5, state, force=False) and mgr.save(7, state, force=True)
    assert mgr.all_steps() == [6, 7]
    assert not mgr.save(6, state)  # not past the newest
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_restore_with_ema_from_a_pre_ema_checkpoint(tmp_path):
    state = _state()
    _step_once(state, 0)
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    mgr.save(1, state)
    fresh = _state(seed=2)
    restored, ema = mgr.restore_with_ema(fresh, copy.deepcopy(fresh.unet))
    assert ema is None
    _assert_state_equal(restored, state)


def test_resume_replays_the_uninterrupted_stream(tmp_path):
    """8 items at batch 2 (4 steps an epoch), a checkpoint every 3 steps:
    a run stopped at step 6 (2 batches into epoch 1) and resumed by a new
    Trainer to step 10 replays the uninterrupted run's (epoch, index)
    batches and its losses bitwise."""
    extra = ["trainer.checkpoint_every_n_steps=3"]
    full_log, cut_log, resume_log = [], [], []
    full, cfg_full = _trainer(tmp_path / "full", extra, log=full_log)
    full.fit(max_steps=10)
    cut, cfg_cut = _trainer(tmp_path / "cut", extra, log=cut_log)
    cut.fit(max_steps=6)
    resumed, _ = _trainer(tmp_path / "cut", extra, log=resume_log)
    state = resumed.init_state()
    assert state.step == 6
    state = resumed.fit(state, max_steps=10)
    assert state.step == 10
    # the logs record fetch order; the loader reads ahead of the steps
    assert cut_log[:6] + resume_log[:4] == full_log[:10]
    assert full_log[0][0][0] == 0 and full_log[9][0][0] == 2 and resume_log[0] == full_log[6]
    losses = lambda cfg: {r["step"]: r["loss/train_avg"] for r in _records(cfg) if "loss/train_avg" in r}  # noqa: E731
    full_l, cut_l = losses(cfg_full), losses(cfg_cut)
    assert set(full_l) == set(cut_l) == set(range(1, 11))
    assert all(full_l[s] == cut_l[s] for s in range(1, 11)), (full_l, cut_l)


def test_monitored_best_and_its_resume(tmp_path):
    """trainer.monitor exports the best step's weights (reference format,
    read by restore_params) and best.json survives a new Trainer."""
    snapshots, vals = {}, iter([5.0, 3.0, 4.0])

    def val_fn(state):
        snapshots[state.step] = state.unet.init_conv.weight.detach().clone()
        return {"top1": next(vals)}

    extra = ["model.optim_config.ema_decay=0.0", "trainer.monitor=top1", "trainer.val_check_interval=1",
             "trainer.checkpoint_every_n_steps=2"]
    tr, cfg = _trainer(tmp_path, extra, val_fn=val_fn)
    tr.fit(max_steps=3)
    best = json.load(open(osp.join(cfg.save_dir, "checkpoints", "best.json")))
    assert best == {"value": 3.0, "step": 2, "stream": "inst", "monitor": "top1"}
    probe, _ = _trainer(tmp_path / "probe")
    checkpoint.restore_params(osp.join(cfg.save_dir, "checkpoints", "best.pth"), probe.task)
    assert torch.equal(probe.task.unet.init_conv.weight, snapshots[2])
    assert not torch.equal(probe.task.unet.init_conv.weight, snapshots[3])

    tr2, _ = _trainer(tmp_path, extra, val_fn=lambda s: {"top1": 99.0})
    assert tr2._best["value"] == 3.0 and tr2._best["step"] == 2
    st = tr2.init_state(resume=False)
    tr2._update_best(9, [("inst", st, {"top1": 9.0})])
    assert tr2._best["step"] == 2
    tr2._update_best(9, [("inst", st, {"top1": 1.0})])
    assert tr2._best["step"] == 9


def test_ema_stream_validated_checkpointed_and_resumed(tmp_path):
    calls = iter([5.0, 4.0, 3.0, 2.0])  # step 1: inst, ema; step 2: inst, ema
    extra = ["model.optim_config.ema_decay=0.5", "trainer.monitor=top1", "trainer.val_check_interval=1",
             "trainer.checkpoint_every_n_steps=2"]
    tr, cfg = _trainer(tmp_path, extra, val_fn=lambda s: {"top1": next(calls)})
    state = tr.fit(max_steps=2)
    assert any("val_ema/top1" in r for r in _records(cfg))
    best = json.load(open(osp.join(cfg.save_dir, "checkpoints", "best.json")))
    assert best["stream"] == "ema" and best["value"] == 2.0
    d = max(float((a - b).abs().max()) for a, b in zip(tr.ema_params.state_dict().values(), state.unet.state_dict().values()))
    assert d > 0.0  # the EMA lags the weights
    saved = copy.deepcopy(tr.ema_params.state_dict())
    tr2, _ = _trainer(tmp_path, extra, val_fn=lambda s: {"top1": 1.0})
    st2 = tr2.init_state()
    assert st2.step == 2
    for k, v in tr2.ema_params.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert all(not p.requires_grad for p in tr2.ema_params.parameters())


@pytest.mark.parametrize("log_every", [1, 2])
def test_steps_per_sec_divides_by_the_steps_taken(tmp_path, monkeypatch, log_every):
    """Each step takes 1 s of a fake clock: every logged window reads 1
    step/s.  (The JAX trainer's first window divides by log_every_n_steps
    though it spans one step less.)"""
    clock = [0.0]
    monkeypatch.setattr(trainer_mod.time, "perf_counter", lambda: clock[0])
    tr, cfg = _trainer(tmp_path, [f"trainer.log_every_n_steps={log_every}", "trainer.checkpoint_every_n_steps=100"])
    inner = tr.train_step

    def timed_step(state, batches):
        clock[0] += 1.0
        return inner(state, batches)

    tr.train_step = timed_step
    tr.fit(max_steps=6)
    rates = [r["steps_per_sec"] for r in _records(cfg) if "steps_per_sec" in r]
    assert len(rates) == 6 // log_every and rates == [1.0] * len(rates)


def test_media_grid_is_written(tmp_path):
    tr, cfg = _trainer(tmp_path, ["trainer.media_every_n_steps=1", "trainer.checkpoint_every_n_steps=100"])
    tr.fit(max_steps=1)
    assert osp.isfile(osp.join(cfg.save_dir, "media", "reconst_step1_rank0.png"))


@pytest.mark.parametrize("override", ["machine.mesh_data=2", "machine.mesh_template=2", "machine.zero1=true"])
def test_more_than_one_device_names_the_roadmap_item(tmp_path, override):
    with pytest.raises(NotImplementedError, match="item 12"):
        _trainer(tmp_path, [override])
