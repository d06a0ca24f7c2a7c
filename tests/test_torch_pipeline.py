"""The port's input pipeline (``nope_tpu_torch.data.pipeline``) against
``nope_tpu.data.pipeline`` on the same datasets: batch order for a seed
and an epoch, ``set_state`` of both loaders, ``ConcatDataset``, error
propagation and the shutdown of an abandoned iterator; and the port's
``data.builder`` for ShapeNet (the Objaverse and BOP branches against the
JAX builder on a ShapeNet root)."""

import threading
import time

import numpy as np
import pytest

from nope_tpu.data import pipeline as jp
from nope_tpu_torch.configs import load_config
from nope_tpu_torch.data import builder
from nope_tpu_torch.data import pipeline as pp


class EpochKeyedDataset:
    """Items depend on (epoch, index), as the readers' epoch-keyed
    reference-sampling streams (``ShapeNetDataset.set_epoch``)."""

    def __init__(self, n, offset=0.0):
        self.n, self.offset, self._epoch = n, offset, 0

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __getitem__(self, i):
        return {"x": np.asarray([1000.0 * self._epoch + i + self.offset], np.float32), "i": np.int64(i)}


def _batches(loader, epochs=1):
    return [[b["x"][:, 0].tolist() for b in loader] for _ in range(epochs)]


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("seed", [0, 5])
def test_dataloader_order_matches_jax(seed, shuffle, drop_last):
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=seed)
    got = pp.DataLoader(EpochKeyedDataset(10), **kw)
    want = jp.DataLoader(EpochKeyedDataset(10), **kw)
    assert len(got) == len(want)
    assert _batches(got, 3) == _batches(want, 3)  # three epochs: each reshuffles and re-keys


@pytest.mark.parametrize("epoch, offset", [(0, 0), (0, 2), (3, 1), (4, 0)])
def test_dataloader_set_state_matches_jax(epoch, offset):
    loaders = [m.DataLoader(EpochKeyedDataset(11), batch_size=3, num_workers=3, seed=2) for m in (pp, jp)]
    for loader in loaders:
        loader.set_state(epoch, offset)
    got, want = (_batches(loader, 2) for loader in loaders)
    assert got == want
    assert len(got[0]) == len(loaders[0]) - offset and len(got[1]) == len(loaders[0])


def _stream(combined, n_steps):
    out, it = [], iter(combined)
    while len(out) < n_steps:
        try:
            out.append(next(it))
        except StopIteration:
            it = iter(combined)
    return [{name: b["x"][:, 0].tolist() for name, b in step.items()} for step in out]


@pytest.mark.parametrize("resume_at", [0, 1, 3, 4, 5, 8, 11])
def test_combined_loader_set_state_matches_jax(resume_at):
    def build(m):
        return m.CombinedLoader({
            "big": m.DataLoader(EpochKeyedDataset(8), batch_size=2, num_workers=1, seed=5),
            "small": m.DataLoader(EpochKeyedDataset(3, offset=100.0), batch_size=2, num_workers=1, seed=9),
        })

    total = 13
    full = _stream(build(pp), total)
    assert full == _stream(build(jp), total)
    resumed, jax_resumed = build(pp), build(jp)
    resumed.set_state(resume_at)
    jax_resumed.set_state(resume_at)
    assert _stream(resumed, total - resume_at) == _stream(jax_resumed, total - resume_at) == full[resume_at:]


def test_concat_dataset_and_collate_match_jax():
    parts = [EpochKeyedDataset(3), EpochKeyedDataset(2, offset=10.0), EpochKeyedDataset(4, offset=20.0)]
    got, want = pp.ConcatDataset(parts), jp.ConcatDataset(parts)
    assert len(got) == len(want) == 9
    for i in range(9):
        np.testing.assert_array_equal(got[i]["x"], want[i]["x"])
    items = [got[i] for i in range(4)]
    for k, v in pp.collate(items).items():
        np.testing.assert_array_equal(v, jp.collate(items)[k])
    with pytest.raises(ValueError, match="0 batches"):
        len(pp.DataLoader(EpochKeyedDataset(2), batch_size=3))
    with pytest.raises(ValueError, match="no loaders"):
        pp.CombinedLoader({})


def test_worker_errors_reach_the_consumer():
    class Bad(EpochKeyedDataset):
        def __getitem__(self, i):
            if i == 5:
                raise RuntimeError("boom at 5")
            return super().__getitem__(i)

    loader = pp.DataLoader(Bad(8), batch_size=2, shuffle=False, num_workers=2)
    got = []
    with pytest.raises(RuntimeError, match="boom at 5"):
        for b in loader:
            got.append(b["i"].tolist())
    assert got == [[0, 1], [2, 3]]


def test_abandoned_iterator_stops_its_producer():
    """A consumer that stops early leaves no producer thread blocked on a
    full queue: ``stop`` is set when the generator closes, and the
    producer's ``offer`` gives up."""
    before = set(threading.enumerate())
    loader = pp.DataLoader(EpochKeyedDataset(200), batch_size=2, shuffle=False, num_workers=2, prefetch=1)
    it = iter(loader)
    next(it)
    time.sleep(0.3)  # the producer fills the queue and blocks in offer()
    it.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and set(threading.enumerate()) - before:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def _cfg(root, *overrides):
    return load_config(None, [f"data.datasets.shapeNet.root_dir={root}", "data.datasets.shapeNet.img_size=32",
                              "machine.batch_size=2", "machine.num_workers=2", *overrides])


def test_builder_shapenet_and_the_paths_that_wait(tmp_path):
    from tests.fixtures import make_mini_shapenet

    root = make_mini_shapenet(str(tmp_path / "root"), categories=("airplane",), objects_per_cat=1,
                              with_templates=False)
    val = builder.build_val_loaders(_cfg(root, "test_data_name=shapeNet"))["shapeNet"]
    assert val.dataset.split == "unseen_training" and len(val) == 1 and not val.shuffle
    batch = next(iter(val))
    assert batch["query"].shape == (2, 32, 32, 3) and batch["all_relativeR"].shape == (2, 26, 6)
    # the training split keeps cads[50:] of a category: a root of 51 airplanes
    # whose query files are only listed here (the loaders are built, not iterated)
    train_root = tmp_path / "train_root"
    (train_root / "images").mkdir(parents=True)
    (train_root / "cad_names.txt").write_text("".join(f"02691156_c{j}\n" for j in range(51)))
    for j in range(51):
        (train_root / "images" / f"obj_{j:06d}").mkdir()
        for q in range(2):
            (train_root / "images" / f"obj_{j:06d}" / f"query_{q:06d}.png").touch()
    train = builder.build_train_loaders(_cfg(train_root))["shapeNet"]
    assert train.dataset.split == "training" and len(train.dataset) == 2 and train.shuffle
    cfg = _cfg(train_root, "data.datasets.shapeNet.native_preprocess=true")
    assert isinstance(builder.build_train_loaders(cfg)["shapeNet"].dataset, builder.NativeCollateView)
    with pytest.raises(ValueError, match="mutually exclusive"):
        builder.build_train_loaders(_cfg(root, "data.datasets.shapeNet.native_preprocess=true",
                                         "data.datasets.shapeNet.wire_dtype=uint8"))
    with pytest.raises(ValueError, match="expected 'threads' or 'grain'"):
        builder.build_train_loaders(_cfg(root, "machine.loader=thread"))
    with pytest.raises(NotImplementedError, match="Not ported"):
        builder.build_train_loaders(_cfg(root, "machine.loader=grain"))
    # the Objaverse and BOP branches (tests/test_torch_data_bop.py) refuse this ShapeNet root as the
    # JAX builder does: no object with 10 renders and a group without members make no batch; no
    # single train split to detect
    from nope_tpu.configs import load_config as jax_load_config
    from nope_tpu.data import builder as jax_builder

    for names, expect in ((("objaverse", "bop_texture"), "yields 0 batches"),
                          (("tless", "bop"), "exactly one train/val split")):
        for name in names:
            ov = [f"data.datasets.{name}.root_dir={root}", f"train_data_name={name}"]
            for build, load in ((builder, load_config), (jax_builder, jax_load_config)):
                with pytest.raises(ValueError, match=expect):
                    build.build_train_loaders(load(None, ov))
    cfg = load_config(None, [f"data.datasets.shapeNet.root_dir={root}"])
    cfg.data.datasets["shapeNet"].name = "nope"
    with pytest.raises(ValueError, match="unknown dataset"):
        builder.build_dataset(cfg.data.datasets["shapeNet"])
