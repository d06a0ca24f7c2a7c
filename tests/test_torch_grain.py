"""The port's grain input stack (``nope_tpu_torch.data.grain_pipeline``,
``machine.loader=grain``) against ``nope_tpu.data.grain_pipeline`` on the
same datasets: the batches of ``GrainLoader`` and ``make_grain_loader`` at
0 and 2 worker processes, ``set_state`` resume inside ``CombinedLoader``,
the partial tail of ``drop_last=False``, the builder's switch, the native
post-batch; and two gloo ranks (``parallel.launch.Ranks``): disjoint
record shards, and ``machine.batch_size`` the step's global batch under the
data-parallel ``Trainer`` (the counterpart of
``tests/test_multiprocess.py::test_two_process_grain_input_feeds_train_step``)."""

import numpy as np
import pytest

from nope_tpu.data import grain_pipeline as jgrain
from nope_tpu.data import pipeline as jp
from nope_tpu_torch.configs import load_config
from nope_tpu_torch.data import builder, grain_pipeline
from nope_tpu_torch.data import pipeline as pp
from nope_tpu_torch.data.grain_pipeline import GrainLoader
from nope_tpu_torch.data.pipeline import collate
from nope_tpu_torch.parallel.launch import Ranks
from tests.grain_datasets import EpochKeyedDataset, GrainPairs
from tests.torch_parallel_ranks import GRAIN_BATCH, GRAIN_RECORDS, GRAIN_STEPS, grain_fit, grain_rank


def _stream(loader, epochs=1):
    return [[b["x"][:, 0].tolist() for b in loader] for _ in range(epochs)]


@pytest.mark.parametrize("num_workers", [0, 2])
def test_grain_loader_matches_jax(num_workers):
    """Two epochs of batches equal JAX's GrainLoader's, for any worker
    count; fresh shuffles and set_epoch streams each epoch."""
    def build(mod):
        return mod.GrainLoader(EpochKeyedDataset(10), batch_size=2, num_workers=num_workers, seed=4)

    got, want = _stream(build(grain_pipeline), 2), _stream(build(jgrain), 2)
    assert got == want and len(build(grain_pipeline)) == len(build(jgrain)) == 5
    e0, e1 = got
    assert sorted(v for b in e0 for v in b) == [float(i) for i in range(10)]
    assert sorted(v for b in e1 for v in b) == [1000.0 + i for i in range(10)]
    assert e0 != [[v - 1000.0 for v in b] for b in e1]  # reshuffled
    resumed = build(grain_pipeline)
    resumed.set_state(1, 3)
    assert _stream(resumed) == [e1[3:]]
    ordered = GrainLoader(EpochKeyedDataset(10), batch_size=4, shuffle=False, num_workers=num_workers)
    assert _stream(ordered) == _stream(pp.DataLoader(EpochKeyedDataset(10), 4, shuffle=False, num_workers=2))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_make_grain_loader_matches_jax(num_workers):
    def batches(mod):
        loader = mod.make_grain_loader(EpochKeyedDataset(10), batch_size=4, seed=3, num_epochs=1,
                                       num_workers=num_workers, drop_remainder=False)
        return [(b["x"][:, 0].tolist(), b["i"].tolist()) for b in loader]

    got = batches(grain_pipeline)
    assert got == batches(jgrain)
    # grain's Batch runs in each worker: the partial tail is per worker
    assert [len(x) for x, _ in got] == ([4, 4, 2] if num_workers == 0 else [4, 4, 1, 1])
    assert sorted(i for _, ids in got for i in ids) == list(range(10))


def test_grain_loader_in_combined_loader_set_state():
    """The Trainer's deterministic resume through the grain path
    (CombinedLoader.set_state -> GrainLoader.set_state), stream for stream
    JAX's."""
    def build(mod, combined):
        return combined({
            "g": mod.GrainLoader(EpochKeyedDataset(8), batch_size=2, seed=2, shard_by_process=False),
            "s": mod.GrainLoader(EpochKeyedDataset(3), batch_size=2, seed=6, shard_by_process=False),
        })

    def stream(loader, n):  # n combined steps, over as many combined epochs as they take
        out = []
        while len(out) < n:
            for step in loader:
                out.append({k: b["x"][:, 0].tolist() for k, b in step.items()})
                if len(out) == n:
                    break
        return out

    full = stream(build(grain_pipeline, pp.CombinedLoader), 9)
    assert full == stream(build(jgrain, jp.CombinedLoader), 9)
    resumed = build(grain_pipeline, pp.CombinedLoader)
    resumed.set_state(6)
    assert stream(resumed, 3) == full[6:]


def test_grain_loader_drop_last_false_emits_partial_tail():
    def build(mod):
        return mod.GrainLoader(EpochKeyedDataset(10), batch_size=4, seed=4, drop_last=False, shard_by_process=False)

    loader = build(grain_pipeline)
    assert len(loader) == 3
    e0 = _stream(loader)[0]
    assert e0 == _stream(build(jgrain))[0] and [len(b) for b in e0] == [4, 4, 2]
    assert sorted(v for b in e0 for v in b) == [float(i) for i in range(10)]
    resumed = build(grain_pipeline)
    resumed.set_state(0, 2)
    assert _stream(resumed) == [e0[2:]]
    with pytest.raises(ValueError, match="yield 0 batches"):
        len(GrainLoader(EpochKeyedDataset(3), batch_size=4))


def test_shard_reads_the_part_of_the_global_batch():
    """``shard(index, count)`` (what the Trainer calls): record shard
    ``index`` of ``count``, ``batch_size / count`` records a batch; the
    parts of every batch are disjoint and together cover the epoch."""
    parts = []
    for index in range(2):
        loader = GrainLoader(EpochKeyedDataset(16), batch_size=4, seed=1).shard(index, 2)
        assert len(loader) == 4
        parts.append([b["i"].tolist() for b in loader])
    assert all(len(b) == 2 for p in parts for b in p)
    seen = [i for p in parts for b in p for i in b]
    assert sorted(seen) == list(range(16))
    with pytest.raises(ValueError, match="not divisible by the data mesh axis"):
        GrainLoader(EpochKeyedDataset(16), batch_size=3).shard(0, 2)
    whole = GrainLoader(EpochKeyedDataset(16), batch_size=4, seed=1)
    assert _stream(whole.shard(0, 1)) == _stream(GrainLoader(EpochKeyedDataset(16), batch_size=4, seed=1))


def test_builder_grain_switch(monkeypatch):
    """JAX's builder test on the port: machine.loader=grain swaps the
    training input stack through the config and the builder."""
    class Toy:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return {"x": np.full(3, float(i), np.float32)}

    monkeypatch.setattr(builder, "build_dataset", lambda cfg: Toy())
    cfg = load_config(None, ["machine.loader=grain", "machine.batch_size=2", "machine.num_workers=0",
                             "train_data_name=shapeNet", "data.datasets.shapeNet.name=shapeNet"])
    loader = builder.build_train_loaders(cfg)["shapeNet"]
    assert isinstance(loader, GrainLoader) and len(loader) == 4
    batches = list(loader)
    assert len(batches) == 4 and batches[0]["x"].shape == (2, 3)
    with pytest.raises(ValueError, match="machine.loader"):
        builder.build_train_loaders(load_config(None, ["machine.loader=Grain", "data.datasets.shapeNet.name=shapeNet"]))


def test_native_post_batch_matches_the_native_collate(tmp_path):
    """``native_preprocess`` under grain: the fused native preprocess runs
    on the collated raw items, the batch the thread loader's native
    collate makes (52 airplanes listed, the two of the training split
    written with their level-2 templates)."""
    from nope_tpu_torch.data.categories import SHAPENET_CAT2ID
    from nope_tpu_torch.data.shapenet import NativeCollateView, ShapeNetDataset
    from nope_tpu_torch.geometry import so3_grid
    from tests.fixtures import make_shapenet_object

    root = tmp_path / "root"
    root.mkdir()
    (root / "cad_names.txt").write_text("".join(f"{SHAPENET_CAT2ID['airplane']}_c{j}\n" for j in range(52)))
    class Probe(ShapeNetDataset):  # the split's object ids, without images
        def _load_metadata(self):
            self.selected = self._selected_object_ids()
            self.query_paths = []

    train_idx, _ = so3_grid.get_obj_poses_from_template_level(2, "upper", return_index=True)
    rng = np.random.default_rng(1)
    for obj_id in Probe(str(root), split="training").selected:
        make_shapenet_object(str(root), obj_id, rng, train_idx, img_px=64)
    ds = NativeCollateView(ShapeNetDataset(str(root), "training", img_size=32))
    assert len(ds) >= 4
    got = next(iter(GrainLoader(ds, 4, shuffle=False, num_workers=0,
                                post_batch_fn=grain_pipeline.make_native_post_batch(32))))
    want = next(iter(pp.DataLoader(ds, 4, shuffle=False, num_workers=2, collate_fn=pp.make_native_collate(32))))
    assert got.keys() == want.keys() and got["query"].shape == (4, 32, 32, 3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _FixedBatches:
    """A loader of given batches, of a given length (the LR schedule's epoch)."""

    def __init__(self, batches, length):
        self.batches, self.length = batches, length

    def __len__(self):
        return self.length

    def __iter__(self):
        return iter(self.batches)


def test_two_rank_grain_shards_and_global_batch(tmp_path):
    """Two gloo ranks: alone, each rank's GrainLoader (2 worker processes)
    reads a disjoint shard of 16 of the 32 records in batches of 4 (JAX's
    contract); under the data-parallel Trainer with machine.batch_size=8,
    each rank reads 4 records a step from its own shard, the parts are
    disjoint, and the step is one process's step over the 8 records: the
    same losses (rel 1e-5), and the same weights on both ranks."""
    ranks = Ranks(grain_rank, 2, (str(tmp_path),), timeout=300).join()
    assert all(r["foreign"] == [] for r in ranks)
    a, b = ([i for batch in r["alone"] for i in batch] for r in ranks)
    assert ranks[0]["alone_len"] == ranks[1]["alone_len"] == 4 and len(a) == len(b) == GRAIN_RECORDS // 2
    assert all(len(batch) == 4 for r in ranks for batch in r["alone"])
    assert not set(a) & set(b) and set(a) | set(b) == set(range(GRAIN_RECORDS))
    per_rank = GRAIN_BATCH // 2
    assert ranks[0]["steps_per_epoch"] == ranks[1]["steps_per_epoch"] == GRAIN_RECORDS // GRAIN_BATCH
    for p0, p1 in zip(ranks[0]["fetched"], ranks[1]["fetched"]):
        assert len(p0) == len(p1) == per_rank and not set(p0) & set(p1)
    assert len(ranks[0]["fetched"]) >= GRAIN_STEPS
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
    ds = GrainPairs()
    batches = []
    for p0, p1 in list(zip(ranks[0]["fetched"], ranks[1]["fetched"]))[:GRAIN_STEPS]:
        batch = collate([ds[i] for i in p0 + p1])
        batch.pop("_idx")
        batches.append(batch)
    losses, _, _ = grain_fit(str(tmp_path / "single"), _FixedBatches(batches, GRAIN_RECORDS // GRAIN_BATCH))
    assert len(losses) == GRAIN_STEPS
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
