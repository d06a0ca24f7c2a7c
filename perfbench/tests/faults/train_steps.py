"""Faults of the training generator (``generators/train_steps.py``): a
step that returns its state unchanged (the second optimizer step
skipped), the gradients halved where the optimizer takes them, half of
each batch left out of the loss (the mean taken over the rest), the
loader's crops shifted by a pixel where they are produced."""


def _train_step_skipped(monkeypatch):
    from nope_tpu_torch.training.optim import Optimizer

    step = Optimizer.step
    calls = []

    def skipped(self):
        calls.append(None)
        return False if len(calls) == 2 else step(self)

    monkeypatch.setattr(Optimizer, "step", skipped)


def _train_gradients_halved(monkeypatch):
    from nope_tpu_torch.training.optim import Optimizer

    step = Optimizer.step

    def halved(self):
        for p in self.params:
            if p.grad is not None:
                p.grad.mul_(0.5)
        return step(self)

    monkeypatch.setattr(Optimizer, "step", halved)


def _train_half_batch(monkeypatch):
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask

    loss = PoseConditionalTask.train_loss
    monkeypatch.setattr(PoseConditionalTask, "train_loss",
                        lambda self, batch: loss(self, {k: v[:len(v) // 2] for k, v in batch.items()}))


def _train_crop_shifted(monkeypatch):
    import numpy as np

    from nope_tpu_torch.data.shapenet import ShapeNetDataset

    crop = ShapeNetDataset._crop
    monkeypatch.setattr(ShapeNetDataset, "_crop", lambda self, img, pose: np.roll(crop(self, img, pose), 1, axis=1))


FAULTS = [_train_step_skipped, _train_gradients_halved, _train_half_batch, _train_crop_shifted]
