"""Faults of the serving generator (``generators/serve_open_loop.py``):
a served row altered, the nearest templates reordered, registrations in
the window that change nothing."""


def _serve_answer_altered(monkeypatch):
    from nope_tpu_torch.serving.engine import PoseEstimator

    assemble = PoseEstimator._assemble
    monkeypatch.setattr(PoseEstimator, "_assemble",
                        lambda self, sim, idx, *a, **k: assemble(self, sim.roll(1, dims=1), idx, *a, **k))


def _serve_nearest_altered(monkeypatch):
    from nope_tpu_torch.serving.engine import PoseEstimator

    assemble = PoseEstimator._assemble
    monkeypatch.setattr(PoseEstimator, "_assemble",
                        lambda self, sim, idx, *a, **k: assemble(self, sim, idx.flip(1), *a, **k))


def _serve_state_unchanged(monkeypatch):
    from nope_tpu_torch.serving.engine import PoseEstimator

    register = PoseEstimator.register_objects

    def unchanged(self, ids, *args, **kwargs):
        if set(ids) <= {"o0", "o1", "o2", "o3"}:  # the set-up's gallery; later registrations change nothing
            register(self, ids, *args, **kwargs)

    monkeypatch.setattr(PoseEstimator, "register_objects", unchanged)


FAULTS = [_serve_answer_altered, _serve_nearest_altered, _serve_state_unchanged]
