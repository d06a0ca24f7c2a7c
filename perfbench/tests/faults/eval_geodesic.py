"""Faults of the evaluation generator (``generators/eval_geodesic.py``):
an answer altered where the step produces it, the top-k reordered, half
of the batch left out of the loss."""


def _eval_answer_altered(monkeypatch):
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask

    step = PoseConditionalTask.eval_geodesic_step

    def altered(self, batch, **kwargs):
        out = step(self, batch, **kwargs)
        out["similarity"] = out["similarity"].roll(1, dims=1)
        return out

    monkeypatch.setattr(PoseConditionalTask, "eval_geodesic_step", altered)


def _eval_half_batch(monkeypatch):
    from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask

    loss = PoseConditionalTask.forward_loss
    monkeypatch.setattr(PoseConditionalTask, "forward_loss",
                        lambda self, q, r, rel: loss(self, q[:len(q) // 2], r[:len(r) // 2], rel[:len(rel) // 2]))


def _eval_topk_altered(monkeypatch):
    from nope_tpu_torch.ops import similarity
    from nope_tpu_torch.tasks import pose_conditional

    top_k = similarity.top_k
    for module in (similarity, pose_conditional):
        monkeypatch.setattr(module, "top_k", lambda sim, k: top_k(sim, k).flip(-1))


FAULTS = [_eval_answer_altered, _eval_topk_altered, _eval_half_batch]
