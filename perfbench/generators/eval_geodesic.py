"""The evaluation generator: ``evaluation/geodesic.evaluate_geodesic``
over a loader of seeded batches.

Its mix's parameters: ``protocol`` ("full" or "fast"), ``batch`` queries
each with its own reference, ``chunk_size`` templates a forward (null: the
bank whole), ``pool`` seeded batches cycled, ``check_rows`` rows judged,
``trace_seconds`` profiled.

``eval_img_per_s``: query images of the window's whole steps over their
time.  The window opens when the call's second batch is pulled, so the
bf16 copy that every ``evaluate_geodesic`` call makes and its first step
(which packs and plans every kernel) are set-up; it closes when the
first batch past ``--seconds`` is pulled, after a step's results are on
the host.
"""

from __future__ import annotations

import time

from perfbench import check, inputs, work
from perfbench.harness import Outcome


def model_flops(cfg: dict, unet_items: int, encodes: int) -> float:
    """Counted FLOPs of ``unet_items`` U-Net items and ``encodes`` VAE
    encodes, over the reference's modules on the meta device."""
    mods = inputs.meta_modules(cfg, "reference")
    latent = cfg["img_size"] // 2 ** (len(cfg["vae"]["args"]["block_out_channels"]) - 1)
    per_item = work.unet_flops_per_item(mods["unet"], cfg["vae"]["args"]["latent_channels"], latent)
    per_image = work.encode_flops_per_image(mods["vae"], cfg["img_size"])
    return unet_items * per_item + encodes * per_image


def run(run) -> Outcome:
    from nope_tpu_torch.evaluation.geodesic import evaluate_geodesic

    mix, cfg = run.mix, run.cfg
    grid = inputs.template_grid(mix["protocol"])
    b, n_pool, chunk = mix["batch"], mix["pool"], mix.get("chunk_size")
    pool = [inputs.eval_batch(grid, b, cfg["img_size"], inputs.rng(run.seed, 1, i)) for i in range(n_pool)]
    task = run.program()
    outputs = []
    step = task.eval_geodesic_step

    def recorded(batch, **kwargs):
        out = step(batch, **kwargs)
        outputs.append({k: out[k] for k in ("loss", "similarity", "nearest_idx", "errors_topk")})
        return out

    task.eval_geodesic_step = recorded
    marks = []

    def loader():
        i = 0
        while True:
            if i:
                marks.append(run.open_window() if i == 1 else time.perf_counter())
                run.profile_at(marks[-1], first_step_done=True)
                if i > 1 and marks[-1] >= marks[0] + run.seconds:
                    return
            yield pool[i % n_pool]
            i += 1

    evaluate_geodesic(task, loader(), chunk_size=chunk)
    run.close_window()
    steps, seconds = len(marks) - 1, marks[-1] - marks[0]
    n = len(grid)
    outputs = [{k: v.cpu().numpy() for k, v in o.items()} for o in outputs]  # [0] is the set-up step's
    del task, step
    flops = model_flops(cfg, steps * b * (n + 1), steps * 4 * b) if run.spans else None
    window = {"seconds": seconds, "steps": steps, "model_flops": flops}
    gen = inputs.rng(run.seed, 9)
    rows = [(int(s), int(r)) for s, r in zip(gen.integers(1, steps + 1, mix["check_rows"]),
                                              gen.integers(0, b, mix["check_rows"]))]
    loss_step = int(gen.integers(1, steps + 1))
    k = int(cfg["task"]["retrieval_k"])

    def judge(side, stand_in=None):
        readings = []
        for s, r in rows:
            batch = pool[s % n_pool]
            args = (batch["reference"][r], batch["query"][r], batch["all_relativeR"][r])
            want = side.similarity_row(*args).cpu().numpy()
            stated = side.stated().similarity_row(*args).cpu().numpy()
            if stand_in is None:
                sim, errors = outputs[s]["similarity"][r], outputs[s]["errors_topk"][r]
            else:
                sim = stand_in.similarity_row(*args).cpu().numpy()
                errors = check.control_errors(stand_in, sim, grid, batch["query_pose"][r], batch["symmetry"][r], k)
            readings.append({"sim_ratio": check.sim_ratio(sim, want, stated),
                             "geo_cos": check.geo_gap(sim, errors, grid, batch["query_pose"][r],
                                                      batch["symmetry"][r], k)})
        batch = pool[loss_step % n_pool]
        got = float(outputs[loss_step]["loss"]) if stand_in is None else stand_in.eval_loss(batch)
        want = side.eval_loss(batch)
        readings.append({"loss_rel": abs(got - want) / abs(want)})
        return check.worst(readings)

    return Outcome({"eval_img_per_s": steps * b / seconds}, steps * b, 0, window, judge)
