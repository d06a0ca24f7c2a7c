"""The serving generator: an open loop through
``serving/engine.PoseEstimator``.

Its mix's parameters: ``gallery`` objects registered at set-up,
``register_group`` a call; then ``schedule`` calls a cycle arriving at
``rate`` a second (Poisson, in an order fixed by ``order_seed``), one in
``1/register_share`` registering a new object, the rest estimating
``batch_min``..``batch_max`` queries (evenly) from an ``image_pool`` of
images, on objects drawn Zipf(``zipf_s``) over the gallery as it stands;
``check_queries`` served queries judged, half on objects registered in
the window; ``trace_seconds`` profiled.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from perfbench import check, inputs
from perfbench.harness import Outcome


def schedule(mix: dict) -> tuple:
    """One cycle of calls and of the gaps between their arrivals:
    ``register_share`` of the calls registrations, the rest estimates whose
    batch sizes run evenly over [batch_min, batch_max]; the gaps the
    quantiles of an exponential of mean 1/``rate`` (Poisson arrivals), in
    an order drawn from the mix's ``order_seed``.  The order is not the
    run's seed's: at this load the queue's tail depends on the order far
    more than on anything else a seed changes, so every seed offers the
    same arrivals and sizes, and the seed draws the content."""
    gen = inputs.rng(mix["order_seed"])
    calls = mix["schedule"]
    regs = round(calls * mix["register_share"])
    sizes = np.arange(mix["batch_min"], mix["batch_max"] + 1)
    plan = [0] * regs + list(np.resize(sizes, calls - regs))
    gaps = -np.log1p(-(np.arange(calls) + 0.5) / calls) / mix["rate"]
    return [int(x) for x in gen.permutation(plan)], gen.permutation(gaps)


def run(run) -> Outcome:
    """Calls are served one at a time in arrival order, estimates on
    objects drawn newest first.  A call's latency runs from when it was
    due, so a stall's wait counts in the calls behind it, to its answer on
    the host (a registration: its bank on the device).  Every call due
    before the window closes is served."""
    from nope_tpu_torch.serving.engine import PoseEstimator

    mix, cfg, img = run.mix, run.cfg, run.cfg["img_size"]
    grid = inputs.template_grid("full")
    rel6 = inputs.rotation_6d(grid @ grid[0].T)
    pool = inputs.images(inputs.rng(run.seed, 3), mix["image_pool"], img)

    def object_image(j):
        return inputs.images(inputs.rng(run.seed, 4, j), 1, img)[0]

    plan, gaps = schedule(mix)
    gen = inputs.rng(run.seed, 6)
    task = run.program()
    est = PoseEstimator(task, level=2, pose_distribution="upper")
    if not np.allclose(est.template_poses, grid):
        raise RuntimeError("the estimator's grid is not the level-2 upper grid")
    gallery = []
    group = mix["register_group"]
    for g in range(0, mix["gallery"], group):
        ids = list(range(g, min(g + group, mix["gallery"])))
        est.register_objects([f"o{j}" for j in ids], np.stack([object_image(j) for j in ids]))
        gallery += ids

    def draw(b):
        """b objects Zipf over the gallery, newest first, and b consecutive
        query images of the pool (a view: the client sends them as they are)."""
        cdf = np.cumsum(np.arange(1, len(gallery) + 1, dtype=np.float64) ** -mix["zipf_s"])
        cdf /= cdf[-1]
        picks = np.searchsorted(cdf, gen.random(b))
        first = int(gen.integers(0, len(pool) - b + 1))
        return [gallery[-1 - int(p)] for p in picks], np.arange(first, first + b)

    est.register_object("warm", inputs.images(inputs.rng(run.seed, 7), 1, img)[0])
    run.sync()
    est.deregister_object("warm")
    for b in range(mix["batch_min"], mix["batch_max"] + 1):
        objs, q = draw(b)
        est.estimate_many([f"o{j}" for j in objs], pool[q])
    run.sync()

    est_ms, reg_ms, waits_ms, answers, failed, fresh = [], [], [], [], 0, []
    t0 = run.open_window()
    deadline, due, i = t0 + run.seconds, t0, 0
    while due < deadline:
        b = plan[i % len(plan)]
        if b == 0:
            j = mix["gallery"] + len(fresh)
            image = object_image(j)
        else:
            objs, q = draw(b)
            ids, queries = [f"o{j}" for j in objs], pool[q[0]:q[-1] + 1]
        now = time.perf_counter()
        run.profile_at(now, first_step_done=now >= t0 + 1.0)
        if now < due:
            with torch.profiler.record_function("serve.idle_until_arrival"):
                time.sleep(due - now)
        waits_ms.append(1e3 * (time.perf_counter() - due))
        try:
            if b == 0:
                with torch.profiler.record_function("serve.register_object"):
                    est.register_object(f"o{j}", image)
                    run.sync()
                reg_ms.append(1e3 * (time.perf_counter() - due))
                gallery.append(j)
                fresh.append(j)
            else:
                with torch.profiler.record_function("serve.estimate_many"):
                    res = est.estimate_many(ids, queries)
                est_ms.append(1e3 * (time.perf_counter() - due))
                answers.append((objs, q, res))
        except Exception:  # a failed call counts against the run and the run goes on
            if not failed:
                traceback.print_exc(file=sys.stderr)
            failed += 1
        due += gaps[i % len(gaps)]
        i += 1
    run.close_window()
    seconds = time.perf_counter() - t0
    del est, task
    window = {"seconds": seconds, "calls": i, "queue_wait_ms": waits_ms}
    gen_check = inputs.rng(run.seed, 9)
    flat = [(a, r) for a in range(len(answers)) for r in range(len(answers[a][0]))]
    fresh_ids = set(fresh)
    on_fresh = [x for x in flat if answers[x[0]][0][x[1]] in fresh_ids]
    picks = [on_fresh[p] for p in gen_check.permutation(len(on_fresh))[:mix["check_queries"] // 2]]
    picked = set(picks)
    rest = [x for x in flat if x not in picked]
    picks += [rest[p] for p in gen_check.permutation(len(rest))[:mix["check_queries"] - len(picks)]]
    k = int(cfg["task"]["retrieval_k"])

    def judge(side, stand_in=None):
        readings = []
        for a, r in picks:
            objs, q, res = answers[a]
            args = (object_image(objs[r]), pool[q[r]], rel6)
            want = side.similarity_row(*args).cpu().numpy()
            stated = side.stated().similarity_row(*args).cpu().numpy()
            if stand_in is None:
                sim, rotations, relative = res.similarity[r], res.rotations[r], res.relative_rotations[r]
            else:
                sim = stand_in.similarity_row(*args).cpu().numpy()
                rotations = stand_in.rotations(grid[check.ref.top_k(torch.from_numpy(sim), k).numpy()])
                relative = stand_in.rotations(rotations @ stand_in.rotations(grid[0].T.copy()))
            exact = grid[check.ref.top_k(torch.from_numpy(sim), k).numpy()]  # the served row's own top-k
            readings.append({"sim_ratio": check.sim_ratio(sim, want, stated),
                             "rot_err": float(max(np.max(np.abs(rotations - exact)),
                                                  np.max(np.abs(relative - exact @ grid[0].T))))})
        return check.worst(readings)

    metrics = {}
    if est_ms:
        metrics["estimate_p95_ms"] = float(np.percentile(est_ms, 95))
    if reg_ms:
        metrics["register_p95_ms"] = float(np.percentile(reg_ms, 95))
    return Outcome(metrics, i, failed, window, judge)
