"""Small sizes of the benchmark's configurations and mixes, for the CPU."""

from __future__ import annotations

from perfbench import harness

UNET = {
    "vae_base": {"u_net_dim": 16, "dim_mults": [1, 2]},
    "vae_cin_ldm": {"model_channels": 32, "num_res_blocks": 1, "attention_resolutions": [2, 1],
                    "channel_mult": [1, 2], "num_head_channels": 16, "context_dim": 24},
}


def config(name: str) -> dict:
    """The configuration at small widths, served in float32, so that a
    sound run reads far inside every limit (set at full width) and only the
    control and the planted faults come near them."""
    cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    cfg["task"]["half_precision_eval"] = False
    cfg["unet"]["args"].update(UNET[name])
    cfg["vae"]["args"].update(block_out_channels=[8, 8, 8, 8], layers_per_block=1, groups=4)
    cfg["img_size"] = 32
    return cfg


#: small sizes of each generator's mixes
MIX = {
    "perfbench.generators.eval_geodesic:run": {"batch": 4, "pool": 2},
    "perfbench.generators.serve_open_loop:run": {"gallery": 4, "register_group": 2, "batch_max": 4, "schedule": 20,
                                                 "image_pool": 8, "check_queries": 4, "rate": 20.0},
}


def mix(workload: str) -> dict:
    m = harness.load_json(harness.cell_files(harness.spec(), workload)["mix"])
    return dict(m, **MIX[m["generator"]])


def run(workload: str, seed: int = 2**31 + 11, seconds: float = 1.0) -> dict:
    import time

    import torch

    return harness.run_cell(workload, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                            cfg=config(config_of(workload)), mix=mix(workload))


def config_of(workload: str) -> str:
    return harness.cell_files(harness.spec(), workload)["cell"]["config"]
