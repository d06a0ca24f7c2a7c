"""Experiment configuration dataclasses + YAML/CLI loading
(``nope_tpu/configs/config.py``, the same tree, keys and defaults).

The port reads the repo's YAML files (``configs/``) by path.  ``yaml``
is imported only when a file is read, so ``load_config(None,
overrides)`` needs no PyYAML.  Training, data and machine fields are
carried for the CLIs that read them; the port reads ``model``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# leaves (mirroring configs/model/vae_base.yaml & friends)
# ---------------------------------------------------------------------------


@dataclass
class OptimConfig:
    """configs/model/*.yaml optim_config + model.py:70-94."""

    optim_name: str = "AdamW"
    loss_type: str = "l1"
    lr: float = 5e-5
    weight_decay: float = 5e-4
    warm_up_steps: int = 500
    use_inv_deltaR: bool = True
    milestones_epochs: Tuple[int, ...] = (10, 30, 50, 100)
    gamma: float = 0.5
    # bf16 forward+backward with f32 master weights and AdamW state
    half_precision_train: bool = False
    # global-norm gradient clipping; 0 = off (the reference recipe has none)
    clip_grad_norm: float = 0.0
    # parameter EMA decay; 0 = off (the reference recipe never calls its EMA)
    ema_decay: float = 0.0
    # >0: skip optimizer steps whose raw gradient global norm exceeds
    # this factor times its running average
    skip_spike_factor: float = 0.0


@dataclass
class TestingConfig:
    similarity_metric: str = "l2"  # the reference quirk metric
    retrieval_k: int = 5
    fast_evaluation: bool = True
    half_precision_eval: bool = True  # bf16 bank + retrieval


@dataclass
class UNetConfig:
    """Network selection: variant in {vae_base, vae_cin_ldm,
    vae_guidedDiffusion, template_base} (configs/model/)."""

    variant: str = "vae_base"
    u_net_dim: int = 192
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    rot_representation_dim: int = 6
    pose_mlp_name: str = "single_layer"
    resnet_block_groups: int = 8
    double_bottleneck: bool = True  # reference quirk (u_net.py:177-183)
    pretrained_path: Optional[str] = None
    # LDM-variant knobs (configs/model/vae_cin_ldm.yaml)
    model_channels: int = 256
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_head_channels: int = 32
    context_dim: int = 512
    transformer_depth: int = 1
    injecting_condition_twice: bool = False
    # guided-diffusion knobs (configs/model/vae_guidedDiffusion.yaml); the
    # ADM's head width is num_head_channels above, the LDM's 32 by default:
    # configs/model_adm.yaml sets the published 64
    gd_channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    gd_attention_resolutions: Tuple[int, ...] = (32, 16, 8)
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    num_heads: int = 4


@dataclass
class EncoderConfig:
    """Frozen feature encoder: SD-VAE (default) or the ResNet-50
    template encoder (configs/model/template_base.yaml)."""

    kind: str = "vae"  # vae | template | template_tiny
    pretrained_path: Optional[str] = None
    latent_dim: int = 4
    using_KL: bool = False
    # VAE architecture (SD v1-5 defaults; shrink for tests)
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    # template-encoder knobs
    descriptor_size: int = 8
    threshold: float = 0.2
    normalize: bool = False


@dataclass
class ModelConfig:
    u_net: UNetConfig = field(default_factory=UNetConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    optim_config: OptimConfig = field(default_factory=OptimConfig)
    testing_config: TestingConfig = field(default_factory=TestingConfig)
    checkpoint_path: Optional[str] = None
    img_size: int = 256


@dataclass
class TrainerConfig:
    """configs/machine/trainer/*.yaml equivalents."""

    max_epochs: int = 1000
    max_steps: Optional[int] = None
    val_check_interval: int = 2000
    checkpoint_every_n_steps: int = 100
    keep_checkpoints: Optional[int] = None  # None == keep all (save_top_k=-1)
    log_every_n_steps: int = 1
    num_sanity_val_steps: int = 2
    media_every_n_steps: int = 1000  # reconstruction grids (0 = off)
    seed: int = 2022
    # monitored best-checkpoint selection (the reference's
    # ModelCheckpoint monitor/mode knobs, configs/callback/checkpoint/
    # base.yaml:5-7): when set to a key of the val_fn score dict, every
    # validation pass that improves it exports a params-only snapshot to
    # <save_dir>/checkpoints/best (+ best.json metadata).  With EMA on,
    # both the instantaneous and EMA streams compete for "best".
    monitor: str = ""
    monitor_mode: str = "min"  # "min" (errors) or "max" (accuracies)


@dataclass
class MachineConfig:
    name: str = "local"
    batch_size: int = 16
    num_workers: int = 10
    # input stack: "threads" (thread-prefetched loader) or "grain" (process workers)
    loader: str = "threads"
    root_dir: str = "."
    dryrun: bool = True
    # mesh axes; data=None -> all devices
    mesh_data: Optional[int] = None
    mesh_template: int = 1
    # ZeRO-1: shard AdamW moments over the data axis (params stay replicated)
    zero1: bool = False


@dataclass
class DatasetConfig:
    name: str = "shapeNet"
    root_dir: str = ""
    split: Optional[str] = None
    img_size: int = 256
    rot_representation: str = "rotation6d"
    pose_distribution: str = "upper"
    fast_evaluation: bool = True
    load_gt_templates: bool = False  # template images for visualization only
    native_preprocess: bool = False  # C++ fused batch composite+warp (training)
    # training-item image wire format: "float32" (normalised to [-1, 1] on
    # the host) or "uint8" (raw crops, normalised on the device)
    wire_dtype: str = "float32"
    # cache decoded and cropped views in host RAM (uint8); for roots that fit
    cache_crops: bool = False
    # BOP extras
    template_dir: Optional[str] = None
    obj_ids: Optional[str] = None
    reset_metaData: bool = False
    # acquisition metadata (reference configs/data/*.yaml `source:`
    # blocks): url/cad_url direct-download archives, http flag (False =
    # non-direct link needing manual/gdrive download), unzip_mode,
    # processing hint — consumed by scripts.download_datasets
    source: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataConfig:
    datasets: Dict[str, DatasetConfig] = field(default_factory=dict)


@dataclass
class UserConfig:
    """configs/user/default.yaml: W&B identity + storage roots.  W&B is
    optional — when unset (or wandb is not installed) metrics flow to
    the JSONL/TensorBoard sinks only."""

    wandb_api_key: Optional[str] = None
    wandb_project_name: Optional[str] = None
    local_root_dir: str = "."
    slurm_root_dir: Optional[str] = None


@dataclass
class ExperimentConfig:
    name_exp: str = "train"
    save_dir: str = "./results"
    train_data_name: List[str] = field(default_factory=lambda: ["shapeNet"])
    test_data_name: List[str] = field(default_factory=lambda: ["shapeNet"])
    use_pretrained: bool = True
    user: UserConfig = field(default_factory=UserConfig)
    machine: MachineConfig = field(default_factory=MachineConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)


# ---------------------------------------------------------------------------
# loading / overrides
# ---------------------------------------------------------------------------


def _coerce(value: str, target_type: Any):
    if target_type is bool or isinstance(target_type, bool):
        return str(value).lower() in ("1", "true", "yes")
    for cast in (int, float):
        try:
            return cast(value)
        except (TypeError, ValueError):
            pass
    if isinstance(value, str) and "," in value:
        return tuple(_coerce(v, None) for v in value.split(","))
    if value in ("null", "None", ""):
        return None
    return value


def _from_dict(cls, data: Dict[str, Any]):
    if not dataclasses.is_dataclass(cls):
        return data
    defaults = cls()
    kwargs: Dict[str, Any] = {}
    field_names = {f.name for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in field_names:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        current = getattr(defaults, key)
        if key == "datasets" and isinstance(value, dict):
            kwargs[key] = {
                name: _from_dict(DatasetConfig, v) for name, v in value.items()
            }
        elif dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _from_dict(type(current), value)
        elif isinstance(current, tuple) and isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def apply_overrides(cfg: ExperimentConfig, overrides: List[str]) -> ExperimentConfig:
    """``a.b.c=value`` dotted overrides (the Hydra CLI idiom)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        key, value = ov.split("=", 1)
        parts = key.split(".")
        obj = cfg
        for i, p in enumerate(parts[:-1]):
            if isinstance(obj, dict):
                if p not in obj and i > 0 and parts[i - 1] == "datasets":
                    # "data.datasets.<name>.field=..." creates the
                    # dataset entry on the fly — the documented CLI
                    # idiom works without a --config file declaring it.
                    # Warn loudly: a typo'd dataset name would otherwise
                    # surface much later as an unrelated loader error.
                    logging.warning(
                        "override %r creates NEW dataset entry %r "
                        "(known: %s) — check for typos", ov, p,
                        sorted(obj) or "none",
                    )
                    obj[p] = DatasetConfig(name=p)
                obj = obj[p]
            else:
                obj = getattr(obj, p)
        last = parts[-1]
        if isinstance(obj, dict):
            obj[last] = _coerce(value, None)
            continue
        current = getattr(obj, last, None)
        if isinstance(current, bool):
            setattr(obj, last, str(value).lower() in ("1", "true", "yes"))
        elif isinstance(current, int) and not isinstance(current, bool):
            setattr(obj, last, int(value))
        elif isinstance(current, float):
            setattr(obj, last, float(value))
        elif isinstance(current, tuple):
            setattr(obj, last, tuple(_coerce(v, None) for v in value.split(",")))
        elif isinstance(current, list):
            setattr(obj, last, [v.strip() for v in value.split(",")])
        else:
            # untyped (None-default) fields: best-effort coercion
            setattr(obj, last, _coerce(value, None))
    return cfg


def _deep_merge(base: dict, over: dict) -> dict:
    """Recursive dict merge, ``over`` winning (the Hydra-defaults
    analogue for ``include:`` composition)."""
    out = dict(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def _load_yaml_tree(path: str) -> dict:
    """Load a YAML file, resolving its ``include: [...]`` list first
    (paths relative to the file; later includes and the file itself win).
    Replaces the reference's 30-file Hydra ``defaults`` composition."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    includes = data.pop("include", [])
    if isinstance(includes, str):
        includes = [includes]
    merged: dict = {}
    for inc in includes:
        inc_path = inc if os.path.isabs(inc) else os.path.join(os.path.dirname(path), inc)
        merged = _deep_merge(merged, _load_yaml_tree(inc_path))
    return _deep_merge(merged, data)


def _interpolate(node, variables: dict):
    """Substitute ``${var}`` occurrences in string leaves (the subset of
    OmegaConf interpolation the reference's data configs use:
    ``${machine.root_dir}``)."""
    if isinstance(node, dict):
        return {k: _interpolate(v, variables) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, variables) for v in node]
    if isinstance(node, str):
        for name, value in variables.items():
            node = node.replace("${" + name + "}", str(value))
        return node
    return node


def load_config(
    yaml_path: Optional[str] = None, overrides: Optional[List[str]] = None
) -> ExperimentConfig:
    overrides = list(overrides) if overrides else []
    if yaml_path is not None:
        data = _load_yaml_tree(yaml_path)
        # a machine.root_dir CLI override must win over the YAML value
        # BEFORE ${machine.root_dir} leaves are substituted (OmegaConf
        # resolves interpolation lazily; this is the eager equivalent)
        root = data.get("machine", {}).get("root_dir", MachineConfig().root_dir)
        for ov in overrides:
            if ov.startswith("machine.root_dir="):
                root = ov.split("=", 1)[1]
        data = _interpolate(data, {"machine.root_dir": root})
        cfg = _from_dict(ExperimentConfig, data)
    else:
        cfg = ExperimentConfig()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    cfg.save_dir = os.path.join(cfg.save_dir, cfg.name_exp)
    return cfg
