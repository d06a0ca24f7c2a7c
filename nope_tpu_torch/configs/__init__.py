"""Dataclass config tree with YAML loading and dotted CLI overrides
(``nope_tpu/configs``)."""

from nope_tpu_torch.configs.config import (  # noqa: F401
    DataConfig,
    ExperimentConfig,
    MachineConfig,
    ModelConfig,
    OptimConfig,
    TestingConfig,
    TrainerConfig,
    apply_overrides,
    load_config,
)
