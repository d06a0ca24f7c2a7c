"""Dataset readers (ShapeNet, BOP, Objaverse) and the input pipeline (``nope_tpu/data``)."""

from nope_tpu_torch.data.pipeline import (  # noqa: F401
    CombinedLoader,
    ConcatDataset,
    DataLoader,
)
