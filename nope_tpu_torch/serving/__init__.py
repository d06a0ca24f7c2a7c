"""Object-centric serving."""

from nope_tpu_torch.serving.engine import PoseEstimate, PoseEstimator  # noqa: F401
