"""Import machinery for oracling against the ACTUAL reference source.

Round-1 parity tests compared against hand-rewritten torch oracles
(``tests/oracles/``); a hand-written oracle can encode the same
misreading twice.  This module lets tests import the real classes from
``/root/reference`` (``src/model/...``) by stubbing the handful of
dependencies that are not installed in this image:

- ``pytorch_lightning``  -> ``LightningModule = nn.Module`` + no-op log
- ``diffusers``          -> placeholder ``AutoencoderKL`` (import-only)
- ``pytorch3d.transforms`` -> a faithful torch ``so3_relative_angle``
  (trace formula + ``acos_linear_extrapolation`` with the 1e-4 cos
  bound — the documented pytorch3d semantics; ``eps`` only gates a
  validity assert there and is ignored here)
- ``einops_exts``        -> rearrange_many/repeat_many/check_shape
- ``torchvision``/``wandb``/``moviepy``/``trimesh``/``pyrender`` ->
  attribute sinks (only touched on visualization/VSD paths tests avoid)

Everything stubbed is *infrastructure*, never the math under test: the
forward passes, losses, LR recipes and retrieval scoring all execute the
reference's own lines.
"""

from __future__ import annotations

import sys
import types

import torch

REFERENCE_ROOT = "/root/reference"


# ---------------------------------------------------------------------------
# pytorch3d.transforms.so3_relative_angle (faithful torch reimplementation)
# ---------------------------------------------------------------------------

def _acos_linear_extrapolation(x: torch.Tensor, bounds) -> torch.Tensor:
    """pytorch3d ``acos_linear_extrapolation``: arccos inside
    [lower, upper], first-order Taylor extension outside."""
    lower, upper = bounds

    def dacos_dx(v: torch.Tensor) -> torch.Tensor:
        return -1.0 / torch.sqrt(1.0 - v * v)

    lo = torch.as_tensor(lower, dtype=x.dtype)
    up = torch.as_tensor(upper, dtype=x.dtype)
    x_mid = torch.clamp(x, lower, upper)
    acos_mid = torch.acos(x_mid)
    above = torch.acos(up) + (x - up) * dacos_dx(up)
    below = torch.acos(lo) + (x - lo) * dacos_dx(lo)
    return torch.where(x > up, above, torch.where(x < lo, below, acos_mid))


def so3_relative_angle(
    R1: torch.Tensor,
    R2: torch.Tensor,
    cos_angle: bool = False,
    cos_bound: float = 1e-4,
    eps: float = 1e-4,
) -> torch.Tensor:
    """pytorch3d ``so3_relative_angle``: angle of R1 @ R2^T via the trace
    formula.  ``eps`` gates a trace-validity assert in pytorch3d (no
    numeric effect for valid rotations) and is accepted but unused."""
    del eps
    R12 = torch.bmm(R1, R2.permute(0, 2, 1))
    rot_trace = R12[:, 0, 0] + R12[:, 1, 1] + R12[:, 2, 2]
    phi_cos = (rot_trace - 1.0) * 0.5
    if cos_angle:
        return phi_cos
    if cos_bound > 0.0:
        bound = 1.0 - cos_bound
        return _acos_linear_extrapolation(phi_cos, (-bound, bound))
    return torch.acos(phi_cos)


# ---------------------------------------------------------------------------
# stub modules
# ---------------------------------------------------------------------------

def _module(name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    sys.modules[name] = mod
    return mod


class _AttrSink:
    """Object that swallows any attribute/call (for wandb.Image etc.)."""

    def __getattr__(self, name):
        return _AttrSink()

    def __call__(self, *args, **kwargs):
        return _AttrSink()


def install() -> None:
    """Idempotently install dependency stubs and put ``/root/reference``
    on ``sys.path`` so ``import src.model...`` resolves to the actual
    reference source (namespace packages; the reference has no
    __init__.py files)."""
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)

    def _sink_getattr(attr):
        # dunders must miss honestly: inspect.getmodule reads __file__
        # off every sys.modules entry and chokes on a sink object
        if attr.startswith("__") and attr.endswith("__"):
            raise AttributeError(attr)
        return _AttrSink()

    if "pytorch_lightning" not in sys.modules:
        pl = _module("pytorch_lightning")

        class LightningModule(torch.nn.Module):
            # minimal Lightning surface the reference touches outside a
            # Trainer: hyperparameter capture and metric logging become
            # no-ops; rank/step default to single-process values.
            def save_hyperparameters(self, *args, **kwargs):
                pass

            def log(self, *args, **kwargs):
                pass

            @property
            def global_rank(self):
                return 0

            @property
            def global_step(self):
                return getattr(self, "_shim_global_step", 0)

            @property
            def logger(self):
                return _AttrSink()

            # real Lightning's DeviceDtypeModuleMixin surface: the LDM/ADM
            # UNetModels read self.dtype in forward (openaimodel.py)
            @property
            def dtype(self):
                return torch.float32

            @property
            def device(self):
                return torch.device("cpu")

        pl.LightningModule = LightningModule
        pl.seed_everything = lambda *a, **k: None

    if "diffusers" not in sys.modules:
        diffusers = _module("diffusers")

        class AutoencoderKL:  # imported at u_net.py:8 but never used in tests
            def __init__(self, *a, **k):
                raise RuntimeError("diffusers stub: not available in tests")

            from_config = classmethod(lambda cls, *a, **k: cls())

        diffusers.AutoencoderKL = AutoencoderKL

    if "pytorch3d" not in sys.modules:
        p3d = _module("pytorch3d")
        transforms = _module("pytorch3d.transforms")
        transforms.so3_relative_angle = so3_relative_angle
        transforms.acos_linear_extrapolation = _acos_linear_extrapolation

        def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
            # pytorch3d semantics: first two ROWS flattened
            # (rotation_conversions.py:490-503)
            return matrix[..., :2, :].reshape(*matrix.shape[:-2], 6)

        def _unused(name):
            def fn(*args, **kwargs):
                raise NotImplementedError(
                    f"pytorch3d.transforms.{name} stub: imported by the "
                    "reference dataloader but not exercised by parity tests"
                )

            return fn

        transforms.matrix_to_rotation_6d = matrix_to_rotation_6d
        transforms.matrix_to_quaternion = _unused("matrix_to_quaternion")
        transforms.matrix_to_euler_angles = _unused("matrix_to_euler_angles")
        p3d.transforms = transforms

    if "einops_exts" not in sys.modules:
        import einops

        ee = _module("einops_exts")

        def rearrange_many(tensors, pattern, **kwargs):
            return [einops.rearrange(t, pattern, **kwargs) for t in tensors]

        def repeat_many(tensors, pattern, **kwargs):
            return [einops.repeat(t, pattern, **kwargs) for t in tensors]

        def check_shape(tensor, pattern, **kwargs):
            return einops.rearrange(tensor, f"{pattern} -> {pattern}", **kwargs)

        ee.rearrange_many = rearrange_many
        ee.repeat_many = repeat_many
        ee.check_shape = check_shape

    if "torchvision" not in sys.modules:
        tv = _module("torchvision")
        tv.transforms = _module("torchvision.transforms")
        tv.transforms.__getattr__ = _sink_getattr
        tv.utils = _module("torchvision.utils")
        tv.utils.save_image = lambda *a, **k: None
        tv.utils.__getattr__ = _sink_getattr

    for name in ("wandb", "trimesh", "pyrender", "ruamel_yaml"):
        if name not in sys.modules:
            mod = _module(name)
            mod.__getattr__ = _sink_getattr
            if name == "trimesh":
                # trimesh_utils.as_mesh isinstance-checks these; they
                # must be real classes (a sink is not a type)
                mod.Scene = type("Scene", (), {})
                mod.Trimesh = type("Trimesh", (), {})
            if name == "ruamel_yaml":
                # inout.load_json parses with ruamel's yaml.load; the
                # files under test are plain JSON (a YAML subset)
                import json as _json

                mod.load = lambda f, Loader=None, **k: _json.load(f)

    if "omegaconf" not in sys.modules:
        oc = _module("omegaconf")
        listconfig = _module("omegaconf.listconfig")

        class ListConfig(list):
            pass

        listconfig.ListConfig = ListConfig
        oc.listconfig = listconfig
        oc.ListConfig = ListConfig

    if "moviepy" not in sys.modules:
        _module("moviepy")
        _module("moviepy.video")
        _module("moviepy.video.io")
        bindings = _module("moviepy.video.io.bindings")
        bindings.mplfig_to_npimage = lambda *a, **k: None

    try:
        _import_reference_modules()
    finally:  # also when the reference is missing: a leaked stub breaks later tests' import probes
        _purge_leaky_stubs()


# every reference module the parity tests touch, imported eagerly while
# the stubs are registered (cached under ``src.*`` afterwards)
_REFERENCE_MODULES = (
    "src.model.u_net.denoising_diffusion_pytorch.u_net",
    "src.model.loss",
    "src.poses.utils",
    "src.model.model",
    "src.model.u_net.ldm.adapt_openaimodel",
    "src.model.u_net.guided_diffusion.adapt_u_net",
    "src.model.u_net.guided_diffusion.u_net",
    "src.model.encoder.resnet",
    "src.model.encoder.base_template",
    "src.model.encoder.template",
    "src.model.utils",
    "src.utils.inout",
    "src.dataloader.shapeNet",
    "src.dataloader.bop",
    "src.dataloader.objaverse",
)

# stubs that must NOT stay importable: nope_tpu probes these with
# try/import to select optional code paths (e.g. utils/mesh.py), and a
# sink module masquerading as the real thing breaks those probes.
# pytorch_lightning/pytorch3d/einops_exts/omegaconf stay registered —
# nothing in nope_tpu imports them, and reference classes re-import
# omegaconf/SinusoidalPosEmb lazily at construction time.
_LEAKY_STUBS = (
    "trimesh",
    "pyrender",
    "wandb",
    "torchvision",
    "torchvision.transforms",
    "torchvision.utils",
    "ruamel_yaml",
    "diffusers",
    "moviepy",
    "moviepy.video",
    "moviepy.video.io",
    "moviepy.video.io.bindings",
)


def _import_reference_modules() -> None:
    import importlib

    for name in _REFERENCE_MODULES:
        importlib.import_module(name)


def _purge_leaky_stubs() -> None:
    for name in _LEAKY_STUBS:
        mod = sys.modules.get(name)
        if mod is not None and getattr(mod, "__loader__", None) is None:
            del sys.modules[name]
