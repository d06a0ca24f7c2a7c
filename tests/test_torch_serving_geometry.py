"""The estimator's latent-geometry pin against ``nope_tpu``'s: a second
registration at another image size, and a registry written at another
geometry, raise the same ``ValueError`` in both packages; the pin
outlives deregistration in both."""

import jax
import numpy as np
import pytest
import torch

from nope_tpu.models.unet import PoseUNet as JaxPoseUNet
from nope_tpu.models.vae import StableDiffusionVAE as JaxVAE
from nope_tpu.serving import PoseEstimator as JaxPoseEstimator
from nope_tpu.tasks.pose_conditional import PoseConditionalTask as JaxTask
from nope_tpu.tasks.pose_conditional import TaskConfig as JaxTaskConfig
from nope_tpu_torch.serving import PoseEstimator
from nope_tpu_torch.tasks.pose_conditional import PoseConditionalTask, TaskConfig
from tests.torch_port_helpers import IMG, UNET, VAE, torch_unet, torch_vae

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tasks():
    jtask = JaxTask(JaxPoseUNet(**UNET), JaxVAE(**VAE), JaxTaskConfig(half_precision_eval=False))
    params = jtask.init(jax.random.key(5), image_size=IMG)
    port = PoseConditionalTask(torch_unet(params["unet"]), torch_vae(params["vae"]),
                               TaskConfig(half_precision_eval=False))
    return jtask, params, port


def _image(size, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (size, size, 3)).astype(np.float32)


def _both(tasks, **kw):
    jtask, params, port = tasks
    return JaxPoseEstimator(jtask, params, fast_evaluation=True, **kw), PoseEstimator(port, fast_evaluation=True, **kw)


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("bank_dtype", ["auto", "int8"])
def test_second_registration_at_another_geometry(tasks, bank_dtype):
    jest, est = _both(tasks, bank_dtype=bank_dtype)
    messages = []
    for e in (jest, est):
        e.register_object("small", _image(IMG))
        assert e._latent_hwc == (IMG // 8, IMG // 8, 4)
        messages.append(_raised(lambda: e.register_object("big", _image(2 * IMG, 1))))
        assert "big" not in e._banks
        # the pin outlives the objects it was taken from, in both packages
        e.deregister_object("small")
        assert e._latent_hwc == (IMG // 8, IMG // 8, 4)
        messages.append(_raised(lambda: e.register_object("big", _image(2 * IMG, 1))))
    assert messages[0] == messages[2] == "mixed latent geometries in one estimator: (4, 4, 4) vs (8, 8, 4)"
    assert messages[1] == messages[3] == messages[0]


@pytest.mark.parametrize("bank_dtype", ["auto", "int8"])
def test_registry_at_another_geometry(tasks, tmp_path, bank_dtype):
    jwrite, write = _both(tasks, bank_dtype=bank_dtype)
    jwrite.register_object("big", _image(2 * IMG, 1))
    write.register_object("big", _image(2 * IMG, 1))
    jwrite.save_registry(str(tmp_path / "jax.npz"))
    write.save_registry(str(tmp_path / "port.npz"))
    for path in ("jax.npz", "port.npz"):
        jest, est = _both(tasks, bank_dtype=bank_dtype)
        messages = []
        for e in (jest, est):
            e.register_object("small", _image(IMG))
            messages.append(_raised(lambda: e.load_registry(str(tmp_path / path))))
            assert set(e._banks) == {"small"}
        assert messages[0] == messages[1] == (
            "registry latent geometry does not match this estimator: (8, 8, 4) vs (4, 4, 4)"), path
        # a fresh estimator takes its geometry from the registry, then holds registrations to it
        jest, est = _both(tasks, bank_dtype=bank_dtype)
        messages = []
        for e in (jest, est):
            e.load_registry(str(tmp_path / path))
            assert e._latent_hwc == (8, 8, 4)
            messages.append(_raised(lambda: e.register_object("small", _image(IMG))))
        assert messages[0] == messages[1] == "mixed latent geometries in one estimator: (8, 8, 4) vs (4, 4, 4)"


def test_estimate_many_after_a_refused_registration(tasks):
    """The fault the pin closes: a second geometry used to register and
    then fail inside estimate_many's bank stack."""
    _, est = _both(tasks)
    est.register_object("a", _image(IMG))
    est.register_object("b", _image(IMG, 2))
    with pytest.raises(ValueError, match="mixed latent geometries"):
        est.register_object("big", _image(2 * IMG, 1))
    q = np.random.default_rng(3).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    r = est.estimate_many(["a", "b"], q)
    assert r.nearest_idx.shape == (2, 5) and np.isfinite(r.similarity).all()
