"""The port's crop (``nope_tpu_torch.geometry.cropping``) and native data
plane (``nope_tpu_torch.native``) against ``nope_tpu``'s: the host
halves, the tensor halves against the JAX device crop, ``crop_frame``
without cv2, and the native library built from the same ``warp.cpp``."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nope_tpu.geometry.cropping as jcrop
from nope_tpu import native as jnative
from nope_tpu.geometry import so3_grid
from nope_tpu_torch import native
from nope_tpu_torch.geometry import cropping

torch.set_num_threads(1)
K = np.array([[525, 0, 256], [0, 525, 256], [0, 0, 1]], dtype=np.float64)
# grid poses pushed 1 m away as the dataset's; pose 0 looks straight down
# the optical axis, where the up hint is degenerate
POSES = so3_grid.load_obj_poses(2)[0::40].copy()
POSES[:, :3, 3] *= 2.0


def _images(n, size=512, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("keep_inplane", [False, True])
def test_host_halves_match_jax(keep_inplane):
    rng = np.random.default_rng(1)
    for pose in POSES:
        np.testing.assert_allclose(cropping.virtual_bbox_corners(pose, 1.0, keep_inplane),
                                   jcrop.virtual_bbox_corners(pose, 1.0, keep_inplane), atol=1e-12)
        np.testing.assert_allclose(cropping.crop_homography(K, pose, 64, keep_inplane, 1.0),
                                   jcrop.crop_homography(K, pose, 64, keep_inplane, 1.0), atol=1e-6)
    src = rng.uniform(0, 512, (4, 2)).astype(np.float32)
    dst = np.array([[0, 0], [0, 256], [256, 0], [256, 256]], np.float32)
    np.testing.assert_allclose(cropping.get_perspective_transform(src, dst),
                               jcrop.get_perspective_transform(src, dst), atol=1e-6)
    with pytest.raises(ValueError, match="camera plane"):
        cropping.crop_homography(K, np.eye(4), 64)


def test_crop_frame_with_cv2_equals_jax():
    """cv2 on both sides: the same bytes, image and mask."""
    img = _images(1, dtype=np.uint8)[0]
    mask = (img[..., 0] > 128).astype(np.uint8) * 255
    for pose in POSES[1:4]:
        got = cropping.crop_frame(img, mask, K, pose, 64, virtual_bbox_size=1.0)
        want = jcrop.crop_frame(img, mask, K, pose, 64, virtual_bbox_size=1.0)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


def test_perspective_transform_torch():
    """float64 solve: the host's homography to ~1e-12; the JAX package's
    float32 solve within the rtol/atol 1e-4 its own test holds it to."""
    rng = np.random.default_rng(2)
    src = rng.uniform(0, 512, (5, 4, 2)).astype(np.float32)
    dst = np.tile(np.array([[0, 0], [0, 256], [256, 0], [256, 256]], np.float32), (5, 1, 1))
    got = cropping.get_perspective_transform_torch(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    host = np.stack([jcrop.get_perspective_transform(s, d) for s, d in zip(src, dst)])
    np.testing.assert_allclose(got, host, rtol=1e-10, atol=1e-12)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jcrop.get_perspective_transform_jax(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_warp_and_crop_torch_match_jax():
    """Batched warp and crop against the JAX device functions, one image
    at a time, with the host's homographies: bitwise on this CPU for the
    warp (the same float32 elementwise transform); the crop within 1e-6
    (float32 corners summed in another order may differ in the last
    bit before truncation, which has not happened on these poses).  Pose
    0 is the degenerate up hint: the JAX device crop solves a singular
    system there, the port takes the host's axes."""
    imgs = _images(len(POSES))
    Ms = np.stack([jcrop.crop_homography(K, p, 64, virtual_bbox_size=1.0) for p in POSES])
    warped = cropping.warp_perspective_torch(torch.from_numpy(imgs), torch.from_numpy(Ms), 64).numpy()
    crops = cropping.crop_frame_torch(torch.from_numpy(imgs), torch.from_numpy(K), torch.from_numpy(POSES), 64,
                                      1.0).numpy()
    assert warped.shape == crops.shape == (len(POSES), 64, 64, 3) and crops.dtype == np.float32
    with jax.default_matmul_precision("highest"):
        for i, pose in enumerate(POSES):
            w = np.asarray(jcrop.warp_perspective_jax(jnp.asarray(imgs[i]), jnp.asarray(Ms[i]), 64))
            np.testing.assert_array_equal(warped[i], w)
            host = jcrop.crop_frame(imgs[i], None, K, pose, 64, virtual_bbox_size=1.0)
            assert np.abs(crops[i] - host).mean() < 5e-3  # the CPU tests' device-vs-host bound
            if i == 0:
                continue
            c = np.asarray(jcrop.crop_frame_jax(jnp.asarray(imgs[i]), jnp.asarray(K, jnp.float32),
                                                jnp.asarray(pose, jnp.float32), 64, 1.0))
            np.testing.assert_allclose(crops[i], c, atol=1e-6)
    # unbatched and 2-D (greyscale) forms
    one = cropping.warp_perspective_torch(torch.from_numpy(imgs[1, ..., 0]), torch.from_numpy(Ms[1]), 64)
    np.testing.assert_array_equal(one.numpy(), warped[1, ..., 0])


@pytest.mark.parametrize("route", ["native", "torch"])
def test_crop_frame_without_cv2_matches_jax_non_cv2_branch(route, monkeypatch):
    """cv2 hidden on both sides: the port's native warp (or, with no
    native library, its torch warp) against the JAX package's JAX warp;
    uint8 within 1 LSB on at least 99.9% of the pixels."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(jcrop, "_HAS_CV2", False)
    if route == "torch":
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)
    else:
        assert native.available()
    imgs = _images(3, seed=3, dtype=np.uint8)
    mask = (imgs[0, ..., 1] > 100).astype(np.uint8) * 255
    diffs = []
    with jax.default_matmul_precision("highest"):
        for img, pose in zip(imgs, POSES[1:4]):
            got, got_mask = cropping.crop_frame(img, mask, K, pose, 64, virtual_bbox_size=1.0)
            want, want_mask = jcrop.crop_frame(img, mask, K, pose, 64, virtual_bbox_size=1.0)
            assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3)
            assert got_mask.shape == want_mask.shape == (64, 64)
            diffs += [np.abs(got.astype(int) - want), np.abs(got_mask.astype(int) - want_mask)]
    d = np.concatenate([x.ravel() for x in diffs])
    assert np.mean(d <= 1) >= 0.999 and d.max() <= 4, (np.mean(d <= 1), d.max())


def test_native_library_matches_jax_package_library():
    """The same warp.cpp on both sides: the warps and the compositing
    bitwise.  The fused batch preprocess within a few float32 ulps of 1
    (6e-8 each): the JAX package's prebuilt library was compiled with
    -march=native, whose fused multiply-adds round its compositing,
    blending and normalisation once where the generic build rounds
    twice."""
    if not (native.available() and jnative.available()):
        pytest.skip("a native library could not be built (no g++)")
    imgs = _images(4, seed=4, dtype=np.uint8)
    rgba = np.concatenate([imgs, imgs[..., :1]], axis=-1)
    for img, pose in zip(imgs, POSES[1:]):
        M = jcrop.crop_homography(K, pose, 256, virtual_bbox_size=1.0)
        np.testing.assert_array_equal(native.warp_perspective(img, M, 256), jnative.warp_perspective(img, M, 256))
        f = img.astype(np.float32)
        np.testing.assert_array_equal(native.warp_perspective(f, M, 256), jnative.warp_perspective(f, M, 256))
    np.testing.assert_array_equal(native.composite_rgba_black(rgba[0]), jnative.composite_rgba_black(rgba[0]))
    Ms = np.stack([jcrop.crop_homography(K, p, 64, virtual_bbox_size=1.0) for p in POSES[1:5]])
    got = native.preprocess_batch(rgba, Ms, 64, num_threads=2)
    np.testing.assert_allclose(got, jnative.preprocess_batch(rgba, Ms, 64, num_threads=2), rtol=0, atol=6e-7)


def test_native_fallbacks(monkeypatch):
    """With no library: numpy compositing, the torch warp, and the batch
    preprocess on those two."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert not native.available()
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (16, 16, 4), np.uint8)
    rgb = native.composite_rgba_black(rgba)
    want = (rgba[..., :3].astype(np.uint16) * rgba[..., 3:].astype(np.uint16) + 127) // 255
    np.testing.assert_array_equal(rgb, want)
    np.testing.assert_array_equal(native.warp_perspective(rgb, np.eye(3), 16), rgb)
    fused = native.preprocess_batch(rgba[None], np.eye(3)[None], 16)
    np.testing.assert_allclose(fused[0], rgb * (2.0 / 255.0) - 1.0, atol=1e-6)
