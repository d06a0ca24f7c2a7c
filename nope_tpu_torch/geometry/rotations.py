"""Rotation representations and the SO(3) angle (``nope_tpu/geometry/rotations.py``).

Rotation-6d, quaternions (w, x, y, z, real first, as pytorch3d),
axis-angle, Euler angles and the geodesic angle with pytorch3d's
linearly extrapolated arccos.  Batched over any leading dimensions and
dtype-preserving.  The 3x3 products are written as a broadcast product
and sum (:func:`matmul3`), so the result does not depend on the matmul
precision settings of the device (TF32 cannot touch them), as the JAX
package pins ``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools

import torch


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for batches of 3x3 matrices, elementwise in the input dtype."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


# ---------------------------------------------------------------------------
# rotation-6d
# ---------------------------------------------------------------------------


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt the 6d representation (the first two *rows* of the
    matrix before orthonormalisation) into a rotation matrix."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp(min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """First two rows of the rotation matrix, flattened."""
    return matrix[..., :2, :].reshape(*matrix.shape[:-2], 6)


# ---------------------------------------------------------------------------
# quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    r, i, j, k = quaternions.unbind(-1)
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
            two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
            two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
        ),
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x <= 0."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """pytorch3d's candidate pick: the four sign-consistent candidates,
    the one with the largest denominator."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = matrix.reshape(matrix.shape[:-2] + (9,)).unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack((
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ), dim=-1))
    quat_by_rijk = torch.stack((
        torch.stack((q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01), dim=-1),
        torch.stack((m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20), dim=-1),
        torch.stack((m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21), dim=-1),
        torch.stack((m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2), dim=-1),
    ), dim=-2)
    candidates = quat_by_rijk / (2.0 * q_abs[..., None].clamp(min=0.1))
    onehot = torch.nn.functional.one_hot(q_abs.argmax(-1), 4).to(matrix.dtype)
    return torch.sum(candidates * onehot[..., None], dim=-2)


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Force a non-negative real part."""
    return torch.where(quaternions[..., :1] < 0, -quaternions, quaternions)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack((
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ), dim=-1)


def quaternion_invert(quaternion: torch.Tensor) -> torch.Tensor:
    return quaternion * quaternion.new_tensor([1, -1, -1, -1])


def quaternion_apply(quaternion: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    point_q = torch.cat((torch.zeros_like(point[..., :1]), point), dim=-1)
    out = quaternion_multiply(quaternion_multiply(quaternion, point_q), quaternion_invert(quaternion))
    return out[..., 1:]


# ---------------------------------------------------------------------------
# axis-angle
# ---------------------------------------------------------------------------


def _sin_half_over(angles: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """sin(x/2)/x, with 1/2 - x²/48 for |x| < 1e-6."""
    small = torch.abs(angles) < 1e-6
    return torch.where(small, 0.5 - angles * angles / 48,
                       torch.sin(half) / torch.where(small, torch.ones_like(angles), angles))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    return torch.cat((torch.cos(half), axis_angle * _sin_half_over(angles, half)), dim=-1)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    return quaternions[..., 1:] / _sin_half_over(2 * half_angles, half_angles)


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


# ---------------------------------------------------------------------------
# Euler angles (pytorch3d convention strings, e.g. "XYZ")
# ---------------------------------------------------------------------------

_AXES = {"X": 0, "Y": 1, "Z": 2}


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(c not in _AXES for c in convention):
        raise ValueError(f"invalid convention {convention}")


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    _check_convention(convention)
    mats = [_axis_angle_rotation(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return functools.reduce(matmul3, mats)


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    _check_convention(convention)
    i0, i2 = _AXES[convention[0]], _AXES[convention[2]]
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in (-1, 2) else 1.0
        central = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1, 1))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1, 1))
    return torch.stack((
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    ), dim=-1)


# ---------------------------------------------------------------------------
# random rotations
# ---------------------------------------------------------------------------


def random_quaternions(n: int, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Unit quaternions drawn on ``generator``'s device."""
    o = torch.randn((n, 4), generator=generator, dtype=dtype, device=generator.device)
    return o / torch.linalg.norm(o, dim=-1, keepdim=True)


def random_rotations(n: int, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """(n, 3, 3) rotations, uniform over SO(3), on ``generator``'s device."""
    return quaternion_to_matrix(random_quaternions(n, generator, dtype))


# ---------------------------------------------------------------------------
# SO(3) angle (pytorch3d so3_relative_angle semantics)
# ---------------------------------------------------------------------------


def acos_linear_extrapolation(x: torch.Tensor, bounds=(-1.0 + 1e-4, 1.0 - 1e-4)) -> torch.Tensor:
    """arccos, linearly extrapolated outside ``bounds`` (pytorch3d
    ``acos_linear_extrapolation``): finite gradients near ±1."""
    lower, upper = bounds

    def dacos_dx(v: float) -> torch.Tensor:
        v = torch.tensor(v, dtype=x.dtype, device=x.device)
        return -1.0 / torch.sqrt(1.0 - v * v)

    def acos_at(v: float) -> torch.Tensor:
        return torch.acos(torch.tensor(v, dtype=x.dtype, device=x.device))

    mid = torch.acos(torch.clamp(x, lower, upper))
    above = acos_at(upper) + (x - upper) * dacos_dx(upper)
    below = acos_at(lower) + (x - lower) * dacos_dx(lower)
    return torch.where(x > upper, above, torch.where(x < lower, below, mid))


def so3_rotation_angle(R: torch.Tensor, eps: float = 1e-4, cos_angle: bool = False,
                       cos_bound: float = 1e-4) -> torch.Tensor:
    """Angle of a batch of rotation matrices.  ``eps`` only gates a
    validity assert in pytorch3d and is accepted for its API;
    ``cos_bound`` sets the arccos extrapolation bounds (pytorch3d's 1e-4
    gives a ~0.405° floor for matching rotations)."""
    del eps
    phi_cos = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5
    if cos_angle:
        return phi_cos
    if cos_bound > 0.0:
        return acos_linear_extrapolation(phi_cos, (-1.0 + cos_bound, 1.0 - cos_bound))
    return torch.acos(torch.clamp(phi_cos, -1.0, 1.0))


def so3_relative_angle(R1: torch.Tensor, R2: torch.Tensor, eps: float = 1e-4,
                       cos_angle: bool = False, cos_bound: float = 1e-4) -> torch.Tensor:
    """Geodesic angle between two batches of rotations; the reference's
    ``eps=1e-2`` only relaxes pytorch3d's assert, the bound stays 1e-4."""
    return so3_rotation_angle(matmul3(R1, R2.transpose(-1, -2)), eps=eps, cos_angle=cos_angle,
                              cos_bound=cos_bound)


def geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Plain clipped-arccos geodesic distance in radians."""
    R12 = matmul3(R2, R1.transpose(-1, -2))
    trace = R12[..., 0, 0] + R12[..., 1, 1] + R12[..., 2, 2]
    return torch.acos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
