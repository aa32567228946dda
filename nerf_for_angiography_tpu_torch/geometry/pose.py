"""C-arm pose math in torch (port of ``nerf_for_angiography_tpu/geometry/
pose.py``; conventions of the reference's phantomdata/proj_helpers.py:34-76).

Angles are in degrees at the public API boundary. Matrices are float32 and
are built on ``device``.
"""

from __future__ import annotations

import math

import torch


def _as_f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def x_rotation_matrix(angle_rad) -> torch.Tensor:
    """4x4 rotation about the x axis. Ref: proj_helpers.py:34-40."""
    a = _as_f32(angle_rad)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rows([[o, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, o]])


def y_rotation_matrix(angle_rad) -> torch.Tensor:
    """4x4 rotation about the y axis. Ref: proj_helpers.py:42-48."""
    a = _as_f32(angle_rad)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rows([[c, z, s, z], [z, o, z, z], [-s, z, c, z], [z, z, z, o]])


def z_rotation_matrix(angle_rad) -> torch.Tensor:
    """4x4 rotation about the z axis. Ref: proj_helpers.py:50-56."""
    a = _as_f32(angle_rad)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _rows([[c, -s, z, z], [s, c, z, z], [z, z, o, z], [z, z, z, o]])


def translation_matrix(vec) -> torch.Tensor:
    """4x4 translation by ``vec[:3]``. Ref: proj_helpers.py:58-61."""
    vec = _as_f32(vec)
    m = torch.eye(4, dtype=torch.float32, device=vec.device)
    m[:3, 3] = vec[:3]
    return m


def _deg2rad(v) -> torch.Tensor:
    return _as_f32(v) * (math.pi / 180.0)


def get_rotation(theta_deg, phi_deg, larm_deg) -> torch.Tensor:
    """``R = inv(Rz(larm) @ Rx(theta) @ Ry(phi))`` (proj_helpers.py:63-66),
    the inverse taken as the transpose of the orthonormal product."""
    th, ph, la = _deg2rad(theta_deg), _deg2rad(phi_deg), _deg2rad(larm_deg)
    fwd = z_rotation_matrix(la) @ (x_rotation_matrix(th) @ y_rotation_matrix(ph))
    return fwd.transpose(-1, -2)


def source_matrix(
    source_pt, theta_deg, phi_deg, larm_deg=0.0, translation=(0.0, 0.0, 0.0)
) -> torch.Tensor:
    """Camera-to-world matrix ``T(translation) @ R @ T(source_pt)``
    (proj_helpers.py:68-76)."""
    m2 = get_rotation(theta_deg, phi_deg, larm_deg)
    m3 = translation_matrix(source_pt)
    m4 = translation_matrix(translation)
    return m4 @ (m2 @ m3)
