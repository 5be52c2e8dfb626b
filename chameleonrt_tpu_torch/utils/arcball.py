"""Quaternion arcball camera (reference util/arcball_camera.h:30-38 / .cpp).

Maintains the camera as translation * rotation about a center of interest;
rotate maps normalized-device mouse positions onto a virtual ball, pan moves
the center in the view plane scaled by zoom distance, zoom translates along
the view axis.
"""

from __future__ import annotations

import numpy as np


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        np.float64,
    )


def _quat_rotate(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    return 2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v + 2.0 * w * np.cross(u, v)


def _screen_to_arcball(p):
    """Map a normalized-device point to the arcball sphere (or its
    hyperbolic skirt)."""
    dist = float(p[0] * p[0] + p[1] * p[1])
    if dist <= 1.0:
        return np.array([0.0, p[0], p[1], np.sqrt(1.0 - dist)], np.float64)
    proj = p / np.linalg.norm(p)
    return np.array([0.0, proj[0], proj[1], 0.0], np.float64)


class ArcballCamera:
    """eye/center/up camera with arcball rotate, pan, zoom."""

    def __init__(self, eye, center, up):
        eye = np.asarray(eye, np.float64)
        center = np.asarray(center, np.float64)
        up = np.asarray(up, np.float64)
        self.center = center.copy()
        dir = center - eye
        self.distance = float(np.linalg.norm(dir))
        z = dir / self.distance
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(x, z)
        # rotation quaternion taking world axes to camera axes: build from
        # the orthonormal frame
        m = np.stack([x, y, -z], axis=0)
        t = np.trace(m)
        if t > 0:
            s = 0.5 / np.sqrt(t + 1.0)
            q = np.array([0.25 / s, (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s])
        else:
            i = int(np.argmax(np.diag(m)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = 2.0 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
            q = np.zeros(4)
            q[0] = (m[k, j] - m[j, k]) / s
            q[1 + i] = 0.25 * s
            q[1 + j] = (m[j, i] + m[i, j]) / s
            q[1 + k] = (m[k, i] + m[i, k]) / s
        self.rotation = q / np.linalg.norm(q)

    # -- queries --------------------------------------------------------
    @property
    def eye(self) -> np.ndarray:
        inv = self.rotation * np.array([1.0, -1.0, -1.0, -1.0])
        view_dir = _quat_rotate(inv, np.array([0.0, 0.0, -1.0]))
        return (self.center - view_dir * self.distance).astype(np.float32)

    @property
    def dir(self) -> np.ndarray:
        inv = self.rotation * np.array([1.0, -1.0, -1.0, -1.0])
        return _quat_rotate(inv, np.array([0.0, 0.0, -1.0])).astype(np.float32)

    @property
    def up(self) -> np.ndarray:
        inv = self.rotation * np.array([1.0, -1.0, -1.0, -1.0])
        return _quat_rotate(inv, np.array([0.0, 1.0, 0.0])).astype(np.float32)

    # -- interactions ---------------------------------------------------
    def rotate(self, prev_mouse, cur_mouse) -> None:
        """Rotate with normalized-device mouse coords in [-1, 1]^2."""
        prev = _screen_to_arcball(np.clip(np.asarray(prev_mouse, np.float64), -1, 1))
        cur = _screen_to_arcball(np.clip(np.asarray(cur_mouse, np.float64), -1, 1))
        prev_conj = prev * np.array([1.0, -1.0, -1.0, -1.0])
        self.rotation = _quat_mul(_quat_mul(cur, prev_conj), self.rotation)
        self.rotation /= np.linalg.norm(self.rotation)

    def pan(self, mouse_delta) -> None:
        """Pan the center in the view plane; delta in normalized-device
        units, scaled by zoom distance."""
        delta = np.asarray(mouse_delta, np.float64) * self.distance
        inv = self.rotation * np.array([1.0, -1.0, -1.0, -1.0])
        right = _quat_rotate(inv, np.array([1.0, 0.0, 0.0]))
        up = _quat_rotate(inv, np.array([0.0, 1.0, 0.0]))
        self.center = self.center - right * delta[0] - up * delta[1]

    def zoom(self, amount: float) -> None:
        self.distance = max(1e-3, self.distance - float(amount) * self.distance * 0.1)
