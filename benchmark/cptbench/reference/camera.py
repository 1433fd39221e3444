"""The reference's pinhole camera: a frozen copy of the port's camera math
(``cuda_path_tracer_ss_torch/models/camera.py``, the reference's
``RenderStructs.h:43-53`` and the key bindings of ``CudaTracer.cu:822-870``),
so that the reference works out the camera of every pass from the keys
alone."""
from __future__ import annotations

import math

import numpy as np

MOVE_STEP = 0.2
ROTATE_STEP = math.radians(10.0)
# each key and the key that undoes it
INVERSE_KEY = {"w": "s", "s": "w", "a": "d", "d": "a", "q": "e", "e": "q",
               "t": "g", "g": "t", "f": "h", "h": "f"}


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], np.float32)


def _quat_normalize(q):
    return (q / np.linalg.norm(q)).astype(np.float32)


def _quat_from_euler(euler_xyz):
    x, y, z = (float(v) * 0.5 for v in euler_xyz)
    cx, sx = math.cos(x), math.sin(x)
    cy, sy = math.cos(y), math.sin(y)
    cz, sz = math.cos(z), math.sin(z)
    return np.array([cx * cy * cz + sx * sy * sz,
                     sx * cy * cz - cx * sy * sz,
                     cx * sy * cz + sx * cy * sz,
                     cx * cy * sz - sx * sy * cz], np.float32)


def _quat_to_matrix(q):
    w, x, y, z = _quat_normalize(q)
    return np.array(
        [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
        np.float32)


class Camera:
    """Position, quaternion (w, x, y, z), z_near and field of view."""

    def __init__(self, position, rotation, z_near: float, fov: float):
        self.position = np.asarray(position, np.float32)
        self.rotation = np.asarray(rotation, np.float32)
        self.z_near = float(z_near)
        self.fov = float(fov)

    @classmethod
    def from_config(cls, cam: dict) -> "Camera":
        return cls(cam["position"], cam["rotation"], cam["z_near"], cam["fov"])

    def move(self, key: str) -> None:
        step, rot = MOVE_STEP, ROTATE_STEP
        local = {"w": (0, 0, -step), "a": (-step, 0, 0), "s": (0, 0, step),
                 "d": (step, 0, 0), "q": (0, step, 0), "e": (0, -step, 0)}
        euler = {"f": (0, rot, 0), "h": (0, -rot, 0), "g": (-rot, 0, 0),
                 "t": (rot, 0, 0)}
        if key in local:
            v = _quat_to_matrix(self.rotation) @ np.asarray(local[key],
                                                            np.float32)
            self.position = (self.position + v).astype(np.float32)
        elif key in euler:
            self.rotation = _quat_normalize(
                _quat_mul(self.rotation, _quat_from_euler(euler[key])))
        else:
            raise ValueError(f"unknown camera key {key!r}")

    def arrays(self):
        """(rotation [3,3], position [3], tan(fov/2), z_near), float32."""
        return (_quat_to_matrix(self.rotation), self.position.copy(),
                np.float32(math.tan(self.fov * 0.5)), np.float32(self.z_near))
