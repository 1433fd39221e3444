"""Pinhole camera with quaternion orientation.

Behavioral spec: ``CudaTracer/RenderStructs.h:43-53`` (defaults: position at
origin, identity rotation, zNear=-0.1, fov=pi/2) and the movement bindings of
``CudaTracer/CudaTracer.cu:822-870`` (WASD/QE translate by 0.2 in camera
space, TFGH rotate by 10 degrees). The camera lives host-side as numpy state;
eye-ray generation on device consumes its rotation as a 3x3 matrix
(:func:`camera_arrays` gives the parameter pack the render entry points take).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

MOVE_STEP = 0.2
ROTATE_STEP = math.radians(10.0)


def quat_identity() -> np.ndarray:
    return np.array([1.0, 0.0, 0.0, 0.0], np.float32)  # (w, x, y, z)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        np.float32,
    )


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return (q / np.linalg.norm(q)).astype(np.float32)


def quat_from_euler(euler_xyz) -> np.ndarray:
    """glm ``quat(vec3 eulerAngles)`` — XYZ intrinsic, radians."""
    x, y, z = (float(v) * 0.5 for v in euler_xyz)
    cx, sx = math.cos(x), math.sin(x)
    cy, sy = math.cos(y), math.sin(y)
    cz, sz = math.cos(z), math.sin(z)
    return np.array(
        [
            cx * cy * cz + sx * sy * sz,
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
        ],
        np.float32,
    )


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = quat_normalize(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    return quat_to_matrix(q) @ np.asarray(v, np.float32)


@dataclasses.dataclass
class Camera:
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = dataclasses.field(default_factory=quat_identity)
    z_near: float = -0.1
    z_far: float = -100.0
    fov: float = math.pi / 2.0

    def rotation_matrix(self) -> np.ndarray:
        return quat_to_matrix(self.rotation)

    # -- movement (CudaTracer.cu:822-870 key bindings as methods) ----------
    def _translate(self, local: np.ndarray):
        self.position = (self.position + quat_rotate(self.rotation, local)).astype(np.float32)

    def _rotate(self, euler):
        self.rotation = quat_normalize(quat_mul(self.rotation, quat_from_euler(euler)))

    def move(self, key: str) -> bool:
        """Apply one movement key; returns True if the camera changed
        (the caller should then reset accumulation, as CudaTracer.cu:782-785)."""
        step, rot = MOVE_STEP, ROTATE_STEP
        actions = {
            "w": lambda: self._translate(np.array([0, 0, -step], np.float32)),
            "a": lambda: self._translate(np.array([-step, 0, 0], np.float32)),
            "s": lambda: self._translate(np.array([0, 0, step], np.float32)),
            "d": lambda: self._translate(np.array([step, 0, 0], np.float32)),
            "q": lambda: self._translate(np.array([0, step, 0], np.float32)),
            "e": lambda: self._translate(np.array([0, -step, 0], np.float32)),
            "f": lambda: self._rotate((0, rot, 0)),
            "h": lambda: self._rotate((0, -rot, 0)),
            "g": lambda: self._rotate((-rot, 0, 0)),
            "t": lambda: self._rotate((rot, 0, 0)),
        }
        if key in actions:
            actions[key]()
            return True
        return False

    # -- device-side parameter pack ---------------------------------------
    def device_params(self):
        """(rotation 3x3, position 3, tan(fov/2), z_near) as float32 arrays."""
        return (
            self.rotation_matrix(),
            self.position.astype(np.float32),
            np.float32(math.tan(self.fov * 0.5)),
            np.float32(self.z_near),
        )


def camera_arrays(camera: Camera):
    """Host camera -> the ``cam_params`` tuple of the render entry points:
    (rotation [3,3], position [3], tan(fov/2), z_near), float32 numpy. The
    kernel wrapper packs it into its camera table on the rendering device."""
    rot, pos, tan_half_fov, z_near = camera.device_params()
    return (np.asarray(rot, np.float32), np.asarray(pos, np.float32),
            np.float32(tan_half_fov), np.float32(z_near))
