"""Structure-of-arrays 3-vector math for the eager engine.

The counterpart of the JAX package's ``ops/vec.py``: every vector quantity
of the eager engine is a :class:`Vec3` of three same-shaped tensors (``[N]``
or scalars), never an ``[N, 3]`` tensor, so each formula of the reference
reads the same here and rounds in the same order (``dot`` is
``(x*x + y*y) + z*z`` on both sides). A scene's ``[N, 3]`` fields become
``Vec3`` at a gather (:func:`gather`).

``sqrt_clamped_grad`` / ``rsqrt_clamped_grad`` are ``torch.autograd``
Functions: the forward is ``torch.sqrt`` / ``torch.rsqrt`` bit for bit, the
backward clamps the derivative as the reference's custom JVPs do, so a
grazing hit or a degenerate frame cannot inject inf (and, through a zero
cotangent of an unselected ``where`` branch, NaN) into a gradient.

The reference's ``match_vma`` / ``full_like_vma`` mark fresh constants as
varying over ``shard_map``'s manual mesh axes; they are artefacts of JAX's
typing of sharded loops and have no counterpart here.
"""
from __future__ import annotations

import dataclasses

import torch


class _SqrtClampedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (0.5 / torch.clamp_min(y, 1e-3))


class _RsqrtClampedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.rsqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        yc = torch.clamp_max(y, 1e3)
        return g * (-0.5 * yc * yc * yc)


def sqrt_clamped_grad(x: torch.Tensor) -> torch.Tensor:
    """``torch.sqrt`` whose derivative 1/(2 sqrt x) is clamped at
    sqrt(x) = 1e-3: a tangent sphere hit (discriminant -> 0+) or
    near-TIR refraction (1 - sin_t2 -> 0+) keeps a finite gradient."""
    return _SqrtClampedGrad.apply(x)


def rsqrt_clamped_grad(x: torch.Tensor) -> torch.Tensor:
    """``torch.rsqrt`` whose derivative -x^(-3/2)/2 stops steepening at
    rsqrt(x) = 1e3 (norms below 1e-3): the normalize of a degenerate
    tangent frame keeps a finite gradient."""
    return _RsqrtClampedGrad.apply(x)


def _full(shape, v, like=None, dtype=torch.float32):
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.full(shape, v, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Vec3:
    """Three same-shaped tensors acting as one vector field."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- constructors ------------------------------------------------------
    @staticmethod
    def full(shape, vals, like=None) -> "Vec3":
        vx, vy, vz = vals
        return Vec3(_full(shape, vx, like), _full(shape, vy, like),
                    _full(shape, vz, like))

    @staticmethod
    def zeros(shape, like=None) -> "Vec3":
        return Vec3.full(shape, (0.0, 0.0, 0.0), like)

    @staticmethod
    def ones(shape, like=None) -> "Vec3":
        return Vec3.full(shape, (1.0, 1.0, 1.0), like)

    @staticmethod
    def from_array(a: torch.Tensor) -> "Vec3":
        """From a trailing-dim-3 tensor ``[..., 3]``."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], -1)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        o = _lift(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        o = _lift(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        o = _lift(o)
        return Vec3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o):
        o = _lift(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        o = _lift(o)
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry ----------------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(self.y * o.z - self.z * o.y,
                    self.z * o.x - self.x * o.z,
                    self.x * o.y - self.y * o.x)

    def norm2(self):
        return self.dot(self)

    def norm(self):
        return torch.sqrt(self.norm2())

    def normalize(self, eps: float = 0.0) -> "Vec3":
        n2 = self.norm2()
        if eps:
            n2 = torch.clamp_min(n2, eps)
        return self * torch.rsqrt(n2)

    def normalize_clamped_grad(self, eps: float = 0.0) -> "Vec3":
        """``normalize`` through :func:`rsqrt_clamped_grad`: the same
        values, finite gradients for near-zero vectors (for a degenerate
        input that a ``where`` selects away)."""
        n2 = self.norm2()
        if eps:
            n2 = torch.clamp_min(n2, eps)
        return self * rsqrt_clamped_grad(n2)

    # -- utility -----------------------------------------------------------
    def map(self, fn) -> "Vec3":
        return Vec3(fn(self.x), fn(self.y), fn(self.z))

    def mean_channels(self):
        return (self.x + self.y + self.z) / 3.0

    def max_channel(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    @property
    def shape(self):
        return self.x.shape

    def __getitem__(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])


def _lift(o) -> Vec3:
    return o if isinstance(o, Vec3) else Vec3(o, o, o)


def where(cond, a, b) -> Vec3:
    """Componentwise select with one broadcast condition."""
    a, b = _lift(a), _lift(b)
    return Vec3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
                torch.where(cond, a.z, b.z))


def gather(table: torch.Tensor, idx) -> Vec3:
    """Rows ``idx`` of an ``[M, 3]`` table (a scene field) as a Vec3."""
    rows = table[idx.long() if isinstance(idx, torch.Tensor) else idx]
    return Vec3(rows[..., 0], rows[..., 1], rows[..., 2])
