"""Scene data model: dataclasses of tensors for geometry, materials, lights.

Behavioral spec: the reference's POD structs and host-side scene assembly
(``CudaTracer/RenderStructs.h:24-121``, ``CudaTracer/Scene.h:5-27``,
``CudaTracer/Scene.cpp:17-371``).

Layout, stated once: every 3-vector field (sphere centers, triangle corners
and normals, colors, light positions and powers) is ONE float32 tensor of
shape ``[N, 3]`` (``background`` is ``[3]``); scalar-per-primitive fields are
``[N]``; indices and flags are int32. Field names are those of the JAX
package's ``Scene`` / ``Materials``. A ``Scene`` is host data: its tensors
live on the CPU, and ``ops.cuda.megakernel.pack_scene(scene, device)``
flattens it into the kernel's tables on the device that renders.

Materials carry the same parameterization as the reference
(``RenderStructs.h:80-107``): diffuse/specular/absorption/emission colors,
specular exponent, IOR, branch weights diff/spec/refr, roughness, flags.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

# Material flag bits — mirrors ``RenderStructs.h:77-78``. Note the reference
# defines COOK_TORRANCE as 0x03 (it *includes* the pure-reflection bit), so a
# pure-reflection material also takes the Cook-Torrance sampling path with
# roughness 0 (== a perfect mirror). We reproduce that exact quirk.
MAT_FLAG_PURE_REFLECTION = 0x01
MAT_FLAG_COOK_TORRANCE = 0x03


@dataclasses.dataclass(frozen=True)
class Materials:
    """Material table; colors ``[M, 3]``, every other field ``[M]``."""

    diffuse: torch.Tensor
    specular: torch.Tensor
    absorption: torch.Tensor
    emission: torch.Tensor
    spec_exp: torch.Tensor
    ior: torch.Tensor
    diff_avg: torch.Tensor
    spec_avg: torch.Tensor
    refr_avg: torch.Tensor
    roughness: torch.Tensor
    flags: torch.Tensor    # int32
    # indices into Scene.textures, -1 = unmapped
    tex_id: torch.Tensor   # int32
    nmap_id: torch.Tensor  # int32


@dataclasses.dataclass(frozen=True)
class Scene:
    """Host-resident scene; counts are tensor shapes."""

    # Spheres: [S]
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor  # int32

    # Triangles: [T]
    tri_v0: torch.Tensor
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_n0: torch.Tensor
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_mat: torch.Tensor  # int32
    # Per-corner texture coordinates, [T, 2] (zeros without UVs).
    tri_uv0: torch.Tensor
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor

    materials: Materials

    # Texture atlas [K, TH, TW, 3] float32 padded to the largest image;
    # tex_hw [K, 2] carries each texture's true (height, width).
    textures: torch.Tensor
    tex_hw: torch.Tensor  # int32

    # Point lights: [Lp]
    pl_pos: torch.Tensor
    pl_power: torch.Tensor

    # Area lights: [La]; each is a pair of triangles (tri0, tri0+1), as in
    # ``RenderStructs.h:66-75`` (numTriangles is always 2, ``Scene.cpp:54``).
    al_power: torch.Tensor
    al_area: torch.Tensor
    al_tri0: torch.Tensor  # int32

    background: torch.Tensor  # [3] — ``defaultColor`` (CudaTracer.cu:653)

    @property
    def num_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_mat.shape[0]

    @property
    def num_point_lights(self) -> int:
        return self.pl_power.shape[0]

    @property
    def num_area_lights(self) -> int:
        return self.al_tri0.shape[0]

    @property
    def num_textures(self) -> int:
        return self.textures.shape[0]

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


_MATERIAL_FIELDS = tuple(f.name for f in dataclasses.fields(Materials))
_SCENE_FIELDS = tuple(f.name for f in dataclasses.fields(Scene)
                      if f.name != "materials")
_INT_FIELDS = frozenset({"sph_mat", "tri_mat", "tex_hw", "al_tri0",
                         "materials.flags", "materials.tex_id",
                         "materials.nmap_id"})


def scene_to_numpy(scene: Scene) -> Dict[str, np.ndarray]:
    """Flatten a scene into a dict of numpy arrays keyed by field name
    (material fields as ``materials.<name>``; 3-vectors as ``[N, 3]``)."""
    d = {k: getattr(scene, k).detach().cpu().numpy() for k in _SCENE_FIELDS}
    for k in _MATERIAL_FIELDS:
        d["materials." + k] = getattr(scene.materials, k).detach().cpu().numpy()
    return d


def scene_from_numpy(d: Dict[str, np.ndarray]) -> Scene:
    """Build a ``Scene`` from the dict layout of :func:`scene_to_numpy` —
    the bridge by which a scene assembled elsewhere (another package's
    scene code, a file loader) reaches this package's kernels."""
    want = set(_SCENE_FIELDS) | {"materials." + k for k in _MATERIAL_FIELDS}
    if set(d) != want:
        raise KeyError(f"scene dict keys differ: missing {sorted(want - set(d))}, "
                       f"unexpected {sorted(set(d) - want)}")

    def t(key):
        dtype = np.int32 if key in _INT_FIELDS else np.float32
        return torch.from_numpy(np.array(d[key], dtype=dtype, order="C"))

    mats = Materials(**{k: t("materials." + k) for k in _MATERIAL_FIELDS})
    return Scene(materials=mats, **{k: t(k) for k in _SCENE_FIELDS})


# ---------------------------------------------------------------------------
# Host-side scene assembly (numpy). The analog of the reference's ``Scene`` class —
# mutable vectors of primitives, frozen to tensors at the end.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material, mirroring the reference ctor defaults
    (``RenderStructs.h:98-106``)."""

    diffuse: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diff_avg: float = 0.0
    specular: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    spec_exp: float = 0.0
    spec_avg: float = 0.0
    ior: float = 1.0
    absorption: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    refr_avg: float = 0.0
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    roughness: float = 0.0
    flags: int = 0
    texture: int = -1      # SceneBuilder.add_texture id; modulates diffuse
    normal_map: int = -1   # SceneBuilder.add_texture id; tangent-space


class SceneBuilder:
    """Accumulates primitives host-side, then freezes into a Scene."""

    def __init__(self):
        self.spheres: List[Tuple[np.ndarray, float, int]] = []
        self.triangles: List[Tuple[np.ndarray, ...]] = []  # v0,v1,v2,n0,n1,n2,mat
        self.tri_uvs: List[np.ndarray] = []                # [3,2] per triangle
        self.materials: List[MaterialSpec] = []
        self.textures: List[np.ndarray] = []               # [h,w,3] float32
        self.point_lights: List[Tuple[np.ndarray, np.ndarray]] = []
        self.area_lights: List[Tuple[np.ndarray, float, int]] = []  # power, area, tri0
        self.background = np.zeros(3, np.float32)

    # -- primitives --------------------------------------------------------
    def add_material(self, m: MaterialSpec) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_texture(self, image) -> int:
        """Register an [h, w, 3] image (uint8 or float in [0,1]) and return
        its id for ``MaterialSpec.texture`` / ``normal_map``."""
        a = np.asarray(image)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        a = np.asarray(a, np.float32)
        if a.ndim != 3 or a.shape[2] != 3:
            raise ValueError(f"texture must be [h, w, 3], got {a.shape}")
        self.textures.append(a)
        return len(self.textures) - 1

    def add_sphere(self, center, radius, material_idx: int):
        self.spheres.append((np.asarray(center, np.float32), float(radius), material_idx))

    def add_triangle(self, v0, v1, v2, n0, n1, n2, material_idx: int,
                     uv=None):
        """``uv``: optional ((u0,v0),(u1,v1),(u2,v2)) per-corner texture
        coordinates; zeros when omitted."""
        self.triangles.append(tuple(np.asarray(v, np.float32) for v in (v0, v1, v2, n0, n1, n2)) + (material_idx,))
        self.tri_uvs.append(np.zeros((3, 2), np.float32) if uv is None
                            else np.asarray(uv, np.float32).reshape(3, 2))

    def add_point_light(self, position, power):
        self.point_lights.append((np.asarray(position, np.float32), np.asarray(power, np.float32)))

    # -- composite models --------------------------------------------------
    def add_rect(self, transformation: np.ndarray, material_idx: int):
        """A unit rect (two triangles) under a 4x4 transform, normals via
        inverse-transpose — behavior of ``Scene.cpp:63-96``."""
        t = np.asarray(transformation, np.float32)
        verts = []
        for i in range(2):
            for j in range(2):
                v = t @ np.array([i - 0.5, j - 0.5, 0.0, 1.0], np.float32)
                verts.append(v[:3])
        n4 = np.linalg.inv(t.T) @ np.array([0.0, 0.0, 1.0, 0.0], np.float32)
        n = n4[:3] / np.linalg.norm(n4[:3])
        # Triangle split matches Scene.cpp:94-95: (v0,v1,v2) and (v3,v1,v2).
        self.add_triangle(verts[0], verts[1], verts[2], n, n, n, material_idx)
        self.add_triangle(verts[3], verts[1], verts[2], n, n, n, material_idx)

    def add_area_light(self, transformation: np.ndarray, material_idx: int, power):
        """Rect light; area from the first triangle's cross product doubled —
        behavior of ``Scene.cpp:40-55`` (the reference stores
        ``length(cross(e1, e2))`` which is exactly the rect's area)."""
        tri0 = len(self.triangles)
        self.add_rect(transformation, material_idx)
        v0, v1, v2 = self.triangles[tri0][:3]
        e1 = v1 - v2
        e2 = v2 - v0
        area = float(np.linalg.norm(np.cross(e1, e2)))
        self.area_lights.append((np.asarray(power, np.float32), area, tri0))

    # -- freeze ------------------------------------------------------------
    def build(self) -> Scene:
        def vec3_of(rows):
            return np.asarray(rows, np.float32).reshape(-1, 3)

        def f32(values):
            return np.asarray(values, np.float32)

        def i32(values):
            return np.asarray(values, np.int32)

        mats = self.materials or [MaterialSpec()]
        uvs = (np.asarray(self.tri_uvs, np.float32).reshape(-1, 3, 2)
               if self.triangles else np.zeros((0, 3, 2), np.float32))
        if self.textures:
            th = max(t.shape[0] for t in self.textures)
            tw = max(t.shape[1] for t in self.textures)
            atlas = np.zeros((len(self.textures), th, tw, 3), np.float32)
            hw = np.zeros((len(self.textures), 2), np.int32)
            for k, t in enumerate(self.textures):
                atlas[k, :t.shape[0], :t.shape[1]] = t
                hw[k] = (t.shape[0], t.shape[1])
        else:
            atlas = np.zeros((0, 1, 1, 3), np.float32)
            hw = np.zeros((0, 2), np.int32)

        d = {
            "sph_center": vec3_of([s[0] for s in self.spheres]),
            "sph_radius": f32([s[1] for s in self.spheres]),
            "sph_mat": i32([s[2] for s in self.spheres]),
            "tri_mat": i32([t[6] for t in self.triangles]),
            "tri_uv0": uvs[:, 0], "tri_uv1": uvs[:, 1], "tri_uv2": uvs[:, 2],
            "textures": atlas, "tex_hw": hw,
            "pl_pos": vec3_of([p[0] for p in self.point_lights]),
            "pl_power": vec3_of([p[1] for p in self.point_lights]),
            "al_power": vec3_of([a[0] for a in self.area_lights]),
            "al_area": f32([a[1] for a in self.area_lights]),
            "al_tri0": i32([a[2] for a in self.area_lights]),
            "background": f32(self.background).reshape(3),
            "materials.diffuse": vec3_of([m.diffuse for m in mats]),
            "materials.specular": vec3_of([m.specular for m in mats]),
            "materials.absorption": vec3_of([m.absorption for m in mats]),
            "materials.emission": vec3_of([m.emission for m in mats]),
            "materials.spec_exp": f32([m.spec_exp for m in mats]),
            "materials.ior": f32([m.ior for m in mats]),
            "materials.diff_avg": f32([m.diff_avg for m in mats]),
            "materials.spec_avg": f32([m.spec_avg for m in mats]),
            "materials.refr_avg": f32([m.refr_avg for m in mats]),
            "materials.roughness": f32([m.roughness for m in mats]),
            "materials.flags": i32([m.flags for m in mats]),
            "materials.tex_id": i32([m.texture for m in mats]),
            "materials.nmap_id": i32([m.normal_map for m in mats]),
        }
        for i, name in enumerate(("tri_v0", "tri_v1", "tri_v2",
                                  "tri_n0", "tri_n1", "tri_n2")):
            d[name] = vec3_of([t[i] for t in self.triangles])
        return scene_from_numpy(d)


# -- small host-side transform helpers (degree-based, matching old glm) ------

def translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, np.float32)
    return m


def scale(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(v, np.float32)
    return m


def rotate_deg(angle_deg: float, axis) -> np.ndarray:
    """Axis-angle rotation in degrees (old glm's ``rotate`` took degrees,
    as used at ``Scene.cpp:254`` etc.)."""
    a = np.deg2rad(np.float32(angle_deg))
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    C = 1 - c
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ],
        np.float32,
    )
    return m
