"""Canned scenes, reproducing the reference's presets geometrically.

Behavioral spec: ``CudaTracer/Scene.cpp:17-371``. The "random" sphere scenes
replay the MSVC ``rand()`` stream (unseeded, so deterministic) to land the
spheres at the same coordinates the reference renders. MSVC evaluates the
``vec3(rnd(..), rnd(..), rnd(..))`` constructor arguments right-to-left, so
the z component consumes the first draw; we replicate that order.
"""
from __future__ import annotations

import numpy as np

from ..utils.msvc_rand import MsvcRand
from .scene import (
    MaterialSpec,
    MAT_FLAG_COOK_TORRANCE,
    MAT_FLAG_PURE_REFLECTION,
    Scene,
    SceneBuilder,
    rotate_deg,
    scale,
    translate,
)

INF = float("inf")


def add_random_spheres(b: SceneBuilder, rng: MsvcRand, num_spheres: int = 5):
    """Cook-Torrance spheres — ``Scene.cpp:173-225``."""
    mat0 = b.add_material(
        MaterialSpec(diffuse=(1.0, 0.1, 0.1), diff_avg=0.1, specular=(1.0, 0.2, 0.2),
                     spec_exp=INF, spec_avg=0.6, ior=1.7,
                     roughness=0.3, flags=MAT_FLAG_COOK_TORRANCE)
    )
    b.add_material(
        MaterialSpec(diffuse=(0.1, 0.1, 1.0), diff_avg=0.1, specular=(0.2, 0.2, 1.0),
                     spec_exp=INF, spec_avg=0.6, ior=1.7,
                     roughness=0.1, flags=MAT_FLAG_COOK_TORRANCE)
    )
    b.add_material(
        MaterialSpec(diffuse=(0.1, 1.0, 0.1), diff_avg=0.1, specular=(0.2, 1.0, 0.2),
                     spec_exp=INF, spec_avg=0.6, ior=1.7,
                     roughness=0.5, flags=MAT_FLAG_COOK_TORRANCE)
    )
    for i in range(num_spheres):
        rng.rnd_int(1), rng.rnd_int(1)  # two discarded draws (Scene.cpp:217)
        z = rng.rnd(7.0) - np.float32(9.0)   # RTL arg order: z draws first
        y = rng.rnd(5.0) - np.float32(2.5)
        x = rng.rnd(5.0) - np.float32(2.5)
        r = rng.rnd(1.0) + np.float32(0.2)
        b.add_sphere((x, y, z), r, mat0 + (i % 3))


def add_random_glass_spheres(b: SceneBuilder, rng: MsvcRand, num_spheres: int = 15):
    """Colored glass spheres with absorbance — ``Scene.cpp:115-167``."""
    mat0 = b.add_material(  # red glass (absorbs G+B)
        MaterialSpec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.0, specular=(1, 1, 1),
                     spec_exp=INF, spec_avg=0.7, ior=1.55,
                     absorption=(0.0, 0.75, 0.75), refr_avg=0.7)
    )
    b.add_material(  # blue glass
        MaterialSpec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.0, specular=(1, 1, 1),
                     spec_exp=INF, spec_avg=0.7, ior=1.55,
                     absorption=(0.75, 0.75, 0.0), refr_avg=0.7)
    )
    b.add_material(  # green glass
        MaterialSpec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.0, specular=(1, 1, 1),
                     spec_exp=INF, spec_avg=0.7, ior=1.55,
                     absorption=(0.75, 0.0, 0.75), refr_avg=0.7)
    )
    for i in range(num_spheres):
        rng.rnd_int(1), rng.rnd_int(1), rng.rnd_int(1)  # three discards (Scene.cpp:159)
        z = rng.rnd(7.0) - np.float32(9.0)
        y = rng.rnd(5.0) - np.float32(2.5)
        x = rng.rnd(5.0) - np.float32(2.5)
        r = rng.rnd(1.0) + np.float32(0.2)
        b.add_sphere((x, y, z), r, mat0 + (i % 3))


def add_defined_spheres(b: SceneBuilder, size: float = 4.0):
    """Two hand-placed spheres — ``Scene.cpp:98-109``."""
    mat0 = b.add_material(
        MaterialSpec(diffuse=(1.0, 0.0, 0.0), diff_avg=0.35, specular=(1, 1, 1),
                     spec_exp=250, spec_avg=0.6, ior=2.5)
    )
    b.add_material(
        MaterialSpec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.0, specular=(1, 1, 1),
                     spec_exp=300, spec_avg=0.9, ior=1.55,
                     absorption=(0.15, 0.15, 0.0), refr_avg=0.9)
    )
    b.add_sphere((-2.0, -(size - 1.5), -(size * 1.3)), 1.5, mat0 + 1)
    b.add_sphere((1.0, -(size - 1.0), -(size * 1.4)), 1.0, mat0)


def add_cornell_box(b: SceneBuilder, wall_size: float = 8.0) -> dict:
    """White/red/green box + mirror + one area light — ``Scene.cpp:231-294``.
    Returns the material handles by role so callers can retarget entries
    without depending on the table layout."""
    m_white = b.add_material(MaterialSpec(diffuse=(1.0, 1.0, 0.8), diff_avg=0.7))
    m_red = b.add_material(MaterialSpec(diffuse=(1.0, 0.0, 0.0), diff_avg=0.7))
    m_green = b.add_material(MaterialSpec(diffuse=(0.0, 1.0, 0.0), diff_avg=0.7))
    m_light = b.add_material(MaterialSpec(emission=(1.0, 1.0, 1.0)))
    m_mirror = b.add_material(
        MaterialSpec(diffuse=(0.0, 0.0, 0.0), diff_avg=0.0, specular=(1, 1, 1),
                     spec_exp=INF, spec_avg=0.8, ior=5.8)
    )

    off = wall_size / 2
    s_wall = scale((wall_size,) * 3)

    b.add_rect(translate((0, -off, -off)) @ rotate_deg(-90, (1, 0, 0)) @ s_wall, m_white)  # floor
    b.add_rect(translate((0, off, -off)) @ rotate_deg(90, (1, 0, 0)) @ s_wall, m_white)    # ceiling
    b.add_rect(translate((-off, 0, -off)) @ rotate_deg(90, (0, 1, 0)) @ s_wall, m_red)     # left
    b.add_rect(translate((off, 0, -off)) @ rotate_deg(-90, (0, 1, 0)) @ s_wall, m_green)   # right
    b.add_rect(  # mirror inset on the right wall
        translate((off - 0.02, 0, -off)) @ rotate_deg(-90, (0, 1, 0)) @ scale((wall_size - 2,) * 3),
        m_mirror,
    )
    b.add_rect(translate((0, 0, -wall_size)) @ s_wall, m_white)  # back

    power = 400.0
    b.add_area_light(
        translate((0, off - 0.01, -off)) @ rotate_deg(90, (1, 0, 0)) @ scale((2.5,) * 3),
        m_light,
        (power, power, power),
    )
    return {"white": m_white, "red": m_red, "green": m_green,
            "light": m_light, "mirror": m_mirror}


def add_mirror_box(b: SceneBuilder, wall_size: float = 10.0):
    """Three mirror walls + two area lights — ``Scene.cpp:301-371``."""
    m_white = b.add_material(MaterialSpec(diffuse=(1.0, 1.0, 0.8), diff_avg=0.7))
    b.add_material(MaterialSpec(diffuse=(1.0, 0.0, 0.0), diff_avg=0.7))   # red (unused)
    b.add_material(MaterialSpec(diffuse=(0.0, 1.0, 0.0), diff_avg=0.7))   # green (unused)
    m_light = b.add_material(MaterialSpec(emission=(1.0, 1.0, 1.0)))
    m_mirror = b.add_material(
        MaterialSpec(diffuse=(0.0, 0.0, 0.0), diff_avg=0.0, specular=(1, 1, 1),
                     spec_exp=INF, spec_avg=0.9, ior=5.8,
                     flags=MAT_FLAG_PURE_REFLECTION)
    )
    m_violet = b.add_material(MaterialSpec(emission=(1.0, 0.6, 1.0)))

    off = wall_size / 2
    s_wall = scale((wall_size,) * 3)

    b.add_rect(translate((0, -off, -off)) @ rotate_deg(-90, (1, 0, 0)) @ s_wall, m_white)      # floor
    b.add_rect(translate((0, off, -off)) @ rotate_deg(90, (1, 0, 0)) @ s_wall, m_mirror)       # ceiling
    b.add_rect(  # left wall, tilted 88 deg and pulled in
        translate((-off + 0.2 * off, 0, -off)) @ rotate_deg(88, (0, 1, 0)) @ s_wall, m_mirror
    )
    b.add_rect(translate((off, 0, -off)) @ rotate_deg(-90, (0, 1, 0)) @ s_wall, m_mirror)      # right
    b.add_rect(translate((0, 0, -wall_size)) @ s_wall, m_white)                                # back
    b.add_rect(translate((0, 0, 0)) @ rotate_deg(180, (0, 1, 0)) @ s_wall, m_white)            # front

    power = 400.0
    b.add_area_light(
        translate((0, off - 0.01, -off)) @ rotate_deg(90, (1, 0, 0)) @ scale((2.5,) * 3),
        m_light,
        (power / 4, power, power),
    )
    b.add_area_light(
        translate((0, -off + 0.01, -off)) @ rotate_deg(-90, (1, 0, 0)) @ scale((1.5,) * 3),
        m_violet,
        (power / 3, 0.0, power / 3),
    )


# ---------------------------------------------------------------------------
# Full presets
# ---------------------------------------------------------------------------

def showcase() -> Scene:
    """The reference's active configuration (``Scene.cpp:25-31``):
    5 Cook-Torrance + 15 glass spheres inside the 10-unit mirror box."""
    b = SceneBuilder()
    rng = MsvcRand()
    add_random_spheres(b, rng, 5)
    add_random_glass_spheres(b, rng, 15)
    add_mirror_box(b, 10.0)
    return b.build()


def cornell() -> Scene:
    """Cornell box with the two defined spheres (bench scene)."""
    b = SceneBuilder()
    add_defined_spheres(b, 4.0)
    add_cornell_box(b, 8.0)
    return b.build()


def cornell_random() -> Scene:
    """Cornell box with the 5 MSVC-rand spheres — the reference's alternate
    build (the commented-out ``addRandomSpheres(5)`` + ``addCornellBox(8)``
    pair, ``Scene.cpp:25-30``), the configuration its shipped
    ``renders/render1.png`` depicts. Same MSVC rand() replay as showcase."""
    b = SceneBuilder()
    rng = MsvcRand()
    add_random_spheres(b, rng, 5)
    add_cornell_box(b, 8.0)
    return b.build()


def cornell_empty() -> Scene:
    b = SceneBuilder()
    add_cornell_box(b, 8.0)
    return b.build()


def cornell_lambert() -> Scene:
    """Diffuse-only Cornell box (no mirror) — the minimal golden-test scene.
    Matches BASELINE config 1 ("Cornell-box spheres, Lambert-only")."""
    b = SceneBuilder()
    m_sph = b.add_material(MaterialSpec(diffuse=(0.2, 0.4, 1.0), diff_avg=0.8))
    b.add_sphere((-1.5, -2.5, -5.5), 1.5, m_sph)
    m_sph2 = b.add_material(MaterialSpec(diffuse=(1.0, 0.8, 0.2), diff_avg=0.8))
    b.add_sphere((1.8, -3.0, -4.5), 1.0, m_sph2)
    handles = add_cornell_box(b, 8.0)
    # knock out the mirror's specular behavior: retarget its material table
    # entry (by returned handle, not position) to diffuse white
    b.materials[handles["mirror"]] = MaterialSpec(diffuse=(1.0, 1.0, 0.8),
                                                  diff_avg=0.7)
    return b.build()


def textured() -> Scene:
    """Color + normal mapping showcase: checkered floor panel, UV-striped
    sphere, and a dimple-normal-mapped back panel inside the Cornell shell
    (the JAX package's preset of the same name, array for array)."""
    b = SceneBuilder()
    rng = np.random.default_rng(7)
    # 16x16 checker (color map)
    c = np.indices((16, 16)).sum(0) % 2
    checker = np.stack([0.9 * c + 0.1, 0.5 * np.ones_like(c),
                        0.9 * (1 - c) + 0.1], -1).astype(np.float32)
    tid_floor = b.add_texture(checker)
    # 32x32 longitude stripes (sphere color map)
    s = (np.indices((32, 32))[1] // 4) % 2
    stripes = np.stack([0.95 * s + 0.05, 0.2 + 0.6 * (1 - s),
                        0.95 * (1 - s) + 0.05], -1).astype(np.float32)
    tid_sph = b.add_texture(stripes)
    # 32x32 dimple normal map: smooth random tangent perturbations
    ang = rng.uniform(0, 2 * np.pi, (32, 32))
    amp = 0.35
    nmap = np.stack([0.5 + amp * np.cos(ang) * 0.5,
                     0.5 + amp * np.sin(ang) * 0.5,
                     0.9 * np.ones_like(ang)], -1).astype(np.float32)
    nid = b.add_texture(nmap)

    m_floor = b.add_material(MaterialSpec(diffuse=(1.0, 1.0, 1.0),
                                          diff_avg=0.8, texture=tid_floor))
    m_sph = b.add_material(MaterialSpec(diffuse=(1.0, 1.0, 1.0),
                                        diff_avg=0.8, texture=tid_sph))
    m_panel = b.add_material(MaterialSpec(diffuse=(0.85, 0.8, 0.6),
                                          diff_avg=0.8, normal_map=nid))
    # floor panel (two triangles with explicit UVs), slightly above the
    # cornell floor
    y = -3.95
    v = [(-3.0, y, -7.0), (3.0, y, -7.0), (3.0, y, -2.5), (-3.0, y, -2.5)]
    uv = [(0, 0), (3, 0), (3, 2), (0, 2)]
    n = (0.0, 1.0, 0.0)
    b.add_triangle(v[0], v[1], v[2], n, n, n, m_floor,
                   uv=(uv[0], uv[1], uv[2]))
    b.add_triangle(v[0], v[2], v[3], n, n, n, m_floor,
                   uv=(uv[0], uv[2], uv[3]))
    # striped sphere (procedural spherical UVs)
    b.add_sphere((-1.6, -2.5, -5.0), 1.5, m_sph)
    # normal-mapped panel leaning on the back wall
    nz = (0.0, 0.0, 1.0)
    pv = [(0.6, -3.9, -7.6), (3.4, -3.9, -7.6), (3.4, -1.2, -7.9),
          (0.6, -1.2, -7.9)]
    puv = [(0, 0), (2, 0), (2, 2), (0, 2)]
    b.add_triangle(pv[0], pv[1], pv[2], nz, nz, nz, m_panel,
                   uv=(puv[0], puv[1], puv[2]))
    b.add_triangle(pv[0], pv[2], pv[3], nz, nz, nz, m_panel,
                   uv=(puv[0], puv[2], puv[3]))
    add_cornell_box(b, 8.0)
    return b.build()


def caustic() -> Scene:
    """Cornell box with a clear glass sphere between the ceiling light and
    the floor — the canonical bidirectional test scene: the sphere focuses
    the light into a floor caustic (a light-path family: specular chain
    from the emitter landing on a diffuse surface) while the sphere itself
    is a camera-visible specular surface (an eye-path family). Pure light
    tracing renders the caustic but a black sphere; pure forward tracing
    renders the sphere but a noisy caustic; ``render_bidir`` gets both
    (render/bidir.py, tests/test_bidir.py)."""
    b = SceneBuilder()
    m_glass = b.add_material(MaterialSpec(
        diffuse=(0.0, 0.0, 0.0), diff_avg=0.0, specular=(1.0, 1.0, 1.0),
        spec_exp=INF, spec_avg=0.08, refr_avg=0.92, ior=1.5))
    # paraxial focus of a glass ball lens: f = R n / (2 (n - 1)) = 2.1 below
    # the center -> center 2.1 above the floor puts the focal point ON the
    # floor (tight, bright caustic disk); off-center so the camera sees the
    # sphere AND the caustic spot unoccluded
    b.add_sphere((1.8, -1.9, -4.5), 1.4, m_glass)
    add_cornell_box(b, 8.0)
    return b.build()


def shadowed_caustic() -> Scene:
    """A glass ball focusing a small emitter onto a floor that sees the
    light ONLY through the glass (round 5): the floor quad fits inside the
    sphere's shadow cone, there are no walls, and the emitter sits outside
    the default camera's fov — so EYE paths reach the light only via rare
    double-refraction chains while LIGHT paths hit the floor every time.
    The canonical scene for caustic-driven INVERSE rendering: forward-only
    gradients are variance-dominated here (spiky overestimates collapse an
    emission fit toward zero) while make_loss(engine='bidir') trains
    cleanly — quantified in tests/test_bidir.py."""
    b = SceneBuilder()
    m_glass = b.add_material(MaterialSpec(
        diffuse=(0.0, 0.0, 0.0), diff_avg=0.0, specular=(1.0, 1.0, 1.0),
        spec_exp=INF, spec_avg=0.08, refr_avg=0.92, ior=1.5))
    m_floor = b.add_material(MaterialSpec(diffuse=(0.85, 0.85, 0.85),
                                          diff_avg=0.85))
    m_light = b.add_material(MaterialSpec(emission=(22.0, 15.0, 6.0)))
    # focal point of a ball lens r=1.2, n=1.5: f = r*n/(2(n-1)) = 1.8
    # below the center -> center 1.8 above the floor focuses ON the floor
    b.add_sphere((0.0, -0.2, -4.0), 1.2, m_glass)
    b.add_rect(translate((0.0, -2.0, -4.0)) @ rotate_deg(-90, (1, 0, 0))
               @ scale((2.8,) * 3), m_floor)
    b.add_area_light(translate((0.0, 4.5, -4.0)) @ rotate_deg(90, (1, 0, 0))
                     @ scale((0.35,) * 3), m_light, (4.0, 4.0, 4.0))
    b.background = np.zeros(3, np.float32)
    return b.build()


def glass_showcase() -> Scene:
    """Glass spheres in a Cornell box — BASELINE config 3 flavor."""
    b = SceneBuilder()
    rng = MsvcRand()
    add_random_glass_spheres(b, rng, 8)
    add_defined_spheres(b, 4.0)
    add_cornell_box(b, 8.0)
    return b.build()


def stress(num_spheres: int = 120) -> Scene:
    """Large-scene stress preset: a grid of mixed glass / Cook-Torrance /
    diffuse spheres in the Cornell box — the reference caps out at 36
    primitives; this does not."""
    b = SceneBuilder()
    m_glass = b.add_material(MaterialSpec(
        diffuse=(1, 1, 1), diff_avg=0.0, specular=(1, 1, 1), spec_exp=INF,
        spec_avg=0.7, ior=1.55, absorption=(0.3, 0.1, 0.4), refr_avg=0.7))
    m_ct = b.add_material(MaterialSpec(
        diffuse=(0.9, 0.6, 0.2), diff_avg=0.15, specular=(1.0, 0.8, 0.4),
        spec_exp=INF, spec_avg=0.55, ior=1.8, roughness=0.25,
        flags=MAT_FLAG_COOK_TORRANCE))
    m_diff = b.add_material(MaterialSpec(diffuse=(0.3, 0.5, 0.9), diff_avg=0.75))
    rng = MsvcRand(seed=7)
    side = int(round(num_spheres ** (1 / 3))) + 1
    count = 0
    for gz in range(side):
        for gy in range(side):
            for gx in range(side):
                if count >= num_spheres:
                    break
                x = -3.0 + 6.0 * gx / max(side - 1, 1) + rng.rnd(0.4) - 0.2
                y = -3.0 + 6.0 * gy / max(side - 1, 1) + rng.rnd(0.4) - 0.2
                z = -7.0 + 5.0 * gz / max(side - 1, 1) + rng.rnd(0.4) - 0.2
                r = 0.25 + rng.rnd(0.25)
                b.add_sphere((x, y, z), r, (m_glass, m_ct, m_diff)[count % 3])
                count += 1
    add_cornell_box(b, 8.0)
    return b.build()


def _icosahedron_obj() -> str:
    """Icosahedron as OBJ text (smooth normals computed by the loader)."""
    import math
    phi = (1 + math.sqrt(5)) / 2
    raw = [(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
           (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
           (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    norm = math.sqrt(1 + phi * phi)
    lines = [f"v {x/norm} {y/norm} {z/norm}" for x, y, z in raw]
    lines += [f"f {a+1} {b+1} {c+1}" for a, b, c in faces]
    return "\n".join(lines)


def mesh_demo() -> Scene:
    """Smooth-shaded icosahedron mesh (OBJ path) in the Cornell box —
    barycentric normal interpolation (Primitives.h:71-73) with genuinely
    varying per-vertex normals, which no rect-built preset has."""
    from ..utils.obj import add_obj_mesh

    b = SceneBuilder()
    m_gold = b.add_material(MaterialSpec(
        diffuse=(0.9, 0.7, 0.2), diff_avg=0.5, specular=(1.0, 0.9, 0.5),
        spec_exp=80.0, spec_avg=0.35, ior=2.5))
    add_obj_mesh(b, _icosahedron_obj(), m_gold,
                 transform=translate((0.0, -1.6, -5.0)) @ scale((1.6,) * 3),
                 from_text=True)
    add_cornell_box(b, 8.0)
    return b.build()


def point_light_spheres() -> Scene:
    """Point-light-only scene (exercises the point-light NEE path,
    ``CudaTracer.cu:354-367``; the reference ships this disabled at
    ``Scene.cpp:21-22``)."""
    b = SceneBuilder()
    b.add_point_light((0.0, 0.0, 2.5), (500.0, 500.0, 500.0))
    b.add_point_light((2.0, 9.0, -5.0), (500.0, 500.0, 500.0))
    add_defined_spheres(b, 4.0)
    add_cornell_box(b, 8.0)
    return b.build()


def stress_dense(num_spheres: int = 10000) -> Scene:
    """Acceleration-structure benchmark: ``num_spheres`` spheres on a
    jittered lattice filling the Cornell box, radii scaled to the lattice
    spacing so per-grid-cell occupancy stays O(1) at ANY count (unlike
    ``stress``, whose fixed 0.25-0.5 radii merge into a solid blob past a
    few hundred). This is the scale regime of the reference's own
    acceleration TODO (CudaTracer.cu:437) — a linear sweep tests every
    ray against all N primitives per bounce."""
    b = SceneBuilder()
    m_diff = b.add_material(MaterialSpec(diffuse=(0.3, 0.5, 0.9),
                                         diff_avg=0.75))
    m_red = b.add_material(MaterialSpec(diffuse=(0.8, 0.3, 0.2),
                                        diff_avg=0.7))
    m_mirror = b.add_material(MaterialSpec(
        diffuse=(1, 1, 1), diff_avg=0.0, specular=(0.9, 0.9, 0.9),
        spec_exp=INF, spec_avg=0.8, ior=INF))
    rng = MsvcRand(seed=11)
    # ceil: round() under-fills the lattice (round(40**(1/3)) = 3 -> 27
    # sites) and would silently deliver fewer spheres than requested
    side = max(2, int(np.ceil(num_spheres ** (1 / 3) - 1e-9)))
    spacing = 7.0 / (side - 1)
    count = 0
    for gz in range(side):
        for gy in range(side):
            for gx in range(side):
                if count >= num_spheres:
                    break
                x = -3.5 + spacing * gx + (rng.rnd(0.6) - 0.3) * spacing
                y = -3.5 + spacing * gy + (rng.rnd(0.6) - 0.3) * spacing
                z = -8.5 + spacing * gz + (rng.rnd(0.6) - 0.3) * spacing
                r = spacing * (0.15 + rng.rnd(0.15))
                b.add_sphere((x, y, z), r,
                             (m_diff, m_red, m_mirror)[count % 3])
                count += 1
    add_cornell_box(b, 10.0)
    return b.build()


def mesh_dense(subdiv: int = 4) -> Scene:
    """Dense-mesh acceleration benchmark: an icosphere with 20*4^subdiv
    triangles (subdiv=4 -> 5120) in the Cornell box. Unlike stress_dense's
    sphere soup (geometry filling the whole frustum), this is the
    production-shaped workload — a compact mesh in mostly-empty space."""
    import math

    b = SceneBuilder()
    m = b.add_material(MaterialSpec(diffuse=(0.75, 0.6, 0.3), diff_avg=0.8))
    phi = (1 + math.sqrt(5)) / 2
    verts = [(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
             (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
             (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)]
    verts = [np.asarray(v, np.float64) for v in verts]
    verts = [v / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdiv):
        cache = {}

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                v = verts[i] + verts[j]
                verts.append(v / np.linalg.norm(v))
                cache[key] = len(verts) - 1
            return cache[key]

        faces = [t for (a, c, d) in faces
                 for t in ((a, mid(a, c), mid(a, d)),
                           (c, mid(c, d), mid(a, c)),
                           (d, mid(a, d), mid(c, d)),
                           (mid(a, c), mid(c, d), mid(a, d)))]
    center = np.asarray([0.0, -1.0, -5.5])
    r = 2.0
    for (a, c, d) in faces:
        p = [center + r * verts[k] for k in (a, c, d)]
        n = [verts[k] for k in (a, c, d)]          # smooth normals
        b.add_triangle(p[0], p[1], p[2], n[0], n[1], n[2], m)
    add_cornell_box(b, 10.0)
    return b.build()


def textured_quad(tex: bool = True, nmap: bool = False,
                  sphere: bool = False) -> Scene:
    """The JAX package's texture test scene (its ``tests/test_texture.py``
    quad): a 2x2 red / blue checker color map and / or a constant tilted
    normal map on a UV-mapped quad (or a sphere with procedural UVs) lit by a
    point light, on black. Not a preset: the multi-device certification run
    (``parallel/dryrun.py``) and ``chip_smoke.py`` train on it."""
    b = SceneBuilder()
    checker = np.zeros((2, 2, 3), np.float32)
    checker[:, 0] = (1.0, 0.1, 0.1)   # left texel column red
    checker[:, 1] = (0.1, 0.1, 1.0)   # right column blue
    tid = b.add_texture(checker) if tex else -1
    nid = -1
    if nmap:
        nm = np.zeros((2, 2, 3), np.float32)
        nm[..., 0], nm[..., 1], nm[..., 2] = 0.85, 0.5, 0.9
        nid = b.add_texture(nm)
    m = b.add_material(MaterialSpec(diffuse=(1.0, 1.0, 1.0), diff_avg=0.8,
                                    texture=tid, normal_map=nid))
    if sphere:
        b.add_sphere((0.0, 0.0, -4.0), 1.6, m)
    else:
        v = [(-2, -2, -4), (2, -2, -4), (2, 2, -4), (-2, 2, -4)]
        uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
        n = (0, 0, 1)
        b.add_triangle(v[0], v[1], v[2], n, n, n, m, uv=(uv[0], uv[1], uv[2]))
        b.add_triangle(v[0], v[2], v[3], n, n, n, m, uv=(uv[0], uv[2], uv[3]))
    b.add_point_light((0.0, 0.0, -1.0), (60.0, 60.0, 60.0))
    b.background = np.zeros(3, np.float32)
    return b.build()


PRESETS = {
    "showcase": showcase,
    "mirror_box": showcase,
    "cornell": cornell,
    "cornell_random": cornell_random,
    "cornell_empty": cornell_empty,
    "cornell_lambert": cornell_lambert,
    "caustic": caustic,
    "shadowed_caustic": shadowed_caustic,
    "textured": textured,
    "glass": glass_showcase,
    "point_lights": point_light_spheres,
    "stress": stress,
    "stress_dense": stress_dense,
    "mesh": mesh_demo,
    "mesh_dense": mesh_dense,
}


def get_scene(name: str) -> Scene:
    if name not in PRESETS:
        raise KeyError(f"unknown scene preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()
