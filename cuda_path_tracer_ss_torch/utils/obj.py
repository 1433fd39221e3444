"""Wavefront OBJ loading (numpy only): the port's copy of the JAX package's
``utils/obj.py``, function for function.

The reference lists OBJ support among its slated features (README.md:30) but
never implemented it; here it is. Supports v / vn / f records with the usual
``v``, ``v//vn`` and ``v/vt/vn`` face syntaxes, fan-triangulates polygons,
and computes area-weighted smooth vertex normals when the file provides none
— the barycentric normal interpolation the estimator already performs
(``Primitives.h:71-73`` semantics) then gives smooth shading for free.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def parse_obj(text: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse OBJ text -> (vertices [V,3], faces [F,3] int, normals [F,3,3]).

    Faces are triangles (polygons fan-triangulated). Normals are per-corner;
    if the file has ``vn`` records they are used, otherwise smooth vertex
    normals are computed by area-weighted face-normal accumulation.
    """
    v, f, n, _, _ = parse_obj_ex(text)
    return v, f, n


def parse_obj_ex(text: str):
    """Like ``parse_obj`` but also returns per-corner texture coordinates
    ([F, 3, 2], zeros where the file has no ``vt``) and the per-face
    material name list (from ``usemtl`` records; None for faces before the
    first usemtl): ``(v, f, n, uv, mtls)``."""
    verts: list = []
    vns: list = []
    vts: list = []
    faces: list = []       # triples of vertex indices
    face_vns: list = []    # triples of vn indices or None
    face_vts: list = []    # triples of vt indices or None
    face_mtls: list = []   # material name (usemtl) per emitted triangle
    current_mtl: Optional[str] = None

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if parts[0] == "v" and len(parts) >= 4:
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif parts[0] == "vn" and len(parts) >= 4:
            vns.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif parts[0] == "vt" and len(parts) >= 3:
            vts.append([float(parts[1]), float(parts[2])])
        elif parts[0] == "usemtl" and len(parts) >= 2:
            current_mtl = parts[1]
        elif parts[0] == "f" and len(parts) >= 4:
            corners = []
            for p in parts[1:]:
                comps = p.split("/")
                # 1-based; negatives are relative to the counts at THIS
                # statement (the OBJ spec), not end-of-file
                vi = int(comps[0])
                vi = vi - 1 if vi > 0 else len(verts) + vi
                ni: Optional[int] = None
                if len(comps) == 3 and comps[2]:
                    ni = int(comps[2])
                    ni = ni - 1 if ni > 0 else len(vns) + ni
                ti: Optional[int] = None
                if len(comps) >= 2 and comps[1]:
                    ti = int(comps[1])
                    ti = ti - 1 if ti > 0 else len(vts) + ti
                corners.append((vi, ni, ti))
            # fan triangulation
            for k in range(1, len(corners) - 1):
                tri = [corners[0], corners[k], corners[k + 1]]
                faces.append([c[0] for c in tri])
                face_vns.append([c[1] for c in tri])
                face_vts.append([c[2] for c in tri])
                face_mtls.append(current_mtl)

    v = np.asarray(verts, np.float32)
    nv = len(verts)
    f = np.asarray(faces, np.int32).reshape(-1, 3)

    if vns and all(all(n is not None for n in tri) for tri in face_vns):
        vn_arr = np.asarray(vns, np.float32)
        n = np.stack([
            [vn_arr[ni] for ni in tri]
            for tri in face_vns
        ]).astype(np.float32)
    else:
        # area-weighted smooth vertex normals
        acc = np.zeros((nv, 3), np.float64)
        for tri in f:
            e1 = v[tri[1]] - v[tri[0]]
            e2 = v[tri[2]] - v[tri[0]]
            fn = np.cross(e1, e2)  # length = 2x area: the weighting
            for vi in tri:
                acc[vi] += fn
        lens = np.linalg.norm(acc, axis=1, keepdims=True)
        acc = acc / np.maximum(lens, 1e-20)
        n = acc[f].astype(np.float32)

    uv = np.zeros((len(faces), 3, 2), np.float32)
    if vts:
        vt_arr = np.asarray(vts, np.float32)
        for fi, tri in enumerate(face_vts):
            for ci, ti in enumerate(tri):
                if ti is not None:
                    uv[fi, ci] = vt_arr[ti]

    return v, f, n, uv, face_mtls


def load_obj(path: str):
    with open(path) as fh:
        return parse_obj(fh.read())


def parse_mtl(text: str):
    """Parse MTL text -> ordered dict of ``name -> MaterialSpec``.

    Projection of the Blinn-Phong MTL model onto the reference's material
    model (RenderStructs.h:98-106 — weights double as branch
    probabilities):

    - ``Kd`` -> diffuse, with ``diff_avg = mean(Kd)`` (the diffuse branch
      probability the reference derives from its albedo weights)
    - ``Ks`` -> specular, ``spec_avg = mean(Ks)``; ``Ns`` -> spec_exp
      (Ns >= 1000 promotes to the perfect-mirror INF convention)
    - ``Ke`` -> emission
    - ``Ni`` -> ior; dissolve ``d < 1`` (or ``Tr > 0``) -> refractive
      branch: ``refr_avg = 1 - d``, absorption from the complement of Kd
    - ``Pr`` (PBR roughness extension) -> roughness, flags |= Cook-Torrance
    - ``map_Kd`` / ``map_bump``/``norm`` file references are collected by
      ``parse_mtl_ex`` (this wrapper drops them); ``add_obj_with_mtl``
      loads the images and binds them as color/normal maps
    """
    return parse_mtl_ex(text)[0]


def parse_mtl_ex(text: str):
    """``parse_mtl`` + texture file references:
    ``(specs, {mtl_name: {"map_kd": path, "map_bump": path}})``."""
    from ..models.scene import MaterialSpec

    mats: dict = {}
    cur: Optional[dict] = None

    def f3(parts):
        return (float(parts[1]), float(parts[2]), float(parts[3]))

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        p = line.split()
        key = p[0].lower()
        if key == "newmtl" and len(p) >= 2:
            cur = {"name": p[1]}
            mats[p[1]] = cur
        elif cur is None:
            continue
        elif key == "kd" and len(p) >= 4:
            cur["Kd"] = f3(p)
        elif key == "ks" and len(p) >= 4:
            cur["Ks"] = f3(p)
        elif key == "ke" and len(p) >= 4:
            cur["Ke"] = f3(p)
        elif key == "ns" and len(p) >= 2:
            cur["Ns"] = float(p[1])
        elif key == "ni" and len(p) >= 2:
            cur["Ni"] = float(p[1])
        elif key == "d" and len(p) >= 2:
            cur["d"] = float(p[1])
        elif key == "tr" and len(p) >= 2:
            cur["d"] = 1.0 - float(p[1])
        elif key == "pr" and len(p) >= 2:
            cur["Pr"] = float(p[1])
        elif key == "map_kd" and len(p) >= 2:
            cur["map_kd"] = p[-1]       # ignore -o/-s options, take the file
        elif key in ("map_bump", "bump", "norm") and len(p) >= 2:
            cur["map_bump"] = p[-1]

    out = {}
    texfiles = {}
    for name, m in mats.items():
        kd = m.get("Kd", (0.0, 0.0, 0.0))
        ks = m.get("Ks", (0.0, 0.0, 0.0))
        ns = m.get("Ns", 0.0)
        if ns >= 1000.0:
            ns = float("inf")
        d = m.get("d", 1.0)
        refr = max(0.0, min(1.0, 1.0 - d))
        rough = m.get("Pr", 0.0)
        out[name] = MaterialSpec(
            diffuse=kd,
            diff_avg=max(0.0, min(1.0, sum(kd) / 3.0)) * d,
            specular=ks,
            spec_exp=ns,
            spec_avg=max(0.0, min(1.0, sum(ks) / 3.0)),
            ior=m.get("Ni", 1.0),
            absorption=tuple(max(0.0, 1.0 - c) for c in kd) if refr > 0
            else (0.0, 0.0, 0.0),
            refr_avg=refr,
            emission=m.get("Ke", (0.0, 0.0, 0.0)),
            roughness=rough,
            flags=3 if rough > 0 else 0,
        )
        refs = {}
        if "map_kd" in m:
            refs["map_kd"] = m["map_kd"]
        if "map_bump" in m:
            refs["map_bump"] = m["map_bump"]
        texfiles[name] = refs
    return out, texfiles


def _find_mtllib(text: str) -> Optional[str]:
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if line.lower().startswith("mtllib ") and len(line.split()) >= 2:
            return line.split(None, 1)[1]
    return None


def add_obj_with_mtl(builder, obj_source: str, material_idx: int,
                     mtl_source: Optional[str] = None,
                     transform: Optional[np.ndarray] = None,
                     from_text: bool = False):
    """``add_obj_mesh`` + material library: resolves the OBJ's ``mtllib``
    (or an explicit ``mtl_source``), registers each ``newmtl`` on the
    builder, and assigns faces by their ``usemtl`` records. Faces without
    a (known) usemtl fall back to ``material_idx``. Returns
    (triangle_count, {mtl_name: material_index})."""
    import os

    if from_text:
        text = obj_source
    else:
        with open(obj_source) as fh:
            text = fh.read()
    mtl_text = None
    if mtl_source is not None:
        mtl_text = mtl_source if from_text else open(mtl_source).read()
    elif not from_text:
        lib = _find_mtllib(text)
        if lib:
            cand = os.path.join(os.path.dirname(obj_source), lib)
            if os.path.exists(cand):
                with open(cand) as fh:
                    mtl_text = fh.read()
    mmap = {}
    if mtl_text:
        import dataclasses

        from .image import read_png

        specs, texfiles = parse_mtl_ex(mtl_text)
        base = "" if from_text else os.path.dirname(
            mtl_source if mtl_source is not None else obj_source)
        tex_cache: dict = {}

        def load_tex(fn):
            if fn not in tex_cache:
                path = fn if from_text else os.path.join(base, fn)
                tex_cache[fn] = (builder.add_texture(read_png(path))
                                 if os.path.exists(path) else -1)
            return tex_cache[fn]

        for name, spec in specs.items():
            refs = texfiles.get(name, {})
            if "map_kd" in refs:
                tid = load_tex(refs["map_kd"])
                if tid >= 0:
                    spec = dataclasses.replace(spec, texture=tid)
            if "map_bump" in refs:
                nid = load_tex(refs["map_bump"])
                if nid >= 0:
                    spec = dataclasses.replace(spec, normal_map=nid)
            mmap[name] = builder.add_material(spec)
    count = add_obj_mesh(builder, text, material_idx, transform=transform,
                         from_text=True, material_map=mmap)
    return count, mmap


def add_obj_mesh(builder, source: str, material_idx: int,
                 transform: Optional[np.ndarray] = None,
                 from_text: bool = False,
                 material_map: Optional[dict] = None):
    """Add an OBJ mesh's triangles to a SceneBuilder, optionally under a 4x4
    transform (normals via inverse-transpose, as the rect builder does).

    ``material_map`` maps ``usemtl`` names to material indices; faces whose
    usemtl name is absent (or appears before any usemtl record) fall back to
    ``material_idx``.
    """
    if from_text:
        text = source
    else:
        with open(source) as fh:
            text = fh.read()
    v, f, n, uv, mtls = parse_obj_ex(text)
    if transform is not None:
        t = np.asarray(transform, np.float32)
        vh = np.concatenate([v, np.ones((len(v), 1), np.float32)], -1)
        v = (vh @ t.T)[:, :3]
        nt = np.linalg.inv(t[:3, :3]).T
        n = n @ nt.T
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    mmap = material_map or {}
    for tri, tri_n, tri_uv, mtl in zip(f, n, uv, mtls):
        midx = mmap.get(mtl, material_idx)
        builder.add_triangle(v[tri[0]], v[tri[1]], v[tri[2]],
                             tri_n[0], tri_n[1], tri_n[2], midx, uv=tri_uv)
    return len(f)
