"""Differentiable rendering: gradients, FD checking, inverse rendering.

The reference is forward-only; differentiability is a capability of this
rewrite: dL/d(material parameters, light powers and positions, sphere and
triangle geometry, camera) of an image loss, and gradient descent on it, on
the reference-parity estimator or (``physical=True``) the unbiased one. A loss renders
through ``render_megakernel_diff`` (``ops/cuda/megakernel_vjp.py``): on a CUDA
device the forward megakernel and the replay-VJP kernel, on the CPU autograd
through the plain PyTorch render; or (``engine="eager"``) by autograd through
the eager engine (``render/integrator.py``), on any device; or by autograd
through light paths on the eager engine: ``engine="lighttrace"``
(``render/lighttrace.py``) and ``engine="bidir"`` (``render/bidir.py``), both
of the physical estimator. Discrete branch /
hit / visibility decisions are detached and continuous factors
differentiated, so gradients match finite differences on the same random
streams.

Parameters are a dict ``{field name: tensor}``; names address nested
dataclass fields with dots, 3-vector fields are ``[N, 3]`` tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from ..constants import DEFAULT_MAX_BOUNCES
from ..models.scene import Scene
from ..ops.cuda import megakernel_vjp as vjp
from ..ops.cuda.megakernel import pack_grid, pack_scene
from ..ops.grid import build_grid
from ..utils import rng
from . import integrator

# Scene leaves it makes sense to optimize.
TRAINABLE_FIELDS = (
    "materials.diffuse",
    "materials.specular",
    "materials.emission",
    "materials.absorption",
    "materials.roughness",
    "materials.spec_exp",
    "materials.diff_avg",
    "materials.spec_avg",
    "materials.refr_avg",
    "materials.ior",
    "al_power",
    "pl_power",
    "pl_pos",
    "sph_center",
    "sph_radius",
    "textures",   # texel values (color / normal maps): inverse texture painting
)

# "cuda": the CUDA kernels (needs a CUDA device); "plain": autograd through
# the plain PyTorch render (any device); "eager": autograd through the eager
# engine, the counterpart of the JAX package's jnp engine (any device);
# "lighttrace" / "bidir": autograd through the eager engine's light paths
# alone / MIS-combined with its eye paths (any device; physical=True).
LIGHT_ENGINES = ("lighttrace", "bidir")
ENGINES = ("cuda", "plain", "eager") + LIGHT_ENGINES


def get_field(scene: Scene, name: str) -> torch.Tensor:
    obj = scene
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def with_field(scene: Scene, name: str, value) -> Scene:
    parts = name.split(".")

    def rebuild(obj, parts, value):
        if len(parts) == 1:
            return dataclasses.replace(obj, **{parts[0]: value})
        child = rebuild(getattr(obj, parts[0]), parts[1:], value)
        return dataclasses.replace(obj, **{parts[0]: child})

    return rebuild(scene, parts, torch.as_tensor(value))


def extract_params(scene: Scene, names: Iterable[str]) -> Dict[str, torch.Tensor]:
    return {n: get_field(scene, n) for n in names}


def merge_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    for n, v in params.items():
        scene = with_field(scene, n, v)
    return scene


# Fields the replay VJP differentiates. The full path adjoint covers every
# exposed trainable field, triangle geometry included (grad_mode="geo"), on
# either estimator (on a textured scene the texels too); the cheaper "linear"
# backward covers only the throughput-linear subset (plus the texels of a
# color-mapped scene) of the parity estimator, and make_loss picks it
# automatically when the optimized fields allow.
def pallas_trainable(physical: bool = False) -> frozenset:
    return (vjp.PALLAS_TRAINABLE_FIELDS_PHYS_GEO if physical
            else vjp.PALLAS_TRAINABLE_FIELDS_GEO)


def pallas_trainable_linear() -> frozenset:
    return vjp.PALLAS_TRAINABLE_FIELDS


def _check_engine(engine: str) -> None:
    if engine == "jnp":
        raise ValueError("unknown engine 'jnp': the JAX package's jnp "
                         "engine is engine='eager' here")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")


def _check_grid_engine(engine: str) -> None:
    if engine in LIGHT_ENGINES:
        raise ValueError(f"engine='{engine}' does not take accel='grid'"
                         " (the adjoint tracer uses the linear sweeps)")


def check_engine_fields(engine: str, field_names, physical: bool = False,
                        scene=None) -> None:
    """Raise early if the chosen engine cannot differentiate a field — a
    silent zero gradient is the failure mode this guards against. The cuda
    and plain engines differentiate the same set: the plain engine detaches
    what the kernel detaches. Pass ``scene`` so that a textured scene gets
    its field set (the texels as well). The eager, lighttrace and bidir
    engines, like the reference's, are full autograd and restrict only the
    fields their estimator never reads."""
    _check_engine(engine)
    if engine == "lighttrace":
        # light paths emit materials.emission and meet no point light: these
        # fields would get a silent zero gradient
        bad = [f for f in field_names
               if f in ("al_power", "pl_power", "pl_pos")]
        if bad:
            raise ValueError(
                f"engine='lighttrace' has no gradient for {bad}: light "
                "paths emit materials.emission and ignore point lights — "
                "optimize 'materials.emission' (or use engine='eager')")
    if engine == "bidir":
        # both halves are physical: area lights emit their material's
        # emission, never al_power (point lights live in the eye half)
        if "al_power" in field_names:
            raise ValueError(
                "engine='bidir' has no gradient for ['al_power']: the "
                "physical estimator emits materials.emission — optimize "
                "'materials.emission' instead")
    if engine in ("eager",) + LIGHT_ENGINES:
        return
    textured = scene is not None and getattr(scene, "num_textures", 0) > 0
    ok = pallas_trainable(physical)
    if textured:
        ok = ok | frozenset({"textures"})
    if "materials.spec_avg" in field_names and not physical:
        # in the parity estimator spec_avg only gates the detached branch
        # choice: a structurally zero gradient, refused rather than returned
        raise ValueError(
            f"engine='{engine}' has no gradient for ['materials.spec_avg']: "
            "in the reference-parity estimator it only gates a detached "
            "branch choice; it carries a real gradient in the physical "
            "estimator (physical=True)")
    bad = [f for f in field_names if f not in ok]
    if bad:
        raise ValueError(
            f"engine='{engine}' (physical={physical}) has no gradient for "
            f"{bad}; its VJP covers {sorted(ok)}")


def _grad_mode_for(field_names, scene=None, physical: bool = False) -> str:
    """The throughput-linear backward kernel is leaner; it is used whenever
    the caller names its optimized fields, none needs the path adjoint and
    the estimator is the parity one. On a textured scene the linear backward
    also trains the texels of color maps, but not those of normal maps (they
    need the full path adjoint's perturbation pullback). Triangle fields
    take the geo backward."""
    if field_names is not None and set(field_names) & vjp.TRI_FIELDS:
        return "geo"
    if physical:
        return "full"
    lean = pallas_trainable_linear()
    if scene is not None and getattr(scene, "num_textures", 0) > 0:
        has_nmap = bool((scene.materials.nmap_id >= 0).any())
        if not has_nmap:
            lean = vjp.PALLAS_TRAINABLE_FIELDS_TEX
    if field_names is not None and set(field_names) <= lean:
        return "linear"
    return "full"


def make_loss(scene: Scene, cam_params, target, width: int, height: int,
              spp: int, max_bounces: int = 8, engine: str = "cuda",
              accel: str = "none", field_names=None,
              physical: bool = False, device=None) -> Callable:
    """Returns ``loss(params, seed)`` — MSE between the rendered radiance
    image and ``target`` (a 0-d tensor that back-propagates into
    ``params``). Passing the RNG seed as an argument keeps one loss for both
    fixed-stream (deterministic) and resampled (stochastic) optimization.

    ``engine="cuda"`` renders with the forward megakernel and
    back-propagates with the replay-VJP kernel; ``engine="plain"`` is
    autograd through the plain PyTorch render; ``engine="eager"`` is
    autograd through the eager engine's ``render`` (``live_cutoff=None``).
    All consume identical RNG streams, so losses and gradients agree to
    float tolerance. ``engine="lighttrace"`` renders ``spp * width *
    height`` light paths (``render_lighttrace``), ``engine="bidir"`` adds
    them to ``spp`` eye samples under MIS weights (``render_bidir``); both
    estimate the physical integral and need ``physical=True``, and splat
    pixels are detached as every discrete decision is. ``device`` defaults
    to "cpu" for the plain engine and to "cuda" for the others; the loss
    lives on it.
    ``loss.grad_mode`` tells which backward was picked ("autograd" on the
    eager engine).

    ``accel="grid"`` builds the uniform grid (``ops/grid.py``) ONCE from the
    initial scene and sweeps through it in every evaluation, forward and
    backward. Valid while the optimized fields leave geometry fixed; moving
    spheres across cell boundaries needs a rebuild. ``physical=True`` renders
    and differentiates the unbiased estimator (its target must be a physical
    render too)."""
    if accel not in ("none", "grid"):
        raise ValueError(f"unknown accel {accel!r}; use 'none' or 'grid'")
    if accel == "grid":
        _check_grid_engine(engine)
    _check_engine(engine)
    device = torch.device(device if device is not None
                          else ("cpu" if engine == "plain" else "cuda"))
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, got {device}")
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.array(target, np.float32))
    if engine in LIGHT_ENGINES:
        return _light_loss(scene, cam_params, target, width, height, spp,
                           max_bounces, engine, physical, device)
    if engine == "eager":
        device = integrator.resolve_device(device)
        target = target.to(device=device, dtype=torch.float32)
        egrid = build_grid(scene).to(device) if accel == "grid" else None

        def eager_loss(params, seed):
            img = integrator.render(merge_params(scene, params), cam_params,
                                    width, height, spp, int(seed),
                                    max_bounces=max_bounces, live_cutoff=None,
                                    grid=egrid, physical=physical,
                                    device=device)
            return torch.mean((img - target) ** 2)

        eager_loss.grad_mode = "autograd"
        return eager_loss
    grad_mode = _grad_mode_for(field_names, scene, physical)
    render = (vjp.render_megakernel_diff if engine == "cuda"
              else vjp.render_megakernel_diff_plain)
    grid = pack_grid(build_grid(scene), device) if accel == "grid" else None
    target = target.to(device=device, dtype=torch.float32)

    def loss(params, seed):
        s = merge_params(scene, params)
        img = render(pack_scene(s, device), cam_params, int(seed), width,
                     height, spp, max_bounces=max_bounces,
                     grad_mode=grad_mode, packed_grid=grid, physical=physical)
        return torch.mean((img - target) ** 2)

    loss.grad_mode = grad_mode
    return loss


def _light_loss(scene, cam_params, target, width, height, spp, max_bounces,
                engine, physical, device) -> Callable:
    """The loss of ``make_loss(engine="lighttrace"|"bidir")``: one graph
    through the light paths (and, for bidir, the eye paths) of a step."""
    if not physical:
        raise ValueError(
            f"engine='{engine}' estimates the PHYSICAL integral (light paths "
            "and MIS weights have no reference-parity analog); pass "
            "physical=True so that the target's provenance matches")
    from .bidir import render_bidir
    from .lighttrace import render_lighttrace

    device = integrator.resolve_device(device)
    target = target.to(device=device, dtype=torch.float32)
    n_paths = spp * width * height   # the effort of spp eye samples

    def light_loss(params, seed):
        s = merge_params(scene, params)
        if engine == "lighttrace":
            img = render_lighttrace(s, cam_params, width, height, n_paths,
                                    int(seed), max_bounces=max_bounces,
                                    device=device)
        else:
            img = render_bidir(s, cam_params, width, height, spp, n_paths,
                               int(seed), max_bounces=max_bounces,
                               device=device)
        return torch.mean((img - target) ** 2)

    light_loss.grad_mode = "autograd"
    return light_loss


def value_and_grad(loss: Callable, params: Dict[str, torch.Tensor], seed
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss value, {field: gradient}) at ``params``; the gradients live
    where the parameters live."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    val = loss(leaves, seed)
    # a field of an empty table (pl_power of a scene without point lights)
    # is never read by the render: its gradient is zeros of its (empty) shape
    grads = (torch.autograd.grad(val, list(leaves.values()), allow_unused=True)
             if val.requires_grad else [None] * len(leaves))
    return val.detach(), {k: torch.zeros_like(v) if g is None else g
                          for (k, v), g in zip(leaves.items(), grads)}


def directional_fd_check(loss: Callable, params: Dict[str, torch.Tensor],
                         seed, eps: float = 2e-3, num_directions: int = 3,
                         generator: torch.Generator = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Compare <grad, v> against central differences along random unit
    directions v, with the SAME render streams on both sides. Returns
    (ad, fd) arrays of shape [num_directions]. The directions come from
    ``generator`` (default: a CPU generator seeded with ``seed``); they
    never touch the render streams."""
    if generator is None:
        generator = torch.Generator().manual_seed(int(seed))
    _, grad = value_and_grad(loss, params, seed)
    names = list(params)
    ad, fd = [], []
    with torch.no_grad():
        for _ in range(num_directions):
            vs = [torch.randn(params[n].shape, generator=generator,
                              dtype=torch.float32) for n in names]
            norm = torch.sqrt(sum((v * v).sum() for v in vs))
            vs = [v / norm for v in vs]
            plus = {n: params[n] + eps * v for n, v in zip(names, vs)}
            minus = {n: params[n] - eps * v for n, v in zip(names, vs)}
            fd.append(float(loss(plus, seed) - loss(minus, seed)) / (2 * eps))
            ad.append(float(sum((grad[n].cpu() * v).sum()
                                for n, v in zip(names, vs))))
    return np.asarray(ad, np.float32), np.asarray(fd, np.float32)


def invert(scene_init: Scene, cam_params, target, field_names: Iterable[str],
           width: int, height: int, spp: int = 4, steps: int = 200,
           lr: float = 5e-2, seed: int = 0,
           max_bounces: int = DEFAULT_MAX_BOUNCES,
           resample_every: int = 0, callback=None, engine: str = "cuda",
           accel: str = "none", physical: bool = False,
           silhouette: bool = False, device=None):
    """Inverse rendering: gradient-descend the named scene fields toward a
    target image with Adam. ``resample_every=k`` derives a new RNG seed every
    k steps (stochastic gradients over sample noise); 0 keeps one fixed
    stream (deterministic loss surface). Returns (recovered scene, params,
    losses). The parameters stay host tensors like the scene's; each step
    packs them onto the rendering device. ``accel="grid"`` is valid when no
    geometry field is optimized (the grid is built once from the initial
    scene — see make_loss); its gates come first, in the reference's order,
    so that they raise what the reference raises."""
    field_names = tuple(field_names)
    if silhouette and engine == "plain":
        raise ValueError("silhouette=True supports engine='eager' or 'cuda' "
                         "(the plain engine is the kernels' CPU yardstick; "
                         "train with engine='eager' on the CPU)")
    if silhouette and engine in LIGHT_ENGINES:
        raise ValueError(
            f"silhouette=True supports engine='eager' or 'cuda': the "
            f"boundary term's jump integrand is the forward estimator's — "
            f"mixing it with the '{engine}' interior gradient would blend "
            "two different integrands' boundary weights (use engine='eager' "
            "with physical=True for boundary-aware physical training)")
    if accel == "grid":
        if silhouette:
            raise ValueError("silhouette=True moves geometry; accel='grid' "
                             "would go stale (same rule as geometry fields)")
        geom = [f for f in field_names
                if f.startswith(("sph_", "tri_")) or "center" in f
                or "radius" in f]
        if geom:
            raise ValueError(f"accel='grid' with geometry fields {geom}: the "
                             "cell lists would go stale; use accel='none'")
        _check_grid_engine(engine)
    check_engine_fields(engine, field_names, physical=physical,
                        scene=scene_init)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(scene_init, field_names).items()}
    # the steps of optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 outside the root
    optimizer = torch.optim.Adam(list(params.values()), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    if silhouette:
        from .silhouette import make_grad_with_boundary
        vg = make_grad_with_boundary(scene_init, cam_params, target,
                                     field_names, width, height, spp,
                                     max_bounces=max_bounces,
                                     physical=physical, engine=engine,
                                     device=device)
    else:
        loss = make_loss(scene_init, cam_params, target, width, height, spp,
                         max_bounces, engine=engine, accel=accel,
                         field_names=field_names, physical=physical,
                         device=device)
    losses = []
    for step in range(steps):
        s = (rng.seed_for(seed, step // resample_every)
             if resample_every else seed)
        optimizer.zero_grad(set_to_none=True)
        if silhouette:
            val, grads = vg(params, s)
            for k, p in params.items():
                p.grad = grads[k]
        else:
            val = loss(params, s)
            val.backward()
        optimizer.step()
        losses.append(float(val.detach()))
        if callback:
            callback(step, losses[-1], params)
    final = {k: v.detach() for k, v in params.items()}
    return merge_params(scene_init, final), final, losses
