"""The reference of an inversion job's first steps: the loss of
``make_loss`` (mean squared error of the mean radiance against the target),
its gradient by autograd through ``pathtracer.radiance``, and Adam, written
out (the update of ``optax.adam`` / ``torch.optim.Adam`` with b1 0.9, b2
0.999, eps 1e-8 outside the root)."""
from __future__ import annotations

from typing import Dict, List

import torch

from . import pathtracer, rng

# paths per autograd graph: bounds the reference's memory at any size
CHUNK_PATHS = 1 << 20


def _lanes(n_pixels: int, spp: int, device):
    """(pixel, sample) of every path of a render, in chunks of whole
    samples."""
    per = max(1, CHUNK_PATHS // n_pixels)
    pix = torch.arange(n_pixels, device=device)
    for s0 in range(0, spp, per):
        k = min(per, spp - s0)
        yield (pix.repeat(k),
               torch.arange(s0, s0 + k, device=device).repeat_interleave(n_pixels))


def render_image(scene: Dict[str, torch.Tensor], cam, seed: int, width: int,
                 height: int, spp: int, max_bounces: int, physical: bool,
                 device, state_bf16: bool = False) -> torch.Tensor:
    """Mean radiance ``[width * height, 3]`` of a whole render, no graph."""
    n = width * height
    with torch.no_grad():
        tb = pathtracer.pack(scene, device)
        c = pathtracer.cam_tensor(cam, device)
        acc = torch.zeros((n, 3), dtype=torch.float64, device=device)
        for pix, smp in _lanes(n, spp, device):
            r = pathtracer.radiance(tb, c, seed, width, height, pix, smp,
                                    max_bounces, physical, state_bf16)
            acc.index_add_(0, pix, r.double())
    return (acc / spp).float()


def loss_and_grads(scene, params: Dict[str, torch.Tensor], cam, seed: int,
                   width: int, height: int, spp: int, max_bounces: int,
                   target: torch.Tensor, physical: bool, device,
                   state_bf16: bool = False):
    """(loss, {field: gradient}) of one step at ``params`` (host tensors;
    the gradients come back on the host). The image is rendered once without
    a graph; the cotangent of the loss then drives one graph per chunk of
    paths, as the backward kernel replays them."""
    n = width * height
    merged = {**scene, **params}
    img = render_image(merged, cam, seed, width, height, spp, max_bounces,
                       physical, device, state_bf16)
    tgt = target.reshape(n, 3).to(device)
    loss = torch.mean((img.double() - tgt.double()) ** 2)
    g_img = (2.0 * (img - tgt) / (n * 3)).detach()
    # the leaves stay where the scene is; ``pack`` moves the tables
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    c = pathtracer.cam_tensor(cam, device)
    for pix, smp in _lanes(n, spp, device):
        tb = pathtracer.pack({**scene, **leaves}, device)
        r = pathtracer.radiance(tb, c, seed, width, height, pix, smp,
                                max_bounces, physical, state_bf16)
        part = (r * g_img[pix]).sum() / spp
        for (k, _), g in zip(leaves.items(),
                             torch.autograd.grad(part, list(leaves.values()),
                                                 allow_unused=True)):
            if g is not None:
                grads[k] += g
    return float(loss), grads


def follow(scene, start: Dict[str, torch.Tensor], cam, job_seed: int,
           steps: int, lr: float, resample_every: int, width: int,
           height: int, spp: int, max_bounces: int, target, physical: bool,
           device, state_bf16: bool = False) -> List[dict]:
    """The first ``steps`` Adam steps of an inversion job from ``start``:
    per step its loss, its gradient and the parameters after its update."""
    p = {k: v.detach().clone().float() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = []
    for step in range(steps):
        s = (rng.seed_for(job_seed, step // resample_every) if resample_every
             else job_seed)
        loss, g = loss_and_grads(scene, p, cam, s, width, height, spp,
                                 max_bounces, target, physical, device,
                                 state_bf16)
        t = step + 1
        for k in p:
            m[k] = b1 * m[k] + (1.0 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1.0 - b2) * g[k] * g[k]
            denom = (v2[k].sqrt() / (1.0 - b2 ** t) ** 0.5) + eps
            p[k] = p[k] - (lr / (1.0 - b1 ** t)) * m[k] / denom
        out.append(dict(loss=loss, grad={k: x.clone() for k, x in g.items()},
                        params={k: x.clone() for k, x in p.items()}))
    return out
