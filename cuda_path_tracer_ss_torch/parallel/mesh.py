"""Device meshes over ``torch.distributed``: the counterpart of the JAX
package's ``parallel/mesh.py``.

The reference renders on one device; its only parallel axis is SIMT over
pixels. Here that axis becomes a data-parallel axis over several processes,
one per rank (``torchrun``'s model, which also spans several hosts as
``jax.distributed`` does). A mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` over the WHOLE world with named dims ``"pixels"``,
``"samples"`` or ``"paths"``: ``axis_index(mesh, axis)`` stands for
``jax.lax.axis_index`` and ``mesh.get_group(axis)`` is the group a psum
reduces over. Each rank renders its share against a full copy of the scene;
the shares merge with one collective, ``all_reduce(SUM)``: a pixel-sharded
result is the rank's tile written into a zero image of the full size and
summed over the pixel axis, which adds exact zeros, so it stays bit-equal to
the single-device image.

``psum`` and ``replicate`` are the ``shard_map`` transpose written out as two
``torch.autograd.Function``\\ s: the psum's backward is the identity (every
rank computes the same loss from the same summed image), and the backward of
``replicate`` — which every sharded entry applies to its differentiable
inputs — all-reduces their gradients over the mesh, so a loss term outside
the render reaches its parameter once.

The reference's ``pixel_sharding`` / ``replicated`` (``NamedSharding``) have
no counterpart: a rank holds its tile and whole copies of everything else,
and nothing here places an array across devices.

Backends: ``nccl`` for ``cuda`` meshes and ``gloo`` for ``cpu`` ones by
default; ``backend="gloo"`` with ``cuda`` is allowed when asked for (several
ranks sharing one card: NCCL does not put two ranks on one GPU, and a mesh
over an NCCL world with more ranks on a host than the host has cards raises
``ValueError`` before any collective). A gloo group reduces a CUDA tensor
through the host. Nothing switches backend or device on its own.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

PIXEL_AXIS = "pixels"
SAMPLE_AXIS = "samples"
# Light-path axis for the light tracer: paths shard over ranks and the splat
# image merges with one psum — every rank touches every pixel.
PATH_AXIS = "paths"

Axes = Union[str, Sequence[str]]


def default_backend(device_type: str) -> str:
    """``nccl`` for CUDA meshes, ``gloo`` for CPU ones."""
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: the CPU, or ``cuda:LOCAL_RANK`` (the rank when
    no launcher set ``LOCAL_RANK``) modulo the host's cards, so that ranks
    sharing a card over gloo all land on it."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device; none is available "
                           "(pass device_type='cpu' to run on the CPU)")
    local = os.environ.get("LOCAL_RANK")
    rank = int(local) if local is not None else dist.get_rank()
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device_type: str = "cuda") -> None:
    """Join this process to the world (``jax.distributed.initialize``).
    With no arguments it reads ``torchrun``'s environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); otherwise ``coordinator``
    is ``host:port`` or an init URL (``tcp://...``, ``file://...``) and
    ``num_processes`` / ``process_id`` are the world size and this rank.
    ``backend`` defaults to ``default_backend(device_type)``. On a CUDA
    mesh it also makes ``rank_device("cuda")`` this process's device."""
    backend = backend or default_backend(device_type)
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
        torch.cuda.init()   # DeviceMesh then keeps this device


def _check_nccl_ranks(backend: str, ranks_on_host: int, cards: int) -> None:
    if backend == "nccl" and ranks_on_host > cards:
        raise ValueError(
            f"an NCCL world with {ranks_on_host} ranks on a host of {cards} "
            "CUDA device(s): NCCL does not put two ranks on one GPU; start "
            "at most one rank per card, or ask for backend='gloo'")


def _mesh(device_type: str, shape: Tuple[int, ...],
          names: Tuple[str, ...]) -> DeviceMesh:
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() "
                           "in every rank (or start the ranks with spawn_world)")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a mesh spans the whole world: {dict(zip(names, shape))} "
                         f"holds {n} ranks, the world size is {world}")
    backend = dist.get_backend()
    if device_type == "cpu" and backend == "nccl":
        raise ValueError("a CPU mesh cannot reduce over NCCL; start the world "
                         "with backend='gloo'")
    if device_type == "cuda":
        ranks_on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        _check_nccl_ranks(backend, ranks_on_host, torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_devices: Optional[int] = None, axis: str = PIXEL_AXIS,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh named ``axis`` over the world's ``n_devices`` ranks (default:
    all of them; another count raises ``ValueError``)."""
    world = dist.get_world_size() if dist.is_initialized() else None
    return _mesh(device_type, (world if n_devices is None else n_devices,),
                 (axis,))


def make_mesh_2d(n_pixel: int, n_sample: int,
                 device_type: str = "cuda") -> DeviceMesh:
    """2-D mesh: sample groups x pixel tiles, pixels on the inner axis (the
    ranks of one tile's sample group are ``n_pixel`` apart)."""
    return _mesh(device_type, (n_sample, n_pixel), (SAMPLE_AXIS, PIXEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str, who: str) -> int:
    """The size of ``mesh``'s ``axis``; ``who`` names the entry in the
    error raised for something that is not a mesh with that axis."""
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"{who} needs a DeviceMesh (parallel.mesh.make_mesh) "
                         f"as its mesh, got {type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(
            f"{who} needs a mesh with a {axis!r} axis; got axes {tuple(names)}. "
            f"Build one with parallel.mesh.make_mesh(n, axis={axis!r})")
    return mesh.size(names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def tile_range(n: int, n_dev: int, index: int) -> Tuple[int, int]:
    """(first pixel, pixel count) of tile ``index`` of ``n`` pixels over
    ``n_dev`` ranks: ceil(n / n_dev) each, the last rank the remainder.
    Raises ``ValueError`` where a rank would get no pixel."""
    per = -(-n // n_dev)
    if per * (n_dev - 1) >= n:
        raise ValueError(f"too many devices for this image: {n} pixels over "
                         f"{n_dev} devices leave a device without a pixel")
    return index * per, min(per, n - index * per)


def in_full_image(tile: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """``tile`` (``[k, 3]``) written at row ``first`` of a zero ``[n, 3]``
    image: a rank's share of a pixel-sharded result, before the psum."""
    return torch.cat([tile.new_zeros((first, 3)), tile,
                      tile.new_zeros((n - first - tile.shape[0], 3))])


def check_device(mesh: DeviceMesh, device, who: str) -> None:
    """Refuse tables on another device type than the mesh's."""
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"{who}: the tables are on {device}, the mesh is a "
                         f"{mesh.device_type!r} mesh")


def _group(mesh: DeviceMesh, axes: Axes):
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names or ())
    if set(axes) == set(names):
        return dist.group.WORLD        # a mesh spans the whole world
    if len(axes) == 1 and axes[0] in names:
        return mesh.get_group(axes[0])
    raise ValueError(f"cannot reduce over {axes} on a mesh with axes {names}")


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce(SUM)`` of ``x`` in place over ``group``. Decided by the
    group's backend: gloo reduces a CUDA tensor through a host copy, NCCL a
    host tensor through a copy on this rank's card."""
    backend = dist.get_backend(group)
    if x.is_cuda and backend == "gloo":
        staged = x.cpu()
    elif not x.is_cuda and backend == "nccl":
        staged = x.to(torch.cuda.current_device())
    else:
        dist.all_reduce(x, group=group)
        return x
    dist.all_reduce(staged, group=group)
    return x.copy_(staged)


class _PSum(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the identity, and zeros
    for ``keep``, the replicated inputs of the render, so that their
    ``replicate`` node runs its collective on every rank even where this
    rank's share does not depend on them."""

    @staticmethod
    def forward(ctx, x, group, *keep):
        ctx.keep = [(k.shape, k.dtype, k.device) for k in keep]
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return (g, None, *(torch.zeros(s, dtype=t, device=d)
                           for s, t, d in ctx.keep))


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: Axes,
         keep: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``mesh``'s ``axis`` (a name, or names:
    all of the mesh's names sum over every rank); differentiable, with the
    identity as its backward. ``keep``: what ``replicate`` returned for
    the render whose share ``x`` is."""
    return _PSum.apply(x, _group(mesh, axis), *keep)


class _Replicate(torch.autograd.Function):
    """Forward: the identity. Backward: the gradients summed over the whole
    mesh, one ``all_reduce`` per device they live on (a camera may stay on
    the host beside tables on a card)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = list(gs)
        for dev in dict.fromkeys(g.device for g in gs):
            idx = [i for i, g in enumerate(gs) if g.device == dev]
            flat = all_reduce_(torch.cat([gs[i].reshape(-1) for i in idx]), ctx.group)
            for i, f in zip(idx, flat.split([gs[i].numel() for i in idx])):
                out[i] = f.view_as(gs[i])
        return (None, *out)


def replicate(xs: Sequence[torch.Tensor], mesh: DeviceMesh) -> Tuple[torch.Tensor, ...]:
    """The tensors ``xs`` (of one dtype) marked as replicated over every
    rank of ``mesh``: the gradients that reach them are summed over the
    ranks."""
    xs = tuple(xs)
    if not xs:
        return ()
    return _Replicate.apply(_group(mesh, mesh.mesh_dim_names), *xs)


def _rank_main(rank: int, n: int, url: str, device_type: str,
               backend: Optional[str], fn: Callable, args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_WORLD_SIZE=str(n))
    initialize_distributed(url, n, rank, backend, device_type)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(n: int, fn: Callable, *args, device_type: str = "cuda",
                backend: Optional[str] = None) -> None:
    """Run ``fn(rank, *args)`` in ``n`` new processes (``spawn``), a world of
    ``n`` ranks on this host joined through a ``file://`` rendezvous in a
    temporary directory (no TCP port to race for). ``fn`` must be a
    module-level function. Returns when every rank has returned; raises if
    one fails, after stopping the others."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="cpt_world_") as tmp:
        url = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(n, url, device_type, backend, fn,
                                             args),
                           nprocs=n, join=True, start_method="spawn")
