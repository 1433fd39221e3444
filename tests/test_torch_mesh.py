"""The port's device meshes (``cuda_path_tracer_ss_torch/parallel/mesh.py``):
shapes, errors, and the two collectives' gradients on a toy function, in
one world of four gloo ranks on the CPU started once for the file (the rank
bodies are ``tests/torch_dist_worker.py``, which imports no JAX)."""
import concurrent.futures
import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as worker
from cuda_path_tracer_ss_torch.parallel import mesh as pm

RANKS = 4


@pytest.fixture(scope="module")
def failing_world():
    """A world of two ranks whose rank 1 raises, started in the background
    while the main world runs."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(pm.spawn_world, 2, worker.failing_rank, device_type="cpu")
    pool.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory, failing_world):
    out = str(tmp_path_factory.mktemp("mesh_world"))
    pm.spawn_world(RANKS, worker.mesh_scenarios, out, device_type="cpu")
    return out


def _load(world, name):
    return [np.load(os.path.join(world, f"{name}.r{r}.npy")) for r in range(RANKS)]


def _json(world, name, rank):
    with open(os.path.join(world, f"{name}.r{rank}.json")) as f:
        return json.load(f)


def test_mesh_shapes_and_axis_indices(world):
    for rank in range(RANKS):
        info = _json(world, "mesh", rank)
        assert info["shape"] == [4] and info["names"] == [pm.PIXEL_AXIS]
        assert info["default_shape"] == [4]
        assert info["sample_names"] == [pm.SAMPLE_AXIS]
        assert info["index"] == rank
        # samples outer, pixels inner, as the reference's make_mesh_2d
        assert info["shape_2d"] == [2, 2]
        assert info["names_2d"] == [pm.SAMPLE_AXIS, pm.PIXEL_AXIS]
        assert (info["sample_2d"], info["pixel_2d"]) == divmod(rank, 2)
        assert info["size_pixels_2d"] == info["size_samples_2d"] == 2
        assert info["device"] == "cpu"


def test_psum_sums_over_the_named_axes(world):
    want = {"psum_1d": lambda r: 10.0,
            "psum_2d_pixels": lambda r: {0: 3.0, 1: 7.0}[r // 2],
            "psum_2d_samples": lambda r: {0: 4.0, 1: 6.0}[r % 2],
            "psum_2d_both": lambda r: 10.0}
    for name, f in want.items():
        for rank, got in enumerate(_load(world, name)):
            np.testing.assert_array_equal(got, np.full(2, f(rank), np.float32), name)


@pytest.mark.parametrize("name,skip", [("toy", None), ("toy_skip", 3)])
def test_psum_and_replicate_gradients(world, name, skip):
    """The toy sharded loss gives every rank the single-process image and
    gradient: the regulariser outside the render counted once, the render's
    terms summed over the ranks once — also where one rank's tile does not
    depend on the parameter (its replicate still reduces)."""
    p = torch.tensor([0.5, -1.0, 2.0], requires_grad=True)
    w = torch.arange(3 * RANKS, dtype=torch.float32).reshape(RANKS, 3, 1) + 1.0
    img = torch.stack([w[r] * (torch.ones_like(p) if r == skip else p)
                       for r in range(RANKS)])
    loss = (img ** 2).sum() + worker.REG * (p ** 2).sum()
    g, = torch.autograd.grad(loss, p)
    for got_g, got_img in zip(_load(world, name + "_grad"), _load(world, name + "_img")):
        np.testing.assert_array_equal(got_img, img.detach().numpy())
        np.testing.assert_allclose(got_g, g.numpy(), rtol=1e-6)


@pytest.mark.parametrize("case,match", [
    ("mesh_of_3", "world size is 4"),
    ("mesh_2d_of_8", "world size is 4"),
    ("mesh_on_tpu", "device_type"),
    ("no_sample_axis", "render_sample_sharded needs a mesh with a 'samples' axis"),
    ("not_a_mesh", "needs a DeviceMesh"),
    ("tables_on_cuda", "cuda"),
    ("reduce_over_unknown_axis", "cannot reduce over"),
])
def test_mesh_errors(world, case, match):
    for rank in range(RANKS):
        kind, msg = _json(world, "errors", rank)[case]
        assert kind == "ValueError" and match in msg, (rank, kind, msg)


def test_a_failed_rank_fails_the_world(failing_world):
    with pytest.raises(mp.ProcessRaisedException, match="fails on purpose"):
        failing_world.result()


def test_make_mesh_needs_a_world():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pm.make_mesh(4, device_type="cpu")


def test_nccl_world_with_more_ranks_than_cards_raises():
    with pytest.raises(ValueError, match="NCCL does not put two ranks on one GPU"):
        pm._check_nccl_ranks("nccl", 4, 1)
    pm._check_nccl_ranks("nccl", 1, 1)
    pm._check_nccl_ranks("gloo", 4, 1)


def test_backends_and_rank_devices():
    assert pm.default_backend("cuda") == "nccl"
    assert pm.default_backend("cpu") == "gloo"
    assert pm.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            pm.rank_device("cuda")


@pytest.mark.parametrize("n,n_dev,want", [
    (81, 4, [(0, 21), (21, 21), (42, 21), (63, 18)]),
    (257, 2, [(0, 129), (129, 128)]),
    (256, 8, [(32 * k, 32) for k in range(8)]),
])
def test_tile_range_covers_every_pixel_once(n, n_dev, want):
    got = [pm.tile_range(n, n_dev, k) for k in range(n_dev)]
    assert got == want
    assert sum(c for _, c in got) == n


def test_tile_range_refuses_an_empty_rank():
    with pytest.raises(ValueError, match="too many devices"):
        pm.tile_range(3, 4, 0)
    with pytest.raises(ValueError, match="too many devices"):
        pm.tile_range(6, 4, 0)
