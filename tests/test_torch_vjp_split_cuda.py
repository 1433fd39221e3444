"""On the card: K2 physical's split schedule (a replay launch, then a reverse
launch, ``ops/cuda/megakernel_vjp.py::_split_schedule``) against the fused
launch on the same inputs, through the linear sweeps and the grid; the
register budget of its launches and the resident-grid counter. Marked
``cuda``; without a card they skip. No JAX here: run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_vjp_split_cuda.py``."""
import pytest
import torch

from cuda_path_tracer_ss_torch.models import presets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as mk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as vjp
from cuda_path_tracer_ss_torch.ops.grid import build_grid

CP = camera_arrays(Camera())
# float atomics add in another order from launch to launch: the split and
# the fused launch agree to rounding (the bound k1_turns.py holds K2 to)
ROWS_BOUND = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("scene,grid,size,spp,bounces", [
    ("cornell", False, 64, 4, 8), ("cornell", True, 64, 4, 8),
    ("shadowed_caustic", False, 40, 3, 2), ("cornell", False, 256, 16, 8)])
def test_split_rows_match_the_fused_launch(card, monkeypatch, scene, grid, size, spp,
                                           bounces):
    built = presets.get_scene(scene)
    packed = mk.pack_scene(built, "cuda")
    packed_grid = mk.pack_grid(build_grid(built), "cuda") if grid else None
    g_img = torch.rand((size, size, 3), generator=torch.Generator().manual_seed(4)).cuda()
    resident = vjp.RESIDENT_LAUNCHES
    split = vjp.backward_rows_cuda(packed, CP, 3, size, size, spp, bounces, g_img,
                                   physical=True, packed_grid=packed_grid)
    torch.cuda.synchronize()
    assert vjp.LAST_SCHEDULE == "split"
    assert vjp.RESIDENT_LAUNCHES == resident + 1   # at most 512 blocks: one wave
    monkeypatch.setattr(vjp, "_split_schedule", lambda *args: False)
    fused = vjp.backward_rows_cuda(packed, CP, 3, size, size, spp, bounces, g_img,
                                   physical=True, packed_grid=packed_grid)
    torch.cuda.synchronize()
    assert vjp.LAST_SCHEDULE == "fused"
    top = float(fused.abs().max())
    assert top > 0
    assert float((split - fused).abs().max()) <= ROWS_BOUND * top


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [False, True])
def test_split_launches_hold_four_blocks_per_sm(card, grid):
    rows = vjp._grad_rows(mk.pack_scene(presets.cornell(), "cpu").counts, physical=True)
    for phase in (vjp.PHASE_REPLAY, vjp.PHASE_REVERSE):
        occ = vjp.backward_occupancy(physical=True, grid=grid, rows=rows, phase=phase)
        assert occ["registers"] <= 128 and occ["blocks_per_sm"] >= 4, (phase, occ)
