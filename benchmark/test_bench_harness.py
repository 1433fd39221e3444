"""CPU tests of the benchmark harness: the manifest and the files it names,
discovery of new cells, job kinds and metrics as files alone, the guard
that keeps the accepted entries of the manifest in place, the roofline and
idle-share arithmetic, the isolation check, the reference against the
port's plain version, and whole runs of every cell at a tiny size on the
CPU (the port's plain engine)."""
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

import accepted  # noqa: E402
from cptbench import faults, isolation, manifest, roofline, runner, trace  # noqa: E402
from cptbench.reference import fit, pathtracer  # noqa: E402

CELLS = [w["name"] for w in manifest.load()["workloads"]]
JOBS = sorted(os.path.basename(p)[:-3]
              for p in glob.glob(os.path.join(BENCH_DIR, "jobs", "*.py")))


def test_manifest_meets_the_contract():
    m = manifest.load()
    assert manifest.problems(m) == []
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"][1].startswith(m["paths"][0] + "/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200
    for e in m["end_to_end"]:
        assert 0.0 < e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in m["per_layer"]:
        assert "bound" not in e and len(e["layer"]) <= 200
    assert len(json.dumps(m)) < 64 * 1024
    assert accepted.departures(m) == []


def _at(entries, name):
    return next(i for i, e in enumerate(entries) if e["name"] == name)


def _swap(entries, a, b):
    i, j = _at(entries, a), _at(entries, b)
    entries[i], entries[j] = entries[j], entries[i]


def _metric(m, name):
    return next(e for e in m["end_to_end"] + m["per_layer"] if e["name"] == name)


# edits to the accepted manifest that the append-only guard refuses
DEPARTURES = {
    "per_layer entries swapped": lambda m: _swap(
        m["per_layer"], "inverse.host_ms", "renderer.readback_ms.preview"),
    "a span metric dropped": lambda m: m["per_layer"].remove(
        _metric(m, "k1.launch_ms.render")),
    "a metric put before the span metrics": lambda m: m["per_layer"].insert(
        _at(m["per_layer"], "renderer.readback_ms.preview"),
        dict(_metric(m, "k1.launch_ms.render"), name="k1.launch_ms.new")),
    "a cell dropped": lambda m: m["workloads"].remove(m["workloads"][1]),
    "configurations swapped": lambda m: _swap(
        m["configs"], "cornell-800", "cornell-256-fit"),
    "a bound loosened": lambda m: _metric(m, "pass_ms_p95").update(bound=0.22),
    "an accepted cell added to an accepted metric": lambda m: _metric(
        m, "primary_Mrays_per_s")["workloads"].append("preview-cornell-800"),
    "a metric's accepted cell dropped": lambda m: _metric(
        m, "k1.launch_ms.render")["workloads"].clear(),
    "a key added": lambda m: m["workloads"][0].update(note="x"),
    "a layer renamed": lambda m: _metric(m, "inverse.adam_ms").update(
        layer="training loop"),
    "run_seconds changed": lambda m: m.update(run_seconds=30),
}


@pytest.mark.parametrize("edit", sorted(DEPARTURES))
def test_the_accepted_entries_never_move_drop_or_change(edit):
    m = manifest.load()
    DEPARTURES[edit](m)
    assert accepted.departures(m)


@pytest.mark.parametrize("job", JOBS)
def test_every_job_kind_has_its_driver_cpu_size_and_faults(job):
    mod = manifest.job_module(job)
    assert isinstance(mod.Job, type)
    over_c, over_t = mod.TINY
    assert isinstance(over_c, dict) and isinstance(over_t, dict)
    for kind in faults.KINDS:   # each planted through the job's own module
        if kind == "control" and hasattr(mod, "control_line"):
            assert callable(mod.control_line)
            continue
        with faults.planted(kind, mod):
            pass


def _tiny(c):
    over_c, over_t = c["job"].TINY
    c["config"].update(over_c)
    c["traffic"].update(over_t)
    return c


@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_planted_through_the_cells_job_is_not_correct(cell):
    """``unchanged`` reaches the job's timed path on the CPU too (the
    others break the CUDA kernels: ``test_bench_control.py``)."""
    c = _tiny(manifest.cell(manifest.load(), cell))
    line = faults.line(c, "unchanged", 2 ** 33 + 6, 0.5, device="cpu")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = manifest.cell(manifest.load(), cell)
    assert hasattr(c["job"], "Job")
    names = {m["name"] for m in c["end_to_end"] + c["per_layer"]}
    assert "setup_s" in names
    for name in names:
        assert callable(manifest.reader(name))
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())


def test_a_new_cell_and_metric_are_files_alone(tmp_path, monkeypatch):
    """Cells added to a copy by new files and appended entries alone: one on
    a new traffic mix with a metric of its own; one with its own job kind,
    configuration and span metric, appended after the accepted entries,
    which runs to correct on the CPU and whose control and faults are
    planted through its own job module."""
    real = manifest.load()
    m = manifest.load()
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".bench_cache"))
    # a traffic mix and a metric of the host's clock
    (bench / "traffic" / "short.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "converged.json").read_text()),
             spp=256)))
    (bench / "checks" / "render-cornell-800-short.json").write_text(
        (bench / "checks" / "render-cornell-800.json").read_text())
    (bench / "metrics" / "render.seconds_each.py").write_text(
        "def read(run):\n    return run.window['seconds'] / run.window['units']\n")
    m["workloads"].append(dict(name="render-cornell-800-short",
                               config="cornell-800", traffic="short", chips=1,
                               why="shorter renders"))
    m["per_layer"].append(dict(name="render.seconds_each", unit="s",
                               better="lower", source="host_clock",
                               layer="frame driver (render/renderer.py)",
                               moves="primary_Mrays_per_s",
                               workloads=["render-cornell-800-short"]))
    # a job kind (which records what it plants), a configuration and a
    # reader of a program span
    cell, kind, config = "render-copy-cornell-800", "render_copy", "cornell-800-copy"
    (bench / "jobs" / f"{kind}.py").write_text(
        (bench / "jobs" / "render.py").read_text()
        + "\n\nPLANTED = []\n_plant = plant\n\n\ndef plant(kind, stack):\n"
          "    PLANTED.append(kind)\n    _plant(kind, stack)\n")
    (bench / "traffic" / "converged-copy.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "converged.json").read_text()),
             job=kind)))
    shutil.copy(bench / "configs" / "cornell-800.json",
                bench / "configs" / f"{config}.json")
    shutil.copy(bench / "checks" / "render-cornell-800.json",
                bench / "checks" / f"{cell}.json")
    (bench / "metrics" / "k1.launch_ms.render_copy.py").write_text(
        "from cptbench import spans\n\n\ndef read(run):\n"
        "    return spans.idle_ms(run, lambda name: name == 'k1.launch')\n")
    m["configs"].append(dict(m["configs"][0], name=config,
                             file=f"benchmark/configs/{config}.json"))
    m["workloads"].append(dict(name=cell, config=config,
                               traffic="converged-copy", chips=1,
                               why="the converged renders through a copied job"))
    m["per_layer"].append(dict(_metric(m, "k1.launch_ms.render"),
                               name="k1.launch_ms.render_copy",
                               workloads=[cell]))
    for name, new in (("primary_Mrays_per_s", "render-cornell-800-short"),
                      ("primary_Mrays_per_s", cell),
                      ("k1.launch_ms.render", cell)):
        _metric(m, name)["workloads"].append(new)
    assert manifest.problems(m, str(bench)) == []
    assert accepted.departures(m) == []

    c = manifest.cell(m, "render-cornell-800-short", str(bench))
    assert c["traffic"]["spp"] == 256
    assert [x["name"] for x in c["per_layer"]] == ["render.seconds_each"]
    read = manifest.reader("render.seconds_each", str(bench))
    assert read(type("R", (), {"window": {"seconds": 3.0, "units": 2}})()) == 1.5

    c = manifest.cell(m, cell, str(bench))
    assert c["job"].__file__ == str(bench / "jobs" / f"{kind}.py")
    assert [x["name"] for x in c["end_to_end"]] == ["setup_s",
                                                    "primary_Mrays_per_s"]
    assert [x["name"] for x in c["per_layer"]] == ["k1.launch_ms.render",
                                                   "k1.launch_ms.render_copy"]
    from cuda_path_tracer_ss_torch.utils import profiling
    with monkeypatch.context() as mp:
        mp.setattr(profiling, "last_report", lambda: dict(
            spans={"k1.launch": dict(idle_s=0.006)}, counters={}))
        run = type("R", (), {"trace": {}, "job": type(
            "J", (), {"slice_units": lambda self: 3})()})()
        assert manifest.reader("k1.launch_ms.render_copy", str(bench))(run) == \
            pytest.approx(2.0)

    _tiny(c)
    line = runner.run_cell(c, 2 ** 33 + 7, 0.5, False, device="cpu")
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "primary_Mrays_per_s"}
    line = faults.line(c, "unchanged", 2 ** 33 + 7, 0.5, device="cpu")
    assert not line["correct"]
    for k in faults.KINDS:
        with faults.planted(k, c["job"]):
            pass
    assert c["job"].PLANTED == ["unchanged"] + list(faults.KINDS)

    # and a cell whose files are missing is named
    m["workloads"].append(dict(name="ghost", config="cornell-800",
                               traffic="nowhere", chips=1, why="missing"))
    assert any("nowhere" in p for p in manifest.problems(m, str(bench)))
    assert manifest.load() == real
    assert not os.path.exists(os.path.join(BENCH_DIR, "jobs", f"{kind}.py"))


def test_roofline_on_a_hand_made_tally():
    counts = (2, 14, 7, 0, 1)
    tally = dict(paths=10, path_bounces=30, stored_bounces=25, shadow_rays=20,
                 shadow_rays_occluded=5)
    sweep = 2 * 32 + 14 * 60
    want = 10 * 40 + 30 * 150 + 20 * 60 + (30 + 15) * sweep + 5 * 32
    assert roofline.k1_flops(counts, tally, False) == want
    phys = roofline.k1_flops(counts, tally, True)
    assert phys == want + 30 * 75 + 20 * (165 - 60)
    k2 = roofline.k2_flops(counts, tally, False)
    assert k2 == want + 25 * (45 + 150 + 130) + 15 * 75 + 10 * 70
    assert roofline.k2_flops(counts, tally, True) == (
        phys + 25 * (45 + 150 + 130) + 15 * 75 + 10 * 70 + 25 * 260 + 20 * 100)
    # 67e9 operations take 1 ms at the peak: a 4 ms kernel is at 25 %
    assert roofline.share_pct(67e9, 1e3, 4e-3) == pytest.approx(25.0)
    assert roofline.least_seconds(1.0, 3.35e12)[1] == "bytes"
    assert roofline.share_pct(1.0, 1.0, 0.0) is None


def _synthetic_trace():
    """A slice of 100 us: kernels at [10, 30] and [20, 50] (one launch
    correlated inside the slice, one launched by the kernel library without a
    recorded launch), a copy at [70, 80], and one kernel launched outside."""
    ev = [dict(ph="X", cat="user_annotation", name=trace.SLICE, ts=0, dur=100),
          dict(ph="X", cat="cpu_op", name="aten::mul", ts=5, dur=10,
               args={"External id": 7}),
          dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=6, dur=2,
               args={"correlation": 1, "External id": 7}),
          dict(ph="X", cat="kernel", name="void elementwise_kernel<>()", ts=10,
               dur=20, args={"correlation": 1, "External id": 7}),
          dict(ph="X", cat="cpu_op", name="_RenderDiff", ts=16, dur=3,
               args={"External id": 9}),
          dict(ph="X", cat="kernel", name="void render_kernel<false>(cpt::X)",
               ts=20, dur=30, args={"correlation": 2, "External id": 9}),
          dict(ph="X", cat="cpu_op", name="aten::copy_", ts=55, dur=30,
               args={"External id": 8}),
          dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", ts=60, dur=2,
               args={"correlation": 3, "External id": 8}),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=70, dur=10,
               args={"correlation": 3, "External id": 8}),
          dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=200,
               dur=2, args={"correlation": 4}),
          dict(ph="X", cat="kernel", name="void render_kernel<true>(cpt::X)",
               ts=205, dur=50, args={"correlation": 4})]
    return ev


def test_idle_share_of_a_synthetic_trace():
    s = trace.summarize(_synthetic_trace())
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(50e-6)      # [10, 50] and [70, 80]
    assert s["device_events"] == 3
    assert trace.kernel_seconds(s, "render_kernel") == pytest.approx(30e-6)
    assert trace.kernel_seconds(s, "render") == 0.0
    ops = dict(s["device_ops"])
    assert ops["aten::mul"] == pytest.approx(20e-6)
    assert ops["aten::copy_"] == pytest.approx(10e-6)
    assert ops["void render_kernel<false>(cpt::X)"] == pytest.approx(30e-6)
    gaps = dict(s["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(50e-6)
    assert gaps["aten::copy_"] == pytest.approx(40e-6)   # [50, 70] and [80, 100]
    assert gaps["aten::mul"] == pytest.approx(10e-6)     # [0, 10]
    idle = manifest.reader("device.idle_pct.render")(
        type("R", (), {"trace": s})())
    assert idle == pytest.approx(50.0)


def test_isolation_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxtyping", "jaxlib.xla_client", "flaxen",
             "cuda_path_tracer_ss_tpu.ops.pallas", "cuda_path_tracer_ss_torch",
             "cuda_path_tracer_ss_tpu_extra"]
    assert isolation.banned_loaded(names) == [
        "cuda_path_tracer_ss_tpu.ops.pallas", "jax", "jax.numpy",
        "jaxlib.xla_client"]
    assert isolation.program_loaded(names) == ["cuda_path_tracer_ss_torch"]


def test_reference_and_harness_load_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import cptbench.reference.pathtracer, cptbench.reference.fit\n"
            "import cptbench.reference.camera, cptbench.reference.display\n"
            "import cptbench.checks, cptbench.runner, cptbench.manifest\n"
            "from cptbench import isolation\n"
            "print(isolation.program_loaded() + isolation.banned_loaded())\n"
            % BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH_DIR)
    assert out.stdout.strip() == "[]"


def _port_scene():
    from cptbench import inputs
    cfg = manifest.cell(manifest.load(), "render-cornell-800")["config"]
    return inputs.scene_arrays(cfg), cfg


@pytest.mark.parametrize("physical", [False, True])
def test_reference_traces_the_ports_plain_version(physical):
    from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
    from cuda_path_tracer_ss_torch.models.presets import get_scene
    from cuda_path_tracer_ss_torch.models.scene import scene_from_numpy, scene_to_numpy
    from cuda_path_tracer_ss_torch.ops.cuda import megakernel as mk
    from cptbench import inputs

    arrays, cfg = _port_scene()
    want_arrays = scene_to_numpy(get_scene(cfg["scene_name"]))
    for k, v in want_arrays.items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    cp = camera_arrays(Camera())
    w = h = 12
    spp, nb = 3, 8
    want = mk.render_megakernel_plain(mk.pack_scene(scene_from_numpy(arrays), "cpu"),
                                      cp, 1234, w, h, spp, nb,
                                      physical=physical).reshape(-1, 3)
    tb = pathtracer.pack(inputs.scene_tensors(arrays), "cpu")
    pix = torch.arange(w * h).repeat_interleave(spp)
    smp = torch.arange(spp).repeat(w * h)
    got = pathtracer.radiance(tb, pathtracer.cam_tensor(cp, "cpu"), 1234, w, h,
                              pix, smp, nb, physical).reshape(w * h, spp, 3).mean(1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_reference_gradient_matches_the_ports_plain_engine():
    from cuda_path_tracer_ss_torch.models.scene import scene_from_numpy
    from cuda_path_tracer_ss_torch.render import inverse
    from cptbench import inputs

    arrays, cfg = _port_scene()
    cam = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
           np.float32(1.0), np.float32(-0.1))
    fields = ["materials.diffuse", "al_power", "materials.ior"]
    scene = inputs.scene_tensors(arrays)
    target = fit.render_image(scene, cam, 5, 8, 8, 2, 8, False, "cpu").reshape(8, 8, 3)
    params = {k: scene[k] * 0.9 for k in fields}
    loss = inverse.make_loss(scene_from_numpy(arrays), cam, target, 8, 8, 2, 8,
                             engine="plain", field_names=fields, device="cpu")
    val, grads = inverse.value_and_grad(loss, params, 77)
    ref_val, ref_grads = fit.loss_and_grads(scene, params, cam, 77, 8, 8, 2, 8,
                                            target, False, "cpu")
    assert float(val) == pytest.approx(ref_val, rel=1e-5)
    for k in fields:
        torch.testing.assert_close(grads[k], ref_grads[k], rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("cell", CELLS)
def test_a_whole_run_on_the_cpu_is_correct(cell):
    c = _tiny(manifest.cell(manifest.load(), cell))
    line = runner.run_cell(c, 2 ** 33 + 5, 0.5, False, device="cpu")
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(c["limits"])
    assert {m["name"] for m in c["end_to_end"]} == set(line["metrics"])
    assert line["attempted"] >= 1


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert runner.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_run_refuses_where_the_program_is_missing(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
