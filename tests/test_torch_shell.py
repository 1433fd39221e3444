"""The rest of the port's shell on the CPU: ``cli interact`` against the
reference CLI, the browser viewer, ``cli view``, SIGKILL + ``--resume``
through the port's CLI as a process, and the device rule of the new
commands."""
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import cuda_path_tracer_ss_torch.cli as tcli
import cuda_path_tracer_ss_torch.viewer as tviewer
import cuda_path_tracer_ss_tpu.cli as jcli
from cuda_path_tracer_ss_torch.models.camera import Camera
from cuda_path_tracer_ss_torch.models.presets import get_scene
from cuda_path_tracer_ss_torch.render.renderer import ProgressiveRenderer, RenderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERACT = ["interact", "--scene", "cornell_empty", "--width", "8", "--height", "8",
            "--spp", "2", "--bounces", "2", "--samples-per-pass", "1", "--out", "final.png"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _interact(cli, extra, workdir, monkeypatch, capsys):
    """Run ``cli interact`` in ``workdir`` on the reference test's key lines;
    (its output with the rays/s figures and screenshot times masked, its
    renderer)."""
    built = []
    build = cli._build
    monkeypatch.setattr(cli, "_build", lambda args: built.append(build(args)) or built[0])
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    monkeypatch.setattr("sys.stdin", io.StringIO("w\np\n0\nx\n"))
    capsys.readouterr()
    cli.main(INTERACT + extra)
    text = capsys.readouterr().out
    assert os.path.exists("final.png") and len(os.listdir(".")) == 2  # + the screenshot
    text = re.sub(r"\d+\.\d+ M rays/s", "<rate> M rays/s", text)
    return re.sub(r"render\d{4}-\d\d-\d\d-\d{6}\.png", "render<time>.png", text), built[0]


def test_interact_prints_the_reference_cli_s_lines(tmp_path, monkeypatch, capsys):
    """The same lines as the reference's ``cli interact --engine jnp``
    (tests/test_cli.py) on the same key lines, and the same camera."""
    want, jr = _interact(jcli, ["--engine", "jnp"], tmp_path / "jax", monkeypatch, capsys)
    got, tr = _interact(tcli, ["--device", "cpu"], tmp_path / "port", monkeypatch, capsys)
    assert got == want
    for line in ("camera moved (w); accumulation reset", "ray-trace mode",
                 "wrote render<time>.png", "wrote final.png"):
        assert line in got
    moved = Camera()
    assert moved.move("w")
    for cam in (tr.camera, moved):
        np.testing.assert_array_equal(cam.position, np.asarray(jr.camera.position))
        np.testing.assert_array_equal(cam.rotation, np.asarray(jr.camera.rotation))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def _poll(port, cond, timeout=30.0, every=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            stats = json.loads(_get(port, "/stats"))
            if cond(stats["spp"]):
                return stats["spp"]
        except OSError:
            pass   # the server is not up yet
        time.sleep(every)
    raise AssertionError("the viewer did not reach the state waited for")


def test_viewer_serves_frames_and_resets_on_a_camera_key(tmp_path, monkeypatch):
    """The port's version of tests/test_viewer.py: serve on a free port,
    fetch the page and a PNG frame, press w, see the accumulation reset
    through /stats, stop cleanly. One sample per pass at 20x20 keeps a pass
    (~0.1 s on the plain version) long beside the 0.05 s polls."""
    monkeypatch.chdir(tmp_path)
    renderer = ProgressiveRenderer(
        get_scene("cornell_empty"), Camera(),
        RenderConfig(width=20, height=20, max_bounces=3, spp=10 ** 9,
                     samples_per_pass=1, device="cpu"))
    port, holder = _free_port(), {}
    t = threading.Thread(target=tviewer.serve, args=(renderer,),
                         kwargs=dict(port=port, state_out=holder), daemon=True)
    t.start()
    try:
        _poll(port, lambda spp: spp >= 1)
        page = _get(port, "/")
        assert b"progressive view" in page and b"PyTorch/CUDA (cpu)" in page
        assert _get(port, "/frame.png")[:8] == b"\x89PNG\r\n\x1a\n"
        before = _poll(port, lambda spp: spp >= 12)
        assert _get(port, "/key?k=w") == b"ok"
        _poll(port, lambda spp: spp < before)
        assert not np.array_equal(renderer.camera.position, Camera().position)
    finally:
        if "state" in holder:
            holder["state"].stop = True
        t.join(timeout=30)
    assert not t.is_alive(), "the viewer's render loop did not stop"
    step_s, image_s, encode_s = holder["state"].pass_seconds[-1]
    assert step_s > 0 and image_s > 0 and encode_s > 0


def test_view_serves_the_renderer_on_its_port(monkeypatch):
    served = {}
    monkeypatch.setattr(tviewer, "serve",
                        lambda r, port: served.update(renderer=r, port=port))
    tcli.main(["view", "--device", "cpu", "--scene", "cornell_empty", "--width", "8",
               "--height", "8", "--port", "12345"])
    r = served["renderer"]
    assert served["port"] == 12345 and (r.config.width, r.config.device) == (8, "cpu")


@pytest.mark.parametrize("cmd", ["interact", "view"])
def test_interact_and_view_raise_without_a_card(cmd, monkeypatch):
    """--device cuda is the default; without a card the renderer raises
    before anything is rendered or served (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")

    def serve(*a, **k):
        raise AssertionError("served without a card")

    monkeypatch.setattr(tviewer, "serve", serve)
    monkeypatch.setattr("sys.stdin", io.StringIO("x\n"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([cmd, "--scene", "cornell", "--width", "8", "--height", "8"])


def test_kill_and_resume_is_bit_identical(tmp_path):
    """tests/test_cli.py's failure-path recovery through the port's CLI as a
    process: a render SIGKILLed after its first periodic snapshot, relaunched
    with --resume until it exits 0, ends with the accumulator of an
    uninterrupted in-process render, bit for bit."""
    ck, out = str(tmp_path / "ck.npz"), str(tmp_path / "killed.npy")
    argv = [sys.executable, "-m", "cuda_path_tracer_ss_torch.cli", "render",
            "--device", "cpu", "--scene", "cornell_empty", "--width", "16",
            "--height", "16", "--spp", "6", "--bounces", "2", "--samples-per-pass",
            "1", "--out", out, "--checkpoint", ck, "--checkpoint-every", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.time() + 120
    while not os.path.exists(ck) and proc.poll() is None and time.time() < deadline:
        time.sleep(0.02)
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        assert proc.returncode == -signal.SIGKILL
    for _ in range(6):
        if subprocess.run(argv + ["--resume", ck], cwd=ROOT, env=env,
                          stdout=subprocess.DEVNULL, timeout=120).returncode == 0:
            break
    else:
        raise AssertionError("the render never completed")
    r = ProgressiveRenderer(get_scene("cornell_empty"), Camera(),
                            RenderConfig(width=16, height=16, spp=6, samples_per_pass=1,
                                         max_bounces=2, device="cpu"))
    r.run()
    np.testing.assert_array_equal(np.load(out), r.radiance())
