"""The port's command line on the CPU (plain engine)."""
import json
import os

import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_torch.cli import main
from cuda_path_tracer_ss_torch.utils.image import read_png

SMALL = ["--device", "cpu", "--scene", "cornell", "--width", "16", "--height",
         "16", "--bounces", "3"]


def test_render_writes_png_and_checkpoint(tmp_path, capsys):
    out, ck = str(tmp_path / "r.png"), str(tmp_path / "ck.npz")
    main(["render", *SMALL, "--spp", "4", "--out", out, "--checkpoint", ck])
    assert os.path.exists(out) and os.path.exists(ck)
    assert not os.path.exists(str(tmp_path / "ck.tmp.npz"))
    img = read_png(out)
    assert img.shape == (16, 16, 3) and img.max() > 0
    assert f"wrote {out}" in capsys.readouterr().out


def test_render_resume_gives_the_same_bytes(tmp_path, capsys):
    """12 spp, stopped after 4+8... then resumed to 28 == 28 spp in one go:
    the AUTO pass schedule is a function of the sample index alone."""
    whole, part, resumed = (str(tmp_path / n) for n in ("w.png", "p.png", "r.png"))
    ck = str(tmp_path / "ck")
    main(["render", *SMALL, "--spp", "28", "--out", whole])
    main(["render", *SMALL, "--spp", "12", "--out", part, "--checkpoint", ck,
          "--checkpoint-every", "1"])
    main(["render", *SMALL, "--spp", "28", "--out", resumed, "--resume", ck])
    with open(whole, "rb") as f, open(resumed, "rb") as g, open(part, "rb") as p:
        a, b, c = f.read(), g.read(), p.read()
    assert a == b and a != c


def test_benchmark_prints_one_json_object(capsys):
    main(["benchmark", *SMALL, "--spp", "1", "--repeats", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    data = json.loads(lines[0])
    assert data["engine"] == "plain" and data["device"] == "cpu"
    assert data["primary_rays_per_s"] > 0 and np.isfinite(data["checksum"])
    assert (data["width"], data["height"], data["spp"], data["bounces"]) == (16, 16, 1, 3)


def test_unknown_and_unported_scenes_raise():
    with pytest.raises(KeyError, match="unknown scene preset"):
        main(["render", "--device", "cpu", "--scene", "nope", "--width", "8",
              "--height", "8"])
    with pytest.raises(KeyError, match="not ported yet"):
        main(["render", "--device", "cpu", "--scene", "textured", "--width", "8",
              "--height", "8"])


@pytest.mark.parametrize("flag", [["--physical"], ["--accel", "grid"]])
@pytest.mark.parametrize("cmd", ["render", "benchmark"])
def test_unported_flags_raise(cmd, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main([cmd, *SMALL, "--spp", "1", *flag])


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["render", "--scene", "cornell", "--width", "8", "--height", "8",
              "--spp", "1"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        main(["benchmark", *SMALL, "--engine", "cuda"])
