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


def test_unknown_and_unported_scenes_raise(tmp_path):
    """An unknown preset raises; every preset of the reference renders, the
    textured one included."""
    with pytest.raises(KeyError, match="unknown scene preset"):
        main(["render", "--device", "cpu", "--scene", "nope", "--width", "8",
              "--height", "8"])
    out = str(tmp_path / "t.png")
    main(["render", "--device", "cpu", "--scene", "textured", "--width", "8",
          "--height", "8", "--spp", "1", "--bounces", "2", "--out", out])
    assert read_png(out).shape == (8, 8, 3)


@pytest.mark.parametrize("flag", [["--physical"], ["--accel", "grid"]])
@pytest.mark.parametrize("cmd", ["render", "benchmark"])
def test_unported_flags_raise(cmd, flag, tmp_path, capsys):
    """Both flags run: the physical estimator renders; the grid renders the
    linear sweeps' image (the same file, the same checksum)."""
    outs = []
    for extra in ([], flag):
        out = str(tmp_path / f"r{len(outs)}.npy")
        args = [cmd, *SMALL, "--spp", "1", *extra]
        if cmd == "render":
            args += ["--out", out]
        main(args)
        text = capsys.readouterr().out
        outs.append(np.load(out) if cmd == "render"
                    else json.loads(text.strip().splitlines()[-1]))
    if flag == ["--physical"]:
        if cmd == "render":
            assert outs[1].max() > 0
        else:
            assert outs[1]["physical"] is True
    elif cmd == "render":
        np.testing.assert_array_equal(outs[1], outs[0])
    else:
        assert outs[1]["accel"] == "grid" and outs[1]["checksum"] == outs[0]["checksum"]


def test_physical_render_differs_from_the_default_estimator(tmp_path, capsys):
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    main(["render", *SMALL, "--spp", "4", "--out", a])
    main(["render", *SMALL, "--spp", "4", "--out", b, "--physical"])
    default, physical = np.load(a), np.load(b)
    assert default.shape == physical.shape == (16, 16, 3)
    assert np.isfinite(physical).all() and physical.mean() > 0
    assert np.abs(default - physical).max() > 1e-3


# ---- light tracing and the bidirectional render ------------------------------

LIGHT = ["--device", "cpu", "--scene", "caustic", "--width", "12", "--height", "12",
         "--bounces", "3", "--paths", "1500", "--batches", "2"]


def test_lighttrace_writes_png(tmp_path, capsys):
    out = str(tmp_path / "lt.png")
    main(["lighttrace", *LIGHT, "--out", out])
    text = capsys.readouterr().out
    assert "batch 2/2" in text and "engine plain" in text and f"wrote {out}" in text
    img = read_png(out)
    assert img.shape == (12, 12, 3) and img.max() > 0


def test_bidir_writes_png_and_shows_what_lighttrace_cannot(tmp_path, capsys):
    """The glass sphere of `caustic` is black in a light-trace-only render
    (no eye-side subpath) and lit in the bidirectional one."""
    lt, bd = str(tmp_path / "lt.png"), str(tmp_path / "bd.png")
    main(["lighttrace", *LIGHT, "--out", lt])
    main(["bidir", *LIGHT, "--spp", "2", "--out", bd])
    assert "eye samples + light paths" in capsys.readouterr().out
    a, b = read_png(lt).astype(float), read_png(bd).astype(float)
    assert b.shape == (12, 12, 3)
    assert b.mean() > a.mean() and (b > 0).mean() > (a > 0).mean()


@pytest.mark.parametrize("cmd", ["lighttrace", "bidir"])
def test_light_commands_pick_their_engine_by_the_device(cmd):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        main([cmd, *LIGHT, "--engine", "cuda"])


@pytest.mark.parametrize("cmd", ["lighttrace", "bidir"])
def test_light_commands_on_the_eager_engine_raise_naming_the_roadmap(cmd):
    """Light paths on the eager engine are ported (ROADMAP Queue 1 item 8
    is done; they no longer raise naming it): without --device cpu they keep
    the device rule and raise without a card, with no fallback to the CPU
    (tests/test_torch_eager_light_grad.py runs them on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    on_card = [a for a in LIGHT if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([cmd, *on_card, "--engine", "eager"])


# ---- the training commands ----------------------------------------------------

TRAIN = ["--width", "10", "--height", "10", "--spp", "2", "--bounces", "3",
         "--seed", "3"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_grad_check_prints_the_reference_cli_s_json(capsys):
    from cuda_path_tracer_ss_tpu.cli import main as jmain

    args = ["grad-check", "--scene", "cornell_lambert", *TRAIN, "--directions", "2"]
    jmain([*args, "--engine", "jnp"])
    want = _last_json(capsys)
    main([*args, "--device", "cpu"])
    got = _last_json(capsys)
    assert set(got) == set(want)
    assert got["fields"] == want["fields"] == ["materials.diffuse", "al_power"]
    assert got["engine"] == "plain" and got["allclose"] is True
    assert len(got["ad"]) == len(got["fd"]) == 2 and got["max_rel_err"] < 0.05


def test_invert_prints_the_reference_cli_s_json(tmp_path, capsys):
    """Same perturbation, same Adam, same streams: the final loss and the
    remaining error equal the reference CLI's."""
    from cuda_path_tracer_ss_tpu.cli import main as jmain

    args = ["invert", "--scene", "cornell", *TRAIN, "--steps", "4", "--lr", "0.1",
            "--perturb", "0.2"]
    jmain([*args, "--engine", "jnp"])
    want = _last_json(capsys)
    out = str(tmp_path / "recovered.png")
    main([*args, "--device", "cpu", "--out", out])
    text = capsys.readouterr().out
    assert "step    0  loss" in text and f"wrote {out}" in text
    got = json.loads(text.strip().splitlines()[-2])
    assert set(got) == set(want) == {"final_loss", "max_abs_err"}
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["max_abs_err"]["materials.diffuse"],
                               want["max_abs_err"]["materials.diffuse"], atol=1e-4)
    assert read_png(out).shape == (10, 10, 3)


@pytest.mark.parametrize("flag,item", [
    (["--physical", "--fields", "materials.diffuse,materials.spec_avg"], "physical"),
    (["--accel", "grid"], "grid"), (["--fields", "tri_v0,materials.diffuse"], "K2 geo")])
@pytest.mark.parametrize("cmd", ["grad-check", "invert"])
def test_training_commands_refuse_what_is_not_ported(cmd, flag, item, capsys):
    """Every training option runs: gradients of the physical estimator
    (spec_avg among them) and of triangle geometry, and the grid, to the
    linear sweeps' numbers. grad-check's AD agrees with FD on the physical
    estimator's smooth fields; invert's loss falls."""
    extra = ["--steps", "3"] if cmd == "invert" else ["--directions", "1"]
    if flag[0] != "--accel":
        main([cmd, "--device", "cpu", *TRAIN, *extra, *flag])
        out = capsys.readouterr().out.strip().splitlines()
        got = json.loads(out[-1])
        if cmd == "grad-check":
            assert got["engine"] == "plain" and np.isfinite(got["ad"]).all()
            assert np.abs(got["ad"]).max() > 0
            if item == "physical":
                assert got["allclose"] is True
        else:
            assert np.isfinite(got["final_loss"])
            first = float(next(ln for ln in out if ln.startswith("step    0")).split()[-1])
            assert got["final_loss"] < first
        return
    got = []
    for accel in ("none", "grid"):
        main([cmd, "--device", "cpu", *TRAIN, *extra, "--accel", accel])
        got.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert got[0] == got[1]


def test_invert_refuses_silhouette_and_spec_avg(capsys):
    """--silhouette on the CPU trains one step on the eager engine (the
    plain engine refuses it); spec_avg without --physical is refused."""
    main(["invert", "--device", "cpu", *TRAIN, "--steps", "1", "--silhouette",
          "--scene", "shadowed_caustic", "--fields", "sph_radius", "--width", "8",
          "--height", "8", "--spp", "1", "--bounces", "2"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(got["final_loss"]) and "sph_radius" in got["max_abs_err"]
    with pytest.raises(ValueError, match="silhouette=True supports"):
        main(["invert", "--device", "cpu", *TRAIN, "--steps", "1", "--silhouette",
              "--engine", "plain"])
    with pytest.raises(ValueError, match="spec_avg"):
        main(["invert", "--device", "cpu", *TRAIN, "--fields", "materials.spec_avg"])


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["render", "--scene", "cornell", "--width", "8", "--height", "8",
              "--spp", "1"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        main(["benchmark", *SMALL, "--engine", "cuda"])
