"""CLI tests (SURVEY.md §2 "App/CLI"): run/bench/render subcommands through
the real argv surface, including checkpoint + resume + frame export."""

import json
import os

import numpy as np
import pytest

from gpufluidsimulator_tpu.utils.cli import main


def test_run_small(tmp_path, capsys):
    mj = str(tmp_path / "m.json")
    rc = main(["run", "-n", "300", "--dim", "2", "--steps", "40",
               "--report-every", "20", "--method", "naive",
               "--metrics-json", mj])
    assert rc == 0
    out = capsys.readouterr().out
    assert "steps/s" in out
    m = json.load(open(mj))
    assert m["steps"] == 40
    assert m["n_particles"] >= 200


def test_run_frames_and_checkpoints(tmp_path):
    frames = str(tmp_path / "frames")
    ckpts = str(tmp_path / "ckpts")
    rc = main(["run", "-n", "200", "--dim", "2", "--steps", "20",
               "--report-every", "10", "--method", "naive",
               "--frames-dir", frames, "--width", "64", "--height", "64",
               "--checkpoint-dir", ckpts])
    assert rc == 0
    assert len(os.listdir(frames)) == 2
    assert any(f.endswith(".npz") for f in os.listdir(ckpts))


def test_run_movie_export(tmp_path, capsys):
    """--movie records in-scan frames to one .npz (frames, N, dim)."""
    mv = str(tmp_path / "movie.npz")
    rc = main(["run", "-n", "300", "--dim", "2", "--steps", "30",
               "--method", "naive", "--movie", mv, "--movie-every", "10"])
    assert rc == 0
    assert "3 frames" in capsys.readouterr().out
    with np.load(mv) as z:
        assert z["frames"].shape[0] == 3
        assert z["frames"].shape[2] == 2
        assert int(z["every"]) == 10
        assert np.isfinite(z["frames"]).all()


def test_run_resume(tmp_path, capsys):
    ckpts = str(tmp_path / "ckpts")
    main(["run", "-n", "200", "--dim", "2", "--steps", "10",
          "--report-every", "10", "--method", "naive",
          "--checkpoint-dir", ckpts])
    from gpufluidsimulator_tpu.utils import checkpoint
    latest = checkpoint.latest(ckpts)
    rc = main(["run", "--steps", "10", "--report-every", "10",
               "--method", "naive", "--resume", latest])
    assert rc == 0
    assert "resumed" in capsys.readouterr().out


def test_bench_json(capsys):
    rc = main(["bench", "-n", "300", "--dim", "2", "--method", "naive",
               "--k1", "1", "--k2", "3"])
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    d = json.loads(line)
    assert d["value"] > 0 and d["ms_per_frame"] > 0
    assert d["metric"] == "particle-steps/sec/device"
    assert d["platform"] == "cpu" and d["device_count"] >= 1


def test_render_from_checkpoint(tmp_path, capsys):
    ckpts = str(tmp_path / "ckpts")
    main(["run", "-n", "200", "--dim", "2", "--steps", "10",
          "--report-every", "10", "--method", "naive",
          "--checkpoint-dir", ckpts])
    from gpufluidsimulator_tpu.utils import checkpoint
    out = str(tmp_path / "f.png")
    rc = main(["render", checkpoint.latest(ckpts), "-o", out,
               "--width", "64", "--height", "64"])
    assert rc == 0
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_param_overrides(capsys):
    rc = main(["bench", "-n", "200", "--dim", "2", "--method", "naive",
               "--viscosity", "1.5", "--k1", "1", "--k2", "2"])
    assert rc == 0


def test_run_spawn_boxes_cli(capsys):
    """The reference's 'particle spawn boxes' capability through the app
    layer: two boxes, the second with a velocity."""
    rc = main(["run", "--scene", "spawn_boxes", "-n", "400", "--dim", "2",
               "--steps", "10", "--report-every", "10", "--method", "naive",
               "--box", "0.0,0.0:1.0,0.25",
               "--box", "0.4,0.6:0.6,0.8:0.5,-1.0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "scene=spawn_boxes" in out


def test_spawn_boxes_velocity_applied():
    """The per-box velocity must actually ride into the state."""
    from gpufluidsimulator_tpu.models import scenes

    params, state = scenes.spawn_boxes(
        n=400, dim=2,
        boxes=[((0.0, 0.0), (1.0, 0.25)),
               ((0.4, 0.6), (0.6, 0.8), (0.5, -1.0))])
    v = np.asarray(state.vel)
    p = np.asarray(state.pos)
    upper = p[:, 1] > 0.5
    assert upper.any() and (~upper).any()
    assert np.allclose(v[upper], [0.5, -1.0])
    assert np.allclose(v[~upper], 0.0)


def test_spawn_boxes_default_scene():
    """--scene spawn_boxes with no --box uses the drop-into-pool default."""
    rc = main(["run", "--scene", "spawn_boxes", "-n", "300", "--dim", "2",
               "--steps", "5", "--report-every", "5", "--method", "naive"])
    assert rc == 0


def test_box_requires_spawn_boxes():
    with pytest.raises(SystemExit):
        main(["run", "--scene", "dam_break", "-n", "100", "--dim", "2",
              "--steps", "1", "--box", "0,0:1,1", "--method", "naive"])


def test_sharded_movie_refused(tmp_path):
    """--sharded --movie must refuse loudly, not silently run single-device
   : the movie branch records frames via
    solver.rollout, which has no sharded counterpart."""
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["run", "-n", "200", "--dim", "2", "--steps", "10",
              "--method", "naive", "--sharded",
              "--movie", str(tmp_path / "m.npz")])


def test_run_profile_dir(tmp_path, capsys):
    """--profile-dir wraps the run in a jax.profiler trace and lands a
    TensorBoard/Perfetto dump."""
    pd = str(tmp_path / "trace")
    rc = main(["run", "-n", "200", "--dim", "2", "--steps", "5",
               "--report-every", "5", "--method", "naive",
               "--profile-dir", pd])
    assert rc == 0
    assert "profiler trace" in capsys.readouterr().out
    found = []
    for root, _, files in os.walk(pd):
        found += [f for f in files if f.endswith((".pb", ".json.gz",
                                                  ".trace.json.gz"))]
    assert found, f"no trace artifacts under {pd}"


def test_run_native_method(capsys):
    """The reference's CPU-mode switch: --method native steps through the
    C++ engine via the same CLI surface (SURVEY.md §3.4)."""
    from gpufluidsimulator_tpu.oracle import native as _native
    if not _native.available():
        pytest.skip("native fluidcore not built")
    rc = main(["run", "-n", "200", "--dim", "2", "--steps", "20",
               "--report-every", "10", "--method", "native"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "method=native" in out


def test_bench_native_method(capsys):
    from gpufluidsimulator_tpu.oracle import native as _native
    if not _native.available():
        pytest.skip("native fluidcore not built")
    rc = main(["bench", "-n", "300", "--dim", "2", "--method", "native",
               "--k1", "1", "--k2", "3"])
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    d = json.loads(line)
    assert d["method"] == "native" and d["value"] > 0


def test_fluidsim_native_matches_oracle():
    """FluidSim(method='native') must advance exactly like oracle.native.run."""
    import numpy as np
    from gpufluidsimulator_tpu import FluidSim, scenes
    from gpufluidsimulator_tpu.oracle import native as _native
    if not _native.available():
        pytest.skip("native fluidcore not built")
    params, state = scenes.dam_break(n=300, dim=2, jitter=0.2, seed=7)
    sim = FluidSim(params, state, method="native")
    sim.step(15)
    p_ref, v_ref, _, _ = _native.run(
        np.asarray(state.pos, np.float64), np.asarray(state.vel, np.float64),
        params, 15)
    np.testing.assert_allclose(np.asarray(sim.state.pos), p_ref.astype(np.float32),
                               rtol=0, atol=1e-6)
    # positions come back in spawn order (ids untouched by the native path)
    np.testing.assert_allclose(sim.get_positions(),
                               p_ref.astype(np.float32), rtol=0, atol=1e-6)
