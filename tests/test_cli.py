"""CLI driver, config round-trip, model API, profiling utils."""

import json
import os

import numpy as np
import pytest

from raytracingtest_tpu.cli import main
from raytracingtest_tpu.config import Config, SceneConfig
from raytracingtest_tpu.utils.profiling import (
    RaysPerSecond, iter_stats, traversal_roofline,
)


def test_cli_info(tmp_path, capsys):
    main(["--cache-dir", str(tmp_path), "info", "--scene", "sphere",
          "--depth", "4"])
    out = capsys.readouterr().out
    assert "nodes=" in out and "level  3" in out


def test_cli_render_png(tmp_path):
    out = str(tmp_path / "r.png")
    main(["--cache-dir", str(tmp_path), "render", "--scene", "sphere",
          "--depth", "4", "--width", "32", "--height", "32", "--out", out])
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (32, 32, 3)
    assert img.std() > 1.0  # not a constant image


def test_cli_render_volumetric(tmp_path):
    out = str(tmp_path / "v.png")
    main(["--cache-dir", str(tmp_path), "render", "--scene", "sphere",
          "--depth", "4", "--width", "32", "--height", "32",
          "--volumetric-k", "2", "--out", out])
    assert os.path.exists(out)


def test_cli_fit_recovers_albedo(tmp_path, capsys):
    main(["--cache-dir", str(tmp_path), "fit", "--scene", "sphere",
          "--depth", "3", "--views", "4", "--view-resolution", "32",
          "--steps", "40", "--out-dir", str(tmp_path / "fit")])
    err = capsys.readouterr().err
    assert "final mean |albedo error|" in err
    assert os.path.exists(tmp_path / "fit" / "fit_state.npz")


def test_cli_build_cache_reused(tmp_path, capsys):
    main(["--cache-dir", str(tmp_path), "info", "--scene", "sphere",
          "--depth", "3"])
    err1 = capsys.readouterr().err
    assert "built sphere" in err1
    main(["--cache-dir", str(tmp_path), "info", "--scene", "sphere",
          "--depth", "3"])
    err2 = capsys.readouterr().err
    assert "built sphere" not in err2  # cache hit


def test_config_json_roundtrip(tmp_path):
    cfg = Config(scene=SceneConfig(scene="sphere", depth=6))
    p = str(tmp_path / "cfg.json")
    cfg.to_json(p)
    cfg2 = Config.from_json(p)
    assert cfg2 == cfg


def test_rays_per_second_counter():
    import time

    c = RaysPerSecond()
    with c.frame(1000):
        time.sleep(0.01)
    assert c.frames == 1
    assert 0 < c.rays_per_s < 1000 / 0.01 * 2
    assert "Mrays/s" in c.summary()


def test_roofline_and_iter_stats():
    r = traversal_roofline(1 << 20, 10, 60.0, "NVIDIA H100 80GB HBM3")
    assert r["rays_per_s_ceiling"] > 1e8  # the hardware bound is far above us
    s = iter_stats(np.array([10, 20, 30, 100]))
    assert s["max"] == 100 and s["p50"] <= s["p99"]


def test_cli_fly_smoke(tmp_path):
    """Main-scene flythrough: update -> sync -> render frames end to end."""
    from raytracingtest_tpu import cli
    out = tmp_path / "fly"
    cli.main(["fly", "--scene", "sphere", "--frames", "3",
              "--resolution", "32", "--chunk-depth", "4", "--lods", "1",
              "--radius", "2", "--min-chunk", "0.25",
              "--arena-nodes", "400000", "--arena-leaves", "400000",
              "--out-dir", str(out)])
    import numpy as np
    from PIL import Image
    strip = np.asarray(Image.open(out / "fly_strip.png"))
    assert strip.shape[0] == 32 and strip.shape[1] >= 64
    assert np.isfinite(strip).all()


def test_cli_probe_scripted(tmp_path, capsys):
    """Interactive probe session (SVODriver + OctreeDebugger analog) in
    scripted mode: ray moves re-probe, cubes insert/delete, overlay
    renders."""
    from raytracingtest_tpu import cli
    out = tmp_path / "probe.png"
    cli.main(["--cache-dir", str(tmp_path), "probe", "--scene", "sphere",
              "--depth", "4", "--width", "64", "--height", "64",
              "--commands",
              "from 0.5 0.95 0.5; to 0.5 0.05 0.5; "
              "insert 0.25 0.25 0.25 0.25; boxes; "
              f"render {out}; delete 0.25 0.25 0.25 0.25; quit"])
    text = capsys.readouterr().out
    assert "leaf" in text              # probe found intersections
    assert "inserted" in text and "removed" in text
    import numpy as np
    from PIL import Image
    img = np.asarray(Image.open(out))
    assert img.shape[:2] == (64, 64)


def test_device_op_breakdown(tmp_path):
    """The profiler-trace aggregation returns per-op device totals (on the
    CPU backend device rows may be absent — the call must still succeed
    and return a list)."""
    import jax.numpy as jnp
    from raytracingtest_tpu.utils.profiling import device_op_breakdown

    def fn(x):
        return float(jnp.sum(jnp.sort(x * 2.0)))

    rows = device_op_breakdown(fn, jnp.arange(1024, dtype=jnp.float32),
                               logdir=str(tmp_path), calls=2)
    assert isinstance(rows, list)
    for name, ms, count in rows:
        assert ms >= 0 and count >= 1


def test_render_and_info_from_saved_checkpoint(tmp_path):
    """--load renders/inspects any saved SVO npz without a scene rebuild
    (the reference's stubbed CompactSVO load-from-file role)."""
    import raytracingtest_tpu as rt
    from raytracingtest_tpu.io import checkpoint as ckpt
    from raytracingtest_tpu.cli import main

    svo = rt.build_svo(rt.get_scene("sphere"), 5).svo
    path = tmp_path / "sphere_d5.npz"
    ckpt.save_svo(svo, str(path))
    out = tmp_path / "img.png"
    main(["render", "--load", str(path), "--width", "64", "--height", "64",
          "--out", str(out)])
    assert out.exists() and out.stat().st_size > 500
    main(["info", "--load", str(path)])
