"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to run
without a GPU. The full-size run happens on the card: python chip_smoke.py."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from raytracingtest_tpu.ops.octree import build_svo
from raytracingtest_tpu.scenes import get_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def terrain5():
    return build_svo(get_scene("terrain"), 5).svo


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert "no GPU found" in captured.err
    assert '"ok"' not in captured.out


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert proc.stdout.strip() == ""


def test_phase_device_reports_platform(capsys):
    info = chip_smoke.phase_device()
    assert info["platform"] == "cpu" and info["count"] == 8
    assert "peak-rate table: False" in capsys.readouterr().out


def test_phase_build_and_cache(tmp_path, capsys):
    svo = chip_smoke.phase_build(5, cache_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert "masks: 0 entries differ" in out
    assert (tmp_path / "svo_terrain_d5.npz").exists()
    assert svo.depth == 5 and svo.n_leaves > 0


def test_phase_render(terrain5, tmp_path, capsys):
    chip_smoke.phase_render(terrain5, 64, 512, str(tmp_path))
    out = capsys.readouterr().out
    assert "tile exact vs host oracle: 0 of 512 rays differ" in out
    assert (tmp_path / "render_64.png").exists()


def test_phase_parity(terrain5, capsys):
    chip_smoke.phase_parity(terrain5, 64)
    out = capsys.readouterr().out
    assert "brick vs plain: 0 of 4096" in out
    assert "tile vs plain: 0 of 4096" in out


def test_phase_fwd_bwd(terrain5, capsys):
    chip_smoke.phase_fwd_bwd(terrain5, 64)
    assert "tile residual 0" in capsys.readouterr().out


def test_phase_fit(tmp_path, capsys):
    chip_smoke.phase_fit(5, views=4, steps=4, res=64,
                         cache_dir=str(tmp_path / "cache"),
                         out_dir=str(tmp_path / "fit"))
    assert "residual 0" in capsys.readouterr().out


def test_phase_fly(tmp_path, capsys):
    chip_smoke.phase_fly(frames=2, res=32, out_dir=str(tmp_path),
                         extra=("--chunk-depth", "4", "--lods", "1",
                                "--hold-frames", "1",
                                "--arena-nodes", "400000",
                                "--arena-leaves", "400000"))
    assert "[6 fly] 3 frames" in capsys.readouterr().out


def test_phase_deep(tmp_path, capsys):
    chip_smoke.phase_deep(depth=5, res=32, n_sample=256, out_dir=str(tmp_path),
                          split_level=1)
    out = capsys.readouterr().out
    assert "deep exact vs host oracle: 0 of 256" in out


def test_phase_four_on_host_devices(capsys):
    chip_smoke.phase_four(depth=5, fit_res=32, render_res=64, trace_res=32,
                          n_devices=4)
    out = capsys.readouterr().out
    assert "sharded trace vs direct: 0 of 1024" in out
    assert "exchange trace vs direct: 0 of 1024" in out


def test_compare_hits_limit():
    ref = np.arange(20000)
    got = ref.copy()
    got[0] = -1                        # 1 in 20000 = 5e-5: within the limit
    assert chip_smoke.compare_hits("x", ref, ref * 1.0, got, ref * 1.0) == 1
    got[1] = -1                        # 1e-4: the limit itself
    chip_smoke.compare_hits("x", ref, ref * 1.0, got, ref * 1.0)
    got[2] = -1
    with pytest.raises(AssertionError):
        chip_smoke.compare_hits("x", ref, ref * 1.0, got, ref * 1.0)


def test_compare_arrays_tolerance():
    ref = np.array([1.0, 2.0, 0.0])
    chip_smoke.compare_arrays("g", ref, ref * (1 + 5e-5), 1e-4, 1e-6)
    with pytest.raises(AssertionError):
        chip_smoke.compare_arrays("g", ref, ref + [0, 0, 1e-5], 1e-4, 1e-6)
    with pytest.raises(AssertionError):
        chip_smoke.compare_arrays("g", ref, [1.0, np.nan, 0.0], 1e-4, 1e-6)


def test_main_path_has_no_matrix_products(terrain5, capsys):
    """The render and loss entry points compile to no dot, convolution or
    BLAS call, so the GPU's TF32 matrix rounding cannot reach them."""
    import jax
    from raytracingtest_tpu import diff

    dsvo, bsvo, tsvo, o_t, d_t, corners, params, light = chip_smoke._inputs(
        terrain5, 32)
    o, d = o_t.reshape(-1, 3), d_t.reshape(-1, 3)
    target = jax.numpy.zeros((o.shape[0], 3))
    lowered = [
        diff.render_diff.lower(*params, dsvo.masks, dsvo.child_base,
                               dsvo.leaf_base, o, d, 5, light),
        diff.render_diff_brick.lower(*params, bsvo.top_masks, bsvo.top_child,
                                     bsvo.top_parent, bsvo.bricks, o, d, 5,
                                     bsvo.top_depth, light),
        diff.render_diff_tile.lower(*params, tsvo, o_t, d_t, corners, light),
        diff.loss_and_grads_tile.lower(*params, tsvo, o_t, d_t, corners,
                                       light, target),
        diff.loss_and_grads.lower(*params, dsvo.masks, dsvo.child_base,
                                  dsvo.leaf_base, o, d, 5, light, target),
    ]
    for lo in lowered:
        text = lo.as_text()
        assert "dot_general" not in text and "convolution" not in text
        chip_smoke.check_no_matrix_products("entry point", lo)
    assert "matrix products none" in capsys.readouterr().out


def test_matrix_product_scan_finds_a_dot(capsys):
    import jax
    import jax.numpy as jnp
    lo = jax.jit(lambda a, b: jnp.dot(a, b) + 1.0).lower(
        jnp.ones((8, 8)), jnp.ones((8, 8)))
    with pytest.raises(AssertionError):
        chip_smoke.check_no_matrix_products("a dot", lo)
    assert chip_smoke.MATRIX_PRODUCT.search(
        'custom-call(), custom_call_target="__cublas$gemm"')
