"""Platform decisions, the compile-cache rule, the peak table, and the GPU
smoke check's comparison helpers — all runnable on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from mycelium_tpu import device
from mycelium_tpu.config import tuned_fea_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend", ["gpu", "rocm"])
def test_tuned_fea_config_same_on_every_backend(backend, monkeypatch):
    """The 'fast' preset must not depend on the backend: no kernel or
    precision switch hides behind it."""
    import dataclasses
    import jax
    base = tuned_fea_config()                  # this session: cpu
    assert (base.operator, base.precond, base.dtype) == ("chain", "tree",
                                                         "float32")
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(device, "platform", lambda: backend)
    assert tuned_fea_config() == base
    assert tuned_fea_config(dtype="float64") == \
        dataclasses.replace(base, dtype="float64")


@pytest.mark.parametrize("found,ok", [("cpu", False), ("rocm", False),
                                      ("gpu", True)])
def test_require_gpu_refuses_other_platforms(found, ok):
    if ok:
        device.require_gpu(found)
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            device.require_gpu(found)


def test_require_gpu_refuses_this_cpu_session():
    """The test session runs on the CPU backend, which must be refused."""
    assert device.platform() == "cpu"
    with pytest.raises(RuntimeError):
        device.require_gpu()


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compilation_cache_rule(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without
    it the cache lands in <repo>/.jax_cache. Run in a fresh interpreter:
    the session's own JAX config is already fixed."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax; jax.config.update('jax_platforms', 'cpu');"
            "from mycelium_tpu.utils import enable_compilation_cache;"
            "d = enable_compilation_cache();"
            "print(d); print(jax.config.jax_compilation_cache_dir);"
            "print(jax.config.jax_persistent_cache_min_compile_time_secs)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(REPO, ".jax_cache"))
    assert out[0] == want and out[1] == want
    # the env-var path leaves JAX's own thresholds alone
    assert float(out[2]) == (1.0 if env_dir else 0.0)


@pytest.mark.parametrize("kind,ok", [("NVIDIA H100 80GB HBM3", True),
                                     ("NVIDIA A100-SXM4-80GB", False),
                                     ("cpu", False)])
def test_peak_table_rejects_unknown_device(kind, ok):
    from mycelium_tpu.bench.roofline import device_peaks
    if ok:
        assert device_peaks(kind)["hbm_gbps"] == 3350.0
    else:
        with pytest.raises(KeyError, match="no published peaks"):
            device_peaks(kind)


def test_smoke_comparison_helpers():
    x = np.array([1.0, 2.0, 2.0])
    assert chip_smoke.rel_l2(x, x) == 0.0
    assert chip_smoke.rel_l2(x * (1 + 1e-5), x) == pytest.approx(1e-5)
    assert chip_smoke.max_rel_diff([1.0, 2.1], [1.0, 2.0]) == \
        pytest.approx(0.05)
    assert chip_smoke.within_band(115.0, 100.0, 0.15)
    assert not chip_smoke.within_band(116.0, 100.0, 0.15)
    assert not chip_smoke.within_band(84.0, 100.0, 0.15)
    fd = np.array([[0.0, 0.0], [0.1, 5.0], [0.2, 9.0], [0.3, 1.0]])
    assert chip_smoke.pick_steps(fd) == [1, 2, 3]
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check(False, "boom")


@pytest.mark.parametrize("scene_name", ["test_X", "test_y"])
def test_smoke_host_oracle_matches_reference_solve(scene_name):
    """chip_smoke's stand-alone numpy/SciPy oracle reproduces the test
    suite's reference solve (assemble_scipy + condensation + spsolve),
    with and without fracture."""
    from mycelium_tpu import scenes
    from mycelium_tpu.config import archive_parity_config
    from mycelium_tpu.fea import build_model
    from test_fea_core import _scipy_reference_solve

    cfg = archive_parity_config()
    sc = scenes.SCENES[scene_name]()
    model = build_model(sc.coords, sc.conn, cfg)
    for active in (np.ones(model.n_elems, bool),
                   np.arange(model.n_elems) % 3 != 0):
        ref = _scipy_reference_solve(model, cfg, active, 0.01, -0.01)
        got = chip_smoke.host_reference_solve(sc.coords, sc.conn, active,
                                              0.01, cfg)
        np.testing.assert_allclose(got.ravel(), ref, rtol=1e-10,
                                   atol=1e-14)


def test_smoke_reads_cli_fea_records(tmp_path):
    from mycelium_tpu.io import write_fea_records
    rng = np.random.default_rng(0)
    disp = rng.normal(size=(3, 12))
    act = rng.random((3, 5)) > 0.5
    fd = rng.normal(size=(3, 2))
    write_fea_records(str(tmp_path), rng.normal(size=(3, 5)), act, disp, fd)
    d, a, f = chip_smoke.read_fea_records(str(tmp_path))
    np.testing.assert_array_equal(d.reshape(3, 12), disp)
    np.testing.assert_array_equal(a, act)
    np.testing.assert_array_equal(f, fd)


def test_smoke_refuses_cpu_without_result_line(tmp_path):
    """Without a GPU the smoke check exits non-zero and prints no result
    line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_smoke_grow_ties_finds_threshold_tips():
    """Tips whose growth or branch test sits on its threshold to f32
    rounding are ties; a tip half way between the thresholds is not."""
    import jax.numpy as jnp
    from mycelium_tpu.config import GrowthConfig
    from mycelium_tpu.growth import init_state

    cfg = GrowthConfig()
    st, _ = init_state(cfg)
    assert len(chip_smoke.grow_ties(st, cfg)) == 0
    slots = np.asarray(st.tip)[:3]
    seg = np.asarray(st.end, np.float64) - np.asarray(st.start, np.float64)
    length = np.linalg.norm(seg[slots], axis=1)
    cost = cfg.c_g * cfg.h0
    sub = st.sub.at[slots].set(jnp.asarray(
        np.array([1.0, 2.0, 1.5]) * cost / length, st.sub.dtype))
    ties = chip_smoke.grow_ties(st._replace(sub=sub), cfg)
    assert sorted(ties.tolist()) == sorted(slots[:2].tolist())
