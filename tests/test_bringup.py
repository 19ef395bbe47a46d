"""What running on a bare GPU machine needs: the plain-JAX detector (no
flax), an import that survives missing flax/orbax/cv2, the compile-cache
placement, and ``chip_smoke.py`` — refusing the CPU, and each of its
phases passing at the tiny config when called directly."""

import os
import subprocess
import sys

import numpy as np
import pytest

import zybo_rt_sampler_image_detection_tpu as zrt
from zybo_rt_sampler_image_detection_tpu.models import yolo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env=None, cwd=REPO, timeout=240):
    base = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS",
                         "ZRT_NO_COMPILE_CACHE")}
    base.update(env or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=cwd, env=base, timeout=timeout)


@pytest.mark.parametrize("width", [0.25, 0.5])
def test_tiny_yolo_variable_tree(width):
    import jax

    cfg = yolo.YoloConfig(input_size=64, width_mult=width, num_classes=2)
    model, v = yolo.init_params(cfg, jax.random.PRNGKey(0))
    assert set(v) == {"params", "batch_stats"}
    w = lambda f: max(8, int(f * width))               # noqa: E731
    p, s = v["params"], v["batch_stats"]
    assert p["block0"]["kernel"].shape == (3, 3, 3, w(16))
    assert p["block6"]["kernel"].shape == (1, 1, w(512), w(256))
    assert p["block9"]["kernel"].shape == (3, 3, w(128) + w(256), w(256))
    assert p["head32"]["kernel"].shape == (1, 1, w(512), 3 * 7)
    assert p["head16"]["bias"].shape == (3 * 7,)
    assert set(s) == set(model.blocks)
    assert s["block4"]["mean"].shape == s["block4"]["var"].shape == (w(256),)
    heads = model.apply(v, np.zeros((2, 64, 64, 3), np.float32))
    assert [h.shape for h in heads] == [(2, 2, 2, 21), (2, 4, 4, 21)]


def test_tiny_yolo_batch_norm_running_stats():
    """Train mode normalises by the batch and folds its statistics into
    the running ones with momentum 0.97; eval mode uses them unchanged."""
    import jax

    cfg = yolo.YoloConfig(input_size=32, width_mult=0.25)
    model, v = yolo.init_params(cfg, jax.random.PRNGKey(1))
    x = np.random.default_rng(0).random((4, 32, 32, 3)).astype(np.float32)
    heads, upd = model.apply(v, x, train=True, mutable=["batch_stats"])
    new = upd["batch_stats"]
    k = np.asarray(v["params"]["block0"]["kernel"], np.float64)
    conv = np.asarray(jax.lax.conv_general_dilated(
        x.astype(np.float64), k, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    mean = conv.mean(axis=(0, 1, 2))
    var = conv.var(axis=(0, 1, 2))
    np.testing.assert_allclose(new["block0"]["mean"], 0.03 * mean,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(new["block0"]["var"], 0.97 + 0.03 * var,
                               rtol=1e-4, atol=1e-6)
    # eval mode: stats untouched, outputs differ from train mode
    same, upd2 = model.apply(v, x, train=False, mutable=["batch_stats"])
    assert upd2["batch_stats"] is v["batch_stats"]
    assert not np.allclose(np.asarray(same[0]), np.asarray(heads[0]))


def test_tiny_yolo_gradients_finite():
    import jax

    from zybo_rt_sampler_image_detection_tpu.models import train

    cfg = yolo.YoloConfig(input_size=32, width_mult=0.25)
    model, v = yolo.init_params(cfg, jax.random.PRNGKey(2))
    x = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    tm = train.build_targets(cfg, [np.array([[4.0, 4.0, 20.0, 20.0, 0.0]])]
                             * 2)

    def loss(params):
        heads, _ = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, x,
                               train=True, mutable=["batch_stats"])
        return train.yolo_loss(cfg, heads, [t for t, _ in tm],
                               [m for _, m in tm])

    grads = jax.grad(loss)(v["params"])
    leaves = jax.tree.leaves(grads)
    assert leaves and all(np.isfinite(np.asarray(g)).all() for g in leaves)
    assert any(np.abs(np.asarray(g)).max() > 0 for g in leaves)


def test_import_without_flax_orbax_cv2():
    """The package imports and runs a detector forward with flax, orbax
    and cv2 unimportable — as on a machine that has only JAX, NumPy and
    SciPy."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('flax', 'orbax', 'cv2'):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
import numpy as np
import zybo_rt_sampler_image_detection_tpu as zrt
from zybo_rt_sampler_image_detection_tpu.models import detect, yolo
det = detect.YoloDetector(cfg=yolo.YoloConfig(input_size=32,
                                              width_mult=0.25))
out = det.get_detections(np.zeros((40, 50, 3), np.uint8))
assert isinstance(out, list)
assert not any(m.split('.')[0] in ('flax', 'orbax', 'cv2')
               for m in sys.modules)
print('ok')
"""
    r = _run(code, env={"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the package sets nothing (JAX
    reads the variable); without it the cache lands at the one fixed path
    inside the checkout.  Neither opens a device."""
    code = """
import jax
import zybo_rt_sampler_image_detection_tpu as zrt
from zybo_rt_sampler_image_detection_tpu import paths
print(jax.config.jax_compilation_cache_dir)
print(jax.config.jax_persistent_cache_min_compile_time_secs)
print(paths.CACHE_ROOT)
"""
    env = {"JAX_PLATFORMS": ""}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jcc")
    r = _run(code, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    cache_dir, min_secs, root = r.stdout.split()
    if env_dir:
        assert cache_dir == str(tmp_path / "jcc")
        assert float(min_secs) == 1.0           # JAX's own default
    else:
        assert root == os.path.join(REPO, ".cache")
        assert cache_dir == os.path.join(root, "jax_compile")
        assert float(min_secs) == 0.0


def test_chip_smoke_refuses_cpu():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, cwd=REPO, timeout=240,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("phase", ["line_rate", "tiers", "listening",
                                   "freq", "fused"])
def test_chip_smoke_phase_tiny(smoke, phase):
    cfg = zrt.Config.tiny().replace(udp_port=21977)
    if phase == "line_rate":
        res = smoke.phase_line_rate(cfg, 0, seconds=1.0, batch=8)
        assert res["processed"] > 0 and res["maps_checked"] == 16
    elif phase == "tiers":
        res = smoke.phase_tiers([("tiny", cfg)], 0)
        assert set(res) == {"tiny/highest", "tiny/high", "tiny/bf16"}
    elif phase == "listening":
        res = smoke.phase_listening(cfg, 0, batch=4)
        assert set(res) == {"time", "mvdr_alpha0.9", "mvdr_alpha0.99",
                            "oracle_offset_samples"}
    elif phase == "freq":
        res = smoke.phase_freq(cfg, 0)
        assert res["bartlett_max_err_rel"] <= smoke.BARTLETT_TOL
    else:
        res = smoke.phase_fused(cfg, 0, K=3, det_size=64, det_width=0.25,
                                cam_hw=(48, 64), window=(80, 48),
                                n_oracle=2)
        assert res["detections"] == [3, 32, 5]
