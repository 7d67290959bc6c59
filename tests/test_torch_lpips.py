"""The port's LPIPS (metrics/lpips_impl.py, metrics/image.py::lpips and the
eval paths' wiring) against the JAX package's, on the CPU.

The JAX package's random init_params (alex and vgg) are bridged through
its own .npz into the port; both packages' lpips_distance then see the
same weights and images. Tolerance: 1e-5 relative plus 1e-7 absolute,
float32 convolutions of two libraries (XLA's and oneDNN's, summed in other
orders) through five taps; a wrong tap, channel or scaling is O(1).
Also: identical images give 0, the converter's three key formats give the
JAX converter's dict, the .npz and .pt round trips, the weight
resolution (explicit path, NERAF_LPIPS_WEIGHTS, then the default cache
paths, else NaN), the too-small image, and the pipeline wiring:
_maybe_lpips, evaluate_vision and eval_image report a number with weights
(evaluate_vision the JAX pipeline's, at the same weights and renders) and
null with the JAX package's skip reason without. Every weight file is
written under tmp_path and found through the environment (monkeypatch);
the default cache paths are patched away, never written.
"""

import shutil

import numpy as np
import pytest
import torch

import neraf_tpu.metrics.lpips_impl as JL
from neraf_tpu.metrics.image import lpips as jlpips_metric
from neraf_tpu_torch.metrics import lpips_impl as L
from neraf_tpu_torch.metrics.image import lpips as lpips_metric
from test_torch_vision_slice import vision_slice  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def _remove_tmp_path(request):
    """Each test's tmp_path is removed when the test ends: pytest keeps every
    test's directory, and the weights files are 10-110 MB."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _no_default_weights(monkeypatch):
    """No weights but the ones a test writes under tmp_path."""
    monkeypatch.delenv("NERAF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(L, "_DEFAULT_PATHS", ())
    monkeypatch.setattr(JL, "_DEFAULT_PATHS", ())


def _bridged(tmp_path, net):
    """The JAX package's random weights, saved by it and loaded by the port."""
    path = tmp_path / f"lpips_{net}.npz"
    jparams = JL.init_params(net)
    JL.save_params_npz(path, jparams, net=net)
    params, got_net = L.load_params(str(path))
    assert got_net == net and set(params) == set(jparams)
    return jparams, params, path


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_distance_matches_jax(net, tmp_path):
    jparams, params, _ = _bridged(tmp_path, net)
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    for normalize in (True, False):
        ours = L.lpips_distance(params, torch.from_numpy(x), torch.from_numpy(y),
                                net=net, normalize=normalize).numpy()
        theirs = np.asarray(JL.lpips_distance(jparams, x, y, net=net,
                                              normalize=normalize))
        np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
        assert ours.shape == (2,) and np.all(ours > 0)
    one = L.lpips_distance(params, x[0], y[0], net=net)
    assert one.ndim == 0
    np.testing.assert_allclose(float(one), float(JL.lpips_distance(
        jparams, x[0], y[0], net=net)), rtol=RTOL, atol=ATOL)


def test_identical_images_give_zero():
    params = L.init_params("alex")
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (32, 32, 3)).astype(np.float32))
    assert abs(float(L.lpips_distance(params, x, x, net="alex"))) < 1e-8


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_init_params_have_the_checkpoint_shapes(net):
    ours, theirs = L.init_params(net), JL.init_params(net)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape and ours[k].dtype == np.float32, k
    assert all(ours[f"lin{i}.w"].min() >= 0 for i in range(5))


def test_converter_handles_all_torch_key_formats():
    """torchvision + lpips heads, a whole LPIPS.state_dict(), and heads
    alone (incomplete: ValueError naming what is missing), each as the
    JAX converter reads it."""
    params = L.init_params("alex")
    tv = {f"features.{i}.{kind}": torch.from_numpy(
        params[f"conv{i}.{'w' if kind == 'weight' else 'b'}"])
        for i in (0, 3, 6, 8, 10) for kind in ("weight", "bias")}
    heads = {f"lin{i}.model.1.weight": torch.from_numpy(
        params[f"lin{i}.w"].reshape(1, -1, 1, 1)) for i in range(5)}
    slices = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}
    full = {f"net.slice{s}.{i}.{kind}": tv[f"features.{i}.{kind}"]
            for i, s in slices.items() for kind in ("weight", "bias")}
    full.update(heads)
    for sds in ([tv, heads], [full]):
        out = L.params_from_torch_state_dicts(sds, net="alex")
        ref = JL.params_from_torch_state_dicts(sds, net="alex")
        assert set(out) == set(params) == set(ref)
        for k in params:
            np.testing.assert_array_equal(out[k], params[k])
            np.testing.assert_array_equal(out[k], np.asarray(ref[k]))
    with pytest.raises(ValueError, match="missing"):
        L.params_from_torch_state_dicts([heads], net="alex")


def test_npz_and_pt_round_trips_and_resolution(tmp_path, monkeypatch):
    """The port's .npz is the JAX package's to read and back; a torch .pt
    state dict loads as vgg; image.lpips takes an explicit path, then
    NERAF_LPIPS_WEIGHTS, then the default paths, else NaN, and equals the
    JAX metric."""
    params = L.init_params("vgg", seed=3)
    ours = tmp_path / "ours.npz"
    L.save_params_npz(ours, params, net="vgg")
    jparams, net = JL.load_params(str(ours))
    assert net == "vgg"
    for k in params:
        np.testing.assert_array_equal(np.asarray(jparams[k]), params[k])
    sd = {f"features.{i}.{kind}": torch.from_numpy(
        params[f"conv{i}.{'w' if kind == 'weight' else 'b'}"])
        for i in L._VGG_CONV_IDXS for kind in ("weight", "bias")}
    sd.update({f"lin{i}.model.1.weight": torch.from_numpy(
        params[f"lin{i}.w"].reshape(1, -1, 1, 1)) for i in range(5)})
    torch.save(sd, tmp_path / "vgg.pt")
    pt, net = L.load_params(str(tmp_path / "vgg.pt"))
    assert net == "vgg" and all(np.array_equal(pt[k], params[k]) for k in params)

    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    val = float(lpips_metric(x, y, weights_path=str(ours)))
    assert np.isfinite(val) and val > 0
    np.testing.assert_allclose(val, float(jlpips_metric(
        x, y, weights_path=str(ours))), rtol=RTOL, atol=ATOL)
    assert np.isnan(float(lpips_metric(x, y)))  # nothing resolves
    monkeypatch.setenv("NERAF_LPIPS_WEIGHTS", str(ours))
    assert L.resolve_default_weights() == str(ours)
    assert float(lpips_metric(x, y)) == val
    monkeypatch.setenv("NERAF_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(L, "_DEFAULT_PATHS", (str(tmp_path / "absent.npz"),
                                              str(ours)))
    assert L.resolve_default_weights() == str(ours)


@pytest.mark.parametrize("net,side", [("alex", 31), ("vgg", 15)])
def test_too_small_image_raises(net, side):
    params = L.init_params(net)
    x = torch.zeros((side, 40, 3))
    with pytest.raises(ValueError, match="needs images"):
        L.lpips_distance(params, x, x, net=net)


def test_pipeline_maybe_lpips_wiring(tmp_path, monkeypatch):
    from neraf_tpu_torch.engine.pipeline import _maybe_lpips

    x = torch.zeros((48, 48, 3))
    assert _maybe_lpips(x, x) is None
    path = tmp_path / "lpips_alex.npz"
    L.save_params_npz(path, L.init_params("alex"), net="alex")
    monkeypatch.setenv("NERAF_LPIPS_WEIGHTS", str(path))
    assert _maybe_lpips(x, x) == 0.0
    small = torch.zeros((8, 8, 3))
    assert _maybe_lpips(small, small) is None


def test_eval_paths_report_lpips_as_the_jax_pipeline(vision_slice, tmp_path,
                                                     monkeypatch):
    """evaluate_vision on the tiny vision slice at 32 x 32 (alex's minimum
    side): without weights lpips null and the JAX skip reason on both
    sides; with the same weights the JAX pipeline's mean (renders within
    1e-4, so 1e-3 relative) and its std, no skip key; eval_image's
    lpips is a number, or null with the reason below the minimum size."""
    from neraf_tpu.data.vision_data import camera_arrays as jcamera_arrays
    from neraf_tpu.engine.pipeline import _LPIPS_SKIP_REASON
    from neraf_tpu_torch.data.vision_data import camera_arrays
    from neraf_tpu_torch.engine.factory import build_joint_pipeline

    pipe, state, port, cams = vision_slice
    images = np.random.default_rng(6).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    res = port.evaluate_vision(camera_arrays(cams, "cpu"), images)
    ref = pipe.evaluate_vision(state, jcamera_arrays(cams), images)
    assert res["lpips"] is None and ref["lpips"] is None
    assert res["lpips_skipped"] == ref["lpips_skipped"] == _LPIPS_SKIP_REASON
    _, _, path = _bridged(tmp_path, "alex")
    monkeypatch.setenv("NERAF_LPIPS_WEIGHTS", str(path))
    res = port.evaluate_vision(camera_arrays(cams, "cpu"), images)
    ref = pipe.evaluate_vision(state, jcamera_arrays(cams), images)
    assert set(res) == set(ref) and "lpips_skipped" not in res
    for k in ("lpips", "lpips_std"):
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-3, err_msg=k)
    assert res["lpips"] > 0

    joint = build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                                 mixed_precision=False)
    jcams = camera_arrays(cams, "cpu")
    m, _ = joint.eval_image(jcams, 0, images[0])
    assert np.isfinite(m["lpips"]) and "lpips_skipped" not in m
    m, _ = joint.eval_image(jcams, 0, images[0, :16, :16])
    assert m["lpips"] is None and m["lpips_skipped"] == _LPIPS_SKIP_REASON
