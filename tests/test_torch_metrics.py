"""The port's evaluation metrics against the JAX package's: grayscale
exact, SSIM / MS-SSIM / PSNR within 1e-6, LPIPS (random weights at
AlexNet's real widths, carried across by params_to_state_dict) within 1e-5
relative."""

import cv2 as cv
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu.metrics import lpips as JL
from aejpeg_tpu.metrics import quality as JQ
from aejpeg_tpu_torch.metrics import lpips as L
from aejpeg_tpu_torch.metrics import quality as Q

torch.set_num_threads(1)


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    a = np.clip(cv.resize(rng.random((16, 16, 3), np.float32), (w, h),
                          interpolation=cv.INTER_CUBIC), 0, 1)
    b = np.clip(a + rng.normal(0, 0.03, a.shape), 0, 1)
    return a.astype(np.float32), b.astype(np.float32)


def test_gray_exact():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    got = Q.rgb_to_gray_u8(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JQ.rgb_to_gray_u8(jnp.asarray(rgb))))
    np.testing.assert_array_equal(got, cv.cvtColor(rgb, cv.COLOR_RGB2GRAY))


class _ExactMeanJnp:
    """jax.numpy whose mean is accumulated in float64 and rounded once."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def mean(a):
        return jnp.asarray(np.asarray(a, np.float64).mean(), jnp.float32)


@pytest.mark.parametrize("shape", [(64, 96), (200, 176), (600, 640)],
                         ids=["small", "ms-ssim-size", "pooled-x2"])
def test_ssim_matches_jax(shape, monkeypatch):
    """ssim (with piq's f = round(min side / 256) pooling) and, from 161 px
    a side, ms_ssim, on RGB floats.  The maps agree bit for bit; the port
    takes their means in float64, where the JAX package's float32 mean
    drifts: by 8e-6 on the (3, 27, 30) map of 600x640's coarsest MS-SSIM
    level.  So the port holds within 1e-6 of JAX with an exact mean
    everywhere, and of plain JAX wherever its drift stays below that."""
    a, b = _pair(*shape, seed=shape[0])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got_s = float(Q.ssim(ta, tb))
    assert abs(got_s - float(JQ.ssim(a, b))) <= 1e-6
    assert abs(float(Q.ssim(ta, ta)) - 1.0) <= 1e-6
    if min(shape) < 161:
        with pytest.raises(ValueError, match="161"):
            Q.ms_ssim(ta, tb)
        return
    got_ms = float(Q.ms_ssim(ta, tb))
    assert 0.5 < got_ms < 1.0
    if max(shape) <= 256:
        assert abs(got_ms - float(JQ.ms_ssim(a, b))) <= 1e-6
    monkeypatch.setattr(JQ, "jnp", _ExactMeanJnp())
    assert abs(got_s - float(JQ.ssim(a, b))) <= 1e-6
    assert abs(got_ms - float(JQ.ms_ssim(a, b))) <= 1e-6


@pytest.mark.parametrize("shape", [(64, 96), (256, 256)])
def test_evaluation_metrics_match_jax(shape):
    """psnr within 1e-6 relative (one float32 ulp is 1.9e-6 dB at 30 dB),
    ssim (cv2 grayscale of the truncated uint8 images, data range 255) and
    ms_ssim within 1e-6."""
    a, b = _pair(*shape, seed=shape[1])
    ours = Q.EvaluationMetrics(a, b, device="cpu")
    theirs = JQ.EvaluationMetrics(a, b)
    assert abs(ours.psnr() - theirs.psnr()) <= 1e-6 * theirs.psnr()
    assert abs(ours.ssim() - theirs.ssim()) <= 1e-6
    if min(shape) >= 161:
        assert abs(ours.ms_ssim() - theirs.ms_ssim()) <= 1e-6


def test_psnr_known_value():
    a = torch.zeros((16, 16, 3))
    assert abs(float(Q.psnr(a, a + 0.1)) - 20.0) < 1e-4


def _alex_params(seed):
    rng = np.random.default_rng(seed)
    params, in_ch = {}, 3
    for i, (out, k, _, _) in enumerate(L.ALEX_CONVS):
        params[f"conv{i}_w"] = (rng.standard_normal((out, in_ch, k, k))
                                * 0.05).astype(np.float32)
        params[f"conv{i}_b"] = (rng.standard_normal(out)
                                * 0.05).astype(np.float32)
        params[f"lin{i}_w"] = np.abs(rng.standard_normal(
            (1, out, 1, 1))).astype(np.float32)
        in_ch = out
    return params


@pytest.fixture(scope="module")
def lpips_setup(tmp_path_factory):
    params = _alex_params(0)
    path = str(tmp_path_factory.mktemp("lpips") / "w.npz")
    np.savez(path, **params)
    rng = np.random.default_rng(1)
    a = rng.random((64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    return params, path, a, b


def test_lpips_matches_jax(lpips_setup):
    params, path, a, b = lpips_setup
    assert L.ALEX_CONVS == tuple(JL._ALEX_CONVS)
    want = float(JL.lpips_distance(a, b, weights_path=path))
    model = L.LPIPS()
    state = L.params_to_state_dict(params)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    with torch.no_grad():
        got = float(model(torch.from_numpy(a).permute(2, 0, 1)[None],
                          torch.from_numpy(b).permute(2, 0, 1)[None]))
    assert got == pytest.approx(want, rel=1e-5)
    assert float(L.lpips_distance(a, b, weights_path=path, device="cpu")) \
        == pytest.approx(want, rel=1e-5)
    assert float(L.lpips_distance(a, a, weights_path=path,
                                  device="cpu")) < 1e-6
    ours = Q.EvaluationMetrics(a, b, lpips_weights=path, device="cpu")
    assert ours.lpips() == pytest.approx(want, rel=1e-5)


def test_lpips_raises_without_weights(monkeypatch):
    monkeypatch.delenv("AEJPEG_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(L, "default_weights_path", lambda: None)
    with pytest.raises(FileNotFoundError):
        L.lpips_distance(np.zeros((32, 32, 3), np.float32),
                         np.zeros((32, 32, 3), np.float32), device="cpu")


def test_lpips_weights_from_env(lpips_setup, monkeypatch):
    _, path, a, b = lpips_setup
    monkeypatch.setenv("AEJPEG_LPIPS_WEIGHTS", path)
    assert L.default_weights_path() == path
    assert float(L.lpips_distance(a, b, device="cpu")) > 0


def test_convert_torch_checkpoint(lpips_setup, tmp_path):
    """torchvision/lpips state dicts -> the .npz both packages load."""
    params = lpips_setup[0]
    alex, lp = {}, {}
    for i, ci in enumerate((0, 3, 6, 8, 10)):
        alex[f"features.{ci}.weight"] = torch.from_numpy(params[f"conv{i}_w"])
        alex[f"features.{ci}.bias"] = torch.from_numpy(params[f"conv{i}_b"])
        lp[f"lins.{i}.model.1.weight"] = torch.from_numpy(params[f"lin{i}_w"])
    out = str(tmp_path / "converted.npz")
    L.convert_torch_checkpoint(alex, lp, out)
    with np.load(out) as z:
        assert set(z.files) == set(params)
        for k in params:
            np.testing.assert_array_equal(z[k], params[k])
