"""The port's Canny stack, stage by stage, against the JAX package's (each
JAX stage jitted as in its pipeline; the port stage gets the JAX stage's
input)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aejpeg_tpu.ops import canny as jc
from aejpeg_tpu_torch.ops import canny as tc
from aejpeg_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

# 128x192 takes the CLAHE gather kernel; 96x128 and 37x53 the fallback
SHAPES = [(128, 192), (96, 128), (37, 53)]


def _layers(h, w, seed):
    """Two float planes like stage A's: smooth structure, hard-edged
    blocks, noise, and negative values (chroma) that wrap in to_uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(2):
        img = 0.5 + 0.4 * np.sin(x / (5.0 + 3 * i) + i) * np.cos(y / 9.0)
        img[h // 4:h // 2, w // 3:2 * w // 3] += 0.3
        img += rng.normal(0, 0.05, img.shape)
        out.append(np.clip(img, -0.2, 1.0))
    return np.stack(out).astype(np.float32)


def _jax(fn, planes, *args):
    f = jax.jit(lambda p: fn(p, *args))
    return np.stack([np.asarray(f(jnp.asarray(p))) for p in planes])


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def stages(request):
    """The JAX stack's stage outputs for one shape."""
    h, w = request.param
    layers = _layers(h, w, h + w)
    s = {"layers": layers}
    s["u8"] = _jax(jc.to_uint8, layers)
    s["clahe"] = _jax(jc.clahe, s["u8"])
    s["gauss"] = _jax(jc.gaussian_blur_u8, s["clahe"])
    s["bilateral"] = _jax(jc.bilateral_u8, s["gauss"])
    s["pct"] = np.stack([[float(v) for v in
                          jc.percentiles_u8(jnp.asarray(p), (10.0, 30.0))]
                         for p in s["bilateral"]]).astype(np.float32)
    sob = [jc.sobel_xy(jnp.asarray(p)) for p in s["bilateral"]]
    s["gx"] = np.stack([np.asarray(g[0]) for g in sob])
    s["gy"] = np.stack([np.asarray(g[1]) for g in sob])
    s["edges_nms"] = np.stack([np.asarray(jax.jit(jc._canny_from_gradients)(
        jnp.asarray(s["gx"][i]), jnp.asarray(s["gy"][i]),
        jnp.float32(s["pct"][i, 0]) ** 2, jnp.float32(s["pct"][i, 1]) ** 2))
        for i in range(2)])
    s["edges"] = _jax(jc.canny, layers)
    return s


def test_to_uint8_bitwise(stages):
    got = tc.to_uint8(torch.from_numpy(stages["layers"])).numpy()
    np.testing.assert_array_equal(got, stages["u8"])


def test_clahe_bitwise(stages):
    got = tc.clahe(torch.from_numpy(stages["u8"])).numpy()
    np.testing.assert_array_equal(got, stages["clahe"])


def test_gaussian_bitwise(stages):
    got = tc.gaussian_blur_u8(torch.from_numpy(stages["clahe"])).numpy()
    np.testing.assert_array_equal(got, stages["gauss"])


def test_bilateral_bitwise(stages):
    """XLA's exp (a table by |d|), its FMAs and its first fused product
    (ops/canny.bilateral_u8): every pixel equal."""
    got = tc.bilateral_u8(torch.from_numpy(stages["gauss"])).numpy()
    np.testing.assert_array_equal(got, stages["bilateral"])


def test_percentiles_bitwise(stages):
    lo, hi = tc.percentiles_u8(torch.from_numpy(stages["bilateral"]),
                               (10.0, 30.0))
    got = torch.stack([lo, hi], dim=1).numpy()
    np.testing.assert_array_equal(got, stages["pct"])


def test_sobel_bitwise(stages):
    gx, gy = tc.sobel_xy(torch.from_numpy(stages["bilateral"]))
    np.testing.assert_array_equal(gx.numpy(), stages["gx"])
    np.testing.assert_array_equal(gy.numpy(), stages["gy"])


def test_nms_hysteresis_bitwise(stages):
    pct = torch.from_numpy(stages["pct"])
    got = tc._canny_from_gradients(
        torch.from_numpy(stages["gx"]), torch.from_numpy(stages["gy"]),
        pct[:, 0] * pct[:, 0], pct[:, 1] * pct[:, 1]).numpy()
    np.testing.assert_array_equal(got, stages["edges_nms"])


def test_full_edge_maps(stages):
    """The whole stack from the float planes: every pixel equal."""
    got = tc.canny(torch.from_numpy(stages["layers"])).numpy()
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(got, stages["edges"])


def test_hysteresis_long_chain():
    """A weak chain longer than one convergence check (many dilation steps)
    grows fully from one strong end; an isolated weak run does not."""
    weak = torch.zeros((1, 8, 300), dtype=torch.bool)
    weak[0, 2, 5:290] = True
    weak[0, 6, 10:20] = True
    strong = torch.zeros_like(weak)
    strong[0, 2, 289] = True
    out = K.hysteresis_plain(strong, weak)
    assert out[0, 2, 5:290].all()
    assert not out[0, 6].any()
    assert int(out.sum()) == 285


HYST_CASES = chip_smoke.hysteresis_maps()


@pytest.mark.parametrize("case", HYST_CASES, ids=lambda c: c[0])
def test_hysteresis_plain_matches_jax(case):
    """The plain loop (the card kernel's bitwise reference) against the
    JAX package's bit-packed while_loop, plane by plane, on the cases
    chip_smoke.py phase 2 holds the kernel to: spirals and a serpentine
    fed from one pixel, chains across 32-pixel words at widths 5-768, no
    strong pixel, every pixel weak, and chains across the rows where the
    card cuts a 2048x1365 plane into bands."""
    _, strong, weak = case
    got = K.hysteresis_plain(torch.from_numpy(strong),
                             torch.from_numpy(weak)).numpy()
    hyst = jax.jit(jc._hysteresis)
    want = np.stack([np.asarray(hyst(jnp.asarray(s), jnp.asarray(k)))
                     for s, k in zip(strong, weak)])
    np.testing.assert_array_equal(got, want)
    assert not (got & ~weak & ~strong).any()


def test_hysteresis_cases_reach_their_edges():
    """The cases ask what they claim: the fed spiral and serpentine grow
    whole from one pixel, the unfed spiral and the isolated run stay off,
    and the band-edge chains cross the card's band edges (rows 512, 1024,
    1536 of 2048x1365 on an H100)."""
    cases = {label: (s, k) for label, s, k in HYST_CASES}
    s, k = cases["spiral 61x67"]
    got = K.hysteresis_plain(torch.from_numpy(s), torch.from_numpy(k))
    assert torch.equal(got[0], torch.from_numpy(k[0]))
    assert not got[1].any()
    s, k = cases["serpentine 64x41"]
    assert s.sum() == 1 and torch.equal(
        K.hysteresis_plain(torch.from_numpy(s), torch.from_numpy(k)),
        torch.from_numpy(k))
    s, k = cases["word crossings (2, 24, 768)"]
    got = K.hysteresis_plain(torch.from_numpy(s), torch.from_numpy(k))
    assert got[0, 2].all() and got[0, 5].all() and not got[0, 22].any()
    assert K.hysteresis_band_rows(2048, 1365, chip_smoke.H100_SMEM_OPTIN) \
        == 512
    s, k = cases["band edges (1, 2048, 1365)"]
    got = K.hysteresis_plain(torch.from_numpy(s), torch.from_numpy(k))
    for e in (512, 1024, 1536):
        assert got[0, e - 12:e + 13, 7].all()
        assert got[0, e - 12:e + 13, 100].all()
        assert got[0, e, 500:900].all()


@pytest.mark.parametrize("h, w, budget, rows", [
    (512, 768, 232448, 512), (256, 384, 232448, 256),
    (2048, 1365, 232448, 512), (674, 1365, 232448, 674),
    (675, 1365, 232448, 338), (1, 1, 16, 1), (10, 33, 8 * 2 * 4, 3)])
def test_hysteresis_band_rows(h, w, budget, rows):
    """A plane stays whole where (2h + 2) rows of its packed words fit the
    budget, else is cut into the fewest equal bands that fit."""
    got = K.hysteresis_band_rows(h, w, budget)
    assert got == rows
    assert got >= h or (2 * got + 2) * -(-w // 32) * 4 <= budget


def test_hysteresis_wrapper_on_cpu_runs_plain():
    """CPU tensors take the plain loop (as float32) and launch nothing."""
    _, s, k = HYST_CASES[0]
    before = K.LAUNCHES["hysteresis"].n
    got = K.hysteresis(torch.from_numpy(s), torch.from_numpy(k))
    assert got.dtype == torch.float32
    assert torch.equal(got, K.hysteresis_plain(
        torch.from_numpy(s), torch.from_numpy(k)).to(torch.float32))
    assert K.LAUNCHES["hysteresis"].n == before
    with pytest.raises(TypeError):
        K.hysteresis(torch.from_numpy(s).to(torch.uint8),
                     torch.from_numpy(k))


@pytest.mark.parametrize("budget, converged, launches, checks", [
    (232448, None, 1, 0),        # every plane whole: one launch, no check
    (8 * 24 * 100, 1, 5, 1),     # bands; round 2 changes nothing
    (8 * 24 * 100, 5, 9, 2),     # ... round 6: a second group of rounds
])
def test_hysteresis_card_route(monkeypatch, budget, converged, launches,
                               checks):
    """The card route's host side, the launches recorded instead of made
    (the flag that the rounds would set written as if round `converged`
    were the last to change a word): one launch and no host check where
    every plane fits, else rounds in groups of four with one check a
    group until a round changed nothing, then the unpack.  Counted on the
    launch counter and as `hysteresis_checks` / `hysteresis_launches` of
    the enclosing span; on the banded path also `hysteresis_bands` (6
    bands of 86 rows: 99 fit the budget) and `hysteresis_rounds` (round
    `converged` + 1 found the fixpoint), and the span's `route`."""
    calls, counted, noted = [], {}, {}
    monkeypatch.setattr(K, "_route", lambda name, device: True)
    monkeypatch.setattr(K, "_smem_budget", lambda device: budget)
    monkeypatch.setattr(K, "count", lambda name, n=1: counted.update(
        {name: counted.get(name, 0) + n}))
    monkeypatch.setattr(K, "note", lambda name, v: noted.update({name: v}))

    def launch(name, device, *args):
        calls.append(name)
        if name == "aej_hysteresis_rounds":
            last, first, n = args[4], args[10], args[11]
            ctypes.c_int.from_address(last).value = min(first + n - 1,
                                                        converged)
    monkeypatch.setattr(K, "_launch", launch)
    strong = torch.zeros((3, 512, 768), dtype=torch.bool)
    before = K.LAUNCHES["hysteresis"].n
    out = K.hysteresis(strong, strong.clone())
    assert out.shape == strong.shape and out.dtype == torch.float32
    if converged is None:
        assert calls == ["aej_hysteresis"]
    else:
        assert calls == ["aej_hysteresis_rounds"] * checks \
            + ["aej_hysteresis_unpack"]
    assert K.LAUNCHES["hysteresis"].n == before + launches
    banded = {} if converged is None else {"hysteresis_bands": 6,
                                           "hysteresis_rounds": converged + 2}
    assert counted == {"hysteresis_checks": checks,
                       "hysteresis_launches": launches, **banded}
    assert noted == {"route": "resident" if converged is None else "banded"}
