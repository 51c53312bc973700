"""The port's GUI on the CPU, held to the JAX package's (gui/): the slider
model, the settings model, the batch planner and the three jobs run without
a display; the widget test runs only where Tk can open a window."""

import os
import sys

import numpy as np
import pytest
import torch

from aejpeg_tpu.codec.batch_encode import encode_batch as j_encode_batch
from aejpeg_tpu.codec.pipeline import Codec as JCodec
from aejpeg_tpu.gui.app import AejpegApp as JApp
from aejpeg_tpu.gui.app import plan_batches as j_plan_batches
from aejpeg_tpu.gui.control_panel import PanelState as JPanelState
from aejpeg_tpu.gui.range_slider import RangeModel as JRangeModel
from aejpeg_tpu.io.image import ImageData as JImage
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.gui.app import AejpegApp, plan_batches
from aejpeg_tpu_torch.gui.control_panel import PanelState
from aejpeg_tpu_torch.gui.preview_panel import ppm_bytes, thumbnail
from aejpeg_tpu_torch.gui.range_slider import RangeModel

from test_torch_sweep import synth

torch.set_num_threads(1)


# ---------------------------------------------------------------- RangeModel
# tests/test_gui.py's cases, each a trace of values run on both models


def _initial_clamp_and_order(cls):
    return [cls(1, 99, init_lo=120, init_hi=-5, track_px=280).values,
            cls(1, 8, init_lo=6, init_hi=2, track_px=100).values]


def _mapping_roundtrip(cls):
    m = cls(1, 99, 20, 60, track_px=280)
    return [m.px_to_value(m.value_to_px(v)) for v in range(1, 100)]


def _drag_no_cross(cls):
    m = cls(0, 100, 20, 60, track_px=200)
    out = [m.grab(m.value_to_px(21))]
    m.drag(m.value_to_px(80))
    out.append(m.values)
    m.release()
    out.append(m.grab(m.value_to_px(61)))
    m.drag(m.value_to_px(90))
    return out + [m.values]


def _coincident_grab_direction(cls):
    m = cls(0, 100, 50, 50, track_px=200)
    m2 = cls(0, 100, 50, 50, track_px=200)
    return [m.grab(m.value_to_px(30)), m2.grab(m2.value_to_px(70))]


def _drag_clamps_to_track(cls):
    m = cls(1, 8, 2, 6, track_px=100)
    m.grab(m.value_to_px(2))
    m.drag(-500.0)
    out = [m.values[0]]
    m.release()
    m.grab(m.value_to_px(6))
    m.drag(1e6)
    return out + [m.values[1]]


RANGE_CASES = {
    "initial_clamp_and_order": (_initial_clamp_and_order,
                                [(1, 99), (2, 6)]),
    "mapping_roundtrip": (_mapping_roundtrip, list(range(1, 100))),
    "drag_no_cross": (_drag_no_cross, ["low", (60, 60), "high", (60, 90)]),
    "coincident_grab_direction": (_coincident_grab_direction,
                                  ["low", "high"]),
    "drag_clamps_to_track": (_drag_clamps_to_track, [1, 8]),
}


@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_range_model_matches_jax(case):
    run, want = RANGE_CASES[case]
    assert run(RangeModel) == run(JRangeModel) == want


def test_range_model_rejects_empty_range():
    with pytest.raises(ValueError):
        RangeModel(5, 5, 5, 5, track_px=100)


# ---------------------------------------------------------------- PanelState


@pytest.mark.parametrize("kw", [
    {}, {"color_space": "ICtCp", "quality": (20, 80),
         "block_exponents": (2, 6)},
    {"color_space": "YCbCr", "quality": (50, 50), "block_exponents": (3, 3)},
    {"color_space": "OKLAB", "quality": (10, 90), "block_exponents": (1, 8)},
], ids=["default", "ictcp", "ycbcr-8", "oklab-2-256"])
def test_panel_state_config_matches_jax(kw):
    ours = PanelState(**kw).to_config()
    theirs = JPanelState(**kw).to_config()
    assert (ours.color_space, ours.quality_range,
            tuple(ours.block_size_range), ours.entropy_level) == (
        theirs.color_space, theirs.quality_range,
        tuple(theirs.block_size_range), theirs.entropy_level)
    assert PanelState(**kw).block_sizes == JPanelState(**kw).block_sizes


def test_panel_state_file_partition():
    files = ["a.png", "b.AJPG", "c.tiff", "d.ajpg"]
    st = PanelState(files=files)
    assert st.image_files() == ["a.png", "c.tiff"]
    assert st.ajpg_files() == ["b.AJPG", "d.ajpg"]
    assert st.image_files() == JPanelState(files=files).image_files()


# ------------------------------------------------------------- batch planner


@pytest.fixture
def image_files(tmp_path):
    """Three PNGs written by the port's ImageData.save: two of 48x64, one
    of 64x40."""
    paths = []
    for i, shape in enumerate([(48, 64), (48, 64), (64, 40)]):
        p = str(tmp_path / f"img{i}.png")
        img = synth(*shape, 20 + i) / np.float32(255)
        at.ImageData.from_array(img).save(p)
        paths.append(p)
    return paths


def test_plan_batches_groups_by_shape(image_files):
    groups = plan_batches(image_files)
    theirs = j_plan_batches(image_files)
    assert [[p for p, _ in g] for g in groups] == \
        [[p for p, _ in g] for g in theirs]
    assert sorted(len(g) for g in groups) == [1, 2]
    for g, jg in zip(groups, theirs):
        assert len({img.original_shape[:2] for _, img in g}) == 1
        for (_, a), (_, b) in zip(g, jg):
            np.testing.assert_array_equal(a.data, b.data)


# ---------------------------------------------------------------- the jobs


class _Stub:
    """What the jobs read of the app: its settings, codec and device."""

    def __init__(self, state, device="cpu"):
        self.state = state
        self.device = device
        self.codec = at.Codec(state.to_config(), device=device)


def test_process_preview_matches_jax():
    arr = synth(64, 64, 2) / np.float32(255)
    state = PanelState()
    out, ratio = AejpegApp._process_preview(_Stub(state),
                                            at.ImageData.from_array(arr))

    class JStub:
        codec = JCodec(JPanelState().to_config())
    jout, jratio = JApp._process_preview(JStub(), JImage.from_array(arr))
    assert out.data.shape == (64, 64, 3) and ratio > 1.0
    assert ratio == jratio
    np.testing.assert_allclose(out.data, jout.data, rtol=0, atol=1e-5)


def test_compress_job_writes_jax_bytes(image_files):
    state = PanelState(quality=(20, 80), block_exponents=(2, 5))
    errors = AejpegApp._compress_job(_Stub(state), image_files)
    assert errors == []
    cfg = JPanelState(quality=(20, 80), block_exponents=(2, 5)).to_config()
    for group in j_plan_batches(image_files):
        want = j_encode_batch([img for _, img in group], cfg)
        for (path, _), blob in zip(group, want):
            with open(os.path.splitext(path)[0] + ".ajpg", "rb") as f:
                assert f.read() == blob


def test_decompress_job_writes_images_back(image_files, tmp_path):
    state = PanelState(quality=(20, 80), block_exponents=(2, 5))
    stub = _Stub(state)
    assert AejpegApp._compress_job(stub, image_files) == []
    ajpgs = [os.path.splitext(p)[0] + ".ajpg" for p in image_files]
    for p in image_files:
        os.remove(p)
    missing = str(tmp_path / "gone.ajpg")
    errors = AejpegApp._decompress_job(stub, ajpgs + [missing])
    assert len(errors) == 1 and "gone.ajpg" in errors[0]
    for path, ajpg in zip(image_files, ajpgs):
        back = at.ImageData.load(path)
        with open(ajpg, "rb") as f:
            want = at.decode_batch([f.read()], device="cpu")[0]
        np.testing.assert_array_equal(back.data, at.ImageData.from_array(
            want.get_uint8() / np.float32(255)).data)
        src = synth(*back.original_shape[:2],
                    20 + image_files.index(path)) / np.float32(255)
        assert 10 * np.log10(1 / np.mean((back.data - src) ** 2)) > 25


def test_decompress_job_isolates_a_bad_container(image_files):
    stub = _Stub(PanelState(block_exponents=(2, 5)))
    assert AejpegApp._compress_job(stub, image_files[:1]) == []
    good = os.path.splitext(image_files[0])[0] + ".ajpg"
    bad = os.path.join(os.path.dirname(good), "bad.ajpg")
    with open(good, "rb") as f:
        blob = f.read()
    with open(bad, "wb") as f:
        f.write(blob[:40])
    os.remove(image_files[0])
    errors = AejpegApp._decompress_job(stub, [good, bad])
    assert len(errors) == 1 and errors[0].startswith("bad.ajpg")
    assert os.path.exists(image_files[0])


# ------------------------------------------------------- image to the panel


def test_thumbnail_fits_the_box_and_keeps_aspect():
    img = synth(120, 200, 5)
    small = thumbnail(img, (100, 100))
    assert small.shape == (60, 100, 3) and small.dtype == np.uint8
    assert thumbnail(img, (400, 400)) is img            # never enlarged
    assert thumbnail(img, (3, 1000)).shape == (2, 3, 3)
    flat = np.full((40, 80, 3), 77, np.uint8)
    np.testing.assert_array_equal(thumbnail(flat, (20, 20)),
                                  np.full((10, 20, 3), 77, np.uint8))


def test_ppm_bytes():
    img = np.random.default_rng(6).integers(0, 256, (3, 5, 3), np.uint8)
    data = ppm_bytes(img)
    assert data.startswith(b"P6\n5 3\n255\n")
    np.testing.assert_array_equal(
        np.frombuffer(data[len(b"P6\n5 3\n255\n"):], np.uint8).reshape(
            3, 5, 3), img)


def test_gui_imports_without_tk(tmp_path):
    """The jobs must import where Tk is missing (the card's machine)."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['tkinter'] = None; "
            "import aejpeg_tpu_torch.gui as g; "
            "print(g.PanelState().to_config().color_space)")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "YCoCg"


# ------------------------------------------------------------- widget layer


def test_app_constructs_and_settings_propagate():
    tk = pytest.importorskip("tkinter")
    try:
        root = tk.Tk()
    except tk.TclError:
        pytest.skip("no display server")
    try:
        app = AejpegApp(root, preview_path=None, device="cpu")
        app.control_panel.quality_slider.set_values(30, 70)
        app.control_panel._committed()
        assert app.codec.config.quality_range == (30, 70)
        app.control_panel.block_slider.set_values(3, 5)
        app.control_panel._committed()
        assert tuple(app.codec.config.block_size_range) == (8, 32)
        photo = app.preview_panel._fit(synth(40, 60, 1), (30, 30))
        assert (photo.width(), photo.height()) == (30, 20)
    finally:
        root.destroy()
