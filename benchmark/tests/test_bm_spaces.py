"""The reference's colour spaces: ICtCp (spaces/ICtCp.py, not linear)
against the port's conversion and its own inverse, and the matrix spaces
(spaces/*.json) converted and decoded bit for bit as before the reference
took spaces of their own files."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from aejpeg_tpu_torch.color import transforms as T
from benchmark.harness import images
from benchmark.reference import codec as ref
from benchmark.reference.spaces import ICtCp

# The reference's forward ICtCp against the port's, largest |difference|
# over the colours below.  The port rounds the sRGB EOTF and XYZ to
# float32 before its double-float32 PQ, the reference rounds once at the
# end: measured 3.0e-8 at most (2 float32 ulps at 0.0625-0.125; I reaches
# 0.15, Ct and Cp 0.11).  The bound leaves three times that; the TF32
# control reads 9.0e-5 (I) to 5.7e-4 (Ct, Cp).
FORWARD_BOUND = 1e-7


def _colours() -> torch.Tensor:
    """65,536 seeded u8 colours, black, white, the six primaries and
    secondaries, and near-black."""
    g = torch.Generator().manual_seed(20)
    sample = torch.randint(0, 256, (65536, 3), generator=g,
                           dtype=torch.uint8)
    fixed = torch.tensor(
        [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255],
         [255, 255, 0], [0, 255, 255], [255, 0, 255], [1, 0, 0], [0, 1, 0],
         [0, 0, 1], [1, 1, 1], [2, 1, 0], [3, 3, 3]], dtype=torch.uint8)
    return ref.unit(torch.cat([fixed, sample]))


@pytest.fixture(scope="module")
def ictcp():
    """(sRGB float32, the port's ICtCp, the reference's, the control's)."""
    torch.set_num_threads(2)
    x = _colours()
    port = T.srgb_to_ictcp(x.reshape(1, 1, -1, 3), tiny=False).reshape(-1, 3)
    return (x, port, ICtCp.from_srgb(x, "reference"),
            ICtCp.from_srgb(x, "tf32"))


def _gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def test_ictcp_forward_agrees_with_the_port(ictcp):
    x, port, want, _ = ictcp
    assert want.dtype == torch.float32 and want.shape == x.shape
    assert _gap(port, want) <= FORWARD_BOUND


def test_ictcp_control_is_far_from_the_port(ictcp):
    _, port, _, control = ictcp
    assert _gap(port, control) >= 10 * FORWARD_BOUND


def test_ictcp_round_trip(ictcp, monkeypatch):
    """to_srgb(forward(x)) in float64 gives x back to 1e-9 with the XYZ
    step inverted exactly; with the codec's published 7-digit inverse of
    that step (the reference's, as the codec's), to 3e-6 (1.8e-6
    measured)."""
    x = ictcp[0].double()
    fwd = ICtCp.forward(x, "reference")
    assert _gap(ICtCp.to_srgb(fwd, "reference"), x) < 3e-6
    monkeypatch.setattr(ICtCp, "XYZ_TO_RGB", np.linalg.inv(ICtCp.RGB_TO_XYZ))
    assert _gap(ICtCp.to_srgb(fwd, "reference"), x) < 1e-9


def test_ictcp_space_is_found_by_name():
    sp = ref.space("ICtCp")
    assert sp["from_srgb"] is ICtCp.from_srgb
    assert sp["ratios"] == [(1, 1), (1, 4), (1, 4)]
    assert ref.layer_shapes({"color_space": "ICtCp"}, (64, 96)) == \
        [(64, 96), (64, 24), (64, 24)]


# --------------------------------------------- the matrix spaces, unchanged

JSON_SPACES = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(ref.SPACES_DIR, "*.json")))


def _convert_before(x, m, prec):
    """codec.convert as it stood when the matrix was the only kind."""
    x = ref._operand(x.to(torch.float32), prec)
    m = ref._operand(torch.tensor(m, device=x.device), prec).tolist()
    return torch.stack([(x[..., 0] * m[j][0] + x[..., 1] * m[j][1])
                        + x[..., 2] * m[j][2] for j in range(3)], -1)


def _decode_tail_before(planes, m, prec):
    """The end of codec.decode as it stood: ycc @ m.T, clipped."""
    dt = ref._dtype(prec)
    ycc = ref._operand(torch.stack(planes, -1), prec).to(dt)
    m = ref._operand(torch.tensor(m, device=ycc.device), prec).to(dt)
    return torch.clamp(ycc @ m.T, 0.0, 1.0)


@pytest.mark.parametrize("prec", ["reference", "tf32"])
@pytest.mark.parametrize("name", JSON_SPACES)
def test_matrix_spaces_are_bitwise_as_before(name, prec):
    with open(os.path.join(ref.SPACES_DIR, f"{name}.json")) as f:
        d = json.load(f)
    m_from = np.asarray(d["from_srgb"], np.float64).astype(np.float32)
    m_to = np.asarray(d["to_srgb"], np.float64).astype(np.float32)
    u8 = images.synth(2, 64, 96, 5, "cpu")
    cfg = {"color_space": name}
    x = ref.unit(u8)
    assert torch.equal(ref.space(name)["from_srgb"](x, prec),
                       _convert_before(x, m_from, prec))
    whole = _convert_before(x, m_from, prec)
    shapes = ref.layer_shapes(cfg, (64, 96))
    want = [ref.area_down(whole[..., i].contiguous(), shapes[i], prec)
            for i in range(3)]
    got = ref.layers_of(u8, cfg, prec)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dt = ref._dtype(prec)
    g = torch.Generator().manual_seed(3)
    planes = [torch.rand((64, 96), generator=g, dtype=torch.float64).to(dt)
              - 0.25 for _ in range(3)]
    got = torch.clamp(ref.space(name)["to_srgb"](torch.stack(planes, -1),
                                                 prec), 0.0, 1.0)
    assert torch.equal(got, _decode_tail_before(planes, m_to, prec))
