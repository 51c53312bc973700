"""LPIPS (AlexNet backbone) as a torch.nn.Module.

Counterpart of the JAX package's metrics/lpips.py, with the same graph as
the `lpips` package the reference uses (net='alex',
src/image/evaluation_metrics.py:34-36): inputs scaled to [-1, 1],
ImageNet-style shift/scale, AlexNet conv features after each of the 5 ReLU
stages, channel-unit-normalized, squared differences projected by learned
1x1 "lin" weights, spatially averaged and summed over stages.

The weights are not in the repository.  Both packages read the same .npz
(`conv{i}_w`, `conv{i}_b`, `lin{i}_w`), given as `weights_path` or by the
AEJPEG_LPIPS_WEIGHTS environment variable; `params_to_state_dict` turns
that dict into this module's state, and `convert_torch_checkpoint` makes
the .npz from torchvision's alexnet and the lpips package's checkpoint.
"""

import functools
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

# AlexNet feature config: (out_ch, kernel, stride, padding), ReLU after each
# conv, max-pool after stages 1 and 2.
ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1))
_POOL_AFTER = (0, 1)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """LPIPS-AlexNet distance between (N, 3, H, W) images in [0, 1]."""

    def __init__(self) -> None:
        super().__init__()
        convs, in_ch = [], 3
        for out_ch, k, s, p in ALEX_CONVS:
            convs.append(nn.Conv2d(in_ch, out_ch, k, stride=s, padding=p))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(
            nn.Parameter(torch.zeros(1, c, 1, 1)) for c, *_ in ALEX_CONVS)
        self.register_buffer(
            "shift", torch.tensor(_SHIFT, dtype=torch.float32).view(
                1, 3, 1, 1), persistent=False)
        self.register_buffer(
            "scale", torch.tensor(_SCALE, dtype=torch.float32).view(
                1, 3, 1, 1), persistent=False)

    def features(self, x: torch.Tensor):
        """x in [-1, 1] -> the 5 post-ReLU feature maps."""
        x = (x - self.shift) / self.scale
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, stride=2)
        return feats

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=a.device)
        for fa, fb, lin in zip(self.features(a * 2.0 - 1.0),
                               self.features(b * 2.0 - 1.0), self.lins):
            d = (_unit_normalize(fa) - _unit_normalize(fb)) ** 2
            total = total + torch.mean(torch.sum(d * lin, dim=1))
        return total

    def unit_features(self, x: torch.Tensor):
        """(N, 3, H, W) images in [0, 1] -> the 5 channel-unit-normalized
        feature maps (those of an original can serve many distances)."""
        return [_unit_normalize(f) for f in self.features(x * 2.0 - 1.0)]

    def distances(self, fa, fb) -> torch.Tensor:
        """Per-image distances (N,) between two unit_features lists."""
        total = torch.zeros((fa[0].shape[0],), dtype=torch.float32,
                            device=fa[0].device)
        for a, b, lin in zip(fa, fb, self.lins):
            total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1),
                                       dim=(1, 2))
        return total


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True)) + eps)


def params_to_state_dict(params: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (`conv{i}_w` (out, in, k, k),
    `conv{i}_b` (out,), `lin{i}_w` (1, C, 1, 1)) -> LPIPS.state_dict()."""
    state = {}
    for i in range(len(ALEX_CONVS)):
        state[f"convs.{i}.weight"] = torch.as_tensor(
            np.asarray(params[f"conv{i}_w"], np.float32))
        state[f"convs.{i}.bias"] = torch.as_tensor(
            np.asarray(params[f"conv{i}_b"], np.float32))
        state[f"lins.{i}"] = torch.as_tensor(
            np.asarray(params[f"lin{i}_w"], np.float32))
    return state


def default_weights_path() -> Optional[str]:
    env = os.environ.get("AEJPEG_LPIPS_WEIGHTS")
    if env and os.path.exists(env):
        return env
    local = os.path.join(os.path.dirname(__file__), "lpips_alex.npz")
    return local if os.path.exists(local) else None


@functools.lru_cache(maxsize=2)
def _load_model(path: str, device: torch.device) -> LPIPS:
    with np.load(path) as z:
        params = {k: z[k] for k in z.files}
    model = LPIPS()
    model.load_state_dict(params_to_state_dict(params))
    return model.to(device).eval()


def lpips_distance(a: np.ndarray, b: np.ndarray,
                   weights_path: Optional[str] = None,
                   device=None) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) float32 [0,1] images.

    device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the CPU."""
    dev = resolve_device(device)
    path = weights_path or default_weights_path()
    if path is None:
        raise FileNotFoundError(
            "LPIPS weights not available. Export them with "
            "aejpeg_tpu_torch.metrics.lpips.convert_torch_checkpoint on a "
            "machine with torchvision+lpips, then set AEJPEG_LPIPS_WEIGHTS.")
    model = _load_model(path, dev)

    def to_nchw(img):
        return torch.as_tensor(np.asarray(img, np.float32),
                               device=dev).permute(2, 0, 1)[None]

    with torch.no_grad():
        return model(to_nchw(a), to_nchw(b))


def convert_torch_checkpoint(alexnet_state: dict, lpips_state: dict,
                             out_path: str) -> None:
    """Write torchvision alexnet.state_dict() + lpips.LPIPS(net='alex')
    .state_dict() as the .npz both packages load."""
    def arr(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float32)

    arrays = {}
    for i, ci in enumerate((0, 3, 6, 8, 10)):  # alexnet.features indices
        arrays[f"conv{i}_w"] = arr(alexnet_state[f"features.{ci}.weight"])
        arrays[f"conv{i}_b"] = arr(alexnet_state[f"features.{ci}.bias"])
    for i in range(len(ALEX_CONVS)):
        arrays[f"lin{i}_w"] = arr(lpips_state[f"lins.{i}.model.1.weight"])
    np.savez(out_path, **arrays)
