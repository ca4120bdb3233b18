"""LPIPS perceptual distance: VGG16 features + linear heads in PyTorch.

Counterpart of `youreditableavatar_tpu/ops/lpips.py`: the conv1_2 /
conv2_2 / conv3_3 / conv4_3 / conv5_3 VGG16 activations, unit-normalized
per channel, squared differences reduced by 1×1 linear heads, averaged
over space and summed over the layers.

Layouts: the public functions take and return NHWC images and features,
as the JAX functions do. The weights are PyTorch's own layout — a conv
weight is (out, in, 3, 3) (OIHW) — so `convert_torch_vgg16` and
`convert_torch_lpips_heads` load a torchvision VGG16 / LPIPS state dict
as they are, and `lpips_params_from_numpy` turns the JAX package's HWIO
parameters into these. Without weights the net initializes randomly
from a seed (a `torch.Generator`; the numbers differ from `jax.random`'s,
so parity carries the weights across).

The convolutions are `F.conv2d` (the JAX code leaves them to XLA, outside
any Pallas kernel). On the card cuDNN may run f32 convolutions in TF32
(`torch.backends.cudnn.allow_tf32`, True by default); `chip_smoke.py`
turns it off and holds LPIPS on the card against the CPU's f64 path: the
value to 1e-4 relative, the gradient with respect to `pred` to 1e-4 of its
largest entry.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.utils.device import resolve_device

# VGG16 conv architecture: (out_channels, layers per block).
VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# LPIPS taps the last conv of each block (pre-pool, post-relu).
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

VggParams = List[Dict[str, Tensor]]


def init_vgg16_params(seed: int = 0, device=None) -> VggParams:
    """He-normal conv weights (OIHW) and zero biases from `seed`."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    params = []
    cin = 3
    for cout, n in VGG_BLOCKS:
        for _ in range(n):
            w = torch.randn((cout, cin, 3, 3), generator=g) * np.sqrt(
                2.0 / (9 * cin))
            params.append({"w": w.to(dev), "b": torch.zeros(cout, device=dev)})
            cin = cout
    return params


def init_lpips_heads(seed: int = 1, device=None) -> List[Tensor]:
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    return [F.softplus(torch.randn((cout,), generator=g) * 0.1).to(dev)
            for cout, _ in VGG_BLOCKS]


def convert_torch_vgg16(state_dict: Mapping[str, Any], device=None) -> VggParams:
    """torchvision `vgg16().features` state_dict → param list (OIHW kept)."""
    dev = resolve_device(device)
    keys = sorted(
        (k for k in state_dict if k.endswith(".weight") and "features" in k),
        key=lambda k: int(k.split(".")[-2]),
    )
    params = []
    for wk in keys:
        w = torch.as_tensor(np.asarray(state_dict[wk]), dtype=torch.float32)
        if w.dim() != 4:
            continue
        b = torch.as_tensor(np.asarray(state_dict[wk.replace(".weight", ".bias")]),
                            dtype=torch.float32)
        params.append({"w": w.to(dev), "b": b.to(dev)})
    return params


def convert_torch_lpips_heads(state_dict: Mapping[str, Any],
                              device=None) -> List[Tensor]:
    """LPIPS `lin{i}.model.1.weight` (C,1,1,1) tensors → (C,) head weights."""
    dev = resolve_device(device)
    heads = []
    for i in range(5):
        for pattern in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if pattern in state_dict:
                w = np.asarray(state_dict[pattern], np.float32).reshape(-1)
                heads.append(torch.as_tensor(np.maximum(w, 0.0), device=dev))
                break
    return heads


def lpips_params_from_numpy(vgg: List[Mapping[str, np.ndarray]],
                            heads: List[np.ndarray], device=None):
    """(vgg params, heads) from the JAX package's arrays as numpy: its HWIO
    conv kernels become OIHW weights."""
    dev = resolve_device(device)
    params = [{"w": torch.as_tensor(np.transpose(np.asarray(p["w"], np.float32),
                                                 (3, 2, 0, 1)).copy(), device=dev),
               "b": torch.tensor(np.asarray(p["b"], np.float32), device=dev)}
              for p in vgg]
    return params, [torch.tensor(np.asarray(h, np.float32), device=dev)
                    for h in heads]


def _features_nchw(params: VggParams, x: Tensor) -> List[Tensor]:
    feats = []
    i = 0
    for _, n in VGG_BLOCKS:
        for _ in range(n):
            x = F.relu(F.conv2d(x, params[i]["w"], params[i]["b"], padding=1))
            i += 1
        feats.append(x)
        x = F.max_pool2d(x, 2, 2)  # "VALID": an odd edge row is dropped
    return feats


def vgg16_features(params: VggParams, x: Tensor) -> List[Tensor]:
    """(B, H, W, 3) in [-1, 1] → the 5 tapped activations, NHWC."""
    return [f.permute(0, 2, 3, 1)
            for f in _features_nchw(params, x.permute(0, 3, 1, 2))]


def lpips(vgg_params: VggParams, heads: List[Tensor], pred: Tensor,
          target: Tensor) -> Tensor:
    """Mean LPIPS over a batch; inputs (B, H, W, 3) in [0, 1]."""
    shift = torch.as_tensor(SHIFT, device=pred.device)
    scale = torch.as_tensor(SCALE, device=pred.device)

    def norm_input(img):
        return (((img * 2.0 - 1.0) - shift) / scale).permute(0, 3, 1, 2)

    fa = _features_nchw(vgg_params, norm_input(pred))
    fb = _features_nchw(vgg_params, norm_input(target))
    total = torch.zeros((), device=pred.device)
    for a, b, h in zip(fa, fb, heads):
        a = a * torch.rsqrt(torch.sum(a * a, 1, keepdim=True) + 1e-10)
        b = b * torch.rsqrt(torch.sum(b * b, 1, keepdim=True) + 1e-10)
        d = (a - b) ** 2
        total = total + torch.mean(torch.sum(d * h[None, :, None, None], 1))
    return total


class LPIPS:
    """Convenience wrapper with optional torch-weight loading."""

    def __init__(
        self,
        vgg_state_dict: Optional[Mapping[str, Any]] = None,
        lpips_state_dict: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        if vgg_state_dict is not None:
            self.vgg = convert_torch_vgg16(vgg_state_dict, self.device)
        else:
            self.vgg = init_vgg16_params(seed, self.device)
        if lpips_state_dict is not None:
            self.heads = convert_torch_lpips_heads(lpips_state_dict,
                                                   self.device)
        else:
            self.heads = init_lpips_heads(seed + 1, self.device)
        self.pretrained = vgg_state_dict is not None

    def __call__(self, pred: Tensor, target: Tensor) -> Tensor:
        if pred.dim() == 3:
            pred, target = pred[None], target[None]
        return lpips(self.vgg, self.heads, pred, target)
