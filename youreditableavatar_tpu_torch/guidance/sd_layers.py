"""Shared functional layers of the Stable-Diffusion model family.

Counterpart of `youreditableavatar_tpu/guidance/sd_layers.py`, of which
only `conv2d` is ported so far (the stub diffusion prior needs it). The
JAX version spells the convolution as shifted matmuls because the TPU's
conv lowering is slow; here it is `F.conv2d` on the same NHWC / HWIO
layouts with the same "SAME" padding. Keep cuDNN's TF32 off on the card
(`torch.backends.cudnn.allow_tf32 = False`, as `chip_smoke.py` sets) so it
stays f32.
"""

from __future__ import annotations

from typing import Any, Dict

import torch.nn.functional as F
from torch import Tensor

Params = Dict[str, Any]


def conv2d(x: Tensor, p: Params, stride: int = 1, padding="SAME") -> Tensor:
    """2-D convolution of NHWC `x` with the HWIO kernel `p["w"]` (+ `p["b"]`).

    `padding` is "SAME", "VALID" or ((top, bottom), (left, right)).
    """
    w = p["w"]  # (kh, kw, cin, cout) HWIO
    kh, kw, _, _ = w.shape
    s = stride
    _, h, wd, _ = x.shape
    if padding == "SAME":
        pt_h = max((-(-h // s) - 1) * s + kh - h, 0)
        pt_w = max((-(-wd // s) - 1) * s + kw - wd, 0)
        pads = ((pt_h // 2, pt_h - pt_h // 2),
                (pt_w // 2, pt_w - pt_w // 2))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    else:
        pads = tuple(tuple(q) for q in padding)
    xn = F.pad(x.permute(0, 3, 1, 2),
               (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=s).permute(0, 2, 3, 1)
    return y + p["b"] if "b" in p else y
