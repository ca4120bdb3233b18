"""f32 2-D convolution of NHWC activations with HWIO kernels (K7).

No Pallas kernel stands behind this one: the JAX package spells the
guidance networks' convolutions as shifted matmuls for XLA
(`youreditableavatar_tpu/guidance/sd_layers.py`). On CUDA tensors
`sd_layers.conv2d` runs `csrc/conv.cu`, an implicit GEMM on FFMA in one
fixed summation order:

- K7f, `conv2d_forward`: output pixels × Cout over R·S·Cin, the activation
  gathered in place (padding and stride in the index arithmetic), the HWIO
  weight read as the row-major (K, Cout) matrix it is, the bias added last.
- K7d, `conv2d_input_grad`: the same GEMM over dY with the taps flipped and
  Cout as the reduction axis; a stride-s convolution splits dX by output
  parity into s² sub-problems (`input_grad_subs`), each a stride-1 gather
  with its own taps, four to a launch.
- At most `SMALL_N` output channels take a warp an output pixel instead
  of a tile (conv_in's input gradient, the conv_out and quant layers).

The sub-problems are plain descriptors (`Sub`); `implicit_gemm_plain` runs
the same descriptors in plain PyTorch, tap by tap, so the CPU tests hold
the index arithmetic the kernel uses against `torch.autograd`. On CPU
tensors `sd_layers.conv2d` keeps its `F.conv2d` code.

The wrapper picks the tile shape and a split-K factor from (M, N, K) and
the card's SM count (`plan`); split-K's partial sums go to a workspace
from `torch.empty` and a second kernel (`conv_reduce`) adds them in split
order, then the bias. No atomics: a shape gives the same bits every run.
The launch neither synchronises nor allocates outside `torch.empty`, so it
records into a CUDA graph. No weight gradient exists on the card: the
networks' weights are frozen, and `Conv2dK7` raises if one requires grad.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from youreditableavatar_tpu_torch import _kernels

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

BK = 32  # the kernel's K tile
MAX_SUBS = 4  # sub-problems in one launch
# Tile shapes of `csrc/conv.cu`: (BM, BN) by the `tile` argument; tile 2
# is a warp an output pixel, for N up to SMALL_N.
TILES = ((128, 128), (128, 64), (8, 8))
SMALL_N = 8
_INT_MAX = 2 ** 31 - 1


@dataclass(frozen=True)
class Sub:
    """One implicit GEMM: the rows are an (out_h, out_w) grid a batch
    image; row (i, j), tap (t, u) gathers input pixel
    (i·stride − pad_h + t, j·stride − pad_w + u) and weight tap
    (w_r0 + w_rstep·t, w_s0 + w_sstep·u); the result lands on output pixel
    (i·o_stride + o_y, j·o_stride + o_x)."""

    M: int
    out_h: int
    out_w: int
    pad_h: int
    pad_w: int
    taps_r: int
    taps_s: int
    w_r0: int
    w_rstep: int
    w_s0: int
    w_sstep: int
    o_stride: int = 1
    o_y: int = 0
    o_x: int = 0


def out_size(h: int, w: int, kh: int, kw: int, stride: int,
             pads: Pads) -> Tuple[int, int]:
    (pt, pb), (pl, pr) = pads
    return (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1


def forward_subs(batch: int, h: int, w: int, kh: int, kw: int, stride: int,
                 pads: Pads) -> List[Sub]:
    """K7f: one sub-problem, the taps in HWIO order."""
    oh, ow = out_size(h, w, kh, kw, stride, pads)
    return [Sub(batch * oh * ow, oh, ow, pads[0][0], pads[1][0], kh, kw,
                0, 1, 0, 1)]


def _phase_taps(k: int, pad: int, stride: int, phase: int):
    """Taps of an output phase: the weight taps r ≡ phase + pad (mod
    stride), last first, and the gather's pad over dY."""
    first = (phase + pad) % stride
    taps = max(0, -(-(k - first) // stride))
    shift = (phase + pad - first) // stride
    return taps, (taps - 1) - shift, first + stride * (taps - 1), -stride


def input_grad_subs(batch: int, h: int, w: int, kh: int, kw: int,
                    stride: int, pads: Pads) -> List[Sub]:
    """K7d: dX[s·i + py, s·j + px] for each parity (py, px) is a stride-1
    gather over dY with the weight taps r ≡ py + pad_top (mod s), flipped
    (the last tap first); Cout is the reduction axis. Stride 1 is the one
    phase (0, 0) with every tap flipped."""
    subs = []
    for py in range(stride):
        hp = -(-(h - py) // stride)
        rt, pad_h, r0, rstep = _phase_taps(kh, pads[0][0], stride, py)
        for px in range(stride):
            wp = -(-(w - px) // stride)
            if hp <= 0 or wp <= 0:
                continue
            st, pad_w, s0, sstep = _phase_taps(kw, pads[1][0], stride, px)
            subs.append(Sub(batch * hp * wp, hp, wp, pad_h, pad_w, rt, st,
                            r0, rstep, s0, sstep, stride, py, px))
    return subs


def implicit_gemm_plain(a: Tensor, w: Tensor, subs: Sequence[Sub],
                        gather_stride: int, out_shape, dgrad: bool,
                        bias: Optional[Tensor] = None) -> Tensor:
    """The kernel's decomposition in plain PyTorch: for each sub-problem,
    each tap gathers the (zero-padded) rows of `a` and multiplies them with
    the tap's (C, N) weight slice (K7d reads the HWIO slice transposed)."""
    out = torch.zeros(out_shape, dtype=a.dtype, device=a.device)
    batch, in_h, in_w, _ = a.shape
    n = out_shape[-1]
    for sb in subs:
        acc = torch.zeros((batch, sb.out_h, sb.out_w, n), dtype=a.dtype,
                          device=a.device)
        for t in range(sb.taps_r):
            ih = torch.arange(sb.out_h, device=a.device) * gather_stride \
                - sb.pad_h + t
            for u in range(sb.taps_s):
                iw = torch.arange(sb.out_w, device=a.device) * gather_stride \
                    - sb.pad_w + u
                ok = ((ih >= 0) & (ih < in_h))[:, None] \
                    & ((iw >= 0) & (iw < in_w))[None, :]
                rows = a[:, ih.clamp(0, in_h - 1)][:, :, iw.clamp(0, in_w - 1)]
                rows = rows * ok[None, :, :, None].to(a.dtype)
                tap = w[sb.w_r0 + sb.w_rstep * t, sb.w_s0 + sb.w_sstep * u]
                acc = acc + rows @ (tap.t() if dgrad else tap)
        if bias is not None:
            acc = acc + bias
        out[:, sb.o_y::sb.o_stride, sb.o_x::sb.o_stride] = acc
    return out


def conv2d_forward_plain(x: Tensor, w: Tensor, b: Optional[Tensor],
                         stride: int, pads: Pads) -> Tensor:
    """K7f's decomposition on any device (plain PyTorch)."""
    batch, h, wd, _ = x.shape
    kh, kw, _, cout = w.shape
    oh, ow = out_size(h, wd, kh, kw, stride, pads)
    return implicit_gemm_plain(x, w, forward_subs(batch, h, wd, kh, kw,
                                                  stride, pads),
                               stride, (batch, oh, ow, cout), False, b)


def conv2d_input_grad_plain(dy: Tensor, w: Tensor, x_shape, stride: int,
                            pads: Pads) -> Tensor:
    """K7d's decomposition on any device (plain PyTorch)."""
    batch, h, wd, _ = x_shape
    kh, kw, _, _ = w.shape
    return implicit_gemm_plain(dy, w, input_grad_subs(batch, h, wd, kh, kw,
                                                      stride, pads),
                               1, tuple(x_shape), True)


# ------------------------------------------------------------------ launch


class _CSub(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "M", "out_h", "out_w", "pad_h", "pad_w", "taps_r", "taps_s", "w_r0",
        "w_rstep", "w_s0", "w_sstep", "o_stride", "o_y", "o_x")]


class _CParams(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("a", "w", "bias", "out", "ws")]
                + [(name, ctypes.c_int) for name in (
                    "in_h", "in_w", "C", "stride", "N", "wS", "wCin", "wCout",
                    "full_h", "full_w", "splits", "kps")]
                + [("sub", _CSub * MAX_SUBS)])


# Resident blocks an SM holds of each tile shape (registers bound them:
# 256 threads of the 128×128 tile fill one SM's file) and the relative
# FFMA rate of the smaller tile (more shared-memory traffic per FMA).
_OCCUPANCY = (1, 2)
_EFFICIENCY = (1.0, 0.9)
_FMA_PER_SM_S = 67e12 / 2 / 132  # FFMA a second per SM at the f32 peak
_BYTES_S = 2.5e12  # device-memory rate the reduce pass reaches
_MAX_SPLITS = 16


def plan(m: int, n: int, k: int, sms: int, single: bool = True
         ) -> Tuple[int, int, int]:
    """(tile, splits, K tiles a split) of least modelled time: waves of
    resident blocks times a block's FMAs, plus split-K's reduce pass.
    Split-K only for a launch of one sub-problem. At most SMALL_N columns
    take the warp-a-pixel kernel."""
    ktiles = -(-k // BK)
    if n <= SMALL_N:
        return 2, 1, 1 << 30
    best = None
    for tile, (bm, bn) in enumerate(TILES[:2]):
        occ = _OCCUPANCY[tile]
        blocks = -(-m // bm) * -(-n // bn)
        top = min(_MAX_SPLITS, max(1, ktiles // 8)) if single else 1
        for want in range(1, top + 1):
            kps = -(-ktiles // want)
            splits = -(-ktiles // kps) if ktiles else 1
            waves = -(-blocks * splits // (sms * occ))
            t = waves * occ * bm * bn * kps * BK / (
                _FMA_PER_SM_S * _EFFICIENCY[tile])
            if splits > 1:
                t += (splits + 1) * m * n * 4 / _BYTES_S + 3e-6
            if best is None or t < best[0]:
                best = (t, tile, splits, kps)
    return best[1], best[2], best[3]


_SMS: Dict[int, int] = {}
_PLANS: Dict[tuple, tuple] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _make_plan(subs: List[Sub], c: int, n: int, sms: int) -> list:
    """A call's launches, four sub-problems each: (tile, splits, grid, the
    parameters without their pointers and sizes, rows of the split)."""
    launches = []
    for i in range(0, len(subs), MAX_SUBS):
        group = subs[i:i + MAX_SUBS]
        m = max(sb.M for sb in group)
        k = max(sb.taps_r * sb.taps_s for sb in group) * c
        tile, splits, kps = plan(m, n, k, sms, single=len(group) == 1)
        bm, bn = TILES[tile]
        prm = _CParams()
        prm.splits = splits
        prm.kps = kps if splits > 1 else 1 << 30
        for j, sb in enumerate(group):
            for name, _ in _CSub._fields_:
                setattr(prm.sub[j], name, getattr(sb, name))
        grid = (-(-m // bm), -(-n // bn), len(group) * splits)
        launches.append((tile, splits, grid, prm, group[0].M))
    return launches


def _check(name: str, t: Tensor, ndim: int, device) -> None:
    _kernels.check_cuda(name, t, torch.float32, ndim)
    if t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.numel() > _INT_MAX:
        raise ValueError(f"{name} has more than 2**31 - 1 elements")


def _check_aligned(name: str, t: Tensor) -> None:
    """Raise where the kernel would read `t` in 16-byte copies from an
    address that is not 16-byte aligned (a view at an odd offset)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for K7's "
                         f"16-byte loads; pass a fresh tensor (.clone())")


def _run(kernel: str, launches: list, a: Tensor, w: Tensor,
         bias: Optional[Tensor], out: Tensor, dgrad: bool, vec: bool,
         geometry: tuple) -> None:
    in_h, in_w, c, stride, n, full_h, full_w = geometry
    kh, kw, cin, cout = w.shape
    for tile, splits, grid, prm, m in launches:
        ws = None
        if splits > 1:
            if splits * m * n > _INT_MAX:
                raise ValueError("split-K workspace above 2**31 - 1 elements")
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=a.device)
        prm.a, prm.w = a.data_ptr(), w.data_ptr()
        prm.bias = bias.data_ptr() if bias is not None else None
        prm.out = out.data_ptr()
        prm.ws = ws.data_ptr() if ws is not None else None
        prm.in_h, prm.in_w, prm.C, prm.stride, prm.N = in_h, in_w, c, stride, n
        prm.wS, prm.wCin, prm.wCout = kw, cin, cout
        prm.full_h, prm.full_w = full_h, full_w
        _kernels.launch(kernel, "yea_conv", a.device, ctypes.addressof(prm),
                        tile, int(dgrad), int(vec), *grid)
        if ws is not None:
            _kernels.launch("conv_reduce", "yea_conv_reduce", a.device,
                            ws.data_ptr(),
                            bias.data_ptr() if bias is not None else None,
                            out.data_ptr(), m * n, n, splits)


def conv2d_forward(x: Tensor, w: Tensor, b: Optional[Tensor], stride: int,
                   pads: Pads) -> Tensor:
    """K7f: (B, H, W, Cin) ⊛ (R, S, Cin, Cout) (+ b) → (B, Ho, Wo, Cout),
    contiguous f32 CUDA tensors."""
    device = x.device
    _check("x", x, 4, device)
    _check("w", w, 4, device)
    if b is not None:
        _check("b", b, 1, device)
    batch, h, wd, cin = x.shape
    kh, kw, wcin, cout = w.shape
    if wcin != cin or (b is not None and b.shape[0] != cout):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and b "
                         f"{None if b is None else tuple(b.shape)} disagree")
    # 16-byte loads: x along Cin in whole K tiles, w along Cout by fours.
    if cin % BK == 0:
        _check_aligned("x", x)
    if cout % 4 == 0:
        _check_aligned("w", w)
    oh, ow = out_size(h, wd, kh, kw, stride, pads)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"no output pixels for {tuple(x.shape)} ⊛ "
                         f"{tuple(w.shape)}, stride {stride}, pads {pads}")
    y = torch.empty((batch, oh, ow, cout), dtype=torch.float32, device=device)
    if y.numel() > _INT_MAX:
        raise ValueError("output has more than 2**31 - 1 elements")
    key = ("f", tuple(x.shape), tuple(w.shape), stride, pads, device)
    launches = _PLANS.get(key)
    if launches is None:
        launches = _make_plan(forward_subs(batch, h, wd, kh, kw, stride, pads),
                              cin, cout, _sm_count(device))
        _PLANS[key] = launches
    _run("conv_forward", launches, x, w, b, y, False, cin % BK == 0,
         (h, wd, cin, stride, cout, oh, ow))
    return y


def conv2d_input_grad(dy: Tensor, w: Tensor, x_shape, stride: int,
                      pads: Pads) -> Tensor:
    """K7d: dX (B, H, W, Cin) of the forward above from dY (B, Ho, Wo,
    Cout), contiguous f32 CUDA tensors."""
    device = dy.device
    _check("dy", dy, 4, device)
    _check("w", w, 4, device)
    batch, h, wd, cin = (int(v) for v in x_shape)
    kh, kw, wcin, cout = w.shape
    oh, ow = out_size(h, wd, kh, kw, stride, pads)
    if wcin != cin or tuple(dy.shape) != (batch, oh, ow, cout):
        raise ValueError(f"dy {tuple(dy.shape)}, w {tuple(w.shape)} and x "
                         f"{tuple(x_shape)} disagree")
    if cout % BK == 0:  # 16-byte loads of dy and w along Cout
        _check_aligned("dy", dy)
        _check_aligned("w", w)
    dx = torch.empty((batch, h, wd, cin), dtype=torch.float32, device=device)
    if dx.numel() > _INT_MAX:
        raise ValueError("dx has more than 2**31 - 1 elements")
    key = ("d", tuple(dx.shape), tuple(w.shape), stride, pads, device)
    launches = _PLANS.get(key)
    if launches is None:
        launches = _make_plan(
            input_grad_subs(batch, h, wd, kh, kw, stride, pads), cout, cin,
            _sm_count(device))
        _PLANS[key] = launches
    _run("conv_input_grad", launches, dy, w, None, dx, True, cout % BK == 0,
         (oh, ow, cout, 1, cin, h, wd))
    return dx


def check_frozen(w: Tensor, b: Optional[Tensor]) -> None:
    """Raise where a weight gradient would be asked of K7, which has none."""
    if w.requires_grad or (b is not None and b.requires_grad):
        raise ValueError(
            "the CUDA convolution computes no weight or bias gradient: "
            "freeze the weights (requires_grad=False) or run on the CPU")


class Conv2dK7(torch.autograd.Function):
    """K7f forward, K7d backward (the input gradient alone)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pads):
        check_frozen(w, b)
        ctx.save_for_backward(w)
        ctx.conv = (tuple(x.shape), stride, pads)
        return conv2d_forward(x, w, b, stride, pads)

    @staticmethod
    def backward(ctx, dy):
        (w,) = ctx.saved_tensors
        x_shape, stride, pads = ctx.conv
        dx = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_input_grad(dy.contiguous(), w, x_shape, stride, pads)
        return dx, None, None, None, None


def conv2d(x: Tensor, w: Tensor, b: Optional[Tensor], stride: int,
           pads: Pads) -> Tensor:
    """K7 for CUDA tensors: differentiable in `x` where autograd asks."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad
            or (b is not None and b.requires_grad)):
        return Conv2dK7.apply(x, w, b, stride, pads)
    return conv2d_forward(x, w, b, stride, pads)
