"""K7, the hand-written f32 implicit-GEMM convolution under
`sd_layers.conv2d` (`ops/conv_cuda.py`, `csrc/conv.cu`).

No JAX here: the `cuda` tests run on a card, from the repository root, with
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_conv.py`. On the CPU the tests hold the decomposition the
kernel follows (the forward's gather, the input gradient's flipped and
transposed taps and its stride-s phase split) against `F.conv2d` and
`torch.autograd` in f64, `sd_layers.conv2d`'s CPU path against its
`F.conv2d` code, and the wrapper's refusals.

On the card, each distinct convolution the three benchmark cells run
(recorded from one step or call of each) is held, forward and input
gradient, against an f64 convolution of the same inputs: K7's largest
error at most twice cuDNN-f32's own at that shape, cuDNN in TF32 (the
negative control) above that bound, two runs bit-identical. One test
captures K7 into a CUDA graph; one holds a tiny SD1.5 step's routing (no
cuDNN convolution kernel, launches one for one with the calls).
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from youreditableavatar_tpu_torch import _kernels
from youreditableavatar_tpu_torch.guidance import sd_layers
from youreditableavatar_tpu_torch.ops import conv_cuda

ROOT = Path(__file__).resolve().parent.parent

S1 = ((1, 1), (1, 1))
ZERO = ((0, 0), (0, 0))
# (batch, h, w, cin, kh, kw, cout, stride, pads): the networks' kinds of
# convolution at tiny widths — 3×3 SAME, the VAE's stride-2 (0, 1) and the
# UNet's (1, 1) downsamples, 1×1 projections, conv_in with 3 and 4
# channels, the 16/16 and 4/4 patch embeds, odd sizes and uneven pads.
GEOMETRIES = [
    (2, 7, 6, 3, 3, 3, 5, 1, S1),
    (1, 8, 8, 4, 3, 3, 6, 2, ((0, 1), (0, 1))),
    (2, 9, 7, 5, 3, 3, 3, 2, S1),
    (1, 6, 5, 8, 1, 1, 7, 1, ZERO),
    (1, 16, 12, 3, 4, 4, 6, 4, ZERO),
    (1, 32, 32, 3, 16, 16, 4, 16, ZERO),
    (1, 5, 7, 2, 3, 3, 3, 3, ((1, 2), (0, 1))),
    (2, 6, 6, 3, 1, 1, 2, 2, ZERO),
    (1, 10, 9, 3, 5, 3, 4, 2, ((2, 1), (1, 0))),
]
GEOMETRY_IDS = [f"{g[4]}x{g[5]}s{g[7]}c{g[3]}-{g[6]}" for g in GEOMETRIES]


# `F.conv2d` on NHWC / HWIO with explicit pads, any device and dtype (on
# the card, cuDNN).
_plain = sd_layers.conv2d_plain


def _draw(geometry, seed=0, dtype=torch.float64, device="cpu"):
    batch, h, wd, cin, kh, kw, cout, stride, pads = geometry
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, h, wd, cin), generator=g, dtype=dtype,
                    device=device)
    w = torch.randn((kh, kw, cin, cout), generator=g, dtype=dtype,
                    device=device) / (kh * kw * cin) ** 0.5
    b = torch.randn((cout,), generator=g, dtype=dtype, device=device) * 0.1
    return x, w, b, stride, pads


# ------------------------------------------------------------------- CPU


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
def test_forward_decomposition_matches_conv2d(geometry):
    x, w, b, stride, pads = _draw(geometry)
    got = conv_cuda.conv2d_forward_plain(x, w, b, stride, pads)
    torch.testing.assert_close(got, _plain(x, w, b, stride, pads),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
def test_input_grad_decomposition_matches_autograd(geometry):
    x, w, _, stride, pads = _draw(geometry, seed=1)
    x.requires_grad_(True)
    y = _plain(x, w, None, stride, pads)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2),
                     dtype=y.dtype)
    (want,) = torch.autograd.grad(y, x, dy)
    got = conv_cuda.conv2d_input_grad_plain(dy, w, x.shape, stride, pads)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
def test_input_grad_phases_cover_each_pixel_once(geometry):
    batch, h, wd, _, kh, kw, _, stride, pads = geometry
    subs = conv_cuda.input_grad_subs(batch, h, wd, kh, kw, stride, pads)
    hits = torch.zeros((h, wd), dtype=torch.int64)
    for sb in subs:
        assert sb.M == batch * sb.out_h * sb.out_w
        hits[sb.o_y::sb.o_stride, sb.o_x::sb.o_stride] += 1
        # every weight tap a phase names lies in the kernel
        for t in range(sb.taps_r):
            assert 0 <= sb.w_r0 + sb.w_rstep * t < kh
        for u in range(sb.taps_s):
            assert 0 <= sb.w_s0 + sb.w_sstep * u < kw
    assert bool((hits == 1).all())
    assert sum(sb.taps_r for sb in subs[::stride]) == kh or stride > kh


def test_vae_downsample_phase_split():
    """The VAE encoder's stride-2 ((0, 1), (0, 1)) downsample: four phases;
    even rows take taps 2 and 0 (in that order), odd rows tap 1."""
    subs = conv_cuda.input_grad_subs(1, 8, 8, 3, 3, 2, ((0, 1), (0, 1)))
    assert [(sb.o_y, sb.o_x) for sb in subs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    even, odd = subs[0], subs[3]
    assert (even.taps_r, even.w_r0, even.w_rstep, even.pad_h) == (2, 2, -2, 1)
    assert (odd.taps_r, odd.w_r0, odd.w_rstep, odd.pad_h) == (1, 1, -2, 0)


def _conv2d_before_k7(x, p, stride=1, padding="SAME"):
    """`sd_layers.conv2d` as it read before K7, verbatim."""
    w = p["w"]
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
    xn = x.permute(0, 3, 1, 2)
    if pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]:
        conv_pad = (pads[0][0], pads[1][0])
    else:
        xn = F.pad(xn, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        conv_pad = 0
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=s,
                 padding=conv_pad).permute(0, 2, 3, 1)
    return y + p["b"] if "b" in p else y


@pytest.mark.parametrize("stride, padding", [
    (1, "SAME"), (2, "SAME"), (1, "VALID"), (2, ((0, 1), (0, 1))),
    (2, ((1, 1), (1, 1))), (4, "VALID")])
@pytest.mark.parametrize("bias", [True, False])
def test_sd_layers_cpu_path_unchanged(stride, padding, bias):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 12, 9, 5), generator=g).requires_grad_(True)
    k = 4 if stride == 4 else 3
    p = {"w": torch.randn((k, k, 5, 6), generator=g)}
    if bias:
        p["b"] = torch.randn((6,), generator=g)
    got = sd_layers.conv2d(x, p, stride, padding)
    want = _conv2d_before_k7(x, p, stride, padding)
    assert torch.equal(got, want)
    dy = torch.randn(got.shape, generator=g)
    assert torch.equal(torch.autograd.grad(got, x, dy)[0],
                       torch.autograd.grad(want, x, dy)[0])


def test_card_path_refuses_a_weight_that_requires_grad():
    x, w, b, stride, pads = _draw(GEOMETRIES[0], dtype=torch.float32)
    x.requires_grad_(True)
    with pytest.raises(ValueError, match="weight or bias gradient"):
        conv_cuda.Conv2dK7.apply(x, w.clone().requires_grad_(True), b,
                                 stride, pads)
    with pytest.raises(ValueError, match="weight or bias gradient"):
        conv_cuda.Conv2dK7.apply(x, w, b.clone().requires_grad_(True),
                                 stride, pads)


def test_kernel_wrappers_refuse_cpu_tensors():
    x, w, b, stride, pads = _draw(GEOMETRIES[0], dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        conv_cuda.conv2d_forward(x, w, b, stride, pads)
    dy = torch.zeros((2, 7, 6, 5))
    with pytest.raises(ValueError, match="CUDA"):
        conv_cuda.conv2d_input_grad(dy, w, x.shape, stride, pads)


@pytest.mark.parametrize("what", ["x", "w", "dy", "w of dy"])
def test_kernel_wrappers_refuse_unaligned_16_byte_operands(what, monkeypatch):
    """A contiguous view at an odd offset, where K7 reads 16 bytes at a
    time (Cin a multiple of 32 for x; Cout of 4 for w; Cout a multiple of
    32 for dy and, in the input gradient, w), is refused before a launch."""
    monkeypatch.setattr(_kernels, "check_cuda", lambda *a: None)

    def off(shape):  # contiguous, 4 bytes past an aligned start
        n = 1
        for v in shape:
            n *= v
        return torch.zeros(n + 1)[1:].view(shape)

    x, w = torch.zeros((1, 4, 4, 32)), torch.zeros((3, 3, 32, 4))
    with pytest.raises(ValueError, match="16-byte"):
        if what == "x":
            conv_cuda.conv2d_forward(off(x.shape), w, None, 1, S1)
        elif what == "w":
            conv_cuda.conv2d_forward(x, off(w.shape), None, 1, S1)
        else:
            w = torch.zeros((3, 3, 4, 32))
            dy = torch.zeros((1, 4, 4, 32))
            if what == "dy":
                dy = off(dy.shape)
            else:
                w = off(w.shape)
            conv_cuda.conv2d_input_grad(dy, w, (1, 4, 4, 4), 1, S1)


@pytest.mark.parametrize("m, n, k, want_split", [
    (128, 1280, 11520, True),     # SD1.5 UNet 8² level at CFG batch 2
    (512, 1280, 11520, True),     # its 16² level
    (262144, 128, 1152, False),   # VAE encoder at 512²
    (8192, 320, 2880, True),      # UNet 64² level
])
def test_plan_splits_k_only_where_blocks_are_few(m, n, k, want_split):
    tile, splits, kps = conv_cuda.plan(m, n, k, 132)
    ktiles = -(-k // conv_cuda.BK)
    assert (splits > 1) == want_split
    assert (splits - 1) * kps < ktiles <= splits * kps
    assert tile in (0, 1)
    assert conv_cuda.plan(m, n, k, 132, single=False)[1] == 1
    assert conv_cuda.plan(m, n, k, 132) == (tile, splits, kps)


@pytest.mark.parametrize("m, n, k", [
    (262144, 3, 1152),   # the VAE encoder conv_in's input gradient
    (8192, 4, 2880),     # the UNet's conv_out
    (4096, 8, 4608),     # the VAE encoder's conv_out
])
def test_plan_takes_a_warp_a_pixel_for_narrow_outputs(m, n, k):
    assert conv_cuda.plan(m, n, k, 132)[:2] == (2, 1)
    assert conv_cuda.plan(m, 16, k, 132)[0] in (0, 1)


# ------------------------------------------------------------------- card


@contextlib.contextmanager
def _cudnn_tf32(on: bool):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _cudnn_input_grad(x_shape, dy, w, stride, pads):
    x = torch.zeros(x_shape, dtype=dy.dtype, device=dy.device,
                    requires_grad=True)
    with torch.enable_grad():
        y = _plain(x, w, None, stride, pads)
        return torch.autograd.grad(y, x, dy)[0]


def _max_err(got, ref64):
    return float((got.double() - ref64).abs().max())


class _Recorder:
    """Wraps `conv_cuda.conv2d` (what `sd_layers.conv2d` calls on the card)
    and records each call's shapes."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = conv_cuda.conv2d

        def conv2d(x, w, b, stride, pads):
            grad = torch.is_grad_enabled() and x.requires_grad
            self.calls.append((tuple(x.shape), tuple(w.shape), stride,
                               tuple(tuple(q) for q in pads), b is not None,
                               grad))
            return inner(x, w, b, stride, pads)

        monkeypatch.setattr(conv_cuda, "conv2d", conv2d)


def _config(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (ROOT / "benchmark" / "workloads" / f"{name}.json").read_text())
    return cfg, traffic


def _sds_step(dev, tmp):
    from benchmark.entries import sds_edit

    cfg, _ = _config("geo_edit.sds")
    w = sds_edit.make_weights(cfg, 11, dev)
    trainer = sds_edit.build_program(cfg, w, 11, dev, str(tmp))
    trainer.train_step(seed=11)  # warm: kernels built, caches filled
    torch.cuda.synchronize(dev)
    return trainer


def _run_inpaint(dev):
    from benchmark.entries import sdxl_inpaint

    cfg, traffic = _config("tex_edit.inpaint")
    w = sdxl_inpaint.make_weights(cfg, 12, dev)
    pipe = sdxl_inpaint.build_program(cfg, w, dev)
    one = dict(traffic, steps=1)
    sdxl_inpaint.inpaint(pipe, one,
                         sdxl_inpaint.call_inputs(traffic, 12, 0, dev))


def _run_localize(dev):
    from benchmark.entries import langsam_localize as ll

    cfg, traffic = _config("localize.langsam")
    verts, faces = ll.make_mesh(cfg)
    cams = ll.probe_cameras(cfg)
    images = ll.render_probes(verts, faces, cams, cfg, dev)
    weights = ll.make_weights(cfg, 13, dev)
    loc = ll.build_program(cfg, 13, dev, verts, faces, weights)
    loc.localize(cams, images, ll.prompt_of(traffic, 13, 0))


def _free():
    gc.collect()
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def cell_convolutions(tmp_path_factory):
    """Each cell's distinct convolutions (x shape, w shape, stride, pads,
    bias, input gradient wanted), recorded on the card from one SDS step,
    one 1-step inpaint call and one localize call; and the SDS step's
    K7 launches beside its calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        rec = _Recorder(mp)
        trainer = _sds_step(dev, tmp_path_factory.mktemp("text"))
        rec.calls.clear()
        before = dict(_kernels.LAUNCHES)
        trainer.train_step(seed=11)
        torch.cuda.synchronize(dev)
        launched = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
        out["sds_step"] = (list(rec.calls), launched)
        out["geo_edit.sds"] = sorted(set(rec.calls))
        del trainer
        _free()
        rec.calls.clear()
        _run_inpaint(dev)
        out["tex_edit.inpaint"] = sorted(set(rec.calls))
        _free()
        rec.calls.clear()
        _run_localize(dev)
        out["localize.langsam"] = sorted(set(rec.calls))
        _free()
    finally:
        mp.undo()
    return out


@pytest.mark.cuda
def test_sds_step_runs_k7_once_a_call(cell_convolutions):
    """The SDS step: one K7f launch a convolution (the UNet's CFG pair is
    one batch-2 call), one K7d launch a convolution the backward crosses
    (the VAE encoder's), and none left to cuDNN."""
    calls, launched = cell_convolutions["sds_step"]
    backward = [c for c in calls if c[5]]
    assert backward and len(backward) < len(calls)
    assert launched["conv_forward"] == len(calls)
    assert launched["conv_input_grad"] == len(backward)
    # The UNet runs without gradient, at CFG batch 2; the VAE encoder with.
    assert {c[0][0] for c in calls if not c[5]} == {2}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["geo_edit.sds", "tex_edit.inpaint",
                                  "localize.langsam"])
def test_k7_against_f64_at_each_cell_shape(cell, cell_convolutions,
                                           cuda_device):
    """Forward and input gradient at every distinct shape of the cell:
    K7's max |Δ| against f64 at most 2× cuDNN-f32's; cuDNN with TF32 above
    that bound; two K7 runs the same bits. The TF32 control is asked of
    the input gradient where the cell runs it (the SDS step's VAE
    encoder): at some forward-only shapes (dX of 4 channels) cuDNN's
    TF32 setting picks no TF32 kernel, and the control reads f32."""
    failures = []
    shapes = {}
    for x_shape, w_shape, stride, pads, bias, grad in cell_convolutions[cell]:
        key = (x_shape, w_shape, stride, pads)
        was = shapes.get(key, (False, False))
        shapes[key] = (was[0] or bias, was[1] or grad)
    for n, ((x_shape, w_shape, stride, pads), (bias, grad)) in enumerate(
            sorted(shapes.items())):
        g = torch.Generator(device=cuda_device).manual_seed(n)
        x = torch.randn(x_shape, generator=g, device=cuda_device)
        w = torch.randn(w_shape, generator=g, device=cuda_device) / (
            w_shape[0] * w_shape[1] * w_shape[2]) ** 0.5
        b = (torch.randn((w_shape[3],), generator=g, device=cuda_device)
             * 0.1 if bias else None)
        with torch.no_grad():
            y = conv_cuda.conv2d_forward(x, w, b, stride, pads)
            again = conv_cuda.conv2d_forward(x, w, b, stride, pads)
            ref = _plain(x.double(), w.double(),
                         None if b is None else b.double(), stride, pads)
            with _cudnn_tf32(False):
                e32 = _max_err(_plain(x, w, b, stride, pads), ref)
            with _cudnn_tf32(True):
                etf = _max_err(_plain(x, w, b, stride, pads), ref)
            ek = _max_err(y, ref)
        del ref
        dy = torch.randn(y.shape, generator=g, device=cuda_device)
        dx = conv_cuda.conv2d_input_grad(dy, w, x_shape, stride, pads)
        dx2 = conv_cuda.conv2d_input_grad(dy, w, x_shape, stride, pads)
        ref = _cudnn_input_grad(x_shape, dy.double(), w.double(), stride, pads)
        with _cudnn_tf32(False):
            d32 = _max_err(_cudnn_input_grad(x_shape, dy, w, stride, pads), ref)
        with _cudnn_tf32(True):
            dtf = _max_err(_cudnn_input_grad(x_shape, dy, w, stride, pads), ref)
        dk = _max_err(dx, ref)
        for what, err, base, tf, same, control in (
                ("forward", ek, e32, etf, torch.equal(y, again), True),
                ("input grad", dk, d32, dtf, torch.equal(dx, dx2), grad)):
            print(f"{cell} {what} x{x_shape} w{w_shape} s{stride} {pads}: "
                  f"K7 {err:.3e} cuDNN-f32 {base:.3e} TF32 {tf:.3e} "
                  f"ratio {err / base if base else float('inf'):.3f}")
            if not (err <= 2 * base and same
                    and (tf > 2 * base or not control)):
                failures.append(f"{what} x{x_shape} w{w_shape} s{stride} "
                                f"{pads}: K7 {err:.3e}, cuDNN f32 {base:.3e}, "
                                f"TF32 {tf:.3e}, bit-identical {same}")
        del x, w, b, y, again, dy, dx, dx2, ref
        _free()
    assert shapes
    assert not failures, "\n".join(failures)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    (2, 8, 8, 1280, 3, 3, 1280, 1, S1),                   # split-K
    (1, 64, 64, 128, 3, 3, 128, 2, ((0, 1), (0, 1))),     # four phases
], ids=["split-k", "phases"])
def test_k7_records_into_a_cuda_graph(geometry, cuda_device):
    x, w, b, stride, pads = _draw(geometry, dtype=torch.float32,
                                  device=cuda_device)
    y = conv_cuda.conv2d_forward(x, w, b, stride, pads)
    dy = torch.randn_like(y)
    dx = conv_cuda.conv2d_input_grad(dy, w, x.shape, stride, pads)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            gy = conv_cuda.conv2d_forward(x, w, b, stride, pads)
            gdx = conv_cuda.conv2d_input_grad(dy, w, x.shape, stride, pads)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gy, y) and torch.equal(gdx, dx)
    x.mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gy, conv_cuda.conv2d_forward(x, w, b, stride, pads))


# cuDNN's and cuBLAS-FFT's convolution kernels by name.
_CUDNN_CONV = re.compile(
    r"cudnn|convolve|fprop|dgrad|wgrad|fft2d|winograd|conv2d_", re.I)


@pytest.mark.cuda
def test_tiny_sd15_step_has_no_cudnn_convolution(cuda_device, monkeypatch):
    from youreditableavatar_tpu_torch.guidance import sd_unet, sd_vae
    from youreditableavatar_tpu_torch.guidance.sd15 import SD15Prior

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    prior = SD15Prior.random_init(gen, sd_unet.TEST_UNET, sd_vae.TEST_VAE,
                                  device=cuda_device)
    images = torch.rand((1, 64, 64, 3), generator=gen, device=cuda_device)
    ctx = torch.randn((1, 77, sd_unet.TEST_UNET.ctx_dim), generator=gen,
                      device=cuda_device)
    t = torch.tensor([500], device=cuda_device)

    def step():
        img = images.clone().requires_grad_(True)
        side = 64 // prior.latent_downscale
        z = prior.encode_images(img, noise=torch.zeros(
            (1, side, side, prior.latent_channels), device=cuda_device))
        cond, uncond = prior.predict_noise(z.detach(), t, ctx, ctx * 0.5)
        (z * (cond - uncond)).sum().backward()
        return img.grad

    step()
    torch.cuda.synchronize()
    rec = _Recorder(monkeypatch)
    before = dict(_kernels.LAUNCHES)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grad = step()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if _CUDNN_CONV.search(n)], names
    assert any(n.startswith("void (anonymous namespace)::conv_kernel")
               for n in names), names
    assert _kernels.LAUNCHES["conv_forward"] - before["conv_forward"] \
        == len(rec.calls)
    assert _kernels.LAUNCHES["conv_input_grad"] - before["conv_input_grad"] \
        == sum(1 for c in rec.calls if c[5]) > 0
    assert bool(torch.isfinite(grad).all())
