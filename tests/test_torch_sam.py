"""PyTorch port vs the JAX package: `guidance/sam.py` (Segment Anything).

Weights are drawn by the JAX package's `init_sam_params` and carried to the
port with `sam_params_from_numpy`; images and boxes are made from seeds with
numpy. The configs are `TEST_SAM` and two variants whose grid does not
divide the window (the window blocks pad the normed activations, attend and
crop).

Tolerances are the JAX suite's own against its torch oracle
(`tests/test_sam.py::TestTorchNumericsParity`): the encoder atol 2e-5 /
rtol 1e-4, the prompt tokens and dense positional encoding 1e-5 / 1e-4,
the decoder's masks and IoU 3e-5 / 1e-4. The segmenter's mask logits are
held at the decoder's tolerance; its masks equal the JAX ones except at
pixels whose JAX logit lies within that tolerance of 0, which are counted
(and must be few). With `trust_decoder=False` the mask is box ∩ foreground
and must match exactly. Converters are held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_sam import synth_state_dict
from torch_port_helpers import (  # noqa: F401  (fixtures)
    cuda_device,
    single_threaded_torch,
)

from youreditableavatar_tpu.guidance import sam as js
from youreditableavatar_tpu_torch.guidance import manifests as tm
from youreditableavatar_tpu_torch.guidance import sam as ts
from youreditableavatar_tpu_torch.guidance.sd_layers import tree_leaves

CPU = "cpu"
ENC_TOL = dict(atol=2e-5, rtol=1e-4)
PROMPT_TOL = dict(atol=1e-5, rtol=1e-4)
DEC_TOL = dict(atol=3e-5, rtol=1e-4)

# TEST_SAM (grid 4, window 2), then grids that do not divide the window:
# 5 → 6 at window 2, and 4 → 6 at window 3.
CONFIGS = {
    "test_sam": js.TEST_SAM,
    "grid5_window2": dataclasses.replace(js.TEST_SAM, img_size=80),
    "grid4_window3": dataclasses.replace(js.TEST_SAM, window=3),
}


def tcfg(cfg):
    return ts.SAMConfig(**dataclasses.asdict(cfg))


def carry(tree):
    return ts.sam_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_trees_equal(got, ref, path="root"):
    """Same structure, every leaf bit-equal (ref leaves numpy or JAX)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            assert_trees_equal(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_trees_equal(g, r, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(_np(got), np.asarray(ref), err_msg=path)


@pytest.fixture(scope="module")
def params():
    jp = js.init_sam_params(jax.random.PRNGKey(0), js.TEST_SAM)
    return jp, carry(jp)


def test_init_tree_matches_jax_layout():
    """The port's init draws the JAX tree's structure and shapes."""
    jp = js.init_sam_params(jax.random.PRNGKey(0), js.TEST_SAM)
    tp = ts.init_sam_params(torch.Generator().manual_seed(0), ts.TEST_SAM)
    jl = jax.tree_util.tree_leaves(jp)
    tl = jax.tree_util.tree_leaves(tp)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, jp)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda _: 0, tp))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoder_matches_jax(name):
    cfg = CONFIGS[name]
    jp = js.init_sam_params(jax.random.PRNGKey(1), cfg)
    img = np.random.default_rng(11).normal(
        size=(2, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    ref = np.asarray(js.sam_encode_image(jp, jnp.asarray(img), cfg))
    got = ts.sam_encode_image(carry(jp), torch.tensor(img), tcfg(cfg))
    assert got.shape == ref.shape == (2, cfg.grid, cfg.grid, cfg.neck_dim)
    np.testing.assert_allclose(_np(got), ref, **ENC_TOL)


def test_prompt_encoder_matches_jax(params):
    jp, tp = params
    box = np.asarray([[8.0, 8.0, 40.0, 56.0], [0.0, 16.0, 64.0, 48.0],
                      [-3.0, 70.0, 12.5, 80.25]], np.float32)
    np.testing.assert_allclose(
        _np(ts.sam_encode_box(tp, torch.tensor(box), 64)),
        np.asarray(js.sam_encode_box(jp, jnp.asarray(box), 64)), **PROMPT_TOL)
    for g in (4, 5, 64):
        np.testing.assert_allclose(_np(ts.sam_dense_pe(tp, g)),
                                   np.asarray(js.sam_dense_pe(jp, g)),
                                   **PROMPT_TOL)


def test_decoder_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(13)
    emb = rng.normal(size=(2, 4, 4, js.TEST_SAM.neck_dim)).astype(np.float32)
    box = np.asarray([[8.0, 8.0, 40.0, 56.0], [16.0, 0.0, 48.0, 64.0]],
                     np.float32)
    toks = js.sam_encode_box(jp, jnp.asarray(box), 64)
    ref_m, ref_iou = js.sam_decode_masks(jp, jnp.asarray(emb), toks,
                                         js.TEST_SAM)
    got_m, got_iou = ts.sam_decode_masks(tp, torch.tensor(emb),
                                         torch.tensor(np.asarray(toks)),
                                         ts.TEST_SAM)
    assert got_m.shape == (2, 4, 16, 16) and got_iou.shape == (2, 4)
    np.testing.assert_allclose(_np(got_m), np.asarray(ref_m), **DEC_TOL)
    np.testing.assert_allclose(_np(got_iou), np.asarray(ref_iou), **DEC_TOL)


def test_conv_transpose_matches_torch_and_jax():
    """The upscaling's 2×2 stride-2 transposed convolution: the converted
    (flipped HWIO) kernel through the port equals torch's ConvTranspose2d on
    the original (in, out, kh, kw) weight and JAX's `lax.conv_transpose`."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 4, 5, 8)).astype(np.float32)
    wt = rng.normal(size=(8, 4, 2, 2)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    ref = F.conv_transpose2d(torch.tensor(x).permute(0, 3, 1, 2),
                             torch.tensor(wt), torch.tensor(b), stride=2)
    p = {"w": ts._conv_transpose_flipped(wt), "b": torch.tensor(b)}
    got = ts._conv_transpose2x2(torch.tensor(x), p)
    np.testing.assert_allclose(_np(got), _np(ref.permute(0, 2, 3, 1)),
                               atol=1e-5, rtol=1e-4)
    wj = np.transpose(wt, (2, 3, 0, 1))[::-1, ::-1].copy()
    np.testing.assert_array_equal(_np(p["w"]), wj)
    out_j = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(wj), (2, 2),
                                   "VALID", dimension_numbers=("NHWC", "HWIO",
                                                               "NHWC")) + b
    np.testing.assert_allclose(_np(got), np.asarray(out_j), atol=1e-5,
                               rtol=1e-4)


def _scene(h, w, seed=0):
    """A grey silhouette with a lighter top band on white, plus noise."""
    img = np.ones((h, w, 3), np.float32)
    y0, y1, x0, x1 = h // 6, 5 * h // 6, w // 3, 2 * w // 3
    img[y0:y1, x0:x1] = 0.3
    img[y0:y0 + (y1 - y0) // 3, x0:x1] = 0.6
    noise = np.random.default_rng(seed).uniform(-0.05, 0.05, img.shape)
    img[y0:y1, x0:x1] += noise[y0:y1, x0:x1].astype(np.float32)
    return img


def _jax_mask_logits(seg, img, box):
    """JAX `SAMSegmenter.segment`'s steps up to the threshold."""
    h, w = img.shape[:2]
    s = seg.cfg.img_size
    scl = s / max(h, w)
    rh, rw = max(round(h * scl), 1), max(round(w * scl), 1)
    x = jax.image.resize(jnp.asarray(img), (rh, rw, 3), "bilinear")
    x = (x - seg.MEAN) / seg.STD
    x = jnp.pad(x, ((0, s - rh), (0, s - rw), (0, 0)))
    emb = seg._encode(x[None])
    toks = js.sam_encode_box(seg.params, jnp.asarray(box)[None] * scl, s)
    masks, _ = seg._decode(emb, toks)
    gm = masks.shape[-1]
    crop = masks[0, 0][: max(round(rh / s * gm), 1),
                       : max(round(rw / s * gm), 1)]
    return np.asarray(jax.image.resize(crop, (h, w), "bilinear"))


FRAMES = {"shrinking": (96, 80), "growing": (40, 48)}


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("trust", [True, False])
def test_segmenter_matches_jax(params, frame, trust):
    jp, tp = params
    img = _scene(*FRAMES[frame])
    jseg = js.SAMSegmenter(jp, js.TEST_SAM, trust_decoder=trust)
    tseg = ts.SAMSegmenter(tp, ts.TEST_SAM, trust_decoder=trust, device=CPU)
    box = js.Grounder().ground(img, "the hat")
    ref_logits = _jax_mask_logits(jseg, img, box)
    got_logits = _np(tseg._mask_logits(img, box))
    np.testing.assert_allclose(got_logits, ref_logits, **DEC_TOL)
    mj = jseg.segment(img, "the hat")
    mt = tseg.segment(img, "the hat").numpy()
    assert mt.shape == mj.shape == img.shape[:2] and mt.dtype == bool
    if trust:
        near = np.abs(ref_logits) <= DEC_TOL["atol"] + DEC_TOL["rtol"] * \
            np.abs(ref_logits).max()
        differ = mt != mj
        assert not (differ & ~near).any()
        assert near.sum() <= 0.01 * near.size, int(near.sum())
    else:
        np.testing.assert_array_equal(mt, mj)
        assert mt.any()
    # A tensor frame segments as its numpy copy.
    np.testing.assert_array_equal(tseg.segment(torch.tensor(img), "the hat"),
                                  mt)


@pytest.mark.parametrize("prompt", ["the hat", "red trousers", "a jacket"])
def test_grounder_matches_jax(prompt):
    for img in (_scene(48, 48), _scene(40, 64, 3),
                np.ones((32, 24, 3), np.float32)):
        np.testing.assert_array_equal(ts.Grounder().ground(img, prompt),
                                      js.Grounder().ground(img, prompt))


def test_convert_manifest_state_dict_matches_jax():
    """A state dict with every key of `sam_manifest(TEST_SAM)` at its shape
    (random values) converts to the JAX converter's tree bit for bit, and
    both trees give the same embedding and masks."""
    rng = np.random.default_rng(3)
    sd = {k: rng.normal(0, 0.05, shape).astype(np.float32)
          for k, shape in tm.sam_manifest(ts.TEST_SAM).items()}
    ref = js.convert_torch_sam(sd)
    got = ts.convert_torch_sam(sd)
    assert_trees_equal(got, ref)
    img = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    e_ref = js.sam_encode_image(ref, jnp.asarray(img), js.TEST_SAM)
    e_got = ts.sam_encode_image(got, torch.tensor(img), ts.TEST_SAM)
    np.testing.assert_allclose(_np(e_got), np.asarray(e_ref), **ENC_TOL)
    box = np.asarray([[8.0, 8.0, 40.0, 56.0]], np.float32)
    m_ref, _ = js.sam_decode_masks(ref, e_ref,
                                   js.sam_encode_box(ref, jnp.asarray(box),
                                                     64), js.TEST_SAM)
    m_got, _ = ts.sam_decode_masks(got, torch.tensor(np.asarray(e_ref)),
                                   ts.sam_encode_box(got, torch.tensor(box),
                                                     64), ts.TEST_SAM)
    np.testing.assert_allclose(_np(m_got), np.asarray(m_ref), **DEC_TOL)


def test_from_torch_file_matches_jax_conversion(params, tmp_path):
    """The JAX tree written as an official-layout checkpoint (torch
    tensors, `torch.save`) loads through `from_torch_file` to the tree the
    JAX converter makes of the same state dict."""
    jp, _ = params
    sd = synth_state_dict(jp)
    path = tmp_path / "sam_vit_test.pth"
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, path)
    seg = ts.SAMSegmenter.from_torch_file(str(path), ts.TEST_SAM, device=CPU)
    assert_trees_equal(seg.params, js.convert_torch_sam(sd))
    assert all(not x.requires_grad for x in tree_leaves(seg.params))


def test_entry_points_default_to_cuda(params):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.SAMSegmenter(params[1], ts.TEST_SAM)


@pytest.mark.cuda
@pytest.mark.parametrize("trust", [True, False])
def test_segmenter_on_card_matches_cpu(params, cuda_device, trust):
    """SAMSegmenter on the card against its CPU run (f32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, tp = params
    img = _scene(96, 80)
    box = ts.Grounder().ground(img, "the hat")
    cpu = ts.SAMSegmenter(tp, ts.TEST_SAM, trust_decoder=trust, device=CPU)
    card = ts.SAMSegmenter(tp, ts.TEST_SAM, trust_decoder=trust,
                           device=cuda_device)
    np.testing.assert_allclose(_np(card._mask_logits(img, box)),
                               _np(cpu._mask_logits(img, box)), **DEC_TOL)
    if not trust:
        np.testing.assert_array_equal(card.segment(img, "the hat").cpu(),
                                      cpu.segment(img, "the hat"))
