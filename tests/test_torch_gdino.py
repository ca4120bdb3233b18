"""PyTorch port vs the JAX package: `guidance/grounding_dino.py`
(GroundingDINO Swin-T), the `SAMSegmenter` + `DinoGrounder` chain (LangSAM)
and `guidance/factory.make_segmenter_backend`.

Weights are drawn by the JAX package's inits at `TEST_GDINO` and carried to
the port with `gdino_params_from_numpy`; images, queries and masks are made
from seeds with numpy. Tolerances are the JAX suite's own against its torch
oracles (`tests/test_gdino.py`): the deformable attention and the bilinear
sampling 1e-5 absolute (+ 1e-4 relative), the towers (Swin, BERT, the
bi-attention and `gdino_ground`'s boxes, scores and logits) 5e-5 absolute +
1e-4 relative, as its BERT tower parity. `gdino_ground`'s selected query
set is held equal index for index (the port sorts stably where JAX's
`top_k` puts the lower index first). Grounded boxes are pixel boxes: held
within 5e-5 of the frame size. Tokenizer ids and converted trees are held
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401  (fixtures)
    cuda_device,
    single_threaded_torch,
)

from youreditableavatar_tpu.guidance import grounding_dino as jg
from youreditableavatar_tpu.guidance import sam as js
from youreditableavatar_tpu.guidance import wordpiece as jw
from youreditableavatar_tpu_torch.guidance import factory as tf
from youreditableavatar_tpu_torch.guidance import grounding_dino as tg
from youreditableavatar_tpu_torch.guidance import sam as ts
from youreditableavatar_tpu_torch.guidance import wordpiece as tw
from youreditableavatar_tpu_torch.guidance.manifests import GDINO_UNCONSUMED
from youreditableavatar_tpu_torch.stages.localization import (
    HeuristicSegmenter,
)

CPU = "cpu"
SAMPLE_TOL = dict(atol=1e-5, rtol=1e-4)
TOWER_TOL = dict(atol=5e-5, rtol=1e-4)
BOX_PX_TOL = 5e-5  # of the frame's size
CFG = jg.TEST_GDINO
TCFG = tg.GDINOConfig(**dataclasses.asdict(CFG))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def carry(tree):
    return tg.gdino_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree))


def randomized(tree, seed, scale=0.2):
    """Every leaf replaced by normal(0, scale) draws (the inits zero the
    biases and gate the bi-attention at 1e-4)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0, scale, np.shape(a)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def params():
    jp = jg.init_gdino_params(jax.random.PRNGKey(0), CFG)
    return jp, carry(jp)


def _tok(text):
    return jg.HashTokenizer(CFG.vocab, CFG.max_text_len)(text)


def test_init_tree_matches_jax_layout():
    jp = jg.init_gdino_params(jax.random.PRNGKey(0), CFG)
    tp = tg.init_gdino_params(torch.Generator().manual_seed(0), TCFG)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, jp)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0, tp))
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(tp)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jp)]


@pytest.mark.parametrize("hw", [(64, 64), (48, 80), (37, 29)])
def test_swin_backbone_matches_jax(params, hw):
    """Square, non-square and a frame that pads at the patch, the windows
    and the patch merges."""
    jp, tp = params
    img = np.random.default_rng(2).uniform(0, 1, hw + (3,)).astype(np.float32)
    ref = jg.swin_backbone(jp["swin"], jnp.asarray(img), CFG)
    got = tg.swin_backbone(tp["swin"], torch.tensor(img), TCFG)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOWER_TOL)


def test_window_helpers_match_jax():
    for w in (4, 7):
        np.testing.assert_array_equal(tg._rel_index(w), jg._rel_index(w))
    x = np.arange(8 * 12 * 3, dtype=np.float32).reshape(8, 12, 3)
    wins = tg._window_partition(torch.tensor(x), 4)
    np.testing.assert_array_equal(
        _np(wins), np.asarray(jg._window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(_np(tg._window_merge(wins, 8, 12, 4)), x)


def test_bert_matches_jax_with_padding(params):
    jp, tp = params
    p = randomized(jp["bert"], 4, 0.1)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, CFG.vocab, CFG.max_text_len).astype(np.int32)
    toks[9:] = 0
    mask = np.zeros(CFG.max_text_len, bool)
    mask[:9] = True
    ref = jg.bert_encode(p, jnp.asarray(toks), jnp.asarray(mask),
                         CFG.text_heads)
    got = tg.bert_encode(carry(p), torch.tensor(toks), torch.tensor(mask),
                         CFG.text_heads)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOWER_TOL)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(5, 7, 3)).astype(np.float32)
    xy = rng.uniform(-0.2, 1.2, (6, 9, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tg._bilinear_sample(torch.tensor(feat), torch.tensor(xy))),
        np.asarray(jg._bilinear_sample(jnp.asarray(feat), jnp.asarray(xy))),
        **SAMPLE_TOL)


@pytest.mark.parametrize("ref_kind", ["point", "box"])
def test_ms_deform_attn_matches_jax(ref_kind):
    """Point and box references with samples off every border of every
    level (zero padding)."""
    heads, pts, d = 2, 3, 16
    shapes = [(6, 8), (3, 4), (2, 1)]
    p = randomized(jg._msda_init(jax.random.PRNGKey(5), d, heads,
                                 len(shapes), pts), 9, 0.3)
    rng = np.random.default_rng(10)
    nq = 40
    q = rng.normal(size=(nq, d)).astype(np.float32)
    ref = rng.uniform(-0.15, 1.15, (nq, 2)).astype(np.float32)
    val = rng.normal(size=(sum(h * w for h, w in shapes), d)).astype(
        np.float32)
    wh = rng.uniform(0.1, 0.9, (nq, 2)).astype(np.float32) \
        if ref_kind == "box" else None
    # The sampling locations reach past each border.
    off = (q @ np.asarray(p["sampling"]["w"]) + np.asarray(
        p["sampling"]["b"])).reshape(nq, heads, len(shapes), pts, 2)
    for li, (h, w) in enumerate(shapes):
        loc = ref[:, None, None] + (off[:, :, li] / np.float32([w, h])
                                    if wh is None else
                                    off[:, :, li] / pts * wh[:, None, None]
                                    * 0.5)
        assert (loc < 0).any(axis=(0, 1, 2)).all()
        assert (loc > 1).any(axis=(0, 1, 2)).all()
    out_j = jg.ms_deform_attn(jnp.asarray(q), jnp.asarray(ref),
                              jnp.asarray(val), shapes, p, heads, pts,
                              ref_wh=None if wh is None else jnp.asarray(wh))
    out_t = tg.ms_deform_attn(torch.tensor(q), torch.tensor(ref),
                              torch.tensor(val), shapes, carry(p), heads, pts,
                              ref_wh=None if wh is None else torch.tensor(wh))
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), **SAMPLE_TOL)


def test_bi_attention_matches_jax(params):
    jp, _ = params
    p = randomized(jp["enc"][0]["bi"], 6)
    rng = np.random.default_rng(7)
    img = rng.normal(size=(30, CFG.dim)).astype(np.float32)
    txt = rng.normal(size=(CFG.max_text_len, CFG.dim)).astype(np.float32)
    mask = np.arange(CFG.max_text_len) < 11
    ri, rt = jg._bi_attention(jnp.asarray(img), jnp.asarray(txt),
                              jnp.asarray(mask), p, CFG.heads)
    gi, gt = tg._bi_attention(torch.tensor(img), torch.tensor(txt),
                              torch.tensor(mask), carry(p), CFG.heads)
    np.testing.assert_allclose(_np(gi), np.asarray(ri), **TOWER_TOL)
    np.testing.assert_allclose(_np(gt), np.asarray(rt), **TOWER_TOL)


def test_sine_embeddings_match_jax():
    rng = np.random.default_rng(8)
    boxes = rng.uniform(0, 1, (7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tg._sine_embed_boxes(torch.tensor(boxes), 16)),
        np.asarray(jg._sine_embed_boxes(jnp.asarray(boxes), 16)),
        **SAMPLE_TOL)
    np.testing.assert_allclose(
        _np(tg._sine_embed_2d(torch.tensor(boxes[:, :2]), 16)),
        np.asarray(jg._sine_embed_2d(jnp.asarray(boxes[:, :2]), 16)),
        **SAMPLE_TOL)


@pytest.mark.parametrize("hw,prompt", [((64, 64), "a red hat"),
                                       ((48, 80), "blue trousers .")])
def test_gdino_ground_matches_jax(params, monkeypatch, hw, prompt):
    """Boxes, scores and logits, and the selected query indices."""
    jp, tp = params
    seen = {}
    top_k = jax.lax.top_k

    def jax_top_k(x, k):
        out = top_k(x, k)
        seen["jax"] = np.asarray(out[1])
        return out

    top_t = tg._top_queries

    def port_top(score, k):
        out = top_t(score, k)
        seen["port"] = _np(out)
        return out

    monkeypatch.setattr(jax.lax, "top_k", jax_top_k)
    monkeypatch.setattr(tg, "_top_queries", port_top)
    img = np.random.default_rng(0).uniform(0, 1, hw + (3,)).astype(np.float32)
    tok, mask = _tok(prompt)
    ref = jg.gdino_ground(jp, jnp.asarray(img), jnp.asarray(tok),
                          jnp.asarray(mask), CFG)
    got = tg.gdino_ground(tp, torch.tensor(img), torch.tensor(tok),
                          torch.tensor(mask), TCFG)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert len(seen["port"]) == CFG.num_queries
    for k in ("boxes", "scores"):
        assert tuple(got[k].shape) == ref[k].shape
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]),
                                   **TOWER_TOL)
    n = int(mask.sum())
    gl, rl = _np(got["logits"]), np.asarray(ref["logits"])
    np.testing.assert_allclose(gl[:, :n], rl[:, :n], **TOWER_TOL)
    np.testing.assert_array_equal(gl[:, n:], rl[:, n:])


def test_top_queries_tie_order():
    """Equal scores: the lower index first, as `jax.lax.top_k`."""
    score = np.asarray([0.5, 0.9, 0.5, 0.9, 0.1, 0.5], np.float32)
    np.testing.assert_array_equal(
        _np(tg._top_queries(torch.tensor(score), 5)),
        np.asarray(jax.lax.top_k(jnp.asarray(score), 5)[1]))


@pytest.mark.parametrize("text", ["a red hat", "The Woman. wearing, shorts",
                                  "x " * 40, "", "über 帽子"])
def test_hash_tokenizer_matches_jax(text):
    for vocab, ml in ((CFG.vocab, CFG.max_text_len), (30522, 256)):
        tj, mj = jg.HashTokenizer(vocab, ml)(text)
        tt, mt = tg.HashTokenizer(vocab, ml)(text)
        assert tt.dtype == tj.dtype and mt.dtype == mj.dtype
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(mt, mj)


@pytest.mark.parametrize("hw", [(90, 70), (32, 48)])
def test_dino_grounder_matches_jax(params, hw):
    """A shrinking and a growing resize to the grounder's 64²."""
    jp, tp = params
    img = np.random.default_rng(4).uniform(0, 1, hw + (3,)).astype(
        np.float32)
    ref = jg.DinoGrounder(jp, CFG, image_size=64).ground(img, "a red hat")
    got = tg.DinoGrounder(tp, TCFG, image_size=64, device=CPU).ground(
        img, "a red hat")
    assert got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=BOX_PX_TOL * max(hw))


def test_dino_grounder_threshold_fallback(params):
    jp, tp = params
    img = np.zeros((32, 48, 3), np.float32)
    ref = jg.DinoGrounder(jp, CFG, image_size=64,
                          box_threshold=1.1).ground(img, "anything")
    got = tg.DinoGrounder(tp, TCFG, image_size=64, box_threshold=1.1,
                          device=CPU).ground(img, "anything")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [0, 0, 48, 32])


def test_grounder_tokenizers_match_jax(params):
    """A WordPiece tokenizer and a `BatchEncoding`-like one (a mapping with
    "input_ids") through `_tokenize`, and the grounder on WordPiece ids."""
    jp, tp = params
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "man", "with", "red",
             "hair", "hat", "##s"]
    jt = jg.DinoGrounder(jp, CFG, tokenizer=jw.WordPieceTokenizer(
        vocab, max_len=CFG.max_text_len))
    tt = tg.DinoGrounder(tp, TCFG, tokenizer=tw.WordPieceTokenizer(
        vocab, max_len=CFG.max_text_len), device=CPU)
    for a, b in zip(tt._tokenize("a man with red hairs"),
                    jt._tokenize("a man with red hairs")):
        np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(1).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(tt.ground(img, "a man with red hair"),
                               jt.ground(img, "a man with red hair"),
                               atol=BOX_PX_TOL * 64)

    def encoding(text):
        return {"input_ids": [[101 % CFG.vocab] + [7] * len(text.split())
                              + [102 % CFG.vocab]]}

    for text in ("a hat", "w " * 30):
        jb = jg.DinoGrounder(jp, CFG, tokenizer=encoding)._tokenize(text)
        tb = tg.DinoGrounder(tp, TCFG, tokenizer=encoding,
                             device=CPU)._tokenize(text)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)


def test_sam_segmenter_with_dino_grounder_matches_jax(params):
    """LangSAM: the GroundingDINO box, then SAM's mask (box ∩ foreground
    with the untrained decoder), equal to the JAX chain."""
    jp, tp = params
    sam_j = js.init_sam_params(jax.random.PRNGKey(1), js.TEST_SAM)
    jseg = js.SAMSegmenter(sam_j, js.TEST_SAM, trust_decoder=False,
                           grounder=jg.DinoGrounder(jp, CFG, image_size=64))
    tseg = ts.SAMSegmenter(
        ts.sam_params_from_numpy(jax.tree_util.tree_map(np.asarray, sam_j)),
        ts.TEST_SAM, trust_decoder=False, device=CPU,
        grounder=tg.DinoGrounder(tp, TCFG, image_size=64, device=CPU))
    img = np.random.default_rng(5).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(tseg.grounder.ground(img, "the hat"),
                               jseg.grounder.ground(img, "the hat"),
                               atol=BOX_PX_TOL * 64)
    mask = tseg.segment(img, "the hat")
    assert mask.dtype == bool and mask.any()
    np.testing.assert_array_equal(mask, jseg.segment(img, "the hat"))


def gdino_state_dict(params):
    """A parameter tree → a state dict in the official
    `groundingdino_swint_ogc.pth` layout (numpy values), as
    `tests/test_gdino.py::TestConverter` writes it."""
    sd = {}

    def put_lin(prefix, lp):
        sd[prefix + ".weight"] = np.asarray(lp["w"]).T.copy()
        sd[prefix + ".bias"] = np.asarray(lp["b"]).copy()

    def put_ln(prefix, lp):
        sd[prefix + ".weight"] = np.asarray(lp["g"]).copy()
        sd[prefix + ".bias"] = np.asarray(lp["b"]).copy()

    def put_mha(prefix, mp):
        sd[prefix + ".in_proj_weight"] = np.concatenate(
            [np.asarray(mp[k]["w"]).T for k in ("q", "k", "v")], 0)
        sd[prefix + ".in_proj_bias"] = np.concatenate(
            [np.asarray(mp[k]["b"]) for k in ("q", "k", "v")], 0)
        put_lin(prefix + ".out_proj", mp["o"])

    def put_msda(prefix, mp):
        put_lin(prefix + ".sampling_offsets", mp["sampling"])
        put_lin(prefix + ".attention_weights", mp["attn_w"])
        put_lin(prefix + ".value_proj", mp["value"])
        put_lin(prefix + ".output_proj", mp["output"])

    def put_box(prefix, bp):
        for i, k in enumerate(("l1", "l2", "l3")):
            put_lin(f"{prefix}.layers.{i}", bp[k])

    sw = params["swin"]
    sd["backbone.0.patch_embed.proj.weight"] = np.asarray(
        sw["patch_proj"]["w"]).transpose(3, 2, 0, 1).copy()
    sd["backbone.0.patch_embed.proj.bias"] = np.asarray(sw["patch_proj"]["b"])
    put_ln("backbone.0.patch_embed.norm", sw["patch_norm"])
    for si, stage in enumerate(sw["stages"]):
        for bi, blk in enumerate(stage["blocks"]):
            bp = f"backbone.0.layers.{si}.blocks.{bi}"
            put_ln(bp + ".norm1", blk["norm1"])
            a = blk["attn"]
            sd[bp + ".attn.qkv.weight"] = np.concatenate(
                [np.asarray(a[k]["w"]).T for k in ("q", "k", "v")], 0)
            sd[bp + ".attn.qkv.bias"] = np.concatenate(
                [np.asarray(a[k]["b"]) for k in ("q", "k", "v")], 0)
            put_lin(bp + ".attn.proj", a["o"])
            sd[bp + ".attn.relative_position_bias_table"] = np.asarray(
                blk["rel_bias"])
            sd[bp + ".attn.relative_position_index"] = np.zeros(3)
            put_ln(bp + ".norm2", blk["norm2"])
            put_lin(bp + ".mlp.fc1", blk["mlp"]["fc1"])
            put_lin(bp + ".mlp.fc2", blk["mlp"]["fc2"])
        if "merge" in stage:
            put_ln(f"backbone.0.layers.{si}.downsample.norm",
                   stage["merge_norm"])
            sd[f"backbone.0.layers.{si}.downsample.reduction.weight"] = \
                np.asarray(stage["merge"]["w"]).T.copy()
    for i in (1, 2, 3):
        put_ln(f"backbone.0.norm{i}", sw["out_norms"][i - 1])

    bt = params["bert"]
    sd["bert.embeddings.word_embeddings.weight"] = np.asarray(bt["tok_emb"])
    sd["bert.embeddings.position_embeddings.weight"] = np.asarray(
        bt["pos_emb"])
    sd["bert.embeddings.token_type_embeddings.weight"] = np.asarray(
        bt["type_emb"])
    sd["bert.embeddings.position_ids"] = np.arange(CFG.max_text_len)
    put_ln("bert.embeddings.LayerNorm", bt["emb_norm"])
    for li, layer in enumerate(bt["layers"]):
        lp = f"bert.encoder.layer.{li}"
        put_lin(lp + ".attention.self.query", layer["attn"]["q"])
        put_lin(lp + ".attention.self.key", layer["attn"]["k"])
        put_lin(lp + ".attention.self.value", layer["attn"]["v"])
        put_lin(lp + ".attention.output.dense", layer["attn"]["o"])
        put_ln(lp + ".attention.output.LayerNorm", layer["attn_norm"])
        put_lin(lp + ".intermediate.dense", layer["mlp"]["fc1"])
        put_lin(lp + ".output.dense", layer["mlp"]["fc2"])
        put_ln(lp + ".output.LayerNorm", layer["mlp_norm"])

    for i, proj in enumerate(params["in_proj"]):
        sd[f"input_proj.{i}.0.weight"] = np.asarray(
            proj["lin"]["w"]).T[:, :, None, None].copy()
        sd[f"input_proj.{i}.0.bias"] = np.asarray(proj["lin"]["b"])
        put_ln(f"input_proj.{i}.1", proj["norm"])
    sd["input_proj.3.0.weight"] = np.asarray(
        params["extra_proj"]["w"]).transpose(3, 2, 0, 1).copy()
    sd["input_proj.3.0.bias"] = np.asarray(params["extra_proj"]["b"])
    put_ln("input_proj.3.1", params["extra_proj"]["norm"])
    sd["transformer.level_embed"] = np.asarray(params["level_emb"])
    put_lin("feat_map", params["feat_map"])
    for li, layer in enumerate(params["enc"]):
        ep = f"transformer.encoder.layers.{li}"
        tp = f"transformer.encoder.text_layers.{li}"
        fp = f"transformer.encoder.fusion_layers.{li}"
        put_msda(ep + ".self_attn", layer["msda"])
        put_ln(ep + ".norm1", layer["msda_norm"])
        put_lin(ep + ".linear1", layer["ffn"]["fc1"])
        put_lin(ep + ".linear2", layer["ffn"]["fc2"])
        put_ln(ep + ".norm2", layer["ffn_norm"])
        put_mha(tp + ".self_attn", layer["txt_attn"])
        put_ln(tp + ".norm1", layer["txt_norm"])
        put_lin(tp + ".linear1", layer["txt_ffn"]["fc1"])
        put_lin(tp + ".linear2", layer["txt_ffn"]["fc2"])
        put_ln(tp + ".norm2", layer["txt_ffn_norm"])
        bi = layer["bi"]
        put_ln(fp + ".layer_norm_v", bi["ln_v"])
        put_ln(fp + ".layer_norm_l", bi["ln_t"])
        for name, k in (("v_proj", "v_proj"), ("l_proj", "t_proj"),
                        ("values_v_proj", "values_v"),
                        ("values_l_proj", "values_t"),
                        ("out_v_proj", "out_v"), ("out_l_proj", "out_t")):
            put_lin(f"{fp}.attn.{name}", bi[k])
        sd[fp + ".gamma_v"] = np.asarray(bi["gamma_v"])
        sd[fp + ".gamma_l"] = np.asarray(bi["gamma_t"])
    put_lin("transformer.enc_output", params["enc_out"]["lin"])
    put_ln("transformer.enc_output_norm", params["enc_out"]["norm"])
    put_box("transformer.enc_out_bbox_embed", params["enc_box"])
    sd["transformer.tgt_embed.weight"] = np.asarray(params["tgt_emb"])
    put_lin("transformer.decoder.ref_point_head.layers.0",
            params["ref_head"]["fc1"])
    put_lin("transformer.decoder.ref_point_head.layers.1",
            params["ref_head"]["fc2"])
    for li, layer in enumerate(params["dec"]):
        dp = f"transformer.decoder.layers.{li}"
        put_mha(dp + ".self_attn", layer["self_attn"])
        put_ln(dp + ".norm2", layer["self_norm"])
        put_mha(dp + ".ca_text", layer["ca_text"])
        put_ln(dp + ".catext_norm", layer["ca_text_norm"])
        put_msda(dp + ".cross_attn", layer["msda"])
        put_ln(dp + ".norm1", layer["msda_norm"])
        put_lin(dp + ".linear1", layer["ffn"]["fc1"])
        put_lin(dp + ".linear2", layer["ffn"]["fc2"])
        put_ln(dp + ".norm3", layer["ffn_norm"])
    put_ln("transformer.decoder.norm", params["dec_norm"])
    put_box("bbox_embed.0", params["bbox_head"])
    put_box("bbox_embed.1", params["bbox_head"])  # a shared-head alias
    return sd


def _assert_trees_equal(got, ref, path="root"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_trees_equal(g, r, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(_np(got), np.asarray(ref), err_msg=path)


@pytest.mark.parametrize("layout", ["plain", "model_prefix", "bert_bert"])
def test_convert_torch_gdino_matches_jax(params, layout):
    """The synthesized official-layout state dict (randomized values, the
    unconsumed buffers and a shared box-head alias included) converts to the
    JAX converter's tree bit for bit, under the checkpoint's `model.` and
    `bert.bert.` key spellings too."""
    jp, _ = params
    sd = gdino_state_dict(randomized(jp, 12))
    if layout == "bert_bert":
        sd = {("bert." + k if k.startswith("bert.") else k): v
              for k, v in sd.items()}
    elif layout == "model_prefix":
        sd = {"model." + k: v for k, v in sd.items()}
    ref = jg.convert_torch_gdino(sd, CFG)
    got = tg.convert_torch_gdino(
        {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, TCFG)
    _assert_trees_equal(got, ref)
    skipped = [k for k in sd if any(u in k for u in GDINO_UNCONSUMED)]
    assert skipped  # the buffers the converter leaves unread are present


def test_make_segmenter_backend_random_names():
    assert isinstance(tf.make_segmenter_backend("heuristic"),
                      HeuristicSegmenter)
    seg = tf.make_segmenter_backend("sam-random", seed=3, device=CPU)
    assert isinstance(seg, ts.SAMSegmenter) and seg.cfg == ts.TEST_SAM
    assert not seg.trust_decoder and type(seg.grounder) is ts.Grounder
    lang = tf.make_segmenter_backend("langsam-random", seed=3, device=CPU)
    assert isinstance(lang.grounder, tg.DinoGrounder)
    assert lang.grounder.cfg == tg.TEST_GDINO
    img = np.ones((48, 40, 3), np.float32)
    img[8:40, 12:28] = 0.4
    for s in (seg, lang):
        mask = s.segment(img, "the hat")
        assert mask.shape == (48, 40) and mask.any()
    with pytest.raises(ValueError, match="unknown segmenter"):
        tf.make_segmenter_backend("lang-sam")
    with pytest.raises(FileNotFoundError):
        tf.make_segmenter_backend("sam", None)
    with pytest.raises(FileNotFoundError):
        tf.make_segmenter_backend("sam", "/nonexistent/sam_vit_h.pth")


@pytest.fixture
def sam_loads(monkeypatch):
    """Record what the "sam" factory path loads, in place of the full-size
    networks: the SAM file and config, the GroundingDINO state dict."""
    seen = {}

    def from_torch_file(cls, path, cfg=ts.SAM_VIT_H, **kw):
        seen.update(path=path, cfg=cfg, **kw)
        return "segmenter"

    def convert(sd, cfg):
        seen["dino_sd"] = sd
        return {"w": torch.zeros(1)}

    monkeypatch.setattr(ts.SAMSegmenter, "from_torch_file",
                        classmethod(from_torch_file))
    monkeypatch.setattr(tg, "convert_torch_gdino", convert)
    return seen


@pytest.mark.parametrize("fname,cfg", [("sam_vit_b_01ec64.pth", "SAM_VIT_B"),
                                       ("sam_vit_l_0b3195.pth", "SAM_VIT_L"),
                                       ("sam_vit_h_4b8939.pth", "SAM_VIT_H"),
                                       ("weights.pth", "SAM_VIT_H")])
def test_make_segmenter_backend_sam_config_by_name(sam_loads, tmp_path,
                                                   fname, cfg):
    path = tmp_path / fname
    path.write_bytes(b"")
    assert tf.make_segmenter_backend("sam", str(path), device=CPU) == \
        "segmenter"
    assert sam_loads["path"] == str(path)
    assert sam_loads["cfg"] == getattr(ts, cfg)
    assert sam_loads["grounder"] is None


def test_make_segmenter_backend_sam_with_dino(sam_loads, tmp_path):
    """The GroundingDINO checkpoint's "model" key is unwrapped; a vocab.txt
    next to the weights (or --dino-vocab) gives a WordPiece tokenizer,
    else a warning and the hash tokenizer; box threshold 0.35 at 800²."""
    sam = tmp_path / "sam_vit_h.pth"
    sam.write_bytes(b"")
    dino_dir = tmp_path / "dino"
    dino_dir.mkdir()
    dino = dino_dir / "groundingdino_swint_ogc.pth"
    torch.save({"model": {"module.x": torch.ones(2)}}, dino)

    with pytest.warns(UserWarning, match="vocab.txt"):
        tf.make_segmenter_backend("sam", str(sam), dino_weights=str(dino),
                                  device=CPU)
    g = sam_loads["grounder"]
    assert sorted(sam_loads["dino_sd"]) == ["module.x"]
    assert isinstance(g, tg.DinoGrounder) and g.cfg == tg.SWIN_T_GDINO
    assert isinstance(g.tokenizer, tg.HashTokenizer)
    assert g.box_threshold == 0.35 and g.image_size == 800

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hat"]
    (dino_dir / "vocab.txt").write_text("\n".join(vocab))
    tf.make_segmenter_backend("sam", str(sam), dino_weights=str(dino),
                              device=CPU)
    tok = sam_loads["grounder"].tokenizer
    assert isinstance(tok, tw.WordPieceTokenizer) and tok.max_len == 256
    other = tmp_path / "bert_vocab.txt"
    other.write_text("\n".join(vocab + ["red"]))
    tf.make_segmenter_backend("sam", str(sam), dino_weights=str(dino),
                              dino_vocab=str(other), device=CPU)
    assert "red" in sam_loads["grounder"].tokenizer.vocab


def test_entry_points_default_to_cuda(params):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card default")
    for call in (lambda: tg.DinoGrounder(params[1], TCFG),
                 lambda: tf.make_segmenter_backend("sam-random")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.cuda
def test_dino_grounder_on_card_matches_cpu(params, cuda_device):
    """gdino_ground on the card against its CPU run (f32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, tp = params
    img = np.random.default_rng(0).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    tok, mask = _tok("a red hat")
    outs = [tg.gdino_ground(tg.gdino_params_from_numpy(
                jax.tree_util.tree_map(_np, tp), dev),
                torch.tensor(img, device=dev), torch.tensor(tok, device=dev),
                torch.tensor(mask, device=dev), TCFG)
            for dev in (CPU, cuda_device)]
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(_np(outs[1][k]), _np(outs[0][k]),
                                   **TOWER_TOL)
    g_cpu = tg.DinoGrounder(tp, TCFG, image_size=64, device=CPU)
    g_card = tg.DinoGrounder(tp, TCFG, image_size=64, device=cuda_device)
    np.testing.assert_allclose(g_card.ground(img, "a hat"),
                               g_cpu.ground(img, "a hat"),
                               atol=BOX_PX_TOL * 64)
