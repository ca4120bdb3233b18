"""`LocalMeshEditing.localize` through the factory's LangSAM
(`make_segmenter_backend("langsam-vit-h-random")`: SAM and GroundingDINO
as the "sam" backend runs them, on random weights) against the
benchmark's plain reference copies (`benchmark/reference/sam.py`,
`grounding_dino.py`, `localization.py`), at the TEST_SAM / TEST_GDINO
widths on the CPU (the factory's published configurations set to them
for the test); the published widths' parameter counts and the reference
inits' layout, counted without drawing the weights; one call's span tree
and counters; the floater removal against the JAX package's.

The scene is the `localize.langsam` cell's, cut as
`benchmark/tests/tiny_localize.py` cuts it: three 64² probes of a 320-face
icosphere, the grounder at its 800²; the weights are the cell's, drawn
by the reference's inits."""

import numpy as np
import pytest
import torch

from benchmark.entries import langsam_localize as entry
from benchmark.tests import tiny, tiny_localize
from youreditableavatar_tpu_torch.guidance import grounding_dino as tg
from youreditableavatar_tpu_torch.guidance import sam as ts
from youreditableavatar_tpu_torch.guidance.factory import (
    make_segmenter_backend)
from youreditableavatar_tpu_torch.guidance.manifests import sam_manifest
from youreditableavatar_tpu_torch.guidance.sd_layers import tree_numel
from youreditableavatar_tpu_torch.utils.profiling import (
    count, counting, recording, take_spans)

CPU = torch.device("cpu")
SEED = 2**31 + 11
PROMPT = "the shirt"
GDINO_SWIN_T_PARAMS = 168_108_034  # the JAX package's init tree


@pytest.fixture(scope="module")
def call():
    """One recorded and counted call, with what the segmenter and the
    grounder handed over."""
    cfg = tiny_localize.localize_config()
    verts, faces = entry.make_mesh(cfg)
    cams = entry.probe_cameras(cfg)
    images = entry.render_probes(verts, faces, cams, cfg, CPU)
    weights = entry.make_weights(cfg, SEED, CPU)
    with tiny_localize.published_widths(cfg):
        loc = entry.build_program(cfg, SEED, CPU, verts, faces, weights)
    seg = loc.segmenter
    taps = {"sam": [], "dino": []}
    seg.taps, seg.grounder.taps = taps["sam"], taps["dino"]
    take_spans()
    with recording(), counting() as counts:
        info = loc.localize(cams, images, PROMPT)
    spans = take_spans()
    seg.taps = seg.grounder.taps = None
    return dict(cfg=cfg, verts=verts, faces=faces, images=images, loc=loc,
                weights=weights, taps=taps, info=info, spans=spans,
                counts=counts)


def test_the_factory_builds_langsam_as_the_sam_backend_runs_it(call):
    seg = call["loc"].segmenter
    assert isinstance(seg, ts.SAMSegmenter)
    assert isinstance(seg.grounder, tg.DinoGrounder)
    assert seg.trust_decoder and not seg.multimask
    g = seg.grounder
    assert (g.image_size, g.box_threshold) == (800, 0.35)
    assert isinstance(g.tokenizer, tg.HashTokenizer)
    assert seg.cfg == ts.TEST_SAM and g.cfg == tg.TEST_GDINO
    assert seg.params is call["weights"]["sam"]
    assert g.params is call["weights"]["dino"]
    # The fusion's layer scales are drawn, not left at the init's 1e-4.
    gamma = call["weights"]["dino"]["enc"][0]["bi"]["gamma_v"]
    assert float(gamma.abs().mean()) > 10 * 1e-4


def test_build_program_refuses_weights_laid_out_otherwise(call):
    c = call
    weights = dict(c["weights"], sam=dict(c["weights"]["sam"]))
    weights["sam"]["prompt"] = dict(weights["sam"]["prompt"])
    weights["sam"]["prompt"]["no_mask"] = torch.zeros(2, 3)
    with tiny_localize.published_widths(c["cfg"]), \
            pytest.raises(ValueError, match="laid out"):
        entry.build_program(c["cfg"], SEED, CPU, c["verts"], c["faces"],
                            weights)


def test_localize_matches_the_reference_copies(call):
    """SAM's mask logits and mask from the program's box, the grounder's
    boxes and logits under the program's picks and the box it keeps, and
    the face mask back-projected from the program's 2D masks, against the
    plain reference."""
    c = call
    limits = tiny.load("workloads", "localize.langsam")["limits"]
    found = entry.gaps(c["cfg"], c["weights"], c["images"], PROMPT,
                       c["taps"], c["info"]["editing_mask_faces"], c["verts"],
                       c["faces"], limits, CPU)
    assert all(found[k] <= limits[k] for k in entry.CHECKS), found
    assert found["face_mask_gap"] == 0.0
    fmask = c["info"]["editing_mask_faces"] > 0.5
    assert 0 < fmask.sum() < len(c["faces"])
    # Left to itself, the reference selects the same tokens and keeps the
    # same box.
    ref = entry.reference_call(c["cfg"], c["weights"], c["images"], PROMPT,
                               CPU)
    for r, d, s in zip(ref, c["taps"]["dino"], c["taps"]["sam"]):
        assert torch.equal(r["dino"]["top"], d["top"])
        np.testing.assert_array_equal(r["box"], d["box"])
        assert torch.equal(r["mask"], s["mask"])


def test_published_widths_give_the_official_parameter_counts():
    """SAM ViT-H as the official checkpoint (`sam_manifest`, less the
    mask-prompt path) and GroundingDINO Swin-T as the JAX tree, counted
    on fake tensors: nothing is drawn."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        seg = make_segmenter_backend("langsam-vit-h-random", seed=SEED,
                                     device="cpu")
    assert seg.cfg == ts.SAM_VIT_H and seg.grounder.cfg == tg.SWIN_T_GDINO
    official = sum(int(np.prod(s))
                   for s in sam_manifest(ts.SAM_VIT_H).values())
    assert tree_numel(seg.params) == official
    assert tree_numel(seg.grounder.params) == GDINO_SWIN_T_PARAMS
    # The cell's weights, drawn by the reference's inits from the config,
    # are laid out as the factory's.
    cfg = tiny.load("configs", "langsam_localize")
    with FakeTensorMode():
        weights = entry.make_weights(cfg, SEED, CPU)
    assert entry._layout(weights["sam"]) == entry._layout(seg.params)
    assert entry._layout(weights["dino"]) == entry._layout(
        seg.grounder.params)


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


def test_one_call_records_one_root_and_its_tree(call):
    spans, views = call["spans"], len(call["images"])
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["localize.call"]
    top = _children(spans, roots[0])
    assert [spans[i].name for i in top] == (
        ["localize.segment", "localize.backproject"] * views
        + ["localize.regions"])
    gcfg, scfg = tg.TEST_GDINO, ts.TEST_SAM
    for i in top[:-1:2]:
        inner = _children(spans, i)
        assert [spans[j].name for j in inner] == ["gdino", "sam.encode",
                                                  "sam.decode"]
        gd, enc, _ = inner
        assert [spans[j].name for j in _children(spans, gd)] == \
            ["gdino.msda"] * (gcfg.enc_layers + gcfg.dec_layers)
        assert [spans[j].name for j in _children(spans, enc)] == \
            ["sam.global"] * len(scfg.global_idx)
    for i in top[1::2]:
        assert _children(spans, i) == []


def test_the_counters_carry_the_widths(call):
    """Blocks and deformable-attention calls by the configuration; tokens
    per level of GroundingDINO's 800² pyramid; every byte handed between
    host and device."""
    c, views = call["counts"], len(call["images"])
    gcfg, scfg = tg.TEST_GDINO, ts.TEST_SAM
    msda = views * (gcfg.enc_layers + gcfg.dec_layers)
    assert c["localize.views"] == views
    assert c["sam.global_blocks"] == views * len(scfg.global_idx)
    assert c["sam.window_blocks"] == views * (scfg.depth
                                              - len(scfg.global_idx))
    assert c["gdino.msda_calls"] == msda
    for level, side in enumerate((100, 50, 25, 13)):
        assert c[f"gdino.msda_tokens.l{level}"] == msda * side * side
    size = call["images"][0].shape[0]
    verts, faces = call["verts"], call["faces"]
    t = gcfg.max_text_len
    assert c["h2d_bytes"] == 12 * (len(verts) + len(faces)) + views * (
        12 * size * size + 16 + 5 * t)
    kept = sum(float(d["scores"].max()) >= 0.35 for d in call["taps"]["dino"])
    # The scores and the kept box of each view; the face mask once a call.
    assert c["d2h_bytes"] == views * 4 * gcfg.num_queries + 16 * kept \
        + len(faces)


def test_counters_count_only_inside_a_block():
    count("x")
    with counting() as outer:
        count("x", 2)
        with counting() as inner:
            count("x", 3)
        count("y")
    count("x")
    assert outer == {"x": 5, "y": 1} and inner == {"x": 3}


@pytest.mark.parametrize("share", [0.05, 0.5, 1.0])
def test_floater_components_are_the_union_finds(share):
    """`face_components` through scipy gives the partition of the JAX
    package's union-find, and `remove_floaters` keeps the same faces, on
    random selections of a sphere's faces."""
    from youreditableavatar_tpu.stages import export as ref
    from youreditableavatar_tpu_torch.stages import export

    verts, faces = entry.icosphere(4, 0.8)
    sel = faces[np.random.default_rng(7).random(len(faces)) < share]
    got = export.face_components(sel, len(verts))
    want = ref.face_components(sel, len(verts))
    assert len(set(zip(got, want))) == len(set(got)) == len(set(want))
    np.testing.assert_array_equal(export.remove_floaters(verts, sel, 0.1),
                                  ref.remove_floaters(verts, sel, 0.1))
