"""The stage-3 localization call: `LocalMeshEditing.localize` of the port
through the factory's LangSAM at published widths (`make_segmenter_backend(
"langsam-vit-h-random")`: GroundingDINO Swin-T at 800², SAM ViT-H at 1024²,
the decoder's mask), whole calls back to back over the same probe renders
of the mesh, a garment prompt drawn from the seed for each call.

The weights are drawn on the card from the seed by the plain reference's
inits (`make_weights`) and put into the segmenter the factory built, once
their tree is laid out as the program's. Each call hands what it computed
through the segmenter's and the grounder's `taps`; the taps of one call,
drawn from the seed as the calls are made, are kept. Once the window has
closed and the program's objects are freed, the plain reference
(`benchmark/reference/grounding_dino.py`, `sam.py`, `localization.py`)
redoes that call from the same weights and images: the grounder's boxes
and logits with the program's own top-900 picks handed in (a near tie
among the scores would otherwise reorder the queries) and the box it
keeps, SAM's low-resolution mask logits and its mask from the program's
box, and the face mask back-projected from the program's 2D masks."""

from __future__ import annotations

import gc
import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import compare, controls, window
from benchmark.core.cell import CellRun, Context, SetupLog, seed_words, tuples
from benchmark.core.roofline import bound
from benchmark.core.trace import profile
from benchmark.core.weights import Pool
from benchmark.entries.tetgs_refine import icosphere

# The inputs' index of the set-up call: one the window never reaches.
WARMUP_CALL = 1 << 30
# A gap where the program handed nothing over for a view.
MISSING = 1.0
CHECKS = ("sam_logit_gap", "mask_gap", "dino_box_gap", "dino_logit_gap",
          "box_gap", "face_mask_gap")
# The scale of the image-text fusion's layer scales (`gamma_v`, `gamma_t`),
# drawn at random: the published init's 1e-4 would leave the fusion's
# residual under every limit; trained, the fusion carries the text into
# the image tokens.
FUSION_GAMMA_SCALE = 0.1


def prompt_of(traffic: Dict, seed: int, call: int) -> str:
    rng = np.random.default_rng([seed, call])
    return traffic["prompts"][int(rng.integers(len(traffic["prompts"])))]


def make_mesh(cfg: Dict):
    return icosphere(cfg["scene"]["icosphere_subdiv"], cfg["scene"]["radius"])


def probe_cameras(cfg: Dict):
    from youreditableavatar_tpu_torch.models.cameras import (
        sample_ring_cameras)

    p = cfg["probes"]
    return sample_ring_cameras(radius=p["radius"], elevations=p["elevations"],
                               counts=p["counts"], fov_deg=p["fov_deg"],
                               height=p["size"], width=p["size"])


def reference_cameras(cfg: Dict):
    from benchmark.reference.localization import ring_cameras

    p = cfg["probes"]
    return ring_cameras(p["radius"], p["elevations"], p["counts"],
                        p["fov_deg"], p["size"])


def render_probes(verts, faces, cams, cfg: Dict, device) -> List[np.ndarray]:
    """The port's renders of the mesh on white, as host (S, S, 3) float
    arrays: a smooth colour field over the surface, Lambert-shaded."""
    from youreditableavatar_tpu_torch.ops.mesh_raster import (
        MeshRasterConfig, rasterize_mesh)

    v = torch.tensor(verts, device=device)
    f = torch.tensor(faces.astype(np.int32), device=device)
    tri = v[f.long()]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    light = torch.tensor([0.3, 0.2, 1.0], device=device)
    shade = 0.35 + 0.65 * (n @ (light / light.norm())).clamp_min(0.0)
    phase = torch.tensor([0.0, 2.1, 4.2], device=device)
    albedo = 0.55 + 0.35 * torch.sin(3.0 * tri.mean(1) + phase)
    colour = albedo * shade[:, None]
    mcfg = MeshRasterConfig(**cfg["mesh_raster"])
    images = []
    for cam in cams:
        fid = rasterize_mesh(v, f, cam.raster_camera(device), mcfg).face_id
        img = torch.ones(fid.shape + (3,), device=device)
        img[fid >= 0] = colour[fid[fid >= 0].long()]
        images.append(img.cpu().numpy())
    return images


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """SAM's and GroundingDINO's trees, drawn on the card through one pool
    by the reference's inits, the fusion's layer scales at
    `FUSION_GAMMA_SCALE`. Each leaf is copied out of the pool, whose last
    block would otherwise hold ~1 GiB of unused draws all run."""
    from benchmark.reference import grounding_dino, sam

    scfg, gcfg = _configs(cfg)
    pool = Pool(seed, device)
    w = {"sam": sam.init_sam_params(pool, scfg),
         "dino": grounding_dino.init_gdino_params(pool, gcfg)}
    for layer in w["dino"]["enc"]:
        bi = layer["bi"]
        for k in ("gamma_v", "gamma_t"):
            bi[k] = pool.take(tuple(bi[k].shape)) * FUSION_GAMMA_SCALE
    return _copied(w)


def _copied(tree):
    if isinstance(tree, dict):
        return {k: _copied(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copied(v) for v in tree]
    return tree.clone()


def _layout(tree):
    """A parameter tree's structure, each leaf by its shape."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    return tuple(tree.shape)


def build_program(cfg: Dict, seed: int, device, verts, faces, weights):
    """The port's `LocalMeshEditing` over the factory's LangSAM, its
    weights replaced by `weights`."""
    from youreditableavatar_tpu_torch.guidance.factory import (
        make_segmenter_backend)
    from youreditableavatar_tpu_torch.guidance.grounding_dino import (
        GDINOConfig)
    from youreditableavatar_tpu_torch.guidance.sam import SAMConfig
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
    from youreditableavatar_tpu_torch.stages.localization import (
        LocalizationConfig, LocalMeshEditing)

    seg = make_segmenter_backend("langsam-vit-h-random", seed=seed,
                                 device=device)
    g = cfg["grounder"]
    if (seg.cfg, seg.grounder.cfg, seg.grounder.image_size,
            seg.grounder.box_threshold) != (
            SAMConfig(**tuples(cfg["sam"])),
            GDINOConfig(**tuples(cfg["gdino"])), g["image_size"],
            g["box_threshold"]):
        raise ValueError("the factory's LangSAM is not the configuration's")
    for owner, key in ((seg, "sam"), (seg.grounder, "dino")):
        if _layout(owner.params) != _layout(weights[key]):
            raise ValueError(f"the drawn {key} tree is not laid out as the "
                             "program's")
        owner.params = weights[key]
    lcfg = LocalizationConfig(
        **cfg["localization"], mesh_cfg=MeshRasterConfig(**cfg["mesh_raster"]))
    return LocalMeshEditing(verts, faces, seg, lcfg, device=device)


def _configs(cfg: Dict):
    from benchmark.reference import grounding_dino, sam

    return (sam.SAMConfig(**tuples(cfg["sam"])),
            grounding_dino.GDINOConfig(**tuples(cfg["gdino"])))


def reference_call(cfg: Dict, weights, images, prompt: str, device,
                   picks=None, boxes=None) -> List[Dict]:
    """The plain reference's outputs of every view: the grounder's
    (`dino`) and the box it keeps (`box`); SAM's low-resolution mask
    logits (`low`) and (H, W) mask (`mask`) from that box. With `picks`
    and `boxes` (the program's, per view), the grounder takes those
    tokens and SAM that box."""
    from benchmark.reference import grounding_dino, sam

    scfg, gcfg = _configs(cfg)
    g = cfg["grounder"]
    out = []
    for v, img in enumerate(images):
        dino, box = grounding_dino.ground(
            weights["dino"], gcfg, img, prompt, g["image_size"],
            g["box_threshold"], device,
            picks=None if picks is None else picks[v])
        low, logits = sam.mask_logits(
            weights["sam"], scfg, img, box if boxes is None else boxes[v],
            device)
        out.append({"dino": dino, "box": box, "low": low,
                    "mask": logits > 0.0})
    return out


def reference_faces(cfg: Dict, verts, faces, masks, device) -> np.ndarray:
    from benchmark.reference.localization import backproject
    from benchmark.reference.mesh_raster import MeshRasterConfig

    return backproject(verts, faces, reference_cameras(cfg), masks,
                       MeshRasterConfig(**cfg["mesh_raster"]),
                       device=device, **cfg["localization"])


def token_count(cfg: Dict, prompt: str) -> int:
    from benchmark.reference.grounding_dino import HashTokenizer

    _, gcfg = _configs(cfg)
    return int(HashTokenizer(gcfg.vocab, gcfg.max_text_len)(prompt)[1].sum())


def box_gap(cfg: Dict, dino: Dict, box: np.ndarray, size, tie: float) -> float:
    """The program's kept xyxy box against the nearest of those the
    reference may keep (its best query's, and any whose score is within
    `tie` of the best or of the threshold), as max |Δ| over the image's
    longer side."""
    from benchmark.reference.grounding_dino import kept_boxes

    h, w = size
    return min(float(np.abs(box - k).max()) for k in kept_boxes(
        dino, h, w, cfg["grounder"]["box_threshold"], tie)) / max(h, w)


def gaps(cfg: Dict, weights, images, prompt: str, taps: Dict, faces_prog,
         verts, faces, limits: Dict, device) -> Dict[str, float]:
    """The checks of one call, its taps against the reference."""
    views = len(images)
    if len(taps["sam"]) != views or len(taps["dino"]) != views or any(
            "mask" not in t for t in taps["sam"]):
        return dict.fromkeys(CHECKS, MISSING)
    ref = reference_call(cfg, weights, images, prompt, device,
                         picks=[t["top"] for t in taps["dino"]],
                         boxes=[t["box"] for t in taps["sam"]])
    n = token_count(cfg, prompt)
    out = dict.fromkeys(CHECKS, 0.0)
    for r, d, s, img in zip(ref, taps["dino"], taps["sam"], images):
        dino = r["dino"]
        logits = dino["logits"][:, :n]
        # A score the program may read differently, by the logit limit at
        # the sigmoid's steepest.
        tie = 0.5 * limits["dino_logit_gap"] * float(logits.abs().max())
        found = {
            "dino_box_gap": compare.image_gap(d["boxes"], dino["boxes"]),
            "dino_logit_gap": compare.image_gap(d["logits"][:, :n], logits),
            "box_gap": box_gap(cfg, dino, d["box"], img.shape[:2], tie),
            "sam_logit_gap": compare.image_gap(s["masks"], r["low"]),
            "mask_gap": float((s["mask"].to(r["mask"].device)
                               != r["mask"]).float().mean()),
        }
        for k, v in found.items():
            out[k] = max(out[k], v)
    masks = [s["mask"].cpu().numpy() for s in taps["sam"]]
    ref_faces = reference_faces(cfg, verts, faces, masks, device)
    out["face_mask_gap"] = float(np.mean(ref_faces != (faces_prog > 0.5)))
    return out


def least_ms(weights, flops: float, views: int) -> float:
    """One call's least time: its FLOPs (counted on the reference's
    networks) at the f32 rate, or both networks' weights read once a
    view."""
    from benchmark.reference.sd_layers import tree_numel

    moved = 4 * views * (tree_numel(weights["sam"]) + tree_numel(
        weights["dino"]))
    return bound(moved, flops)[0]


def _nonfinite(taps: Dict) -> torch.Tensor:
    """Whether an output of the call is not finite, as a flag on the
    device (read after the window)."""
    outs = [t[k] for t in taps["dino"] for k in ("boxes", "logits")]
    outs += [t["masks"] for t in taps["sam"]]
    return torch.stack([~torch.isfinite(x).all() for x in outs]).any()


def run(ctx: Context) -> CellRun:
    from youreditableavatar_tpu_torch.utils.profiling import counting

    cfg, traffic, dev = ctx.config, ctx.workload, ctx.device
    seed = seed_words(ctx.seed)
    log = SetupLog(ctx)
    verts, faces = make_mesh(cfg)
    cams = probe_cameras(cfg)
    images = render_probes(verts, faces, cams, cfg, dev)
    log(f"{len(images)} probe views rendered")
    weights = make_weights(cfg, seed, dev)
    loc = build_program(cfg, seed, dev, verts, faces, weights)
    seg = loc.segmenter
    if dev.type == "cuda":
        # The factory's own draws and the pool are gone: the peak is what
        # the calls hold from here.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    log("LangSAM built")

    def localize(i):
        taps = {"sam": [], "dino": []}
        seg.taps, seg.grounder.taps = taps["sam"], taps["dino"]
        info = loc.localize(cams, images, prompt_of(traffic, seed, i))
        return taps, info["editing_mask_faces"]

    with counting() as counts:
        localize(WARMUP_CALL)
    log("a call")
    print("counts of a call: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())), file=sys.stderr)
    setup_s = ctx.setup_seconds()

    # One call's taps are kept, each call of the window with the same
    # chance (a reservoir of one); the others' are dropped once their
    # outputs are checked for finiteness on the device.
    pick = np.random.default_rng([seed, 1])
    kept, nonfinite = {}, []

    def timed(i):
        taps, fmask = localize(i)
        nonfinite.append(_nonfinite(taps))
        if pick.random() * (i + 1) < 1.0:
            kept.update(call=i, taps=taps, faces=fmask)

    window_s, calls = window.call_window(timed, ctx.seconds, dev)
    metrics = {"step_ms": (window.step_ms(window_s, calls), "ms"),
               "setup_s": (setup_s, "s")}
    failed = int(torch.stack(nonfinite).sum())
    trace = None
    if ctx.trace:
        def profiled():
            localize(calls)
            return 1
        trace = profile(profiled)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    seg.taps = seg.grounder.taps = None
    del loc, seg
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    found = gaps(cfg, weights, images,
                 prompt_of(traffic, seed, kept["call"]), kept["taps"],
                 kept["faces"], verts, faces, traffic["limits"], dev)
    for k, v in found.items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    layer = {"unit_ms": metrics["step_ms"][0], "gaps": found,
             "counts": dict(counts)}
    if ctx.trace:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            reference_call(cfg, weights, images, prompt_of(traffic, seed, 0),
                           dev)
        layer["least_ms"] = least_ms(weights, counter.get_total_flops(),
                                     len(images))
    return CellRun(
        attempted=calls, failed=failed, metrics=metrics,
        checks=[(k, found[k], traffic["limits"][k]) for k in CHECKS],
        memory_peak_bytes=peak, trace=trace, layer=layer)


class _ReferenceLocalizer:
    """The plain reference with TF32 on, behind the program's interface:
    the program's segmenter keeps its weights and its taps."""

    def __init__(self, program, cfg: Dict):
        self.segmenter, self.cfg = program.segmenter, cfg
        self.verts, self.faces = program.verts, program.faces
        self.device = program.device

    def localize(self, cameras, images, prompt):
        seg = self.segmenter
        weights = {"sam": seg.params, "dino": seg.grounder.params}
        with controls.tf32():
            out = reference_call(self.cfg, weights, images, prompt,
                                 self.device)
            for r in out:
                seg.grounder.taps.append({**r["dino"], "box": r["box"]})
                seg.taps.append({"box": r["box"], "masks": r["low"],
                                 "mask": r["mask"]})
            fmask = reference_faces(self.cfg, self.verts, self.faces,
                                    [r["mask"].cpu().numpy() for r in out],
                                    self.device)
        return {"editing_mask_faces": fmask.astype(np.float64)}


def CONTROL():
    """The reference in the program's place, computed with TF32 on: the
    nearest precision below the configuration's f32."""
    build = build_program
    return controls.patched(
        sys.modules[__name__], "build_program",
        lambda cfg, seed, device, verts, faces, weights: _ReferenceLocalizer(
            build(cfg, seed, device, verts, faces, weights), cfg))


def _global_blocks_windowed():
    """SAM's global-attention blocks run as windowed ones."""
    import dataclasses

    from youreditableavatar_tpu_torch.guidance import sam

    encode = sam.sam_encode_image
    return controls.patched(
        sam, "sam_encode_image", lambda params, image, cfg: encode(
            params, image, dataclasses.replace(cfg, global_idx=())))


def _one_level_sampled():
    """Deformable attention samples the first level of the pyramid only:
    the others contribute nothing."""
    from youreditableavatar_tpu_torch.guidance import grounding_dino

    sample = grounding_dino._bilinear_sample_heads
    levels = grounding_dino.SWIN_T_GDINO.levels
    calls = [0]

    def first_level(feat, xy):
        out = sample(feat, xy)
        calls[0] += 1
        return out if calls[0] % levels == 1 else torch.zeros_like(out)
    return controls.patched(grounding_dino, "_bilinear_sample_heads",
                            first_level)


def _fusion_skipped():
    """The encoder's image-text fusion passes both sides on unchanged."""
    from youreditableavatar_tpu_torch.guidance import grounding_dino

    return controls.patched(grounding_dino, "_bi_attention",
                            lambda img, txt, txt_mask, p, h: (img, txt))


def _lowest_score_kept():
    """The grounder keeps the box of the lowest score, not the highest
    (its scores handed over as 1 - score)."""
    from youreditableavatar_tpu_torch.guidance import grounding_dino

    ground = grounding_dino.gdino_ground

    def flipped(*args, **kw):
        out = ground(*args, **kw)
        return {**out, "scores": 1.0 - out["scores"]}
    return controls.patched(grounding_dino, "gdino_ground", flipped)


def _crop_off_by_one():
    """SAM's low-resolution mask is cropped one cell short on each side
    before it is resized to the image."""
    from youreditableavatar_tpu_torch.stages import edit_texture

    resize = edit_texture._resize_bilinear

    def short(img, height, width):
        return resize(img[:-1, :-1] if img.dim() == 2 else img, height, width)
    return controls.patched(edit_texture, "_resize_bilinear", short)


def _half_views_backprojected():
    """Every second view is left out of the back-projection."""
    from youreditableavatar_tpu_torch.stages.localization import (
        LocalMeshEditing)

    back = LocalMeshEditing._backproject
    calls = [0]

    def half(self, *args):
        calls[0] += 1
        if calls[0] % 2:
            back(self, *args)
    return controls.patched(LocalMeshEditing, "_backproject", half)


FAULTS = {"global_blocks_windowed": _global_blocks_windowed,
          "one_level_sampled": _one_level_sampled,
          "fusion_skipped": _fusion_skipped,
          "lowest_score_kept": _lowest_score_kept,
          "crop_off_by_one": _crop_off_by_one,
          "half_views_backprojected": _half_views_backprojected}
