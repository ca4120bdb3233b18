"""The stage-4b refine step: `RefineTrainer.step(view_idx)` of the port in a
closed loop over the turntable views, round after round in one order
drawn from the run's seed (every seed visits every view alike), on a
scene, cameras and target images made from the seed.

The scene is the edit phase's model as `chip_smoke.py` builds it: Gaussians
bound to an icosphere's faces (one at the centroid of a face smaller than
the mean, three inside a larger one), the cap above `editable_cap_z`
editable — flat disks on its faces, as `build_edit_tetgs` makes them — and
the rest frozen keep Gaussians, with colours, opacities and SH drawn from
the seed. Set-up builds the trainer, drives its first check steps through
`step` (they build the kernels), reads their losses, the first gradient
from Adam's state and the change, then steps once over every view so that
each view's layout has been sized before the window, and hands the same
trainer to the window. Once the window has closed and the program is
freed, the plain reference (`benchmark/reference/refine_step.py`) makes
the same steps and the readings are compared."""

from __future__ import annotations

import gc
import math
import sys
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.core import controls, training, window
from benchmark.core.cell import CellRun, Context, SetupLog, seed_words
from benchmark.core.roofline import bound
from benchmark.core.trace import profile
from benchmark.core.weights import Pool

PROFILED_STEPS = 5
BARY_1 = np.array([[1 / 3, 1 / 3, 1 / 3]], np.float32)
BARY_3 = np.array([[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6],
                   [1 / 6, 1 / 6, 2 / 3]], np.float32)
SH_C0 = 0.28209479177387814


def icosphere(subdiv: int, radius: float):
    """(verts (V, 3) f32, faces (F, 3) int64): 20·4^subdiv outward faces
    (`chip_smoke.py:246`)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                        f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mids = v[uniq].mean(axis=1)
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        ab, bc, ca = (len(v) + inv.reshape(3, -1))
        v = np.concatenate([v, mids])
        a, b, c = f.T
        f = np.concatenate([np.stack(x, 1) for x in
                            ((a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca))])
    return (v * radius).astype(np.float32), f.astype(np.int64)


def _bary(verts, faces):
    """Anchors and their faces: one at the centroid of a face smaller than
    the mean area, three inside a larger one (the port's `_bary_points`)."""
    tri = verts[faces]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                         tri[:, 2] - tri[:, 0]), axis=-1)
    three = area >= area.mean()
    one_ids, three_ids = np.flatnonzero(~three), np.flatnonzero(three)
    pts = np.concatenate([
        np.einsum("gk,fkc->fgc", BARY_1, tri[one_ids]).reshape(-1, 3),
        np.einsum("gk,fkc->fgc", BARY_3, tri[three_ids]).reshape(-1, 3)])
    ids = np.concatenate([one_ids, np.repeat(three_ids, 3)])
    return pts.astype(np.float32), ids


def _matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotations → (N, 4) wxyz, w ≥ 0."""
    w = np.sqrt(np.clip(1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2], 0, None)) / 2
    x = np.sqrt(np.clip(1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2], 0, None)) / 2
    y = np.sqrt(np.clip(1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2], 0, None)) / 2
    z = np.sqrt(np.clip(1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2], 0, None)) / 2
    x = np.copysign(x, m[:, 2, 1] - m[:, 1, 2])
    y = np.copysign(y, m[:, 0, 2] - m[:, 2, 0])
    z = np.copysign(z, m[:, 1, 0] - m[:, 0, 1])
    q = np.stack([w, x, y, z], -1)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def make_scene(cfg: Dict, seed: int, device) -> Dict:
    """The edit model's frozen binding and its 2D parameters, as tensors."""
    sc = cfg["scene"]
    verts, faces = icosphere(sc["icosphere_subdiv"], sc["radius"])
    cap = verts[faces].mean(1)[:, 2] > sc["editable_cap_z"]
    pool = Pool(seed, device)
    # Keep Gaussians: isotropic, a third of the anchors' spacing across.
    kpts, kids = _bary(verts, faces)
    kpts, kids = kpts[~cap[kids]], kids[~cap[kids]]
    nk = len(kpts)
    tri = verts[faces]
    edge = np.linalg.norm(tri[:, 1] - tri[:, 0], axis=-1)
    k_r = torch.as_tensor(edge[kids] / 3.0, device=device)
    k_levels = sc["keep_sh_levels"]
    logit = math.log(sc["keep_opacity"] / (1 - sc["keep_opacity"]))
    keep = {
        "keep_xyz": torch.as_tensor(kpts, device=device),
        "keep_log_scales": torch.log(k_r)[:, None].repeat(1, 3),
        "keep_quats": torch.tensor([[1.0, 0, 0, 0]], device=device).repeat(nk, 1),
        "keep_opacity_raw": torch.full((nk, 1), logit, device=device),
        "keep_sh_dc": ((pool.uniform((nk, 1, 3), 0.05, 0.95) - 0.5) / SH_C0),
        "keep_sh_rest": pool.take((nk, k_levels ** 2 - 1, 3)) * sc["sh_rest_std"],
    }
    # Edit disks on the cap's faces (the port's build_edit_tetgs).
    used = np.unique(faces[cap])
    remap = np.zeros(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    ev, ef = verts[used], remap[faces[cap]]
    epts, eids = _bary(ev, ef)
    etri = ev[ef[eids]]
    n = np.cross(etri[:, 1] - etri[:, 0], etri[:, 2] - etri[:, 0])
    v0 = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-8)
    v1 = etri[:, 1] - etri[:, 0]
    v1 = v1 / (np.linalg.norm(v1, axis=-1, keepdims=True) + 1e-8)
    v2 = np.cross(v0, v1)
    v2 = v2 / (np.linalg.norm(v2, axis=-1, keepdims=True) + 1e-8)
    d = np.maximum(np.min(np.linalg.norm(epts[:, None] - etri, axis=-1),
                          axis=1), 1e-7)
    ne = len(epts)
    vn = np.zeros_like(ev)
    for i in range(3):
        np.add.at(vn, ef[:, i], np.cross(ev[ef[:, 1]] - ev[ef[:, 0]],
                                         ev[ef[:, 2]] - ev[ef[:, 0]]))
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    fn = vn[ef[eids]].mean(1)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    e_logit = math.log(sc["edit_opacity"] / (1 - sc["edit_opacity"]))
    binding = dict(keep)
    binding.update({
        "edit_ori": torch.as_tensor(epts, device=device),
        "edit_normals": torch.as_tensor(fn.astype(np.float32), device=device),
        "edit_face_indices": torch.as_tensor(eids.astype(np.int32), device=device),
        "edit_mesh_verts": torch.as_tensor(ev, device=device),
        "edit_mesh_faces": torch.as_tensor(ef.astype(np.int32), device=device),
    })
    params = {
        "delta": torch.zeros((ne, 1), device=device),
        "log_scales": torch.as_tensor(np.log(np.stack(
            [np.full(ne, 1e-8), d, d], -1)).astype(np.float32), device=device),
        "quats": torch.as_tensor(_matrix_to_quat(np.stack([v0, v1, v2], -1)),
                                 device=device),
        "opacity_raw": torch.full((ne, 1), e_logit, device=device),
        "sh_dc": ((pool.uniform((ne, 1, 3), 0.05, 0.95) - 0.5) / SH_C0),
        "sh_rest": torch.zeros((ne, 0, 3), device=device),
    }
    return {"binding": binding, "params": params}


def turntable(cfg: Dict):
    """(R, T, focal) of each turntable view: the port's
    `sample_circle_cameras` (look-at +z up, full framing: focal × 1.4, the
    centre 0.05 below the origin), COLMAP convention."""
    t = cfg["turntable"]
    size = t["size"]
    focal = 1.4 * 0.5 * size / math.tan(0.5 * math.radians(t["fov_deg"]))
    out = []
    for k in range(t["views"]):
        el, az = math.radians(t["elevation_deg"]), math.radians(360.0 * k / t["views"])
        pos = t["radius"] * np.array([math.cos(el) * math.cos(az),
                                      math.cos(el) * math.sin(az), math.sin(el)])
        look = np.array([0.0, 0.0, -0.05]) - pos
        look /= np.linalg.norm(look)
        right = np.cross(look, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, look)
        r_c2w = np.stack([right, up, -look], -1) @ np.diag([1.0, -1.0, -1.0])
        out.append((r_c2w.astype(np.float32),
                    (-r_c2w.T @ pos).astype(np.float32), focal))
    return out


def target_images(cfg: Dict, traffic: Dict, seed: int, device) -> torch.Tensor:
    """(views, H, W, 3) smooth colour fields in [0, 1] from the seed."""
    t = cfg["turntable"]
    g = torch.Generator(device=device).manual_seed(seed)
    c = traffic["image_cells"]
    coarse = torch.rand((t["views"], 3, c, c), generator=g, device=device)
    return torch.stack([F.interpolate(x[None], size=(t["size"], t["size"]),
                                      mode="bilinear", align_corners=False)[0]
                        .permute(1, 2, 0) for x in coarse])


def view_order(seed: int, views: int) -> np.ndarray:
    """One round over the views in an order drawn from the seed; step i
    takes view `order[i % views]`."""
    return np.random.default_rng([seed, 2]).permutation(views)


def build_program(cfg, scene, cams, images, device):
    from youreditableavatar_tpu_torch.models.cameras import GSCamera
    from youreditableavatar_tpu_torch.models.tetgs_edit import (
        EditBinding, EditParams)
    from youreditableavatar_tpu_torch.stages.edit_texture import (
        RefineConfig, RefineTrainer)

    size = cfg["turntable"]["size"]
    b = scene["binding"]
    binding = EditBinding(**b, sh_levels=1, use_delta=False)
    params = EditParams(**{k: v.clone() for k, v in scene["params"].items()})
    gs = [GSCamera(R=r, T=t, fx=f, fy=f, cx=(size - 1) / 2.0,
                   cy=(size - 1) / 2.0, width=size, height=size)
          for r, t, f in cams]
    r = dict(cfg["refine"])
    r["key_views"] = tuple(r["key_views"])
    return RefineTrainer(binding, params, gs,
                         [x for x in images.cpu().numpy()],
                         RefineConfig(**r), device=device)


def build_reference(cfg, scene, cams, images, device, row_dtype=None):
    from benchmark.reference.gs_types import RasterCamera
    from benchmark.reference.refine_step import RefineStep

    size = cfg["turntable"]["size"]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    rcams = []
    for r, t, f in cams:
        view = np.eye(4, dtype=np.float32)
        view[:3, :3], view[:3, 3] = r.T, t
        rcams.append(RasterCamera(viewmat=f32(view), fx=f32(f), fy=f32(f),
                                  cx=f32((size - 1) / 2.0),
                                  cy=f32((size - 1) / 2.0),
                                  width=size, height=size))
    return RefineStep(scene["binding"], scene["params"], rcams, images,
                      cfg["refine"], device, row_dtype)


def program_readings(trainer, order) -> Dict:
    p = trainer.params
    return training.readings(
        lambda k: trainer.step(int(order[k]))[0],
        [getattr(p, n) for n in ("delta", "log_scales", "quats", "opacity_raw",
                                 "sh_dc", "sh_rest")],
        trainer.optimizer, 0.9)


def reference_readings(cfg, scene, cams, images, order, device,
                       row_dtype=None) -> Dict:
    ref = build_reference(cfg, scene, cams, images, device, row_dtype)
    p = ref.params
    out = training.readings(
        lambda k: ref.step(int(order[k]))["loss"],
        [getattr(p, n) for n in ("delta", "log_scales", "quats", "opacity_raw",
                                 "sh_dc", "sh_rest")], ref.optimizer, 0.9)
    out["records"] = ref.records
    return out


def launch_quantities(recs: List[Dict]) -> Dict[str, float]:
    """Per launch (one of each rasterizer kernel a step), the quantities
    the kernels' bounds count (`benchmark/kernels/*.json`), averaged over
    the reference's own renders of its first steps."""
    def mean(k):
        return sum(r[k] for r in recs) / len(recs)

    return {"gaussians": mean("gaussians"), "gs_pairs": mean("num_pairs"),
            "gs_padded_pairs": mean("padded_pairs"), "gs_tiles": mean("tiles"),
            "gs_contrib": mean("n_contrib")}


def least_ms(cfg: Dict, scene: Dict, recs: List[Dict]) -> float:
    """A step's least time: the bytes it cannot avoid — the target image
    read and the render written, the Gaussians' rows read, Adam's words of
    the edit parameters (parameter, gradient, two moments: 7) — against
    its least arithmetic, the compositing's per-(pair, pixel) operations
    forward and backward (27 + 60, the kernels' counts) over the
    contributing evaluations."""
    size = cfg["turntable"]["size"]
    sh = cfg["refine"]["sh_levels"] ** 2
    n_edit = scene["params"]["delta"].shape[0]
    edit_words = n_edit * (1 + 3 + 4 + 1 + 3 * sh)
    gaussians = sum(r["gaussians"] for r in recs) / len(recs)
    contrib = sum(r["n_contrib"] for r in recs) / len(recs)
    moved = 4 * (2 * size * size * 3 + 16 * gaussians + 7 * edit_words)
    return bound(moved, (27 + 60) * contrib)[0]


def run(ctx: Context) -> CellRun:
    cfg, traffic, dev = ctx.config, ctx.workload, ctx.device
    seed = seed_words(ctx.seed)
    log = SetupLog(ctx)
    scene = make_scene(cfg, seed, dev)
    cams = turntable(cfg)
    images = target_images(cfg, traffic, seed, dev)
    views = cfg["turntable"]["views"]
    order = view_order(seed, views)
    log("scene, cameras and targets made")
    trainer = build_program(cfg, scene, cams, images, dev)
    log("trainer built")
    prog = program_readings(trainer, order)
    log(f"{training.CHECK_STEPS} steps")
    losses = []

    def step(i):
        losses.append(trainer.step(int(order[i % views]))[0])

    for i in range(training.CHECK_STEPS, training.CHECK_STEPS + views):
        step(i)
    log(f"a round of {views} views")
    setup_s = ctx.setup_seconds()

    start = training.CHECK_STEPS + views
    window_s, durations = window.step_window(lambda i: step(start + i),
                                             ctx.seconds, dev)
    steps = len(durations)
    step_ms = window.step_ms(window_s, steps)
    metrics = {"step_ms.refine": (step_ms, "ms"), "setup_s": (setup_s, "s")}
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) + sum(
        1 for x in prog["loss"] if not math.isfinite(x))
    trace = None
    if ctx.trace:
        first = start + steps

        def profiled():
            for k in range(PROFILED_STEPS):
                step(first + k)
            return PROFILED_STEPS
        trace = profile(profiled)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    del trainer, step, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_readings(cfg, scene, cams, images, order, dev)
    found = training.gaps(prog, ref)
    for k, v in found.items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    layer = {"unit_ms": step_ms, "durations_ms": durations, "gaps": found,
             "readings": {"program": prog,
                          "reference": {k: ref[k] for k in prog}}}
    if ctx.trace:
        layer["least_ms"] = least_ms(cfg, scene, ref["records"])
        layer["launch_quantities"] = launch_quantities(ref["records"])
    limits = traffic["limits"]
    return CellRun(
        attempted=steps, failed=failed, metrics=metrics,
        checks=[(k, found[k], lim) for k, lim in limits.items()],
        memory_peak_bytes=peak, trace=trace, layer=layer)


class _ReferenceTrainer:
    """The plain reference, the compositing's rows stored in bfloat16,
    behind the trainer's interface."""

    def __init__(self, step):
        self.ref, self.params, self.optimizer = step, step.params, step.optimizer

    def step(self, view_idx):
        return torch.as_tensor(self.ref.step(view_idx)["loss"]), {}


def CONTROL():
    """The reference in the program's place with the compositing's rows
    stored in bfloat16. TF32, the step below the configuration's f32,
    touches none of this step's arithmetic (it reads exactly 0): no
    matmul, and the D-SSIM filter's cuDNN kernels are FFMA ones."""
    return controls.patched(
        sys.modules[__name__], "build_program",
        lambda cfg, scene, cams, images, device: _ReferenceTrainer(
            build_reference(cfg, scene, cams, images, device,
                            row_dtype=torch.bfloat16)))


def _state_unchanged():
    from youreditableavatar_tpu_torch.stages import edit_texture

    make = edit_texture.make_edit_optimizer

    def frozen(params, lr_sh, lr_opacity, mask):
        opt = make(params, lr_sh, lr_opacity, mask)
        opt.__class__ = controls.frozen_state(torch.optim.Adam)
        return opt
    return controls.patched(edit_texture, "make_edit_optimizer", frozen)


def _half_batch():
    """The loss over the top half of the image's rows only."""
    from youreditableavatar_tpu_torch.stages import edit_texture

    loss = edit_texture.l1_dssim

    def half(pred, target, factor):
        h = pred.shape[0] // 2
        return loss(pred[:h], target[:h], factor)
    return controls.patched(edit_texture, "l1_dssim", half)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch}
