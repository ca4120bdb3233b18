"""Stages 0–1 — SDF shape initialization + localized SDS geometry editing.

Counterpart of `youreditableavatar_tpu/stages/spatial.py`:

  * `ShapeInitializer.run`: phase A regresses the field to the signed
    distance of the anchor-aligned body mesh (the native `MeshSDF` BVH over
    a pre-sampled point pool), phase B refines with rendered-normal L1
    against the mesh's own normal maps from random cameras plus a strong
    SDF anchor term.
  * `HumanEditTrainer`: per step — sample a local+global camera pair,
    extract the partitioned update surface, render normal maps, SDS on the
    local OR global normal map, the keep-region recon loss, the control-SDF
    loss and normal consistency, all with `C()` schedules; AdamW. With
    `use_sds=False` (the "du" edit mode, an `SDSDUGuidance`) the SDS term
    becomes latent-MSE + L1 + perceptual pulls toward a cached
    multi-step-denoised edit of the current render, one cache entry per
    azimuth bucket, refreshed every `per_editing_step` steps.

Each step runs on the device of the geometry (the hash-grid backward is
K4, every normal map's z-buffer resolve K5). On a CUDA device the step's
geometry — the surface and its normal maps (`edit.render`), and the recon,
control and normal-consistency terms (`edit.losses`) — runs as CUDA graph
replays, forward and backward (`utils/cuda_graphs.GraphedChain`), of the
same functions that run eagerly elsewhere; a graph is captured for each
`graph_key` the first time a step needs it. The guidance, the per-step
weights and the sum into the loss stay eager.

Randomness has one seam per trainer. Every draw the JAX code makes from a
PRNG key comes from one method that returns it as a tensor:
`ShapeInitializer.draw` (the pool seed and each step's pool indices) and
`HumanEditTrainer.draws` (each step's SDS timestep and noise, its recon
indices and, in the du mode, the cache refresh's timestep), from a
`torch.Generator` seeded by (seed, phase, step). Camera and host-side
draws are numpy, as in the JAX package.

`HumanEditTrainer.save_checkpoint` / `restore_checkpoint` resume a run
mid-curriculum: a resumed run makes the steps an uninterrupted one makes.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch import _kernels
from youreditableavatar_tpu_torch.data.camera_sampler import (
    RandomCameraConfig,
    RandomCameraSampler,
)
from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
from youreditableavatar_tpu_torch.guidance.sds import (
    SDSGuidance,
    draw_timestep_noise,
)
from youreditableavatar_tpu_torch.models.geometry import Partition, TetGeometry
from youreditableavatar_tpu_torch.models.part_renderer import (
    normal_consistency,
    render_geometry_maps,
    render_part_maps,
)
from youreditableavatar_tpu_torch.models.sdf import SDFField, SDFParams
from youreditableavatar_tpu_torch.native import MeshSDF
from youreditableavatar_tpu_torch.ops.gaussian_raster import (
    BudgetGovernor,
    RasterCamera,
)
from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
from youreditableavatar_tpu_torch.utils.cuda_graphs import GraphedChain
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.optim import parse_optimizer
from youreditableavatar_tpu_torch.utils.profiling import span
from youreditableavatar_tpu_torch.utils.registry import register
from youreditableavatar_tpu_torch.utils.schedule import C, ScheduleSpec


def _generator(*key: int) -> torch.Generator:
    """A CPU generator seeded by a tuple of ints."""
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


def align_anchor_mesh(
    verts: np.ndarray,
    anchor_verts: Optional[np.ndarray] = None,
    shape_init_params: float = 0.9,
    y_offset: float = 0.3,
) -> Tuple[np.ndarray, Dict[str, Any]]:
    """`convert_mesh_init` mesh-side chain (`cameras.py:225-270`)."""
    anchor = verts if anchor_verts is None else anchor_verts
    centroid = anchor.mean(0)
    v = verts - centroid
    v = v.copy()
    v[:, 1] += y_offset
    x_ = np.array([0.0, 0.0, 1.0])  # front +z
    z_ = np.array([0.0, 1.0, 0.0])  # up +y
    y_ = np.cross(z_, x_)
    std2mesh = np.stack([x_, y_, z_], axis=0).T
    mesh2std = np.linalg.inv(std2mesh)
    scale = np.abs(v).max()
    v = v / scale * shape_init_params
    v = (mesh2std @ v.T).T
    meta = {
        "centroid": centroid,
        "scale": float(scale),
        "shape_init_params": shape_init_params,
        "y_offset": y_offset,
    }
    return v.astype(np.float32), meta


@dataclasses.dataclass(frozen=True)
class ShapeInitConfig:
    sdf_iters: int = 15000
    sdf_points_per_iter: int = 40000
    sdf_pool_size: int = 2_000_000
    sdf_lr: float = 1e-3
    normal_iters: int = 501
    normal_lr: float = 5e-5
    normal_height: int = 512
    normal_width: int = 512
    normal_sdf_weight: float = 10000.0
    normal_points_per_iter: int = 40000
    camera: RandomCameraConfig = dataclasses.field(
        default_factory=lambda: RandomCameraConfig(
            elevation_range=(-10, 10),
            camera_distance_range=(3.0, 3.3),
            fovy_range=(40, 45),
            height=512, width=512,
        )
    )


_PHASES = {"pool": 0, "sdf": 1, "normal": 2}


@register("human-init")
class ShapeInitializer:
    """Stage-0 SDF fit to a reconstructed body mesh."""

    def __init__(
        self,
        field: SDFField,
        geometry: TetGeometry,
        cfg: ShapeInitConfig = ShapeInitConfig(),
        device=None,
    ):
        self.field = field
        self.geometry = geometry
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = 0
        self.using_native = None  # whether the last run's MeshSDF was native
        # Each step's loss as a device tensor (no host sync), per phase.
        self.trace: Dict[str, List[Tensor]] = {"sdf": [], "normal": []}

    def draw(self, phase: str, step: int):
        """The trainer's randomness: the pool seed (phase "pool", an int)
        or the (P,) int64 pool indices of step `step` of phase "sdf" or
        "normal", on the trainer's device."""
        g = _generator(self.seed, _PHASES[phase], step)
        if phase == "pool":
            return int(torch.randint(0, 2**31 - 1, (1,), generator=g))
        n = (self.cfg.sdf_points_per_iter if phase == "sdf"
             else self.cfg.normal_points_per_iter)
        return torch.randint(0, self.cfg.sdf_pool_size, (n,),
                             generator=g).to(self.device)

    def run(
        self,
        verts: np.ndarray,
        faces: np.ndarray,
        seed: int = 0,
        mesh_cfg: MeshRasterConfig = MeshRasterConfig(),
        debug_dir: Optional[str] = None,
        params: Optional[SDFParams] = None,
    ) -> Tuple[SDFParams, Dict[str, Any]]:
        """Fit the SDF to the body mesh, from `params` (else fresh
        parameters drawn from `seed`). With `debug_dir` set, exports the GT
        body mesh and the fitted isosurface as PLYs after each phase.
        Returns (params, info): `losses` (every 500th SDF and 100th normal
        step), `pool_size`, and `pool_s`, the host seconds of the MeshSDF
        pool."""
        cfg = self.cfg
        dev = self.device
        self.seed = seed
        self.trace = {"sdf": [], "normal": []}
        if params is None:
            params = self.field.init_params(_generator(seed, 3), device=dev)

        # Host: signed distance oracle + pre-sampled pool (host work only,
        # so the host clock times it).
        t0 = time.perf_counter()
        mesh_sdf = MeshSDF(verts, faces)
        self.using_native = mesh_sdf.using_native
        rng = np.random.default_rng(self.draw("pool", 0))
        pool = rng.uniform(-1, 1, (cfg.sdf_pool_size, 3)).astype(np.float32)
        # MeshSDF is positive outside, as is the field.
        pool_sdf = mesh_sdf(pool)
        pool_s = time.perf_counter() - t0
        pool_t = torch.as_tensor(pool, device=dev)
        pool_sdf_t = torch.as_tensor(pool_sdf, device=dev)

        field = self.field
        # The whole shape init runs at the curriculum's step-0 mask.
        init_mask = field.level_mask(0, device=dev)

        opt = torch.optim.Adam(params.parameters(), lr=cfg.sdf_lr)
        losses = []
        for i in range(cfg.sdf_iters):
            idx = self.draw("sdf", i)
            opt.zero_grad(set_to_none=True)
            pred = field.forward_sdf(params, pool_t[idx], level_mask=init_mask)
            loss = torch.mean((pred - pool_sdf_t[idx]) ** 2)
            loss.backward()
            opt.step()
            self.trace["sdf"].append(loss.detach())
            if i % 500 == 0:
                losses.append(float(loss.detach()))

        def _dump(tag):
            if debug_dir is None:
                return
            from youreditableavatar_tpu_torch.stages.export import compact_mt
            from youreditableavatar_tpu_torch.utils.saving import save_ply

            os.makedirs(debug_dir, exist_ok=True)
            with torch.no_grad():
                mt = self.geometry.isosurface(params, level_mask=init_mask)
            v, f, _ = compact_mt(mt)
            save_ply(os.path.join(debug_dir, f"init_{tag}.ply"), v, f)
            save_ply(os.path.join(debug_dir, "init_gt_body.ply"),
                     np.asarray(verts), np.asarray(faces))

        _dump("sdf_phase")

        # Phase B: rendered-normal refinement vs the GT mesh's own normal
        # maps + a strong anchor on the pool SDF.
        gt_verts = torch.tensor(np.asarray(verts, np.float32), device=dev)
        gt_faces = torch.as_tensor(np.asarray(faces).astype(np.int32),
                                   device=dev)
        gt_valid = torch.ones(gt_faces.shape[0], dtype=torch.bool, device=dev)
        sampler = RandomCameraSampler(cfg.camera, seed=0)
        opt2 = torch.optim.Adam(params.parameters(), lr=cfg.normal_lr)
        geometry = self.geometry
        for i in range(cfg.normal_iters):
            batch = sampler.sample()
            cam = batch.global_[0].raster_camera(dev)._replace(
                width=cfg.normal_width, height=cfg.normal_height)
            idx = self.draw("normal", i)
            with torch.no_grad():
                gt_maps = render_geometry_maps(gt_verts, gt_faces, gt_valid,
                                               cam, mesh_cfg)
            opt2.zero_grad(set_to_none=True)
            mt = geometry.isosurface(params, level_mask=init_mask)
            pred = render_geometry_maps(mt.verts, mt.faces, mt.faces_valid,
                                        cam, mesh_cfg)
            l_norm = torch.mean(torch.abs(pred["comp_normal"]
                                          - gt_maps["comp_normal"]))
            l_sdf = torch.mean(
                (field.forward_sdf(params, pool_t[idx], level_mask=init_mask)
                 - pool_sdf_t[idx]) ** 2)
            loss = l_norm + cfg.normal_sdf_weight * l_sdf
            loss.backward()
            opt2.step()
            self.trace["normal"].append(loss.detach())
            if i % 100 == 0:
                losses.append(float(loss.detach()))

        _dump("normal_phase")
        return params, {"losses": losses, "pool_size": cfg.sdf_pool_size,
                        "pool_s": pool_s}


@dataclasses.dataclass(frozen=True)
class HumanEditConfig:
    """Stage-1 defaults mirror `configs/geometry-edit.yaml:51-66` +
    `systems/humanedit.py:34-52`."""

    max_steps: int = 10000
    # AdamW lr 2e-5, betas (0.9, 0.99), eps 1e-15 (`geometry-edit.yaml:68-73`)
    optimizer: str = "adamw"
    lr: float = 2e-5
    betas: Tuple[float, float] = (0.9, 0.99)
    eps: float = 1e-15
    lambda_sds: ScheduleSpec = 0.5  # also the local-vs-global choice weight
    lambda_sds_global: ScheduleSpec = 0.5
    lambda_sdf_recon: ScheduleSpec = 5000.0
    lambda_sdf_control: ScheduleSpec = 2000.0  # `lambda_sdf`
    lambda_normal_consistency: ScheduleSpec = 2000.0
    # After sub_step the NC weight switches (`humanedit.py:206-216`).
    lambda_normal_consistency_sub: ScheduleSpec = 2000.0
    sub_step: int = 500
    start_sdf_loss_step: int = 3000
    recon_points: int = 30000
    log_every: int = 50
    # Mesh-raster pair-budget overflow policy ("grow", "raise", "warn").
    overflow_policy: str = "grow"
    # Selection-cache refresh period K for part_isosurface_cached; 0
    # disables the cache (full sweep per step).
    sdf_cache_refresh: int = 8
    # Visual checkpoints: normal-map dump cadence, when `save_dir` is set.
    image_every: int = 250
    # Optional image-guided editing (`use_additional_input`).
    use_additional_input: bool = False
    lambda_normal: ScheduleSpec = 100.0
    lambda_normal_sub: ScheduleSpec = 100.0
    lambda_mask: ScheduleSpec = 100.0
    # Multi-step "du" edit mode: when use_sds is False the SDS term is
    # replaced by latent-MSE ("f") + image L1 + perceptual pulls toward a
    # cached multi-step-denoised edit of the current render, refreshed every
    # `guidance.cfg.per_editing_step` steps (needs an `SDSDUGuidance`). The
    # camera stream is random per step, so the cache is keyed by an azimuth
    # bucket (du_view_buckets sectors).
    use_sds: bool = True
    lambda_f: ScheduleSpec = 1.0
    lambda_l1: ScheduleSpec = 10.0
    lambda_p: ScheduleSpec = 10.0
    du_view_buckets: int = 16
    camera: RandomCameraConfig = dataclasses.field(
        default_factory=lambda: RandomCameraConfig(
            elevation_range=(-5, 10),
            camera_distance_range=(3.3, 3.5),
            fovy_range=(40, 45),
        )
    )


@register("human-edit")
class HumanEditTrainer:
    """Stage-1 localized geometry editing with SDS guidance."""

    def __init__(
        self,
        field: SDFField,
        geometry: TetGeometry,
        partition: Partition,
        params: SDFParams,
        guidance: SDSGuidance,
        prompts_local: PromptProcessor,
        prompts_global: Optional[PromptProcessor],
        cfg: HumanEditConfig = HumanEditConfig(),
        mesh_cfg: MeshRasterConfig = MeshRasterConfig(),
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.field = field
        self.geometry = geometry
        self.partition = partition
        self.params = params
        self.frozen_params = copy.deepcopy(params).requires_grad_(False)
        self.guidance = guidance
        self.prompts_local = prompts_local
        self.prompts_global = prompts_global
        self.cfg = cfg
        self.mesh_cfg = mesh_cfg
        self.seed = seed
        self.sampler = RandomCameraSampler(cfg.camera, seed=seed)
        self.rng = np.random.default_rng(seed)
        self.optimizer = parse_optimizer(cfg.optimizer, cfg.lr, cfg.betas,
                                         cfg.eps)(params.parameters())
        self.control_sdf: Optional[Tensor] = None
        self.global_step = 0
        self.metrics: List[Dict[str, float]] = []
        self.governor = BudgetGovernor(policy=cfg.overflow_policy,
                                       name="human-edit-mesh")
        # Visual checkpoints (normal maps every cfg.image_every steps) are
        # written here when set.
        self.save_dir: Optional[str] = None
        # Optional utils.saving.ProgressFile for UI frontends.
        self.progress = None
        # Optional image-guided editing targets (H, W, ...) in [0, 1]:
        # dict(front_normal, back_normal, front_mask).
        self.input_images: Optional[Dict[str, np.ndarray]] = None
        # The geometry's CUDA graphs of one key less its use_global (below),
        # one chain per use_global.
        self._graph_base: Optional[tuple] = None
        self._graphs: Dict[bool, GraphedChain] = {}

        grid_pos = geometry.grid_pos
        with torch.no_grad():
            # Frozen-field SDF at grid vertices: the recon target.
            self.recon_sdf = field.forward_sdf_chunked(self.frozen_params,
                                                       grid_pos)
        # Selection cache: at t=0 the live field equals the frozen field, so
        # the partition's frozen_sdf is the exact initial cache.
        self._sdf_cache: Optional[Tensor] = None
        if cfg.sdf_cache_refresh > 0:
            self._sdf_cache = partition.frozen_sdf.clone()
            live = partition.live_vert_idx.cpu().numpy()
            k_ref = cfg.sdf_cache_refresh
            r = -(-live.shape[0] // k_ref)
            pad = np.resize(live, (k_ref * r,))  # wraps; dupes harmless
            self._refresh_slices = torch.as_tensor(
                pad.reshape(k_ref, r).astype(np.int64), device=self.device)

    def draws(self, seed: int, step: int) -> Dict[str, Tensor]:
        """The step's randomness: the SDS timestep `t` (1,) and latent
        noise, the (recon_points,) recon vertex indices, `enc_noise`, the
        ε of the prior's encoder sample (every encode of the step shares
        it) and, in the du mode, `du_t`, the cache refresh's timestep (an
        int), and `edit_noise`, the noise of its multi-step edit."""
        g = _generator(seed, step)
        min_t, max_t = self.guidance.timestep_range(0, step)
        prior = self.guidance.prior
        d = prior.latent_downscale
        shape = (1, self.cfg.camera.height // d, self.cfg.camera.width // d,
                 prior.latent_channels)
        t, noise = draw_timestep_noise(shape, min_t, max_t, g, self.device)
        nv = self.geometry.grid_pos.shape[0]
        recon = torch.randint(0, nv, (self.cfg.recon_points,), generator=g)
        out = {"t": t, "noise": noise, "recon_idx": recon.to(self.device)}
        if not self.cfg.use_sds:
            out["du_t"] = int(torch.randint(min_t, max_t + 1, (),
                                            generator=g))
        out["enc_noise"] = torch.randn(shape, generator=g).to(self.device)
        if not self.cfg.use_sds:
            out["edit_noise"] = torch.randn(shape, generator=g).to(self.device)
        return out

    # ---- the step's geometry, graphed on a CUDA device --------------------

    def graph_key(self, use_global: bool, n_active: int) -> tuple:
        """What the geometry's graphs hold beyond their tensor inputs; the
        last entry is `use_global`. A change of any other (the governor
        growing `mesh_cfg.pair_budget`, the curriculum's `n_active`) makes
        the next step capture anew."""
        cam = self.cfg.camera
        return (self.device, n_active, self.geometry.budgets, self.mesh_cfg,
                self.cfg.sdf_cache_refresh > 0, self.cfg.use_additional_input,
                (cam.height, cam.width),
                tuple(x.data_ptr() for x in self.params.parameters()),
                bool(use_global))

    def _render_inputs(self, use_global, cam_l, cam_g, sdf_cache,
                       refresh_idx) -> tuple:
        """The tensors `_render_fn` takes: the selection cache and its
        refresh slice (where the cache is on), then the local camera's and
        (with use_global) the global camera's viewmat, fx, fy, cx, cy."""
        cache = ((sdf_cache, refresh_idx) if self.cfg.sdf_cache_refresh > 0
                 else ())
        return cache + tuple(cam_l[:5]) + (tuple(cam_g[:5]) if use_global
                                           else ())

    def _render_fn(self, use_global: bool, n_active: int):
        """The edit surface at the live params and its normal maps, as a
        function of `_render_inputs`' tensors → (mt, the new selection
        cache as a 1-tuple (empty without the cache), the maps the step
        reads, the guided normal image)."""
        field = self.field
        part = self.partition
        cached = self.cfg.sdf_cache_refresh > 0
        w, h = self.cfg.camera.width, self.cfg.camera.height
        read = ["local_num_pairs"] + (["global_num_pairs"] if use_global
                                      else [])
        if self.cfg.use_additional_input:
            read += ["local_update_mask", "local_comp_normal",
                     "local_opacity"]

        def render(*t):
            cams = t[2:] if cached else t
            # Progressive hash-grid band; n_active skips the masked levels.
            lm = (torch.arange(field.cfg.grid.n_levels, device=self.device)
                  < n_active).to(torch.float32)
            if cached:
                mt, new_cache = self.geometry.part_isosurface_cached(
                    self.params, part, t[0], t[1], level_mask=lm,
                    n_active=n_active)
            else:
                mt = self.geometry.part_isosurface(self.params, part,
                                                   level_mask=lm,
                                                   n_active=n_active)
            cam_g = RasterCamera(*cams[5:], w, h) if use_global else None
            maps = render_part_maps(part.keep_mesh, mt,
                                    RasterCamera(*cams[:5], w, h), cam_g,
                                    self.mesh_cfg)
            normal_img = maps["global_comp_normal" if use_global
                              else "local_comp_normal"]
            return (mt, (new_cache,) if cached else (),
                    {k: maps[k] for k in read}, normal_img)
        return render

    def _losses_fn(self, n_active: int):
        """(mt, recon indices, control SDF) → the unweighted recon, control
        and normal-consistency terms."""
        field = self.field
        part = self.partition

        def losses(mt, k_idx, control_sdf):
            lm = (torch.arange(field.cfg.grid.n_levels, device=self.device)
                  < n_active).to(torch.float32)
            # Surface-aware recon: keep-region vertices must match the
            # frozen field.
            live = field.forward_sdf(self.params, self.geometry.grid_pos[k_idx],
                                     level_mask=lm, n_active=n_active)
            frozen = self.recon_sdf[k_idx]
            keep_w = (~part.live_vert_mask[k_idx]).to(torch.float32)
            loss_recon = torch.sum(keep_w * (live - frozen) ** 2)
            # HumanNorm control-SDF on the edit region (snapshotted live
            # field after warmup).
            loss_ctrl = torch.sum(
                part.live_vert_mask[k_idx].to(torch.float32)
                * (live - control_sdf[k_idx]) ** 2)
            return loss_recon, loss_ctrl, normal_consistency(mt)
        return losses

    def _geometry_chain(self, use_global, n_active, cam_l, cam_g, sdf_cache,
                        refresh_idx, losses_in) -> Optional[GraphedChain]:
        """The graphs of this step's geometry on a CUDA device, None
        elsewhere. A key seen for the first time is captured here, with
        the other use_global of the same key, from this step's inputs, and
        the graphs of other keys are dropped."""
        if self.device.type != "cuda":
            return None
        key = self.graph_key(use_global, n_active)
        if key[:-1] != self._graph_base:
            self._graph_base, self._graphs = key[:-1], {}
        if use_global not in self._graphs:
            leaves = list(self.params.parameters())
            for ug in (use_global, not use_global):
                self._graphs[ug] = GraphedChain(
                    (self._render_fn(ug, n_active), self._losses_fn(n_active)),
                    (self._render_inputs(ug, cam_l, cam_g, sdf_cache,
                                         refresh_idx),
                     lambda out: (out[0],) + losses_in), leaves)
        return self._graphs[use_global]

    @staticmethod
    def _geometry_call(chain, i, fn, *args):
        """Function i of the geometry: replayed from `chain`, else run."""
        if chain is None:
            _kernels.GRAPHS["eager"] += 1
            return fn(*args)
        with span("edit.graph"):
            return chain(i, *args)

    def _step(self, use_global, draws, cam_l, cam_g, cond, uncond, weights,
              min_t, max_t, control_sdf, guide_normal, guide_mask, guide_flag,
              sdf_cache, refresh_idx, n_active, du_gt=None):
        cfg = self.cfg
        losses_in = (draws["recon_idx"], control_sdf)

        self.optimizer.zero_grad(set_to_none=True)
        with span("edit.render"):
            chain = self._geometry_chain(use_global, n_active, cam_l, cam_g,
                                         sdf_cache, refresh_idx, losses_in)
            mt, cache, maps, normal_img = self._geometry_call(
                chain, 0, self._render_fn(use_global, n_active),
                *self._render_inputs(use_global, cam_l, cam_g, sdf_cache,
                                     refresh_idx))
            new_cache = cache[0] if cache else sdf_cache
        with span("edit.guidance"):
            if cfg.use_sds:
                sds = self.guidance(normal_img[None], cond, uncond, None,
                                    min_t, max_t, t=draws["t"],
                                    noise=draws["noise"],
                                    enc_noise=draws.get("enc_noise"))
                loss = weights["sds"] * sds["loss_sds"]
                guide_aux = {"sds": sds["loss_sds"]}
            else:
                # du edit mode: pull the render toward the cached multi-step
                # edit `du_gt` (refreshed in `_prepare`).
                du = self.guidance.du_loss_terms(
                    normal_img[None], du_gt[None],
                    enc_noise=draws.get("enc_noise"))
                loss = (weights["du_f"] * du["loss_f"]
                        + weights["du_l1"] * du["loss_l1"])
                if "loss_p" in du:
                    loss = loss + weights["du_p"] * du["loss_p"]
                guide_aux = {"du_f": du["loss_f"], "du_l1": du["loss_l1"]}

        with span("edit.losses"):
            loss_recon, loss_ctrl, loss_nc = self._geometry_call(
                chain, 1, self._losses_fn(n_active), mt, *losses_in)
            loss = loss + weights["recon"] * loss_recon
            # The control term counts once its weight is on (the graph
            # computes it whatever the weight).
            if not weights["control"] > 0:
                loss_ctrl = torch.zeros((), device=self.device)
            loss = loss + weights["control"] * loss_ctrl
            loss = loss + weights["nc"] * loss_nc

            pairs = maps["local_num_pairs"]
            if use_global:
                pairs = torch.maximum(pairs, maps["global_num_pairs"])
            aux = {
                **guide_aux,
                "recon": loss_recon,
                "control": loss_ctrl,
                "nc": loss_nc,
                # mesh-raster pairs (max over the views rendered this step),
                # compared against mesh_cfg.pair_budget by the governor
                "mesh_pairs": pairs.to(torch.float32),
            }

            if cfg.use_additional_input:
                # Image-guided editing: MSE between the update-region
                # normals and the front/back GT normal image, + silhouette
                # L2 on the front mask.
                upd = maps["local_update_mask"][..., None]
                pred_n = upd * maps["local_comp_normal"] + 0.5 * (1.0 - upd)
                gt_n = upd * guide_normal + 0.5 * (1.0 - upd)
                loss_normal = torch.sum((pred_n - gt_n) ** 2)
                loss = loss + weights["img_normal"] * loss_normal
                upd2 = maps["local_update_mask"]
                pred_o = upd2 * torch.clamp(maps["local_opacity"], 1e-5,
                                            1.0 - 1e-5)
                if guide_flag < 0.5:  # front view only: silhouette L2
                    loss_mask = torch.sum((pred_o - upd2 * guide_mask) ** 2)
                else:
                    loss_mask = torch.zeros((), device=self.device)
                loss = loss + weights["img_mask"] * loss_mask
                aux["img_normal"] = loss_normal
                aux["img_mask"] = loss_mask

        with span("edit.backward"):
            loss.backward()
        with span("edit.optimizer"):
            self.optimizer.step()
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                normal_img.detach(), new_cache)

    def train_step(self, seed: int = 0) -> Dict[str, float]:
        """One edit step; its record (the loss and each term) as floats."""
        with span("edit.step"):
            with span("edit.prepare"):
                step_i, args = self._prepare(seed)
            loss, aux, normal_img, new_cache = self._step(*args)
            with span("edit.record"):
                return self._record(step_i, args[0], loss, aux, normal_img,
                                    new_cache)

    def _prepare(self, seed: int):
        """The step's host draws, cameras, prompts, weights and uploads:
        (step, the arguments of `_step`)."""
        cfg = self.cfg
        dev = self.device
        step_i = self.global_step
        # Per-step derived host RNG streams: every host-side draw is a pure
        # function of (seed, step).
        step_rng = np.random.default_rng((self.seed, 1, step_i))
        self.sampler.rng = np.random.default_rng((self.seed, 2, step_i))
        batch = self.sampler.sample(step_i)
        cam_l = batch.local[0].raster_camera(dev)
        cam_g = batch.global_[0].raster_camera(dev)

        w_local = C(cfg.lambda_sds, 0, step_i)
        use_global = step_rng.random() >= w_local
        prompts = (self.prompts_global
                   if use_global and self.prompts_global is not None
                   else self.prompts_local)
        cond, uncond = prompts.get_text_embeddings(
            batch.elevation_deg[:1], batch.azimuth_deg[:1])

        # Snapshot the control SDF at the warmup boundary.
        if step_i == cfg.start_sdf_loss_step:
            with torch.no_grad():
                self.control_sdf = self.field.forward_sdf_chunked(
                    self.params, self.geometry.grid_pos)

        # NC weight switches to the `_sub` schedule once subdivision engages.
        nc_spec = (cfg.lambda_normal_consistency if step_i < cfg.sub_step
                   else cfg.lambda_normal_consistency_sub)
        weights = {
            "sds": C(cfg.lambda_sds_global if use_global else cfg.lambda_sds,
                     0, step_i),
            "recon": C(cfg.lambda_sdf_recon, 0, step_i),
            "control": (C(cfg.lambda_sdf_control, 0, step_i)
                        if self.control_sdf is not None else 0.0),
            "nc": C(nc_spec, 0, step_i),
            "du_f": C(cfg.lambda_f, 0, step_i) if not cfg.use_sds else 0.0,
            "du_l1": C(cfg.lambda_l1, 0, step_i) if not cfg.use_sds else 0.0,
            "du_p": C(cfg.lambda_p, 0, step_i) if not cfg.use_sds else 0.0,
        }
        # Image-guided editing: random front/back choice per step; 0 = front.
        guide_flag = float(step_rng.integers(0, 2))
        h, w = cfg.camera.height, cfg.camera.width
        guide_normal = guide_mask = None
        if cfg.use_additional_input and self.input_images is not None:
            img_n_spec = (cfg.lambda_normal if step_i < cfg.sub_step
                          else cfg.lambda_normal_sub)
            weights["img_normal"] = C(img_n_spec, 0, step_i)
            weights["img_mask"] = C(cfg.lambda_mask, 0, step_i)
            which = "front" if guide_flag < 0.5 else "back"
            guide_normal = torch.as_tensor(
                np.asarray(self.input_images[f"{which}_normal"], np.float32),
                device=dev)
            guide_mask = torch.as_tensor(np.asarray(
                self.input_images.get("front_mask", np.ones((h, w))),
                np.float32), device=dev)
        else:
            weights["img_normal"] = weights["img_mask"] = 0.0
            guide_normal = torch.zeros((h, w, 3), device=dev)
            guide_mask = torch.zeros((h, w), device=dev)

        min_t, max_t = self.guidance.timestep_range(0, step_i)
        nv = self.geometry.grid_pos.shape[0]
        ctrl = (self.control_sdf if self.control_sdf is not None
                else torch.zeros(nv, device=dev))
        sdf_cache = refresh_idx = None
        if cfg.sdf_cache_refresh > 0:
            sdf_cache = self._sdf_cache
            refresh_idx = self._refresh_slices[step_i % cfg.sdf_cache_refresh]

        # Progressive level count (exact skip of masked levels' hash work).
        gcfg = self.field.cfg.grid
        if gcfg.progressive:
            n_active = int(min(
                gcfg.start_level
                + max(step_i - gcfg.start_step, 0) // gcfg.update_steps,
                gcfg.n_levels,
            ))
        else:
            n_active = gcfg.n_levels

        draws = self.draws(seed, step_i)
        cond = torch.as_tensor(cond, device=dev)
        uncond = torch.as_tensor(uncond, device=dev)
        du_gt = None
        if not cfg.use_sds:
            # du edit mode: refresh the azimuth bucket's edited image from
            # the CURRENT render when due (host state, like the
            # reference's edited-image cache), then pull toward it.
            az = float(batch.azimuth_deg[0]) % 360.0
            bucket = int(az / 360.0 * cfg.du_view_buckets) \
                % cfg.du_view_buckets
            per_edit = int(getattr(self.guidance.cfg, "per_editing_step", 10))
            if (bucket not in self.guidance.edited_images
                    or step_i % per_edit == 0):
                with torch.no_grad():
                    # The training step recomputes and carries the cache.
                    cur = self._render_fn(use_global, n_active)(
                        *self._render_inputs(use_global, cam_l, cam_g,
                                             sdf_cache, refresh_idx))[3]
                self.guidance.maybe_refresh(
                    cur[None], cond, uncond, None, min_t, max_t, bucket,
                    step_i, t=draws["du_t"],
                    enc_noise=draws.get("enc_noise"),
                    edit_noise=draws.get("edit_noise"))
            du_gt = self.guidance.edited_images[bucket][0]
        return step_i, (
            use_global, draws, cam_l, cam_g, cond, uncond, weights, min_t,
            max_t, ctrl, guide_normal, guide_mask, guide_flag, sdf_cache,
            refresh_idx, n_active, du_gt)

    def _record(self, step_i: int, use_global: bool, loss, aux, normal_img,
                new_cache) -> Dict[str, float]:
        """Carry the selection cache (into the trainer's own buffer: a
        graph's output is overwritten by its next replay), read the record
        back (one host read), govern the pair budget and write the visual
        checkpoint."""
        cfg = self.cfg
        if cfg.sdf_cache_refresh > 0:
            self._sdf_cache.copy_(new_cache)
        self.global_step += 1
        # One host read for the whole record.
        names = list(aux)
        values = torch.stack([loss] + [aux[k] for k in names]).tolist()
        rec = {"loss": values[0], **dict(zip(names, values[1:]))}
        if step_i % cfg.log_every == 0:
            self.metrics.append({"step": step_i, **rec})
            # Mesh-raster pair-budget governance.
            new_mcfg = self.governor.check(self.mesh_cfg,
                                           int(rec["mesh_pairs"]), 0,
                                           step=step_i)
            if new_mcfg is not None:
                self.mesh_cfg = new_mcfg
        # Visual checkpoint: the training normal map every image_every steps.
        if self.save_dir is not None and step_i % cfg.image_every == 0:
            from youreditableavatar_tpu_torch.utils.saving import save_image

            save_image(
                os.path.join(
                    self.save_dir,
                    f"train-normal/it{step_i}-"
                    f"{'global' if use_global else 'local'}-normal.png",
                ),
                np.clip(normal_img.cpu().numpy(), 0, 1),
            )
        return rec

    def save_checkpoint(self, path: str) -> None:
        """Full resumable training state: params, the optimizer's state, the
        step, and the control-SDF snapshot and selection cache where they
        exist (one `torch.save` file, `utils.checkpoint.save_state`)."""
        from youreditableavatar_tpu_torch.utils.checkpoint import save_state

        extra = {}
        if self.control_sdf is not None:
            extra["control_sdf"] = self.control_sdf
        if self._sdf_cache is not None:
            # The carried selection cache: a restored run then makes exactly
            # the tet selections an uninterrupted one makes.
            extra["sdf_cache"] = self._sdf_cache
        save_state(path, self.params, self.optimizer, step=self.global_step,
                   extra=extra or None)

    def restore_checkpoint(self, path: str) -> None:
        """Resume mid-curriculum with step-replay semantics.

        Restores params (in place, so the optimizer keeps them), the
        optimizer's state and the step, and re-derives every piece of
        step-dependent state, as the reference's `do_update_step(epoch,
        step, on_load_weights=True)` replay does:

          * the progressive hash-grid level count — a function of
            `global_step`, read at every step;
          * all `C()` schedules and the timestep range — functions of step;
          * every draw — from generators seeded by (seed, step) (`draws`,
            and the per-step host streams of `train_step`), so no generator
            state needs restoring;
          * the control-SDF snapshot — restored if it was taken, else
            (resuming before `start_sdf_loss_step`) taken at the boundary as
            in an uninterrupted run;
          * the selection cache — restored, or rebuilt from the live field
            for a checkpoint without one.
        """
        from youreditableavatar_tpu_torch.utils.checkpoint import load_state

        state = load_state(path, map_location=self.device)
        with torch.no_grad():
            self.params.load_state_dict(state["params"])
        if "opt_state" in state:
            self.optimizer.load_state_dict(state["opt_state"])
        self.global_step = int(state["step"])
        extra = state.get("extra") or {}
        self.control_sdf = extra.get("control_sdf")
        if self.cfg.sdf_cache_refresh > 0:
            cache = extra.get("sdf_cache")
            if cache is None:
                live = self.partition.live_vert_idx
                with torch.no_grad():
                    vals = self.field.forward_sdf_chunked(
                        self.params, self.geometry.grid_pos[live],
                        level_mask=self.field.level_mask(self.global_step,
                                                         self.device))
                cache = self.partition.frozen_sdf.clone()
                cache[live] = vals
            self._sdf_cache = cache

    def train(self, seed: int = 0, num_steps: Optional[int] = None) -> SDFParams:
        n = num_steps or self.cfg.max_steps
        for i in range(n):
            # Draws derive from (seed, global step), so a run that resumes
            # at step k makes the draws an uninterrupted one would.
            self.train_step(seed)
            if self.progress is not None and (
                i % self.cfg.log_every == 0 or i == n - 1
            ):
                self.progress.step(i + 1, n)
        return self.params
