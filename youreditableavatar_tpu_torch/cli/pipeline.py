"""The end-to-end pipeline (the `run.sh` role) and the per-stage entry
points.

Counterpart of `youreditableavatar_tpu/cli/pipeline.py`, the reference's
four-stage file-mediated flow (`run.sh:1-99`):

  stage 0/1 (spatial):  body mesh → SDF init checkpoint → (optional SDS
                        edit) → init_mesh.npy / edit_mesh.npy
  stage 2  (init tex):  init_mesh.npy + posed frames → TetGS appearance fit
                        → probe renders → editing_region_info.npy
  stage 4  (edit tex):  edit_mesh.npy + keep Gaussians → progressive
                        inpaint → blend images → 3D refine → turntable

Every stage reads and writes the `.npy` / `.npz` artifacts with the JAX
package's schemas, so a stage run by one package is read by the other.
The checkpoints are `utils.checkpoint.save_state` files (one `torch.save`
file, not an orbax directory). Where the JAX pipeline splits `jax.random`
keys, these derive integer seeds and `torch.Generator`s from the same
`seed`; the two packages draw different streams. `run_synthetic_pipeline`
runs the whole chain on generated data with the stub backends.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from youreditableavatar_tpu_torch.data.camera_sampler import (
    RandomCameraConfig,
    RandomCameraSampler,
)
from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
from youreditableavatar_tpu_torch.guidance.sds import SDSConfig, SDSGuidance
from youreditableavatar_tpu_torch.guidance.stub import StubInpainter
from youreditableavatar_tpu_torch.models.geometry import (
    GeometryBudgets,
    TetGeometry,
)
from youreditableavatar_tpu_torch.models.sdf import SDFField, SDFFieldConfig
from youreditableavatar_tpu_torch.models.tetgs import (
    build_tetgs,
    extract_keep_gaussians,
    gaussian_arrays,
    load_tetgs,
    save_tetgs,
)
from youreditableavatar_tpu_torch.models.tetgs_edit import build_edit_tetgs
from youreditableavatar_tpu_torch.models.textured_mesh import TexturedMeshModel
from youreditableavatar_tpu_torch.ops.gaussian_raster import (
    RasterizeConfig,
    render_gaussians,
)
from youreditableavatar_tpu_torch.ops.hashgrid import HashGridConfig
from youreditableavatar_tpu_torch.ops.marching_tets import (
    make_tet_grid,
    marching_tets,
)
from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
from youreditableavatar_tpu_torch.stages.edit_texture import (
    InpaintConfig,
    InpaintTrainer,
    RefineConfig,
    RefineTrainer,
)
from youreditableavatar_tpu_torch.stages.export import (
    export_edit_mesh,
    export_init_mesh,
    load_edit_mesh,
    load_editing_region_info,
    load_init_mesh,
)
from youreditableavatar_tpu_torch.stages.init_texture import (
    InitTextureConfig,
    TetGSInitTrainer,
)
from youreditableavatar_tpu_torch.stages.localization import (
    HeuristicSegmenter,
    LocalizationConfig,
    LocalMeshEditing,
)
from youreditableavatar_tpu_torch.stages.spatial import (
    HumanEditConfig,
    HumanEditTrainer,
    ShapeInitConfig,
    ShapeInitializer,
)
from youreditableavatar_tpu_torch.utils.checkpoint import load_state, save_state
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.misc import cleanup
from youreditableavatar_tpu_torch.utils.profiling import MetricsLogger
from youreditableavatar_tpu_torch.utils.saving import save_image, save_video


@dataclasses.dataclass
class PipelineScale:
    """Sizing knobs; `tiny()` runs the whole chain in minutes on the CPU."""

    grid_res: int = 64
    image_hw: int = 512
    sdf_iters: int = 15000
    normal_iters: int = 501
    edit_steps: int = 10000
    fit_iters: int = 4000
    inpaint_views: int = 32
    turntable_views: int = 60
    refine_iters: int = 2000
    budgets: GeometryBudgets = dataclasses.field(
        default_factory=GeometryBudgets
    )
    raster: RasterizeConfig = dataclasses.field(
        default_factory=lambda: RasterizeConfig()
    )
    mesh_raster: MeshRasterConfig = dataclasses.field(
        default_factory=lambda: MeshRasterConfig()
    )
    hashgrid: HashGridConfig = dataclasses.field(
        default_factory=HashGridConfig
    )

    @staticmethod
    def tiny() -> "PipelineScale":
        return PipelineScale(
            grid_res=10,
            image_hw=64,
            sdf_iters=200,
            normal_iters=3,
            edit_steps=4,
            fit_iters=30,
            inpaint_views=3,
            turntable_views=4,
            refine_iters=10,
            budgets=GeometryBudgets(
                mt_verts=4096, mt_faces=8192, compact=4096,
                subdiv_mid=16384, fine_mt_verts=16384, fine_mt_faces=32768,
            ),
            # Budgets here are initial hints only: the texture trainers
            # size them from an exact count pre-pass at init, and every
            # trainer's BudgetGovernor grows them on a runtime overflow.
            raster=RasterizeConfig(pair_budget=1 << 13, tile_capacity=512),
            mesh_raster=MeshRasterConfig(pair_budget=1 << 14),
            hashgrid=HashGridConfig(
                n_levels=4, n_features_per_level=2, log2_hashmap_size=13,
                base_resolution=4, per_level_scale=1.5,
            ),
        )


def _field(scale: PipelineScale) -> SDFField:
    return SDFField(
        SDFFieldConfig(grid=scale.hashgrid, sdf_bias="sphere",
                       sdf_bias_radius=0.4)
    )


def _cam_cfg(scale: PipelineScale, **kw) -> RandomCameraConfig:
    base = dict(
        height=scale.image_hw, width=scale.image_hw,
        camera_distance_range=(1.6, 1.8), elevation_range=(-5, 10),
        fovy_range=(40, 45),
    )
    base.update(kw)
    return RandomCameraConfig(**base)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def run_spatial_stage(
    out_dir: str,
    body_verts: np.ndarray,
    body_faces: np.ndarray,
    edit_prompt: str,
    scale: PipelineScale,
    seed: int = 0,
    edit_prompt_global: Optional[str] = None,
    editing_region_info: Optional[Dict] = None,
    guidance_backend: str = "stub",
    sd_weights: Optional[str] = None,
    system_cfg: Optional[Dict] = None,
    progress_path: Optional[str] = None,
    init_debug: bool = False,
    device=None,
) -> Dict[str, str]:
    """Stages 0+1: SDF init → (SDS edit over the localized region) → exports.

    Without `editing_region_info` only the init runs (the geometry-init
    mode, max_steps=0) and `init_mesh.npy` is exported. With it, the SDS
    edit runs and `edit_mesh.npy` is exported.
    """
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    metrics = MetricsLogger(out_dir)
    field = _field(scale)
    geometry = TetGeometry(field, scale.grid_res, scale.budgets, device=dev)

    init_cfg = ShapeInitConfig(
        sdf_iters=scale.sdf_iters,
        normal_iters=scale.normal_iters,
        sdf_points_per_iter=min(40000, 8192 if scale.grid_res < 32 else 40000),
        sdf_pool_size=min(2_000_000, 100_000 if scale.grid_res < 32 else
                          2_000_000),
        normal_height=scale.image_hw, normal_width=scale.image_hw,
        normal_points_per_iter=4096,
        camera=_cam_cfg(scale),
    )
    initializer = ShapeInitializer(field, geometry, init_cfg, device=dev)
    params, info = initializer.run(
        body_verts, body_faces, seed, scale.mesh_raster,
        debug_dir=os.path.join(out_dir, "init_debug") if init_debug
        else None,
    )
    ckpt_path = os.path.join(out_dir, "initial_checkpoint")
    save_state(ckpt_path, params, step=0)
    metrics.log(0, stage="shape_init", final_loss=info["losses"][-1])

    with torch.no_grad():
        mt = geometry.isosurface(params)
    init_mesh_path = os.path.join(out_dir, "init_mesh.npy")
    data = export_init_mesh(init_mesh_path, mt)
    # The companion PLY the reference's run.sh hands the localization stage
    # as --seg_mesh_path (`mesh_exporter_init.py:65-81`, run.sh:51).
    from youreditableavatar_tpu_torch.utils.saving import save_ply

    coarse_ply = os.path.join(out_dir, "init_mesh_coarse.ply")
    save_ply(
        coarse_ply,
        np.asarray(data["mesh"]["vertices"], np.float32),
        np.asarray(data["mesh"]["faces"]),
    )
    artifacts = {
        "ckpt": ckpt_path,
        "init_mesh": init_mesh_path,
        "init_mesh_coarse": coarse_ply,
    }

    if editing_region_info is not None:
        face_mask = np.zeros(mt.faces.shape[0], bool)
        src = np.asarray(editing_region_info["editing_mask_faces"]) > 0.5
        face_mask[: len(src)] = src[: len(face_mask)]
        part = geometry.partition_init(
            params, torch.as_tensor(face_mask, device=dev) & mt.faces_valid,
            frozen_mt=mt,
        )
        from youreditableavatar_tpu_torch.guidance.factory import (
            make_guidance_backend)

        prior, enc = make_guidance_backend(
            guidance_backend, sd_weights, seed, device=dev
        )
        sys_cfg = system_cfg or {}
        g_cfg = dict(sys_cfg.get("guidance", {}))
        sds_kwargs = {
            k: g_cfg[k] for k in
            ("guidance_scale", "min_step_percent", "max_step_percent",
             "grad_clip", "weighting_strategy")
            if k in g_cfg
        }
        sds_kwargs = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in sds_kwargs.items()
        }
        guidance = SDSGuidance(prior, SDSConfig(**sds_kwargs))
        prompts = PromptProcessor(
            edit_prompt, "low quality", enc,
            cache_dir=os.path.join(out_dir, ".cache"),
            model_name=guidance_backend,
        )
        # A distinct global prompt (the reference's run.sh local_prompt vs
        # global_prompt; config key system.prompt_global): SDS on the
        # full-body view uses the scene-level phrasing.
        gp = edit_prompt_global or sys_cfg.get("prompt_global")
        prompts_global = prompts if not gp else PromptProcessor(
            str(gp), "low quality", enc,
            cache_dir=os.path.join(out_dir, ".cache"),
            model_name=guidance_backend,
        )
        loss_cfg = dict(sys_cfg.get("loss", {}))
        opt_cfg = dict(sys_cfg.get("optimizer", {}))
        edit_kwargs: Dict = dict(
            max_steps=scale.edit_steps,
            camera=_cam_cfg(scale),
            recon_points=4096,
            start_sdf_loss_step=int(
                sys_cfg.get("start_sdf_loss_step",
                            max(scale.edit_steps // 2, 1))
            ),
        )
        if "sub_step" in sys_cfg:
            edit_kwargs["sub_step"] = int(sys_cfg["sub_step"])
        if "use_additional_input" in sys_cfg:
            edit_kwargs["use_additional_input"] = bool(
                sys_cfg["use_additional_input"])
        for yk, ck in (
            ("lambda_sds", "lambda_sds"),
            ("lambda_sds_global", "lambda_sds_global"),
            ("lambda_sdf", "lambda_sdf_control"),
            ("lambda_sdf_recon", "lambda_sdf_recon"),
            ("lambda_normal_consistency", "lambda_normal_consistency"),
            ("lambda_normal_consistency_sub",
             "lambda_normal_consistency_sub"),
            ("lambda_normal", "lambda_normal"),
            ("lambda_normal_sub", "lambda_normal_sub"),
            ("lambda_mask", "lambda_mask"),
        ):
            if yk in loss_cfg:
                v = loss_cfg[yk]
                edit_kwargs[ck] = tuple(v) if isinstance(v, list) else v
        if "name" in opt_cfg:
            edit_kwargs["optimizer"] = str(opt_cfg["name"])
        if "lr" in opt_cfg:
            edit_kwargs["lr"] = float(opt_cfg["lr"])
        if "betas" in opt_cfg:
            edit_kwargs["betas"] = tuple(opt_cfg["betas"])
        if "eps" in opt_cfg:
            edit_kwargs["eps"] = float(opt_cfg["eps"])
        edit_cfg = HumanEditConfig(**edit_kwargs)
        trainer = HumanEditTrainer(
            field, geometry, part, params, guidance, prompts,
            prompts_global, edit_cfg, scale.mesh_raster, seed=seed,
            device=dev,
        )
        trainer.save_dir = out_dir
        if progress_path is not None:
            from youreditableavatar_tpu_torch.utils.saving import ProgressFile

            trainer.progress = ProgressFile(progress_path)
        params = trainer.train(seed + 1)
        if trainer.progress is not None:
            trainer.progress.close()
        for rec in trainer.metrics:
            metrics.log(rec["step"], stage="human_edit", **{
                k: v for k, v in rec.items() if k != "step"
            })
        save_state(os.path.join(out_dir, "edited_checkpoint"), params,
                   step=scale.edit_steps)
        with torch.no_grad():
            upd = geometry.part_isosurface(params, part)
        edit_mesh_path = os.path.join(out_dir, "edit_mesh.npy")
        export_edit_mesh(edit_mesh_path, part.keep_mesh, upd)
        artifacts["edit_mesh"] = edit_mesh_path
    metrics.close()
    return artifacts


def run_spatial_validate(
    out_dir: str,
    ckpt_path: str,
    scale: PipelineScale,
    num_views: int = 60,
    subdir: str = "validation",
    elevation_deg: float = 5.0,
    device=None,
) -> str:
    """Turntable normal renders of a spatial-stage checkpoint.

    The reference's `--validate/--test` dispatch renders the val/test
    turntables (`train_spatial.py:205-210`): load the checkpoint →
    isosurface → a mesh-raster normal map per view → PNG frames (+ a video
    when imageio has an mp4 writer).
    """
    from youreditableavatar_tpu_torch.models.cameras import (
        sample_circle_cameras)
    from youreditableavatar_tpu_torch.models.part_renderer import (
        render_geometry_maps)

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    field = _field(scale)
    geometry = TetGeometry(field, scale.grid_res, scale.budgets, device=dev)
    params = field.init_params(0, device=dev)
    params.load_state_dict(load_state(ckpt_path, map_location=dev)["params"])

    cams = sample_circle_cameras(
        num_views=num_views, radius=1.7, elevation_deg=elevation_deg,
        fov_deg=45.0, height=scale.image_hw, width=scale.image_hw,
    )
    vdir = os.path.join(out_dir, subdir)
    os.makedirs(vdir, exist_ok=True)
    frames = []
    with torch.no_grad():
        mt = geometry.isosurface(params)
        for k, cam in enumerate(cams):
            normal = render_geometry_maps(
                mt.verts, mt.faces, mt.faces_valid, cam.raster_camera(dev),
                scale.mesh_raster)["comp_normal"]
            frame = np.clip(normal.cpu().numpy(), 0.0, 1.0)
            save_image(os.path.join(vdir, f"frame{k:04d}.png"), frame)
            frames.append(frame)
    try:
        save_video(os.path.join(vdir, "turntable.mp4"), frames, fps=20)
    except Exception:
        pass  # imageio without an mp4 writer: the frames alone suffice
    return vdir


def run_init_texture_stage(
    out_dir: str,
    init_mesh_path: str,
    cameras,
    scale: PipelineScale,
    seg_prompt: str = "the garment",
    segmenter=None,
    vertex_colors: Optional[np.ndarray] = None,
    fit_iters: Optional[int] = None,
    device=None,
) -> Dict[str, str]:
    """Stage 2 + localization: appearance fit, probe renders, region masks."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    mesh = load_init_mesh(init_mesh_path)
    verts = np.asarray(mesh["vertices"], np.float32)
    faces = np.asarray(mesh["faces"], np.int64)
    f2t = np.asarray(mesh["face_to_global_tet_idx"], np.int64)

    binding, params = build_tetgs(
        verts, faces, vertex_colors, f2t, sh_levels=2, device=dev
    )
    cfg = InitTextureConfig(
        num_iterations=fit_iters or scale.fit_iters,
        raster=scale.raster,
        sh_warmup_every=max((fit_iters or scale.fit_iters) // 2, 1),
    )
    trainer = TetGSInitTrainer(binding, params, cameras, cfg, device=dev)
    params = trainer.train()
    ckpt = os.path.join(out_dir, "tetgs_init_last.npz")
    save_tetgs(ckpt, binding, params)

    # Probe renders for localization (`refine.py:377-427`'s probe views).
    sampler = RandomCameraSampler(_cam_cfg(scale), seed=1)
    probe_cams = [sampler.sample().global_[0] for _ in range(3)]
    probe_images = trainer.render_views(probe_cams)
    for i, img in enumerate(probe_images):
        save_image(os.path.join(out_dir, f"probe_{i:02d}.png"), img)

    seg = segmenter or HeuristicSegmenter(mode="upper")
    loc = LocalMeshEditing(
        verts, faces, seg,
        LocalizationConfig(dilate_iters=2, erode_iters=2,
                           mesh_cfg=scale.mesh_raster),
        device=dev,
    )
    region_path = os.path.join(out_dir, "editing_region_info.npy")
    loc.localize(probe_cams, probe_images, seg_prompt, region_path)
    return {
        "tetgs_init": ckpt,
        "editing_region_info": region_path,
    }


def run_edit_texture_stage(
    out_dir: str,
    edit_mesh_path: str,
    tetgs_init_path: str,
    prompt: str,
    scale: PipelineScale,
    inpainter=None,
    seed: int = 0,
    sample_type: str = "full",
    device=None,
) -> Dict[str, str]:
    """Stage 4: progressive inpaint + refine, final turntable renders.

    `sample_type` crops the probe / turntable framing to the garment band
    ("upper" / "lower" / "full", the reference's `gen_tet_camera` /
    `run_pg.sh`); the first two inpainting views keep the full-body framing
    for the joint front/back step.
    """
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    edit = load_edit_mesh(edit_mesh_path)
    verts = np.asarray(edit["vertices"], np.float32)
    faces = np.asarray(edit["faces"], np.int64)
    nkv = int(edit["keep_vertices_num"])
    nkf = int(edit["keep_faces_num"])
    editing_mask = np.asarray(edit["editing_mask"]) > 0

    # Keep Gaussians from the stage-2 model by tet-id intersection.
    binding0, params0, _ = load_tetgs(tetgs_init_path, device=dev)
    keep_tets = np.asarray(edit["face_to_global_tet_idx"][:nkf])
    keep = extract_keep_gaussians(binding0, params0, keep_tets)

    # The edit sub-mesh, re-indexed.
    sub_faces = faces[nkf:] - nkv
    edit_verts = verts[nkv:]
    ok = (sub_faces >= 0).all(1) & (sub_faces < len(edit_verts)).all(1)
    eb, ep = build_edit_tetgs(edit_verts, sub_faces[ok], keep, sh_levels=1,
                              device=dev)

    tm = TexturedMeshModel(verts, faces, editing_mask, scale.mesh_raster,
                           device=dev)
    # The reference's view sets: 3-ring probe cameras for the progressive
    # inpainting ladder and a turntable for the refinement, with the
    # garment-band framing.
    from youreditableavatar_tpu_torch.models.cameras import (
        sample_circle_cameras,
        sample_ring_cameras,
    )

    nv = scale.inpaint_views
    counts = (max(nv // 4, 2), max(3 * nv // 8, 1), max(3 * nv // 8, 1))
    cams = sample_ring_cameras(
        counts=counts, height=scale.image_hw, width=scale.image_hw,
        sample_type=sample_type,
    )[:nv]
    inp_cfg = InpaintConfig(
        iters_first=scale.fit_iters // 4 or 1,
        iters_second=scale.fit_iters // 5 or 1,
        iters_rest=scale.fit_iters // 10 or 1,
        raster=scale.raster,
    )
    trainer = InpaintTrainer(
        eb, ep, tm, cams, inpainter or StubInpainter(), prompt,
        "low quality", inp_cfg, device=dev,
    )
    ep = trainer.inpaint_training(_generator(seed, dev))

    turn = sample_circle_cameras(
        num_views=scale.turntable_views, height=scale.image_hw,
        width=scale.image_hw, sample_type=sample_type,
    )
    blends = trainer.prepare_refine_guidance(turn, _generator(seed + 1, dev))
    blend_dir = os.path.join(out_dir, "blend_images")
    for i, b in enumerate(blends):
        save_image(os.path.join(blend_dir, f"{i:04d}.png"), b)

    rcfg = RefineConfig(
        num_iterations=scale.refine_iters, raster=scale.raster, sh_levels=2,
        key_views=tuple(k for k in (0, 14, 29, 44) if k < len(turn)),
    )
    refiner = RefineTrainer(eb, ep, turn, blends, rcfg, device=dev)
    refiner.refined_editing(seed=seed)
    finals = refiner.validate(turn)
    final_dir = os.path.join(out_dir, "validation_refine")
    for i, img in enumerate(finals):
        save_image(os.path.join(final_dir, f"frame{i:04d}.png"), img)
    if len(finals) > 1:
        try:
            save_video(os.path.join(out_dir, "validation_refine.mp4"),
                       finals, fps=10)
        except Exception:
            pass  # no imageio video writer: the frames alone suffice
    return {"blend_dir": blend_dir, "final_dir": final_dir}


def synthetic_body(grid_res: int, device=None):
    """The synthetic "reconstructed body": the marching-tets surface of an
    ellipsoid on a grid of `max(grid_res, 10)`, within the fixed budgets of
    8,192 vertices and 16,384 faces. → (verts, faces, num_verts,
    num_faces), the counts before the budgets cut them."""
    dev = resolve_device(device)
    gv, gt = make_tet_grid(max(grid_res, 10))
    pos = torch.as_tensor(gv, device=dev)
    sdf = torch.linalg.norm(
        pos * torch.tensor([1.0, 1.0, 0.7], device=dev), dim=-1) - 0.3
    mt = marching_tets(pos, sdf, torch.as_tensor(gt, device=dev), 8192, 16384)
    nv, nf = int(mt.num_verts), int(mt.num_faces)
    verts = mt.verts.cpu().numpy()[:nv]
    faces = mt.faces[mt.faces_valid].cpu().numpy()[:nf]
    return verts, faces, nv, nf


def run_synthetic_pipeline(out_dir: str, scale: Optional[PipelineScale] = None,
                           prompt: str = "a red jacket",
                           device=None) -> Dict[str, str]:
    """The whole chain on synthetic data (an ellipsoid body, stub priors)."""
    dev = resolve_device(device)
    scale = scale or PipelineScale.tiny()
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()

    body_verts, body_faces, _, _ = synthetic_body(scale.grid_res, dev)

    # Stage 0: SDF init + init_mesh export.
    sp_dir = os.path.join(out_dir, "spatial")
    arts = run_spatial_stage(
        sp_dir, body_verts, body_faces, prompt, scale, device=dev
    )

    # Stage 2 needs posed "GT frames": render the init mesh's Gaussians
    # from synthetic cameras with procedural colours.
    mesh = load_init_mesh(arts["init_mesh"])
    colors = np.clip(
        0.5 + 0.8 * np.asarray(mesh["vertices"], np.float32), 0.05, 0.95
    )
    sampler = RandomCameraSampler(_cam_cfg(scale), seed=7)
    b_gt, p_gt = build_tetgs(
        np.asarray(mesh["vertices"], np.float32),
        np.asarray(mesh["faces"], np.int64), colors,
        np.asarray(mesh["face_to_global_tet_idx"], np.int64), sh_levels=2,
        device=dev,
    )
    gt_cams = []
    rc = dataclasses.replace(scale.raster, sh_degree=0)
    with torch.no_grad():
        m_, s_, q_, o_, sh_ = gaussian_arrays(b_gt, p_gt)
        for _ in range(6):
            cam = sampler.sample().global_[0]
            img = render_gaussians(m_, s_, q_, o_, sh_,
                                   cam.raster_camera(dev), rc,
                                   torch.ones(3, device=dev))["image"]
            cam.image = torch.clamp(img, 0, 1).cpu().numpy()
            gt_cams.append(cam)

    it_dir = os.path.join(out_dir, "init_texture")
    arts2 = run_init_texture_stage(
        it_dir, arts["init_mesh"], gt_cams, scale, vertex_colors=colors,
        device=dev,
    )
    cleanup()  # free the stage's memory before the edit (the reference's
    # `cleanup()` between stages)

    # Stage 1 (edit) over the localized region, then the edit mesh export.
    region = load_editing_region_info(arts2["editing_region_info"])
    arts3 = run_spatial_stage(
        sp_dir, body_verts, body_faces, prompt, scale,
        editing_region_info=region, device=dev,
    )
    cleanup()

    # Stage 4.
    et_dir = os.path.join(out_dir, "edit_texture")
    arts4 = run_edit_texture_stage(
        et_dir, arts3["edit_mesh"], arts2["tetgs_init"], prompt, scale,
        device=dev,
    )
    return {
        **arts, **arts2, **arts3, **arts4,
        "elapsed_s": str(round(time.time() - t0, 1)),
    }
