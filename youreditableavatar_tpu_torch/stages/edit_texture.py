"""Stage 4 — texture editing: progressive inpainting + 3D refinement.

Counterpart of `youreditableavatar_tpu/stages/edit_texture.py`:

  * `InpaintTrainer.inpaint_training`: walk the 3-ring camera set; per view
    render masks/normals with the textured-mesh model (the mesh visibility
    rasterizer), call the Inpainter backend (any `guidance.base.Inpainter`;
    views 0/1 use the joint front/back path), composite the guidance image,
    fit the edit-Gaussian colors/opacity against it (iteration ladder
    1000/800/400), then roll back Gaussians outside the painted faces.
  * `InpaintTrainer.prepare_refine_guidance`: turntable renders,
    img2img-refined (strength 0.4), blended per pixel between edit and keep
    renders.
  * `RefineTrainer.refined_editing`: promote the 2D disks to the 3D model
    and train on the blended views (l1+dssim, 10× weight on the key views,
    scaling regularizer, and with `lambda_perceptual > 0` an LPIPS term).

With a `segmenter` (any `stages.localization.Segmenter`), the joint
front/back views blend their guidance only where the painted mask and a
"person" mask of the inpainted image agree, dilated by 15 px — the edge
fix for stray background pixels the inpainter painted.

Where the JAX trainers take a PRNG key these take a `torch.Generator` (or
None) and hand it to the inpainter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.base import Inpainter
from youreditableavatar_tpu_torch.models.cameras import GSCamera
from youreditableavatar_tpu_torch.models.tetgs import PARAM_NAMES
from youreditableavatar_tpu_torch.models.tetgs_edit import (
    EditBinding,
    EditParams,
    full_gaussian_arrays,
    promote_to_3d,
    render_edit_tetgs,
    rollback_outside_faces,
)
from youreditableavatar_tpu_torch.models.textured_mesh import TexturedMeshModel
from youreditableavatar_tpu_torch.ops.gaussian_raster import (
    BudgetGovernor,
    RasterCamera,
    RasterizeConfig,
)
from youreditableavatar_tpu_torch.ops.image_losses import dssim, l1_dssim
from youreditableavatar_tpu_torch.ops.lpips import LPIPS
from youreditableavatar_tpu_torch.ops.morphology import dilate
from youreditableavatar_tpu_torch.stages.init_texture import (
    CameraStack,
    auto_size_raster_config,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.profiling import span
from youreditableavatar_tpu_torch.utils.registry import register


@dataclasses.dataclass(frozen=True)
class InpaintConfig:
    # Iteration ladder per view group.
    iters_first: int = 1000
    iters_second: int = 800
    iters_rest: int = 400
    first_group: int = 4
    second_group: int = 4
    lr_sh: float = 0.0025
    lr_opacity: float = 0.05
    inpaint_steps: int = 30
    white_background: bool = True
    # Fit loss = (1−f)·masked-L1 + f·D-SSIM against the composited target.
    dssim_factor: float = 0.2
    # Views 0/1 (front + back) are inpainted JOINTLY as one side-by-side
    # image so the two sides agree.
    joint_front_back: bool = True
    fb_res: int = 512  # per-side resolution of the joint inpaint
    # Pair-budget overflow policy (ops.gaussian_raster.budget): "grow"
    # rebuilds the fit step at a larger budget and refits the view;
    # "raise" hard-fails; "warn" keeps going on a truncated render.
    overflow_policy: str = "grow"
    # Size pair_budget/tile_capacity from an exact count pre-pass at init.
    auto_size_budget: bool = True
    raster: RasterizeConfig = dataclasses.field(
        default_factory=lambda: RasterizeConfig()
    )


def _edit_param_mask(train_positions: bool = False,
                     train_geometry: bool = False) -> Dict[str, bool]:
    """Which EditParams leaves train during inpainting (colors + opacity)."""
    return {
        "delta": train_positions,
        "log_scales": train_geometry,
        "quats": train_geometry,
        "opacity_raw": True,
        "sh_dc": True,
        "sh_rest": True,
    }


def make_edit_optimizer(
    params: EditParams, lr_sh: float, lr_opacity: float,
    train_mask: Dict[str, bool],
) -> torch.optim.Adam:
    """Adam (eps 1e-15) with one group per trained leaf. A leaf whose mask
    is False is not given to the optimizer and so never moves; it also
    stops requiring a gradient."""
    lrs = {
        "delta": 1.6e-4,
        "log_scales": 5e-3,
        "quats": 1e-3,
        "opacity_raw": lr_opacity,
        "sh_dc": lr_sh,
        "sh_rest": lr_sh / 20.0,
    }
    groups = []
    for name in PARAM_NAMES:
        leaf = getattr(params, name)
        leaf.requires_grad_(bool(train_mask[name]))
        if train_mask[name] and leaf.numel() > 0:
            groups.append({"params": [leaf], "lr": lrs[name], "name": name})
    return torch.optim.Adam(groups, eps=1e-15)


def _resize_bilinear(img: Tensor, height: int, width: int) -> Tensor:
    """(H, W) or (H, W, C) bilinear resize with half-pixel centres,
    antialiased when it shrinks."""
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    x = F.interpolate(x.permute(2, 0, 1)[None], size=(height, width),
                      mode="bilinear", align_corners=False, antialias=True)
    x = x[0].permute(1, 2, 0)
    return x[..., 0] if squeeze else x


def _background(white: bool, device) -> Tensor:
    return torch.full((3,), 1.0 if white else 0.0, device=device)


@register("tetgs-inpaint")
class InpaintTrainer:
    def __init__(
        self,
        binding: EditBinding,
        params: EditParams,
        mesh_model: TexturedMeshModel,
        cameras: Sequence[GSCamera],
        inpainter: Inpainter,
        prompt: str,
        negative_prompt: str = "",
        cfg: InpaintConfig = InpaintConfig(),
        segmenter=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.binding = binding
        self.params = params
        self.mesh_model = mesh_model
        self.cameras = list(cameras)
        self.inpainter = inpainter
        self.prompt = prompt
        self.negative_prompt = negative_prompt
        self.cfg = cfg
        # Optional stages.localization.Segmenter for the front/back views'
        # edge fix: the guidance blend mask is intersected with a "person"
        # mask of the inpainted image and max-pool dilated, so stray
        # background pixels the inpainter painted outside the subject do
        # not become targets.
        self.segmenter = segmenter
        self.train_mask = _edit_param_mask()
        self.governor = BudgetGovernor(
            policy=cfg.overflow_policy, name="tetgs-inpaint"
        )
        if cfg.auto_size_budget:
            self.cfg = cfg = dataclasses.replace(
                cfg, raster=auto_size_raster_config(
                    full_gaussian_arrays(binding, params)[:5],
                    CameraStack(self.cameras, with_images=False,
                                device=self.device),
                    cfg.raster,
                )
            )
        self.history: List[Dict[str, float]] = []

    def _bg(self) -> Tensor:
        return _background(self.cfg.white_background, self.device)

    def _rcfg(self) -> RasterizeConfig:
        return dataclasses.replace(
            self.cfg.raster, sh_degree=self.binding.sh_levels - 1
        )

    def _render_current(self, cam: RasterCamera) -> Tensor:
        with torch.no_grad():
            return render_edit_tetgs(
                self.binding, self.params, cam, self._rcfg(), self._bg()
            )["image"]

    def _fit_step(self, params: EditParams, optimizer: torch.optim.Adam,
                  cam: RasterCamera, target: Tensor, weight: Tensor):
        """One fit step of `params` on one view: (loss, diagnostics)."""
        optimizer.zero_grad(set_to_none=True)
        out = render_edit_tetgs(self.binding, params, cam, self._rcfg(),
                                self._bg())
        diff = torch.abs(out["image"] - target)
        l1 = torch.sum(diff * weight[..., None]) / (
            torch.sum(weight) * 3.0 + 1e-6
        )
        # The D-SSIM term runs on the full composited target (outside the
        # mask target == current render, so it only shapes the painted
        # region and its surround).
        dssim_f = self.cfg.dssim_factor
        loss = (1.0 - dssim_f) * l1 + dssim_f * dssim(out["image"], target)
        loss.backward()
        optimizer.step()
        diag = {"num_pairs": out["num_pairs"],
                "num_tile_overflow": out["num_tile_overflow"]}
        return loss.detach(), diag

    def _iters_for_view(self, idx: int) -> int:
        if idx < self.cfg.first_group:
            return self.cfg.iters_first
        if idx < self.cfg.first_group + self.cfg.second_group:
            return self.cfg.iters_second
        return self.cfg.iters_rest

    def _joint_front_back_guidance(
        self, generator: Optional[torch.Generator]
    ) -> List[Tensor]:
        """Views 0/1 inpainted as ONE side-by-side front|back image, so
        front and back agree; the halves are split back and used as the
        per-view guidance."""
        cfg = self.cfg
        h, w = self.cameras[0].height, self.cameras[0].width
        r = cfg.fb_res
        halves = {"image": [], "mask": [], "normal": []}
        for gscam in self.cameras[:2]:
            cam = gscam.raster_camera(self.device)
            view = self.mesh_model.render_view(cam)
            masks = self.mesh_model.prepare_inpaint_masks(view)
            current = self._render_current(cam)
            halves["image"].append(_resize_bilinear(current, r, r))
            halves["mask"].append(
                _resize_bilinear(masks["inpaint_mask_soft"], r, r))
            halves["normal"].append(
                _resize_bilinear(view["comp_normal"], r, r))
        img_fb = torch.cat(halves["image"], dim=1)
        mask_fb = torch.cat(halves["mask"], dim=1)
        norm_fb = torch.cat(halves["normal"], dim=1)
        joint = self.inpainter.inpaint(
            image=img_fb, mask=mask_fb, control_normal=norm_fb,
            control_repaint=img_fb, prompt=self.prompt,
            negative_prompt=self.negative_prompt, generator=generator,
            steps=self.cfg.inpaint_steps,
        )
        joint = torch.clamp(
            torch.as_tensor(joint, dtype=torch.float32, device=self.device),
            0.0, 1.0)
        return [
            _resize_bilinear(joint[:, :r], h, w),
            _resize_bilinear(joint[:, r:], h, w),
        ]

    def inpaint_training(
        self, generator: Optional[torch.Generator] = None,
        iters_scale: float = 1.0,
    ) -> EditParams:
        cfg = self.cfg
        dev = self.device

        fb_guidance: Optional[List[Tensor]] = None
        if cfg.joint_front_back and len(self.cameras) >= 2:
            fb_guidance = self._joint_front_back_guidance(generator)

        for vi, gscam in enumerate(self.cameras):
            cam = gscam.raster_camera(dev)
            view = self.mesh_model.render_view(cam)
            masks = self.mesh_model.prepare_inpaint_masks(view)

            # Current model render (the image being completed).
            current = self._render_current(cam)

            # Guidance image: views 0/1 take the precomputed joint
            # front/back result; later views the per-view
            # normal-conditioned inpaint.
            if fb_guidance is not None and vi < 2:
                guidance = fb_guidance[vi]
            else:
                guidance = self.inpainter.inpaint(
                    image=current,
                    mask=masks["inpaint_mask_soft"],
                    control_normal=view["comp_normal"],
                    control_repaint=current,
                    prompt=self.prompt,
                    negative_prompt=self.negative_prompt,
                    generator=generator,
                    steps=cfg.inpaint_steps,
                )
            guidance = torch.clamp(
                torch.as_tensor(guidance, dtype=torch.float32, device=dev),
                0.0, 1.0)
            # Composite: keep region from the current render.
            m = masks["inpaint_mask_soft"][..., None]
            if self.segmenter is not None and fb_guidance is not None \
                    and vi < 2:
                # Edge fix for the joint views: blend only where the
                # painted mask ∩ person mask says the subject is, dilated
                # by a 15-px max-pool.
                person = torch.as_tensor(
                    self.segmenter.segment(guidance, "person"),
                    dtype=torch.bool, device=dev)
                mm = (masks["inpaint_mask"] > 0.5) & person
                m = dilate(mm, size=15)[..., None]
            target = guidance * m + current * (1 - m)

            # Fit the edit gaussians to the composited target inside the
            # editable coverage.
            weight = ((view["editable"] > 0.5)
                      | (masks["inpaint_mask"] > 0.5)).to(torch.float32)
            prev_params = self.params
            n_iters = max(1, int(self._iters_for_view(vi) * iters_scale))
            # Restart-on-grow: overflow diagnostics are view-dependent, so
            # probe them on the view's first step; if the governor grows the
            # budget, refit the whole view from the pre-fit params (the
            # truncated first step is discarded).
            while True:
                params = prev_params.copy()
                optimizer = make_edit_optimizer(
                    params, cfg.lr_sh, cfg.lr_opacity, self.train_mask)
                regrown = False
                for it in range(n_iters):
                    loss, diag = self._fit_step(params, optimizer, cam,
                                                target, weight)
                    if it == 0:
                        new_rcfg = self.governor.check(
                            cfg.raster, diag["num_pairs"],
                            diag["num_tile_overflow"], step=vi,
                        )
                        if new_rcfg is not None:
                            self.cfg = cfg = dataclasses.replace(
                                cfg, raster=new_rcfg
                            )
                            regrown = True
                            break
                if not regrown:
                    break
            self.params = params

            # Back-project the newly painted pixels (host numpy, one copy
            # of the masks per view) and roll back gaussians outside the
            # painted face set.
            painted_px = (masks["inpaint_mask"] > 0.5).cpu().numpy()
            self.mesh_model.back_project(view, painted_px)
            # Faces painted in ANY view so far stay; others roll back.
            total_painted = torch.as_tensor(
                self.mesh_model.painted[self.mesh_model.faces_np].any(1),
                device=dev,
            )
            self.params = rollback_outside_faces(
                self.binding, self.params, prev_params, total_painted
            )
            self.history.append(
                {"view": vi, "loss": float(loss), "iters": n_iters}
            )
        return self.params

    def prepare_refine_guidance(
        self,
        turntable: Sequence[GSCamera],
        generator: Optional[torch.Generator] = None,
        strength: float = 0.4,
        upscale_to_2048: bool = False,
        draws=None,
    ) -> List[np.ndarray]:
        """Refined + blended guidance images, one per turntable view: each
        render is img2img-refined at `strength` and blended with the render
        by the soft edit mask. With `upscale_to_2048` (an SDXL pipeline's
        `sdxl_tile_refine`) each view is refined as 2×2 crops of its 2×
        upscale and resized back to the render's shape.

        `draws(name, shape)`, when given, is handed to the inpainter with
        the names prefixed "view<i>/" (view i's draws)."""
        out_images = []
        for i, gscam in enumerate(turntable):
            cam = gscam.raster_camera(self.device)
            render = self._render_current(cam)
            kw = {}
            if draws is not None:
                kw["draws"] = (lambda name, shape, i=i:
                               draws(f"view{i}/{name}", shape))
            if upscale_to_2048:
                from youreditableavatar_tpu_torch.guidance.sdxl_pipeline \
                    import sdxl_tile_refine

                refined = torch.clamp(sdxl_tile_refine(
                    self.inpainter, render, self.prompt, generator, strength,
                    upscale_to_2048=True, **kw), 0, 1)
                refined = _resize_bilinear(refined, *render.shape[:2])
            else:
                refined = torch.clamp(
                    torch.as_tensor(
                        self.inpainter.img2img(
                            render, render, self.prompt, generator=generator,
                            strength=strength, **kw,
                        ), dtype=torch.float32, device=self.device,
                    ), 0, 1,
                )
            blend = self.mesh_model.concat_blend_masks(cam)
            m = blend["edit_mask_soft"][..., None]
            img = refined * m + render * (1 - m)
            out_images.append(img.cpu().numpy())
        return out_images


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    num_iterations: int = 2000
    key_views: Tuple[int, ...] = (0, 14, 29, 44)
    key_view_weight: float = 10.0
    dssim_factor: float = 0.2
    scaling_reg: bool = True
    # Optional LPIPS perceptual term; 0 = off.
    lambda_perceptual: float = 0.0
    white_background: bool = True
    overflow_policy: str = "grow"  # see ops.gaussian_raster.budget
    auto_size_budget: bool = True
    raster: RasterizeConfig = dataclasses.field(
        default_factory=lambda: RasterizeConfig()
    )
    sh_levels: int = 4


@register("tetgs-refine")
class RefineTrainer:
    def __init__(
        self,
        binding2d: EditBinding,
        params2d: EditParams,
        cameras: Sequence[GSCamera],
        images: Sequence[np.ndarray],
        cfg: RefineConfig = RefineConfig(),
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.binding, self.params = promote_to_3d(
            binding2d, params2d, sh_levels=cfg.sh_levels
        )
        self.cameras = list(cameras)
        self.stack = CameraStack(self.cameras, with_images=False,
                                 device=self.device)
        self.images = torch.as_tensor(
            np.stack(images).astype(np.float32), device=self.device)
        self.optimizer = make_edit_optimizer(
            self.params, 0.0025, 0.05,
            _edit_param_mask(train_positions=True, train_geometry=True),
        )
        self.governor = BudgetGovernor(
            policy=cfg.overflow_policy, name="tetgs-refine"
        )
        if cfg.auto_size_budget:
            self.cfg = cfg = dataclasses.replace(
                cfg, raster=auto_size_raster_config(
                    full_gaussian_arrays(self.binding, self.params)[:5],
                    self.stack, cfg.raster,
                )
            )
        self.losses: List[float] = []
        self._lpips = LPIPS(device=self.device) \
            if cfg.lambda_perceptual > 0 else None

    def _bg(self) -> Tensor:
        return _background(self.cfg.white_background, self.device)

    def _rcfg(self) -> RasterizeConfig:
        return dataclasses.replace(self.cfg.raster,
                                   sh_degree=self.cfg.sh_levels - 1)

    def step(self, view_idx: int):
        """One refine step on view `view_idx`: (loss, diagnostics)."""
        with span("refine.step"):
            return self._step(view_idx)

    def _step(self, view_idx: int):
        cfg = self.cfg
        weight = cfg.key_view_weight if view_idx in cfg.key_views else 1.0
        self.optimizer.zero_grad(set_to_none=True)
        with span("refine.render"):
            out = render_edit_tetgs(self.binding, self.params,
                                    self.stack.camera(view_idx),
                                    self._rcfg(), self._bg())
        with span("refine.losses"):
            target = self.images[view_idx]
            loss = weight * l1_dssim(out["image"], target, cfg.dssim_factor)
            if self._lpips is not None:
                loss = loss + cfg.lambda_perceptual * self._lpips(
                    out["image"][None], target[None])
            if cfg.scaling_reg:
                scales = torch.exp(self.params.log_scales)
                max_v = torch.max(scales, dim=-1).values
                min_v = torch.min(scales, dim=-1).values
                ratio = max_v / torch.clamp(min_v, min=1e-12)
                bad = (ratio > 10.0) & (max_v > 0.1)
                cnt = torch.sum(bad)
                loss = loss + torch.sum(
                    torch.where(bad, max_v, torch.zeros_like(max_v))
                ) / torch.clamp(cnt, min=1)
        with span("refine.backward"):
            loss.backward()
        with span("refine.optimizer"):
            self.optimizer.step()
        diag = {"num_pairs": out["num_pairs"],
                "num_tile_overflow": out["num_tile_overflow"]}
        return loss.detach(), diag

    def refined_editing(
        self, seed: int = 0, num_iterations: Optional[int] = None
    ) -> EditParams:
        n_iter = num_iterations or self.cfg.num_iterations
        # numpy's generator, so both packages visit the same views.
        rng = np.random.default_rng(seed)
        for it in range(n_iter):
            vi = int(rng.integers(0, len(self.cameras)))
            loss, diag = self.step(vi)
            if it % 100 == 0:
                new_rcfg = self.governor.check(
                    self.cfg.raster, diag["num_pairs"],
                    diag["num_tile_overflow"], step=it,
                )
                if new_rcfg is not None:
                    self.cfg = dataclasses.replace(self.cfg, raster=new_rcfg)
                self.losses.append(float(loss))
        return self.params

    def validate(self, cameras: Sequence[GSCamera]) -> List[np.ndarray]:
        """Final turntable renders, clipped to [0, 1], as host arrays."""
        out = []
        with torch.no_grad():
            for cam in cameras:
                img = render_edit_tetgs(
                    self.binding, self.params,
                    cam.raster_camera(self.device), self._rcfg(), self._bg()
                )["image"]
                out.append(torch.clamp(img, 0, 1).cpu().numpy())
        return out
