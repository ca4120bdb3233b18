"""Stage 2 — initial texture: fit bound-Gaussian appearance to frames.

Counterpart of `youreditableavatar_tpu/stages/init_texture.py`: the
photometric fit (l1 + D-SSIM at λ=0.2 + scaling regulariser) over the
training cameras with the 3DGS Adam groups, raising the active SH degree
every `sh_warmup_every` iterations. Cameras and frames are stacked device
tensors; each step renders one view through the Hopper kernels (CUDA) or
their plain versions (CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch.models.cameras import GSCamera
from youreditableavatar_tpu_torch.models.optimizer import (
    OptimizationParams,
    make_tetgs_optimizer,
)
from youreditableavatar_tpu_torch.models.tetgs import (
    PARAM_NAMES,
    TetGSBinding,
    TetGSParams,
    gaussian_arrays,
    scaling_regularizer,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster import (
    BudgetGovernor,
    RasterCamera,
    RasterizeConfig,
    count_pairs,
    fit_pair_budget,
    render_gaussians,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.binning import (
    pack_depth_ordered,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.counting import (
    tile_histogram,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.expand_cuda import (
    expand_pairs_kernel,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.preprocess import (
    preprocess_gaussians,
)
from youreditableavatar_tpu_torch.ops.image_losses import l1_dssim
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.registry import register


@dataclasses.dataclass(frozen=True)
class InitTextureConfig:
    num_iterations: int = 4000
    dssim_factor: float = 0.2
    sh_warmup_every: int = 1000
    scaling_reg: bool = True
    scaling_reg_weight: float = 1.0
    log_every: int = 100
    white_background: bool = True
    # Size the pair budget from an exact count pre-pass at init, and
    # grow/raise on runtime overflow instead of training on truncated renders.
    auto_size_budget: bool = True
    overflow_policy: str = "grow"  # "grow" | "raise" | "warn"
    raster: RasterizeConfig = dataclasses.field(
        default_factory=lambda: RasterizeConfig()
    )
    opt: OptimizationParams = dataclasses.field(
        default_factory=lambda: OptimizationParams()
    )


class CameraStack:
    """Stacked device-side cameras + frames (uniform resolution)."""

    def __init__(self, cameras: Sequence[GSCamera], with_images: bool = True,
                 device=None):
        if not cameras:
            raise ValueError("no cameras")
        dev = resolve_device(device)
        w, h = cameras[0].width, cameras[0].height
        for c in cameras:
            if (c.width, c.height) != (w, h):
                raise ValueError("cameras must share a resolution on-device")
        self.width, self.height = w, h

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        self.viewmats = f32(np.stack([c.viewmat for c in cameras]))
        self.fx = f32([c.fx for c in cameras])
        self.fy = f32([c.fy for c in cameras])
        self.cx = f32([c.cx for c in cameras])
        self.cy = f32([c.cy for c in cameras])
        self.images: Optional[Tensor] = None
        if with_images and cameras[0].image is not None:
            self.images = f32(np.stack([c.image for c in cameras]))
        self.n = len(cameras)
        self.device = dev

    def camera(self, idx: int) -> RasterCamera:
        return RasterCamera(
            viewmat=self.viewmats[idx], fx=self.fx[idx], fy=self.fy[idx],
            cx=self.cx[idx], cy=self.cy[idx],
            width=self.width, height=self.height,
        )

    def spatial_extent(self) -> float:
        v = self.viewmats.detach().cpu().numpy()
        centers = np.asarray([-(m[:3, :3].T @ m[:3, 3]) for m in v])
        return float(np.linalg.norm(centers - centers.mean(0), axis=-1).max())


def auto_size_raster_config(
    gaussians: Tuple[Tensor, Tensor, Tensor, Tensor, Optional[Tensor]],
    stack: CameraStack,
    rcfg: RasterizeConfig,
    sample: int = 8,
    headroom: float = 1.3,
) -> RasterizeConfig:
    """Exact-count pre-pass over ≤ `sample` evenly spaced views → bucketed
    pair budget and per-tile capacity (the max tile depth, read from the
    tile histogram of the fitted budget's expansion)."""
    means, scales, quats, opac, _ = gaussians
    means, scales, quats, opac = (x.detach() for x in (means, scales, quats, opac))
    sh = torch.zeros((means.shape[0], 1, 3), device=means.device)
    rcfg0 = dataclasses.replace(rcfg, sh_degree=0)
    idxs = np.unique(
        np.linspace(0, stack.n - 1, min(stack.n, sample)).astype(np.int32)
    )
    mx = max(int(count_pairs(means, scales, quats, opac, sh, stack.camera(i),
                             rcfg0)) for i in idxs)
    budget = fit_pair_budget(mx, headroom=headroom)

    ts = rcfg.tile_size
    ntx = -(-stack.width // ts)
    nty = -(-stack.height // ts)
    mt = 0
    with torch.no_grad():
        for i in idxs:
            proj = preprocess_gaussians(means, scales, quats, opac, sh,
                                        stack.camera(i), 0, ts, rcfg.scale_mod,
                                        None, rect_mode=rcfg.rect_mode)
            tile, _, _ = expand_pairs_kernel(pack_depth_ordered(proj), budget,
                                             ntx, nty, ts)
            mt = max(mt, int(tile_histogram(tile, ntx * nty)[:-1].max()))
    capacity = fit_pair_budget(mt, headroom=headroom, min_budget=128)
    return dataclasses.replace(rcfg, pair_budget=budget, tile_capacity=capacity)


@register("tetgs-init-trainer")
class TetGSInitTrainer:
    """Photometric appearance fit over training views."""

    def __init__(
        self,
        binding: TetGSBinding,
        params: TetGSParams,
        cameras: Sequence[GSCamera],
        cfg: InitTextureConfig = InitTextureConfig(),
        device=None,
    ):
        self.device = resolve_device(device)
        self.binding = binding
        self.params = params
        self.cfg = cfg
        self.stack = CameraStack(cameras, device=self.device)
        if self.stack.images is None:
            raise ValueError("training cameras need images")
        self.spatial_extent = self.stack.spatial_extent()
        self.optimizer = make_tetgs_optimizer(params, cfg.opt,
                                              self.spatial_extent)
        if cfg.auto_size_budget:
            self.cfg = cfg = dataclasses.replace(
                cfg, raster=auto_size_raster_config(
                    gaussian_arrays(binding, params), self.stack, cfg.raster)
            )
        self.governor = BudgetGovernor(policy=cfg.overflow_policy,
                                       name="tetgs-init")
        self._steps: Dict[int, Callable] = {}
        self.losses: List[float] = []
        self.stats: List[dict] = []

    def _make_step(self, sh_degree: int) -> Callable:
        cfg = self.cfg
        binding, params, stack = self.binding, self.params, self.stack
        bg = torch.full((3,), 1.0 if cfg.white_background else 0.0,
                        device=self.device)
        rcfg = dataclasses.replace(cfg.raster, sh_degree=sh_degree)

        def step(cam_idx: int):
            """One fit step on view `cam_idx`: (loss, diagnostics)."""
            self.optimizer.zero_grad()
            means, scales, quats, opac, sh = gaussian_arrays(binding, params)
            out = render_gaussians(means, scales, quats, opac, sh,
                                   stack.camera(cam_idx), rcfg, bg)
            loss = l1_dssim(out["image"], stack.images[cam_idx],
                            cfg.dssim_factor)
            if cfg.scaling_reg:
                loss = loss + cfg.scaling_reg_weight * scaling_regularizer(
                    binding, params)
            loss.backward()
            self.optimizer.step()
            diag = {"num_pairs": out["num_pairs"],
                    "num_tile_overflow": out["num_tile_overflow"]}
            return loss.detach(), diag

        return step

    def step_fn(self, iteration: int) -> Callable:
        """The step function for `iteration` (SH degree raised every
        `sh_warmup_every` iterations, up to sh_levels − 1)."""
        sh_degree = min(iteration // max(self.cfg.sh_warmup_every, 1),
                        self.binding.sh_levels - 1)
        if sh_degree not in self._steps:
            self._steps[sh_degree] = self._make_step(sh_degree)
        return self._steps[sh_degree]

    def param_stats(self) -> dict:
        """min/max/mean/std of every Gaussian parameter tensor."""
        out = {}
        for name in PARAM_NAMES:
            a = getattr(self.params, name).detach()
            if a.numel() == 0:
                continue
            out[name] = {"min": float(a.min()), "max": float(a.max()),
                         "mean": float(a.mean()), "std": float(a.std())}
        return out

    def train(self, seed: int = 0, num_iterations: Optional[int] = None,
              verbose: bool = False) -> TetGSParams:
        n_iter = num_iterations or self.cfg.num_iterations
        rng = np.random.default_rng(seed)
        t0 = time.time()
        for it in range(n_iter):
            cam_idx = int(rng.integers(0, self.stack.n))
            loss, diag = self.step_fn(it)(cam_idx)
            if it % self.cfg.log_every == 0 or it == n_iter - 1:
                new_rcfg = self.governor.check(
                    self.cfg.raster, diag["num_pairs"],
                    diag["num_tile_overflow"], step=it,
                )
                if new_rcfg is not None:
                    self.cfg = dataclasses.replace(self.cfg, raster=new_rcfg)
                    self._steps.clear()  # rebuild at the grown budget
                self.losses.append(float(loss))
                self.stats.append({"iteration": it, "loss": float(loss),
                                   "num_pairs": int(diag["num_pairs"]),
                                   "num_tile_overflow":
                                       int(diag["num_tile_overflow"]),
                                   **self.param_stats()})
                if verbose:
                    print(f"[tetgs-init] it {it} loss {float(loss):.5f}")
        self.elapsed = time.time() - t0
        return self.params

    def render_views(self, cameras: Sequence[GSCamera],
                     sh_degree: Optional[int] = None) -> List[np.ndarray]:
        """Validation renders, clipped to [0, 1], as host arrays."""
        deg = self.binding.sh_levels - 1 if sh_degree is None else sh_degree
        rcfg = dataclasses.replace(self.cfg.raster, sh_degree=deg)
        bg = torch.full((3,), 1.0 if self.cfg.white_background else 0.0,
                        device=self.device)
        out = []
        with torch.no_grad():
            means, scales, quats, opac, sh = gaussian_arrays(self.binding,
                                                             self.params)
            for cam in cameras:
                img = render_gaussians(means, scales, quats, opac, sh,
                                       cam.raster_camera(self.device), rcfg,
                                       bg)["image"]
                out.append(torch.clamp(img, 0, 1).cpu().numpy())
        return out
