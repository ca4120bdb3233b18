"""The stage-1 SDS geometry-edit step, plain: a frozen copy of the SDS path
of the port's `HumanEditTrainer` (`stages/spatial.py`: `draws`, `_render`,
`_step`, `train_step`) over the plain modules of this package.

Kept: the per-step camera pair, the local-or-global choice, the view
prompts, the selection cache refreshed in rotating slices, the SDS term,
the keep-region recon and control-SDF terms, normal consistency and AdamW.
Left out, as the cell never takes them: the du mode, image-guided editing,
the pair-budget governor and the visual checkpoints."""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import Tensor

from benchmark.reference.camera_sampler import (
    RandomCameraConfig,
    RandomCameraSampler,
)
from benchmark.reference.part_renderer import (
    normal_consistency,
    render_part_maps,
)
from benchmark.reference.schedule import C
from benchmark.reference.sds import draw_timestep_noise


def step_generator(*key: int) -> torch.Generator:
    """A CPU generator seeded by a tuple of ints."""
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


class EditStep:
    """One SDS edit step at a time from `start_step`, on `params` in place.

    `loss_weights` holds the schedules `lambda_sds`, `lambda_sds_global`,
    `lambda_sdf_recon`, `lambda_sdf_control`, `lambda_normal_consistency`,
    `lambda_normal_consistency_sub`; `control_sdf` the control field at the
    grid vertices (None: the term is off)."""

    def __init__(self, field, geometry, partition, params, guidance, prompts,
                 camera: RandomCameraConfig, mesh_cfg, loss_weights: Dict,
                 optimizer: Dict, recon_points: int, sub_step: int,
                 sdf_cache_refresh: int, start_step: int, seed: int,
                 control_sdf: Optional[Tensor], device):
        self.field, self.geometry, self.partition = field, geometry, partition
        self.params = params
        self.guidance, self.prompts = guidance, prompts
        self.camera, self.mesh_cfg = camera, mesh_cfg
        self.w = loss_weights
        self.recon_points, self.sub_step = recon_points, sub_step
        self.refresh = sdf_cache_refresh
        self.global_step = start_step
        self.seed = seed
        self.device = device
        self.sampler = RandomCameraSampler(camera, seed=seed)
        self.optimizer = torch.optim.AdamW(
            params.parameters(), lr=optimizer["lr"],
            betas=tuple(optimizer["betas"]), eps=optimizer["eps"],
            weight_decay=optimizer["weight_decay"])
        frozen = copy.deepcopy(params).requires_grad_(False)
        with torch.no_grad():
            self.recon_sdf = field.forward_sdf_chunked(frozen,
                                                       geometry.grid_pos)
        self.control_sdf = control_sdf
        self.sdf_cache = partition.frozen_sdf.clone()
        live = partition.live_vert_idx.cpu().numpy()
        r = -(-live.shape[0] // sdf_cache_refresh)
        pad = np.resize(live, (sdf_cache_refresh * r,))
        self.refresh_slices = torch.as_tensor(
            pad.reshape(sdf_cache_refresh, r).astype(np.int64), device=device)
        self.records: List[Dict[str, float]] = []

    def draws(self, seed: int, step: int) -> Dict[str, Tensor]:
        g = step_generator(seed, step)
        min_t, max_t = self.guidance.timestep_range(0, step)
        prior = self.guidance.prior
        d = prior.latent_downscale
        shape = (1, self.camera.height // d, self.camera.width // d,
                 prior.latent_channels)
        t, noise = draw_timestep_noise(shape, min_t, max_t, g, self.device)
        nv = self.geometry.grid_pos.shape[0]
        recon = torch.randint(0, nv, (self.recon_points,), generator=g)
        enc_noise = torch.randn(shape, generator=g).to(self.device)
        return {"t": t, "noise": noise, "recon_idx": recon.to(self.device),
                "enc_noise": enc_noise}

    def step(self, seed: int) -> Dict[str, float]:
        dev = self.device
        step_i = self.global_step
        field, geometry, part, p = (self.field, self.geometry,
                                    self.partition, self.params)
        step_rng = np.random.default_rng((self.seed, 1, step_i))
        self.sampler.rng = np.random.default_rng((self.seed, 2, step_i))
        batch = self.sampler.sample(step_i)
        cam_l = batch.local[0].raster_camera(dev)
        cam_g = batch.global_[0].raster_camera(dev)
        use_global = step_rng.random() >= C(self.w["lambda_sds"], 0, step_i)
        cond, uncond = self.prompts.get_text_embeddings(
            batch.elevation_deg[:1], batch.azimuth_deg[:1])
        nc_spec = (self.w["lambda_normal_consistency"]
                   if step_i < self.sub_step
                   else self.w["lambda_normal_consistency_sub"])
        w_sds = C(self.w["lambda_sds_global"] if use_global
                  else self.w["lambda_sds"], 0, step_i)
        w_recon = C(self.w["lambda_sdf_recon"], 0, step_i)
        w_ctrl = (C(self.w["lambda_sdf_control"], 0, step_i)
                  if self.control_sdf is not None else 0.0)
        w_nc = C(nc_spec, 0, step_i)
        min_t, max_t = self.guidance.timestep_range(0, step_i)
        refresh_idx = self.refresh_slices[step_i % self.refresh]
        gcfg = field.cfg.grid
        n_active = int(min(gcfg.start_level + max(step_i - gcfg.start_step, 0)
                           // gcfg.update_steps, gcfg.n_levels))
        draws = self.draws(seed, step_i)
        cond = torch.as_tensor(cond, device=dev)
        uncond = torch.as_tensor(uncond, device=dev)
        lm = (torch.arange(gcfg.n_levels, device=dev) < n_active).to(
            torch.float32)

        self.optimizer.zero_grad(set_to_none=True)
        mt, new_cache = geometry.part_isosurface_cached(
            p, part, self.sdf_cache, refresh_idx, level_mask=lm,
            n_active=n_active)
        maps = render_part_maps(part.keep_mesh, mt, cam_l,
                                cam_g if use_global else None, self.mesh_cfg)
        normal_img = (maps["global_comp_normal"] if use_global
                      else maps["local_comp_normal"])
        sds = self.guidance(normal_img[None], cond, uncond, None, min_t,
                            max_t, t=draws["t"], noise=draws["noise"],
                            enc_noise=draws["enc_noise"])
        loss = w_sds * sds["loss_sds"]
        k_idx = draws["recon_idx"]
        live = field.forward_sdf(p, geometry.grid_pos[k_idx], level_mask=lm,
                                 n_active=n_active)
        keep_w = (~part.live_vert_mask[k_idx]).to(torch.float32)
        loss_recon = torch.sum(keep_w * (live - self.recon_sdf[k_idx]) ** 2)
        loss = loss + w_recon * loss_recon
        if w_ctrl > 0:
            loss_ctrl = torch.sum(
                part.live_vert_mask[k_idx].to(torch.float32)
                * (live - self.control_sdf[k_idx]) ** 2)
            loss = loss + w_ctrl * loss_ctrl
        loss = loss + w_nc * normal_consistency(mt)
        loss.backward()
        self.optimizer.step()
        self.sdf_cache = new_cache
        self.global_step += 1
        rec = {"loss": float(loss.detach()),
               "faces": int(mt.faces_valid.sum()) + int(
                   part.keep_mesh.faces_valid.sum()),
               "pairs": int(maps["local_num_pairs"])
               + (int(maps["global_num_pairs"]) if use_global else 0),
               "resolves": 2 if use_global else 1}
        self.records.append(rec)
        return rec
