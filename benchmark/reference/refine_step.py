"""The stage-4b refine step, plain: frozen copies of the port's
`models/tetgs_edit.py` (`EditParams`, `promote_to_3d`, the keep ∥ edit
arrays) and of `RefineTrainer.step` with `make_edit_optimizer`
(`stages/edit_texture.py`), rendering through `gs_render`.

Kept: the 2D → 3D promotion, the key-view weight, L1 + D-SSIM, the
scaling regulariser, Adam (eps 1e-15) with one group per leaf at the
port's rates. Left out, as the cell never takes them: the LPIPS term and
the pair-budget governor."""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import Tensor, nn

from benchmark.reference.gs_render import RasterizeConfig, render_gaussians
from benchmark.reference.image_losses import l1_dssim

PARAM_NAMES = ("delta", "log_scales", "quats", "opacity_raw", "sh_dc",
               "sh_rest")
LEARNING_RATES = {"delta": 1.6e-4, "log_scales": 5e-3, "quats": 1e-3,
                  "opacity_raw": 0.05, "sh_dc": 0.0025,
                  "sh_rest": 0.0025 / 20.0}


class EditParams(nn.Module):
    def __init__(self, **leaves: Tensor):
        super().__init__()
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(leaves[name]))


def promote_to_3d(binding: Dict, params: Dict, sh_levels: int):
    """2D disks → the 3D refine model: normal-offset deltas from the
    anchors, scales / quats / SH warm-started, the SH budget grown."""
    ne = binding["edit_ori"].shape[0]
    old_k = params["sh_rest"].shape[1]
    sh_rest = torch.zeros((ne, sh_levels ** 2 - 1, 3),
                          device=params["sh_rest"].device)
    if old_k > 0:
        sh_rest[:, :old_k] = params["sh_rest"]
    return EditParams(
        delta=torch.zeros((ne, 1), device=params["delta"].device),
        log_scales=params["log_scales"].clone(), quats=params["quats"].clone(),
        opacity_raw=params["opacity_raw"].clone(),
        sh_dc=params["sh_dc"].clone(), sh_rest=sh_rest)


def gaussian_arrays(b: Dict, p: EditParams, sh_levels: int):
    """keep ∥ edit (means, scales, quats, opacities, sh), the edit part at
    its normal offsets."""
    kk = sh_levels ** 2
    em = b["edit_ori"] + b["edit_normals"] * p.delta
    esh = torch.cat([p.sh_dc, p.sh_rest[:, :kk - 1]], dim=1)
    ksh_rest = b["keep_sh_rest"][:, :kk - 1]
    if ksh_rest.shape[1] < kk - 1:
        ksh_rest = torch.cat([ksh_rest, torch.zeros(
            (ksh_rest.shape[0], kk - 1 - ksh_rest.shape[1], 3),
            device=ksh_rest.device)], dim=1)
    ksh = torch.cat([b["keep_sh_dc"], ksh_rest], dim=1)
    return (torch.cat([b["keep_xyz"], em]),
            torch.cat([torch.exp(b["keep_log_scales"]),
                       torch.exp(p.log_scales)]),
            torch.cat([b["keep_quats"], p.quats]),
            torch.cat([torch.sigmoid(b["keep_opacity_raw"])[:, 0],
                       torch.sigmoid(p.opacity_raw)[:, 0]]),
            torch.cat([ksh, esh]))


class RefineStep:
    """One refine step at a time on `params` (3D, in place)."""

    def __init__(self, binding: Dict, params2d: Dict, cameras: List,
                 images: Tensor, cfg: Dict, device, row_dtype=None):
        self.binding = binding
        self.cfg = cfg
        self.sh_levels = cfg["sh_levels"]
        self.params = promote_to_3d(binding, params2d, self.sh_levels)
        self.cameras, self.images = cameras, images
        self.optimizer = torch.optim.Adam(
            [{"params": [getattr(self.params, n)], "lr": LEARNING_RATES[n]}
             for n in PARAM_NAMES], eps=1e-15)
        self.rcfg = RasterizeConfig(sh_degree=self.sh_levels - 1)
        self.bg = torch.full((3,), 1.0 if cfg["white_background"] else 0.0,
                             device=device)
        self.row_dtype = row_dtype
        self.records: List[Dict] = []

    def step(self, view_idx: int) -> Dict[str, float]:
        cfg = self.cfg
        weight = (cfg["key_view_weight"] if view_idx in cfg["key_views"]
                  else 1.0)
        self.optimizer.zero_grad(set_to_none=True)
        out = render_gaussians(*gaussian_arrays(self.binding, self.params,
                                                self.sh_levels),
                               self.cameras[view_idx], self.rcfg, self.bg,
                               row_dtype=self.row_dtype)
        loss = weight * l1_dssim(out["image"], self.images[view_idx],
                                 cfg["dssim_factor"])
        if cfg["scaling_reg"]:
            scales = torch.exp(self.params.log_scales)
            max_v = torch.max(scales, dim=-1).values
            min_v = torch.min(scales, dim=-1).values
            ratio = max_v / torch.clamp(min_v, min=1e-12)
            bad = (ratio > 10.0) & (max_v > 0.1)
            loss = loss + torch.sum(
                torch.where(bad, max_v, torch.zeros_like(max_v))
            ) / torch.clamp(torch.sum(bad), min=1)
        loss.backward()
        self.optimizer.step()
        rec = {"loss": float(loss.detach())}
        rec.update({k: out[k] for k in ("num_pairs", "n_contrib",
                                        "padded_pairs", "tiles", "gaussians")})
        self.records.append(rec)
        return rec
