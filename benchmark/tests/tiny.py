"""Tiny configurations of the benchmark's cells for the CPU tests: the
cells' own files with every width cut to the port's TEST configurations,
so a whole run (set-up, window, reference, comparison) takes seconds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import torch

from benchmark.core.cell import Context

BENCH = Path(__file__).resolve().parent.parent

TEST_UNET = {"base": 32, "mults": [1, 2], "blocks_per_level": 1, "ctx_dim": 32,
             "head_dim": 16, "groups": 8, "attn_levels": [0],
             "fixed_heads": None}
TEST_VAE = {"chans": [16, 32], "blocks_per_level": 1, "groups": 8}
TEST_CLIP = {"vocab_size": 100, "max_len": 16, "dim": 32, "layers": 2,
             "heads": 4, "mlp_dim": 64, "eos_token_id": 99}


def load(kind: str, name: str):
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def sds_config():
    cfg = copy.deepcopy(load("configs", "sd15_geometry_edit"))
    cfg["unet"].update(TEST_UNET)
    cfg["vae"].update(TEST_VAE)
    cfg["clip"].update(TEST_CLIP)
    cfg["field"]["grid"].update(n_levels=4, log2_hashmap_size=13,
                                base_resolution=4, per_level_scale=1.5)
    cfg["field"]["n_neurons"] = 32
    cfg["field"]["sdf_bias_radius"] = 0.4
    cfg["tet_grid"] = 10
    cfg["budgets"] = {"mt_verts": 4096, "mt_faces": 8192, "compact": 2048,
                      "subdiv_mid": 8192, "fine_mt_verts": 8192,
                      "fine_mt_faces": 16384}
    cfg["mesh_raster"]["pair_budget"] = 1 << 14
    cfg["edit"]["recon_points"] = 2048
    cfg["edit"]["camera"].update(height=64, width=64,
                                 camera_distance_range=[1.6, 1.8])
    return cfg


def context(name, config, workload, seed=5, seconds=0.5, tmp=None,
            device="cpu"):
    return Context(name=name, config=config, workload=workload, seed=seed,
                   seconds=seconds, trace=False, device=torch.device(device),
                   started=0.0, cache_dir=Path(tmp))


TEST_SDXL_UNET = {"base": 32, "mults": [1, 2], "blocks_per_level": 1,
                  "ctx_dim": 32, "head_dim": 16, "groups": 8,
                  "attn_levels": [1], "tf_depth": [0, 2], "pooled_dim": 16,
                  "add_time_dim": 8}


def inpaint_config():
    cfg = copy.deepcopy(load("configs", "sdxl_texture_edit"))
    cfg["unet"].update(TEST_SDXL_UNET)
    cfg["vae"].update(TEST_VAE)
    cfg["controlnet"].update(cond_embed_chans=[8, 16], control_time_dim=8,
                             fuser_layers=1, fuser_heads=4)
    # Two towers whose penultimate widths add up to the UNet's context.
    cfg["clip_l"].update(TEST_CLIP, dim=16, heads=2, mlp_dim=32)
    cfg["clip_g"].update(TEST_CLIP, dim=16, heads=2, mlp_dim=32)
    return cfg


def inpaint_workload():
    wl = copy.deepcopy(load("workloads", "tex_edit.inpaint"))
    wl.update(size=32, steps=3, warmup_steps=2, image_cells=4)
    return wl


def refine_config():
    cfg = copy.deepcopy(load("configs", "sdxl_texture_edit"))
    cfg["scene"]["icosphere_subdiv"] = 2
    cfg["turntable"].update(views=4, size=64)
    cfg["refine"]["key_views"] = [0]
    return cfg


def refine_workload():
    wl = copy.deepcopy(load("workloads", "tex_edit.refine"))
    wl.update(image_cells=4)
    return wl
