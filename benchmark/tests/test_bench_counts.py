"""The frozen arithmetic at tiny sizes against a hand count: the bound,
FLOPs counted on the reference's layers, each cell's least-time bytes and
its kernels' quantities per launch."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.core.roofline import bound
from benchmark.entries import sdxl_inpaint, sds_edit, tetgs_refine
from benchmark.reference import sd_layers
from benchmark.tests import tiny

KERNELS = Path(__file__).resolve().parents[1] / "kernels"


def test_bound_takes_the_larger_time():
    assert bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert bound(0, 67e9) == (pytest.approx(1.0), "operations")
    assert bound(3.35e9, 2 * 67e9) == (pytest.approx(2.0), "operations")


def _flops(fn):
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


def test_flops_of_the_reference_layers():
    x = torch.randn(4, 8)
    lin = {"w": torch.randn(8, 16), "b": torch.zeros(16)}
    assert _flops(lambda: sd_layers.linear(x, lin)) == 2 * 4 * 8 * 16
    img = torch.randn(1, 5, 5, 3)
    conv = {"w": torch.randn(3, 3, 3, 4), "b": torch.zeros(4)}
    assert _flops(lambda: sd_layers.conv2d(img, conv)) == 2 * 25 * 27 * 4


def test_sds_least_bytes_and_launch_quantities():
    cfg = tiny.sds_config()
    w = sds_edit.make_weights(cfg, 3, torch.device("cpu"))
    unet = sum(t.numel() for t in sd_layers.tree_leaves(w["unet"]))
    enc = sum(t.numel() for t in sd_layers.tree_leaves(w["vae"]["encoder"]))
    field = 4 * 2 ** 13 * 2 + (8 * 32 + 32) + (32 * 1 + 1)
    assert w["grid"].numel() == 4 * 2 ** 13 * 2
    moved = 4 * (unet + enc + 7 * field)
    assert sds_edit.least_ms(cfg, w, 0) == pytest.approx(moved / 3.35e9)
    recs = [{"pairs": 100, "faces": 10, "resolves": 1},
            {"pairs": 300, "faces": 20, "resolves": 2}]
    q = sds_edit.launch_quantities(cfg, {"records": recs})
    # 4 levels × 8 corners × (4 · 2048 corners, 8192 midpoints, 2048 recon)
    assert q.pop("hash_rows") == pytest.approx(
        4 * 8 * (4 * 2048 + 8192 + 2048) / 3)
    assert q.pop("hash_table_floats") == 4 * 2 ** 13 * 2
    assert q == {"mesh_pixels": 64 * 64, "mesh_tiles": 4,
                 "mesh_pairs": 400 / 3, "mesh_faces": (10 + 40) / 3}


def test_inpaint_least_bytes():
    cfg = tiny.inpaint_config()
    w = sdxl_inpaint.make_weights(cfg, 3, torch.device("cpu"))
    n = {k: sum(t.numel() for t in sd_layers.tree_leaves(w[k]))
         for k in ("unet", "controlnet", "vae", "clip_l", "clip_g")}
    moved = 4 * (3 * (n["unet"] + n["controlnet"]) + n["vae"] + n["clip_l"]
                 + n["clip_g"] + 16 * 16)
    assert sdxl_inpaint.least_ms(w, 0, 3) == pytest.approx(moved / 3.35e9)


def test_refine_least_time_and_launch_quantities():
    cfg = tiny.refine_config()
    scene = tetgs_refine.make_scene(cfg, 3, torch.device("cpu"))
    ne = scene["params"]["delta"].shape[0]
    recs = [{"gaussians": 500, "num_pairs": 2000, "padded_pairs": 3072,
             "tiles": 4, "n_contrib": 10 ** 7}]
    moved = 4 * (2 * 64 * 64 * 3 + 16 * 500 + 7 * ne * (1 + 3 + 4 + 1 + 48))
    ops = 87 * 10 ** 7
    assert tetgs_refine.least_ms(cfg, scene, recs) == pytest.approx(
        max(moved / 3.35e9, ops / 67e9))
    assert tetgs_refine.launch_quantities(recs) == {
        "gaussians": 500, "gs_pairs": 2000, "gs_padded_pairs": 3072,
        "gs_tiles": 4, "gs_contrib": 10 ** 7}


def test_the_scene_binds_as_the_port_does():
    """81,920 faces bind 122,880 Gaussians at the full size (checked here on
    the subdivision-2 sphere: 320 faces, one or three a face)."""
    cfg = tiny.refine_config()
    scene = tetgs_refine.make_scene(cfg, 3, torch.device("cpu"))
    n = scene["binding"]["keep_xyz"].shape[0] + scene["params"]["delta"].shape[0]
    assert 320 <= n <= 3 * 320
    assert torch.allclose(scene["params"]["quats"].norm(dim=-1),
                          torch.ones(scene["params"]["quats"].shape[0]))


@pytest.mark.parametrize("name", sorted(p.stem for p in KERNELS.glob("*.json")))
def test_kernel_files_count_known_quantities(name):
    k = json.loads((KERNELS / f"{name}.json").read_text())
    known = {"hash_rows", "hash_table_floats", "mesh_faces", "mesh_pairs",
             "mesh_tiles", "mesh_pixels", "gaussians", "gs_pairs",
             "gs_padded_pairs", "gs_tiles", "gs_contrib"}
    assert set(k["bytes"]) <= known and set(k.get("operations", {})) <= known
    assert k["match"]
