"""The `localize.langsam` cell cut for the CPU tests: the port's TEST_SAM
and TEST_GDINO widths (the grounder still at 800²), three 64² probes of a
320-face icosphere, and a block in which the factory's published SAM ViT-H
and GroundingDINO Swin-T configurations are those widths."""

from __future__ import annotations

import contextlib
import copy

from benchmark.core import controls
from benchmark.core.cell import tuples
from benchmark.tests.tiny import load

TEST_SAM = {"img_size": 64, "embed_dim": 32, "depth": 2, "heads": 4,
            "window": 2, "global_idx": [1], "neck_dim": 16,
            "decoder_heads": 4}
TEST_GDINO = {"swin_dim": 8, "depths": [1, 1, 1, 1], "num_heads": [1, 2, 2, 2],
              "window": 4, "vocab": 64, "text_dim": 16, "text_layers": 2,
              "text_heads": 2, "max_text_len": 16, "dim": 16, "heads": 2,
              "ffn": 32, "enc_layers": 2, "dec_layers": 2, "points": 2,
              "num_queries": 20}


def localize_config():
    cfg = copy.deepcopy(load("configs", "langsam_localize"))
    cfg["sam"].update(TEST_SAM)
    cfg["gdino"].update(TEST_GDINO)
    cfg["scene"]["icosphere_subdiv"] = 2
    cfg["probes"].update(counts=[1, 1, 1], size=64)
    cfg["mesh_raster"]["pair_budget"] = 1 << 14
    cfg["localization"].update(dilate_iters=1, erode_iters=1)
    return cfg


def localize_workload():
    return load("workloads", "localize.langsam")


@contextlib.contextmanager
def published_widths(cfg):
    """Inside the block, the port's published SAM ViT-H and GroundingDINO
    Swin-T configurations are `cfg`'s, so that the factory builds its
    LangSAM at `cfg`'s widths."""
    from youreditableavatar_tpu_torch.guidance import grounding_dino, sam

    with controls.patched(sam, "SAM_VIT_H",
                          sam.SAMConfig(**tuples(cfg["sam"]))), \
            controls.patched(grounding_dino, "SWIN_T_GDINO",
                             grounding_dino.GDINOConfig(
                                 **tuples(cfg["gdino"]))):
        yield
