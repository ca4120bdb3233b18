"""The fp16 geometry-edit cell, `geo_edit.sds_fp16`, at the port's tiny TEST
widths on the CPU: the port agrees with the plain reference at the
cell's own limits, and each planted fault of its entry (the f32 cell's three:
a step that leaves its state unchanged, the CFG batch's unconditioned half
left out, every second row of K4's scatter left out) and its control (the
plain reference computing in bf16) come out not correct through `run` at
the cell's own limits; its configuration is the f32 cell's but for its
precision; and its kernel file's `match` names only half-precision
convolutions."""

import json
import re
import time
from pathlib import Path

import pytest

from benchmark.entries import sds_edit_fp16
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELL = "geo_edit.sds_fp16"


def _config():
    """`tiny.sds_config()` with the fp16 configuration's name and
    precision: the tiny cut of the f32 file, which the fp16 file equals
    but for these (`test_the_configuration_is_the_f32_one_in_fp16`)."""
    cfg = tiny.sds_config()
    half = tiny.load("configs", "sd15_geometry_edit_fp16")
    cfg.update(name=half["name"], precision=half["precision"])
    return cfg


def _run(tmp_path, seed=5):
    ctx = tiny.context(CELL, _config(), tiny.load("workloads", CELL),
                       seed=seed, seconds=0.3, tmp=tmp_path)
    ctx.started = time.time()
    return sds_edit_fp16.run(ctx)


@pytest.mark.parametrize("fault", sorted(sds_edit_fp16.FAULTS))
def test_a_planted_fault_is_not_correct(fault, tmp_path):
    with sds_edit_fp16.FAULTS[fault]():
        res = _run(tmp_path)
    assert not res.correct, res.checks


def test_the_bf16_control_is_not_correct(tmp_path):
    with sds_edit_fp16.CONTROL():
        res = _run(tmp_path)
    assert not res.correct, res.checks


def test_the_port_agrees_and_counts_its_half_convolutions(tmp_path):
    res = _run(tmp_path)
    assert res.correct, res.checks
    counts = res.layer["counts"]
    assert counts["sds.nonfinite"] == 0
    assert counts["sd.conv.half.forward"] > counts["sd.conv.half.input_grad"] > 0
    assert res.failed == 0 and res.attempted >= 1
    assert res.metrics["setup_s"][0] > 0
    assert set(res.layer["peaks"]) >= {"unet.mid", "vae.mid"}


def test_the_configuration_is_the_f32_one_in_fp16():
    f32 = tiny.load("configs", "sd15_geometry_edit")
    half = tiny.load("configs", "sd15_geometry_edit_fp16")
    differ = {k for k in set(f32) | set(half) if f32.get(k) != half.get(k)}
    assert differ == {"name", "deployment", "source", "precision", "assumed"}
    assert half["precision"] == {"dtype": "float16", "networks": "float16",
                                 "text_encoder": "float16",
                                 "geometry": "float32", "tf32": False}
    assert half["assumed"][:len(f32["assumed"])] == f32["assumed"]


def _kernel_names():
    """Every `__global__` kernel of the port's sources (K1–K7), the f32
    library kernels the three f32 cells' traces show, and the fp16 cell's
    GEMMs."""
    names = set()
    for src in (ROOT / "youreditableavatar_tpu_torch" / "csrc").glob("*.cu"):
        names |= set(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(?:void\s+)?(\w+)\s*\(",
                                src.read_text()))
    return names | {
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)",
        "void (anonymous namespace)::conv_ws_kernel<128, false>((anonymous namespace)::ConvParams)",
        "void at::native::(anonymous namespace)::cunn_SoftMaxForwardReg<float, float, float, at::native::(anonymous namespace)::SoftMaxForwardEpilogue, long, 8>(float*, float const*, long)",
        # the fp16 cell's GEMMs and cuDNN's helpers, which are no
        # convolution kernel of the spatial kind
        "nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NNT",
        "void cutlass::Kernel2<cutlass_75_tensorop_f16_s1688gemm_f16_128x128_nn_align1>(cutlass_75_tensorop_f16_s1688gemm_f16_128x128_nn_align1::Params)",
        "void cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace_kernel<xmma__5x_cudnn::implicit_gemm::dgrad::Warp_specialized_params_nonte>",
    }


def test_conv_half_matches_no_f32_kernel():
    k = json.loads((ROOT / "benchmark" / "kernels" / "conv_half.json").read_text())
    rx = re.compile(k["match"])
    names = _kernel_names()
    assert {"scatter_kernel", "resolve_kernel"} <= names
    assert any(n.startswith("conv_") for n in names)
    assert not [n for n in names if rx.search(n)]
    others = [json.loads(p.read_text())["match"]
              for p in (ROOT / "benchmark" / "kernels").glob("*.json")
              if p.stem != "conv_half"]
    half = [n for n in SAMPLE_HALF_KERNELS if rx.search(n)]
    assert half == SAMPLE_HALF_KERNELS
    assert not [n for n in half for m in others if re.search(m, n)]


# cuDNN's kernels of the fp16 cell's spatial convolutions, as its trace
# names them on the H100 (strided, split-K, small-channel forms among them);
# and a bf16 one.
SAMPLE_HALF_KERNELS = [
    "sm90_xmma_fprop_implicit_gemm_f16f16_f16f32_f32_nhwckrsc_nhwc_tilesize128x128x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn",
    "sm90_xmma_dgrad_implicit_gemm_f16f16_f16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_on_kernel__5x_cudnn",
    "sm90_xmma_dgrad_implicit_gemm_indexed_f16f16_f16f32_f32_nhwckrsc_nhwc_tilesize256x128x64_warpgroupsize2x1x1_g1_strided_execute_kernel__5x_cudnn",
    "sm80_xmma_fprop_implicit_gemm_indexed_wo_smem_f16f16_f16f32_f32_nhwckrsc_nhwc_tilesize128x32x16_stage1_warpsize4x1x1_g1_tensor16x8x16_aligna4_alignc4_execute_kernel__5x_cudnn",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn",
]
