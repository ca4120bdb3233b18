"""Spatial-stage CLI (the reference's `train_spatial.py:57-248` surface).

    python -m youreditableavatar_tpu_torch.cli.train_spatial \
        --config configs/geometry-init.yaml --train --mesh body.npy

Modes (the reference's --train / --validate / --test / --export dispatch):
  --train with a geometry-init config: the SDF shape initialization from
    the body mesh (max_steps=0) and the `init_mesh.npy` export.
  --train with a geometry-edit config (+ --region editing_region_info.npy):
    the localized SDS edit and the `edit_mesh.npy` export.
  --validate / --test: turntable normal renders of a checkpoint (--test the
    full 60-view circle, --validate an 8-view probe).

Guidance backend (--guidance): "stub" runs weight-free, "sd15-random" runs
the whole SD1.5 code path on tiny random weights, "sd15" loads
diffusers-format weights from --sd-weights. The SD1.5 UNet, VAE and CLIP
text encoder run in fp16 unless the config sets
`system.guidance.half_precision_weights` (threestudio's key, and its
default: true) to false (override:
`system.guidance.half_precision_weights=false`). The stage runs on the
CUDA card unless --device names another device.
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--train", action="store_true")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--export", action="store_true")
    p.add_argument("--region", default=None,
                   help="editing_region_info.npy for the edit mode")
    p.add_argument("--mesh", default=None,
                   help="body mesh (.npy dict) for the shape init")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint file for --validate/--test")
    p.add_argument("--guidance", default="stub",
                   choices=["stub", "sd15", "sd15-random"])
    p.add_argument("--sd-weights", default=None,
                   help="diffusers layout dir (unet/ vae/ text_encoder/)")
    p.add_argument("--out", default="outputs/spatial")
    p.add_argument("--typecheck", action="store_true",
                   help="runtime checks: autograd anomaly detection "
                        "(reference --typecheck, train_spatial.py:83-86)")
    p.add_argument("--gradio", action="store_true",
                   help="write a single-line progress file for UI "
                        "frontends (reference --gradio progress callback)")
    p.add_argument("--init-debug", action="store_true",
                   help="export the SDF-init meshes for inspection "
                        "(reference init_debug, implicit_sdf.py:332-361)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    if args.typecheck:
        import torch

        # The reference installs a jaxtyping + typeguard import hook; the
        # runtime analogue here fails fast on NaNs in the backward.
        torch.autograd.set_detect_anomaly(True)

    from youreditableavatar_tpu_torch.cli.pipeline import (
        PipelineScale,
        run_spatial_stage,
        run_spatial_validate,
    )
    from youreditableavatar_tpu_torch.stages.export import (
        load_editing_region_info)
    from youreditableavatar_tpu_torch.utils.config import load_config
    from youreditableavatar_tpu_torch.utils.saving import snapshot_run

    cfg = load_config(args.config, args.overrides)
    snapshot_run(args.out, dict(cfg.system) if cfg.system else None)
    scale_kw = dict(cfg.system.get("scale", {}))
    scale = (
        PipelineScale.tiny() if scale_kw.pop("tiny", False)
        else PipelineScale()
    )
    for k, v in scale_kw.items():
        # Strict: unknown scale keys are config bugs, not no-ops.
        if not hasattr(scale, k):
            p.error(f"unknown system.scale key {k!r} "
                    f"(valid: {sorted(vars(scale))})")
        object.__setattr__(scale, k, v)

    if args.validate or args.test:
        if args.ckpt is None:
            p.error("--validate/--test requires --ckpt")
        vdir = run_spatial_validate(
            args.out, args.ckpt, scale,
            num_views=60 if args.test else 8,
            subdir="test" if args.test else "validation",
            device=args.device,
        )
        print({"renders": vdir})
        return

    if args.mesh is None:
        p.error("--mesh is required (body mesh artifact)")
    if args.mesh.endswith(".npy"):
        data = np.load(args.mesh, allow_pickle=True).item()
        verts = np.asarray(data["vertices"], np.float32)
        faces = np.asarray(data["faces"], np.int64)
    else:
        raise SystemExit("only .npy mesh dicts supported in this build")

    region = (
        load_editing_region_info(args.region) if args.region else None
    )
    arts = run_spatial_stage(
        args.out, verts, faces,
        cfg.system.get("prompt", "an avatar"), scale,
        seed=cfg.seed, editing_region_info=region,
        guidance_backend=args.guidance, sd_weights=args.sd_weights,
        system_cfg=dict(cfg.system),
        progress_path=(
            f"{args.out}/progress.txt" if args.gradio else None
        ),
        init_debug=args.init_debug,
        device=args.device,
    )
    print(arts)


if __name__ == "__main__":
    main()
