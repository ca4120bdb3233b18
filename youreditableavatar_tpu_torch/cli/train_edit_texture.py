"""Edit-texture CLI (the reference's `train_edit_texture.py:8-53` surface):
progressive inpainting + 3D refinement over the edited region.

    python -m youreditableavatar_tpu_torch.cli.train_edit_texture \
        --edit_mesh edit_mesh.npy --tetgs_init tetgs_init_last.npz \
        --prompt "a red jacket"

--inpainter picks the guidance (`guidance.factory.make_inpainter_backend`):
"stub", "sdxl" (with --sdxl-weights) or "sdxl-random". The stage runs on
the CUDA card unless --device names another device.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--edit_mesh", required=True)
    p.add_argument("--tetgs_init", required=True,
                   help="stage-2 checkpoint (tetgs_init_last.npz)")
    p.add_argument("--prompt", required=True)
    p.add_argument("--out", default="outputs/edit_texture")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--sample-type", default="full",
                   choices=["full", "upper", "lower"],
                   help="garment framing for probe/turntable views "
                        "(reference run_pg.sh sample_type)")
    p.add_argument("--inpainter", default="stub",
                   choices=["stub", "sdxl", "sdxl-random"])
    p.add_argument("--sdxl-weights", default=None,
                   help="diffusers layout dir (unet/ vae/ controlnet/ ...)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from youreditableavatar_tpu_torch.cli.pipeline import (
        PipelineScale,
        run_edit_texture_stage,
    )
    from youreditableavatar_tpu_torch.guidance.factory import (
        make_inpainter_backend)

    scale = PipelineScale.tiny() if args.tiny else PipelineScale()
    inpainter = make_inpainter_backend(args.inpainter, args.sdxl_weights,
                                       device=args.device)
    arts = run_edit_texture_stage(
        args.out, args.edit_mesh, args.tetgs_init, args.prompt, scale,
        inpainter=inpainter, sample_type=args.sample_type,
        device=args.device,
    )
    print(arts)


if __name__ == "__main__":
    main()
