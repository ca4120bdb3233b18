"""Init-texture CLI (the reference's `train_init_texture.py:8-43` surface):
the stage-2 appearance fit over COLMAP-posed frames + region localization.

    python -m youreditableavatar_tpu_torch.cli.train_init_texture \
        --init_mesh init_mesh.npy --source_path colmap_root

--segmenter picks the localization's segmenter (`guidance.factory.
make_segmenter_backend`): "heuristic", "sam" (with --sam-weights, and
--dino-weights / --dino-vocab for GroundingDINO's text-grounded boxes),
"sam-random", "langsam-random" or "langsam-vit-h-random" (SAM ViT-H and
GroundingDINO Swin-T at published widths on random weights). The stage
runs on the CUDA card unless --device names another device.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--init_mesh", required=True)
    p.add_argument("--source_path", required=True,
                   help="COLMAP dataset root (sparse/ + images/)")
    p.add_argument("--out", default="outputs/init_texture")
    p.add_argument("--seg_prompt", default="the garment")
    p.add_argument("--iters", type=int, default=4000)
    p.add_argument("--downscale", type=float, default=1.0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--segmenter", default="heuristic",
                   choices=["heuristic", "sam", "sam-random",
                            "langsam-random", "langsam-vit-h-random"])
    p.add_argument("--sam-weights", default=None,
                   help="official sam_vit_*.pth checkpoint")
    p.add_argument("--dino-weights", default=None,
                   help="official groundingdino_swint_ogc.pth (with "
                        "--segmenter sam: text-grounded boxes)")
    p.add_argument("--dino-vocab", default=None,
                   help="BERT vocab.txt for the WordPiece tokenizer "
                        "(default: vocab.txt next to --dino-weights)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from youreditableavatar_tpu_torch.cli.pipeline import (
        PipelineScale,
        run_init_texture_stage,
    )
    from youreditableavatar_tpu_torch.guidance.factory import (
        make_segmenter_backend)
    from youreditableavatar_tpu_torch.models.cameras import (
        load_colmap_cameras)

    cams = load_colmap_cameras(args.source_path, downscale=args.downscale)
    scale = PipelineScale.tiny() if args.tiny else PipelineScale()
    arts = run_init_texture_stage(
        args.out, args.init_mesh, cams, scale,
        seg_prompt=args.seg_prompt, fit_iters=args.iters,
        segmenter=make_segmenter_backend(
            args.segmenter, args.sam_weights,
            dino_weights=args.dino_weights,
            dino_vocab=args.dino_vocab, device=args.device),
        device=args.device,
    )
    print(arts)


if __name__ == "__main__":
    main()
