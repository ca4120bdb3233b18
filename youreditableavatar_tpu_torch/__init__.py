"""PyTorch + CUDA port of `youreditableavatar_tpu` for NVIDIA Hopper (H100).

Each module mirrors the JAX package's module of the same path and public
names. Plain tensor code is PyTorch; every Pallas kernel of the JAX package
on the ported path is a hand-written CUDA kernel under `csrc/`, built with
`nvcc` for sm_90a at first use (`_kernels.py`) and bound through ctypes.

The tensor's device picks the implementation: CUDA tensors go through the
kernels, CPU tensors through each kernel's plain PyTorch version (the CPU
parity tests use those). Entry points run on `cuda` unless the caller
passes `device="cpu"`.

Sub-packages:
  stages/             init_texture (TetGSInitTrainer), edit_texture
                      (InpaintTrainer, RefineTrainer), spatial
                      (ShapeInitializer, HumanEditTrainer), localization
                      (LocalMeshEditing), export
  models/             tetgs, tetgs_edit, textured_mesh, optimizer, cameras,
                      colmap, mlp, sdf (SDFField), geometry (TetGeometry),
                      part_renderer, mesh (Mesh)
  data/               camera_sampler (random local/global cameras)
  guidance/           base (protocols), stub (StubDiffusionPrior,
                      StubInpainter, StubPromptEncoder), sds, prompts,
                      prompt_library; the diffusion networks: sd_layers,
                      sd_unet, sd_vae, clip_text, sd15 (SD15Prior,
                      CLIPPromptEncoder), sdxl_controlnet, sdxl_pipeline;
                      the segmentation networks: sam (SAMSegmenter),
                      grounding_dino (DinoGrounder), wordpiece; manifests
                      (official checkpoint keys) and factory (name →
                      prior / inpainter / segmenter)
  cli/                pipeline (the run.sh flow: run_synthetic_pipeline
                      and the per-stage runs) and the stage CLIs
                      train_spatial, train_init_texture, train_edit_texture
                      (`python -m youreditableavatar_tpu_torch.cli.<name>`)
  native/             MeshSDF (the C++ BVH signed distance, built with g++)
  ops/gaussian_raster the Gaussian-splat render (kernels K1f, K1b, K2, K3a,
                      K3b) and the per-pair compositing backward (K6)
  ops/mesh_raster     the mesh visibility rasterizer (kernel K5) and the
                      differentiable interpolation over it
  ops/hashgrid        the hash-grid encoding; its table gradient is kernel
                      K4 (ops/hashgrid_cuda)
  ops/                covariance, image_losses, knn, lpips, marching_tets,
                      morphology, padded_gather, quaternion, segments,
                      shape_loss, sh
  parallel/           distributed_init, make_mesh (torch.distributed +
                      DeviceMesh) and the sharded TetGS train step
  utils/              checkpoint, config, device, graphics, misc, optim,
                      profiling, registry, saving, schedule
  csrc/, _kernels.py  the CUDA sources and their loader
"""
