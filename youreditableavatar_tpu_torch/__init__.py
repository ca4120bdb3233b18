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
                      (ShapeInitializer, HumanEditTrainer), export
  models/             tetgs, tetgs_edit, textured_mesh, optimizer, cameras,
                      colmap, mlp, sdf (SDFField), geometry (TetGeometry),
                      part_renderer
  data/               camera_sampler (random local/global cameras)
  guidance/           base (protocols), stub (StubDiffusionPrior,
                      StubInpainter, StubPromptEncoder), sds, prompts,
                      prompt_library, sd_layers (conv2d)
  native/             MeshSDF (the C++ BVH signed distance, built with g++)
  ops/gaussian_raster the Gaussian-splat render (kernels K1f, K1b, K2, K3a,
                      K3b) and the per-pair compositing backward (K6)
  ops/mesh_raster     the mesh visibility rasterizer (kernel K5) and the
                      differentiable interpolation over it
  ops/hashgrid        the hash-grid encoding; its table gradient is kernel
                      K4 (ops/hashgrid_cuda)
  ops/                covariance, image_losses, knn, marching_tets,
                      morphology, quaternion, segments, sh
  parallel/           distributed_init, make_mesh (torch.distributed +
                      DeviceMesh) and the sharded TetGS train step
  utils/              checkpoint, config, device, graphics, misc, optim,
                      profiling, registry, saving, schedule
  csrc/, _kernels.py  the CUDA sources and their loader
"""
