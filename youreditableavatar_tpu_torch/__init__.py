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
                      (InpaintTrainer, RefineTrainer)
  models/             tetgs, tetgs_edit, textured_mesh, optimizer, cameras,
                      colmap
  guidance/           base (protocols), stub (StubInpainter,
                      StubPromptEncoder)
  ops/gaussian_raster the Gaussian-splat render (kernels K1f, K1b, K2, K3a,
                      K3b)
  ops/mesh_raster     the mesh visibility rasterizer (kernel K5) and the
                      differentiable interpolation over it
  ops/                covariance, image_losses, knn, morphology, quaternion,
                      segments, sh
  utils/              config, device, graphics, registry, saving, schedule
  csrc/, _kernels.py  the CUDA sources and their loader
"""
