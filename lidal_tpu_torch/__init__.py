"""lidal_tpu_torch — the PyTorch + CUDA port of ``lidal_tpu`` for NVIDIA Hopper.

Mirrors the subpackages of ``lidal_tpu`` (the JAX reference it is tested
against).  Ported so far: the MinkUNet evaluation path.

Subpackages
-----------
ops       coordinate keys, voxel dedup, rulebook construction, sparse conv;
          hand-written CUDA kernels (``csrc/``) for the sorted-key lookup and
          the gather-GEMM conv, each beside its plain torch version
models    MinkUNet (eval mode) as ``nn.Module`` s with torchsparse names
data      augmentation + voxelization, eval batch preparation
runtime   eval loop, weight transfer from the JAX package
utils     confusion matrix and IoU

Importing the package builds and loads no kernel: ``kernels_build`` compiles
a kernel's source with nvcc the first time a CUDA tensor reaches its wrapper.
"""

__version__ = "0.1.0"
