"""lidal_tpu_torch — the PyTorch + CUDA port of ``lidal_tpu`` for NVIDIA Hopper.

Mirrors the subpackages of ``lidal_tpu`` (the JAX reference it is tested
against).  Ported so far: MinkUNet evaluation and training on SemanticKITTI.

Subpackages
-----------
ops       coordinate keys, voxel dedup, rulebook construction, sparse conv and
          its gradients; hand-written CUDA kernels (``csrc/``) for the
          sorted-key lookup, the gather-GEMM conv and the conv backward, each
          beside its plain torch version
models    MinkUNet (eval and train mode) as ``nn.Module`` s with torchsparse names
data      SemanticKITTI frames, loader, label-set selection, augmentation +
          voxelization, train and eval batch preparation
runtime   eval loop, train step and loop, checkpoints, weight and Adam-state
          transfer from the JAX package
utils     confusion matrix and IoU

Importing the package builds and loads no kernel: ``kernels_build`` compiles
a kernel's source with nvcc the first time a CUDA tensor reaches its wrapper.
"""

__version__ = "0.1.0"
