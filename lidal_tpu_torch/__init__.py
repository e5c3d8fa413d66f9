"""lidal_tpu_torch — the PyTorch + CUDA port of ``lidal_tpu`` for NVIDIA Hopper.

Mirrors the subpackages of ``lidal_tpu`` (the JAX reference it is tested
against).  Ported so far: one whole active-learning round on SemanticKITTI or
nuScenes (training, evaluation, multi-view inference, scoring and selection
with any of the nine strategies) with MinkUNet or SPVCNN, the offline prep
and the import of the reference's checkpoints; not yet multi-device runs.

Subpackages
-----------
ops       coordinate keys, voxel dedup, rulebook construction, sparse conv and
          its gradients, the point<->voxel transfers of SPVCNN; hand-written
          CUDA kernels (``csrc/``) for the sorted-key lookup, the gather-GEMM
          conv, the conv backward, the banded nearest neighbour and the
          weighted 8-tap gather with its transpose, each beside its plain
          torch version
models    MinkUNet and SPVCNN (eval and train mode) as ``nn.Module`` s with
          torchsparse names
active    hash-grid matching, LiDAL scoring and selection, the neighbour ring,
          the staged and the fused round
data      SemanticKITTI frames, the nuScenes manifest and splits, loader,
          label-set selection, augmentation + voxelization, train and eval
          batch preparation
prep      pose registration, k-means / VCCS supervoxels over the native
          library (``csrc/*.cpp`` built with g++ at first use), surface
          variation
runtime   eval loop, train step and loop, checkpoints, weight and Adam-state
          transfer from the JAX package, the torchsparse checkpoint import
utils     confusion matrix and IoU, profiling, determinism audit, PCD / PLY IO

Importing the package builds and loads no kernel: ``kernels_build`` compiles
a kernel's source with nvcc the first time a CUDA tensor reaches its wrapper,
and ``prep/native`` the host library the first time a prep stage calls it.
"""

__version__ = "0.1.0"
