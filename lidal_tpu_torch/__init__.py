"""lidal_tpu_torch — the PyTorch + CUDA port of ``lidal_tpu`` for NVIDIA Hopper.

Mirrors the subpackages of ``lidal_tpu`` (the JAX reference it is tested
against).  Ported: one whole active-learning round on SemanticKITTI or
nuScenes (training, evaluation, multi-view inference, scoring and selection
with any of the nine strategies) with MinkUNet or SPVCNN, the offline prep,
the import of the reference's checkpoints, and runs over several processes,
one per card (``torchrun``: data-parallel training with masked sync-BN,
sharded eval, inference and LiDAL scoring).

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
parallel  process groups over ``torch.distributed`` (NCCL on the card, gloo on
          the CPU): rank, shard and barrier helpers, a differentiable sum
utils     confusion matrix and IoU, profiling, determinism audit, PCD / PLY IO

Importing the package builds and loads no kernel: ``kernels_build`` compiles
a kernel's source with nvcc the first time a CUDA tensor reaches its wrapper,
``prep/native`` the host library the first time a prep stage calls it, and
no process group exists until a caller (the command line under ``torchrun``:
``parallel/mesh.init_from_env``) creates one.
"""

__version__ = "0.1.0"
