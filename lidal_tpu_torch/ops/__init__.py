"""Sparse-voxel engine: keys, voxelization, rulebooks, sparse conv and its CUDA kernels."""
