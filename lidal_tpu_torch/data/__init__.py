"""Augmentation, voxelization and fixed-capacity batch preparation."""
