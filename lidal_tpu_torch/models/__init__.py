"""Sparse networks as torch modules."""
