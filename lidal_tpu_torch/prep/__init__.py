"""Offline preparation: pose registration and per-frame point tables."""
