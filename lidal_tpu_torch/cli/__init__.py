"""Command implementations wiring the run loops, data and checkpoints."""
