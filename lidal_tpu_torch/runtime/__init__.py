"""Eval loop and weight transfer."""
