"""Decoder models (attention-only configs with dense MLPs)."""
