"""Encoder, grounding, decoder and their assembly."""
