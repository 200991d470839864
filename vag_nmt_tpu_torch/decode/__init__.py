"""Beam search and corpus translation."""
