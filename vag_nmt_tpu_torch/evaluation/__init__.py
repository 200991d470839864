"""Evaluation metrics (BLEU)."""
