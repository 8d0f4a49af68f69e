"""Synthetic multimodal datasets and client partitioning (numpy copies)."""
