"""Fusion loss, Eq. 12 aggregation and the Theorem-1 trackers on tensors."""
