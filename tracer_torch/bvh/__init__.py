"""Flat escape-index BVH and its binned-SAH builder."""
