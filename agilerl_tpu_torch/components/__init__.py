"""Rollout storage of the on-policy algorithms."""
