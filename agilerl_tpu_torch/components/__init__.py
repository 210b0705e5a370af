"""Rollout and replay storage of the on-policy and off-policy algorithms."""
