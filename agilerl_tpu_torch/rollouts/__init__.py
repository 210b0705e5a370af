"""Rollout collection into the agents' buffers."""
