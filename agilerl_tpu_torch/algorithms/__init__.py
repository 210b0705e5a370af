"""Algorithms of the port: GRPO (slice 2)."""
