"""Functional layers of the port (``layers``); the evolvable modules come with
the classic RL slice."""
