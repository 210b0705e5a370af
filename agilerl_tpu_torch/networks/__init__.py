"""Evolvable networks of the classic RL stack: encoder -> latent -> head."""
