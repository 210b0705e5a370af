"""Utilities of the port: RNG derivation, parameter trees, population glue, LLM gyms."""
