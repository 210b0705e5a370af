"""LLM stack of the port: model, generation, presets, weight conversion."""
