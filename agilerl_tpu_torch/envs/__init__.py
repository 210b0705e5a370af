"""Device-side environments: batched torch state machines."""
