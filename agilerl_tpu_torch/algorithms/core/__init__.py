"""Algorithm core: registry, optimizer wrapper, evolvable base."""
