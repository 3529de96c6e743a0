"""Observability: the flight recorder and the tenant interner (the rest of
the JAX package's ``obs/`` is ``ROADMAP.md`` Queue 1 items 9b and 9c)."""
