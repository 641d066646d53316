"""Vendor-side pieces of the port.  So far only the cost tracker
(:mod:`.cost`), which the serve pool's remote backends price requests with;
the API clients and evaluators are ROADMAP.md queue 1's "API clients and
the API sweeps"."""

from .cost import CostTracker

__all__ = ["CostTracker"]
