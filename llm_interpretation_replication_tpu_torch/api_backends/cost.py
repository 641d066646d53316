"""Token/cost accounting with subset extrapolation (a copy of the JAX
package's ``api_backends/cost.py``).

Behavioral replica of perturb_prompts.py:347-350, 653-665, 1020-1066: per-model
input/output token tallies priced from the MODEL_PRICING table (USD per 1M
tokens), with full-sweep cost extrapolation from a processed subset.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..config import api_models


class CostTracker:
    def __init__(self, pricing: Optional[Dict] = None):
        self.pricing = pricing if pricing is not None else api_models().get("pricing", {})
        self.usage: Dict[str, Dict[str, int]] = {}
        # one tracker is shared by every RemoteReplica worker thread and
        # the sweep's per-model threads at once; the tally increments
        # below are read-modify-write (G09 api_backends/cost.py
        # 'CostTracker.usage' — lost updates undercount spend)
        self._lock = threading.Lock()

    def record(self, model: str, input_tokens: int, output_tokens: int) -> None:
        with self._lock:
            u = self.usage.setdefault(model, {"input_tokens": 0, "output_tokens": 0, "requests": 0})
            u["input_tokens"] += int(input_tokens)
            u["output_tokens"] += int(output_tokens)
            u["requests"] += 1

    def record_response(self, model: str, response: Dict) -> None:
        """Pull usage out of an OpenAI-style response object."""
        usage = response.get("usage", {})
        self.record(
            model,
            usage.get("prompt_tokens", usage.get("input_tokens", 0)),
            usage.get("completion_tokens", usage.get("output_tokens", 0)),
        )

    def cost(self, model: str) -> float:
        u = self.usage.get(model)
        p = self.pricing.get(model)
        if not u or not p:
            return 0.0
        return (
            u["input_tokens"] / 1e6 * p.get("input", 0.0)
            + u["output_tokens"] / 1e6 * p.get("output", 0.0)
        )

    def total_cost(self) -> float:
        return sum(self.cost(m) for m in self.usage)

    def extrapolate(self, model: str, processed: int, total: int) -> float:
        """Full-sweep cost estimate from a processed subset."""
        if processed <= 0:
            return 0.0
        return self.cost(model) * (total / processed)

    def summary(self) -> Dict[str, Dict]:
        return {
            model: {**u, "cost_usd": round(self.cost(model), 4)}
            for model, u in self.usage.items()
        }
