"""API response cache with field-level completeness checks (a copy of the
JAX package's ``api_backends/cache.py``): a JSON cache keyed on the first
100 characters of the question, per-evaluator required-field sets, and
partial re-runs (only the missing evaluators run again).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Sequence

KEY_PREFIX_LEN = 100

#: required result fields per evaluator (reference completeness check)
REQUIRED_FIELDS = {
    "gpt": ["gpt_response", "gpt_yes_prob", "gpt_no_prob", "gpt_relative_prob",
            "gpt_confidence", "gpt_weighted_confidence"],
    "gemini": ["gemini_response", "gemini_yes_prob", "gemini_no_prob",
               "gemini_relative_prob", "gemini_confidence", "gemini_weighted_confidence"],
    "claude": ["claude_response", "claude_confidence"],
    "random": ["random_response", "random_confidence"],
}


def cache_key(question: str) -> str:
    return question[:KEY_PREFIX_LEN]


class ResponseCache:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._data: Dict[str, Dict] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)

    def get(self, question: str) -> Optional[Dict]:
        return self._data.get(cache_key(question))

    def put(self, question: str, record: Dict, flush: bool = True) -> None:
        key = cache_key(question)
        existing = self._data.get(key, {})
        existing.update(record)
        self._data[key] = existing
        if flush:
            self.flush()

    def flush(self) -> None:
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._data, f, indent=2, default=str)
            os.replace(tmp, self.path)

    def missing_evaluators(
        self, question: str, evaluators: Sequence[str] = ("gpt", "gemini", "claude", "random")
    ) -> list:
        """Which evaluators still need to run for this question (partial
        re-run logic)."""
        record = self.get(question) or {}
        missing = []
        for name in evaluators:
            fields = REQUIRED_FIELDS.get(name, [])
            # key presence marks the evaluator as run: None is a legitimate
            # value (e.g. Gemini weighted confidence with no digit tokens)
            if any(f not in record for f in fields):
                missing.append(name)
        return missing

    def is_complete(self, question: str,
                    evaluators: Sequence[str] = ("gpt", "gemini", "claude", "random")) -> bool:
        return not self.missing_evaluators(question, evaluators)

    def __len__(self) -> int:
        return len(self._data)
