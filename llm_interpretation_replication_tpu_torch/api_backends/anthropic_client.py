"""Anthropic client: messages and Message Batches (a copy of the JAX
package's ``api_backends/anthropic_client.py``).

Claude exposes no logprobs, so the binary leg is a deterministic single
reply (probabilities zeroed) or :meth:`AnthropicClient.approximate_logprobs`,
N repeated samples counted per target token; batches cap at 10,000
requests, polled every 30 s for up to 24 h.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.retry import RetryPolicy, retry_with_exponential_backoff
from .transport import TransportError, UrllibTransport

BASE_URL = "https://api.anthropic.com/v1"
API_VERSION = "2023-06-01"
MAX_BATCH_SIZE = 10_000


class AnthropicClient:
    def __init__(self, api_key: str, transport=None, base_url: str = BASE_URL,
                 retry_policy: Optional[RetryPolicy] = None):
        self.api_key = api_key
        self.transport = transport or UrllibTransport()
        self.base_url = base_url
        self.retry_policy = retry_policy or RetryPolicy(
            retry_on=(TransportError,), max_retries=10
        )

    def _request(self, method: str, path: str, json_body=None):
        headers = {
            "x-api-key": self.api_key,
            "anthropic-version": API_VERSION,
        }

        @retry_with_exponential_backoff(self.retry_policy)
        def call():
            try:
                status, body = self.transport.request(
                    method, f"{self.base_url}{path}", headers, json_body
                )
            except TransportError as err:
                if not err.retryable:
                    raise RuntimeError(str(err)) from err
                raise
            return body

        return call()

    def create_message(self, model: str, messages: Sequence[Dict],
                       max_tokens: int = 500, temperature: float = 0.0) -> Dict:
        return json.loads(
            self._request(
                "POST", "/messages",
                json_body={
                    "model": model,
                    "max_tokens": max_tokens,
                    "temperature": temperature,
                    "messages": list(messages),
                },
            )
        )

    @staticmethod
    def text_of(message: Dict) -> str:
        return "".join(
            block.get("text", "") for block in message.get("content", [])
            if block.get("type") == "text"
        ).strip()

    def approximate_logprobs(
        self,
        model: str,
        messages: Sequence[Dict],
        target_tokens: Sequence[str],
        n_samples: int = 10,
        temperature: float = 1.0,
        max_tokens: int = 500,
    ) -> Tuple[Dict[str, float], List[str]]:
        """Frequency-based probability estimate over repeated samples.
        The study's quirks are kept: the FIRST
        matching target in target order is counted (so 'Not Covered' counts as
        'Covered' when targets are ('Covered', 'Not')), and zero matches fall
        back to a uniform distribution."""
        counts = {t: 0 for t in target_tokens}
        texts = []
        for _ in range(n_samples):
            msg = self.create_message(model, messages, max_tokens, temperature)
            text = self.text_of(msg)
            texts.append(text)
            for t in target_tokens:
                if t in text:
                    counts[t] += 1
                    break
        if sum(counts.values()) == 0:
            probs = {t: 1.0 / len(target_tokens) for t in target_tokens}
        else:
            probs = {t: c / n_samples for t, c in counts.items()}
        return probs, texts

    # -- message batches --------------------------------------------------

    def create_batch(self, requests: Sequence[Dict]) -> Dict:
        if len(requests) > MAX_BATCH_SIZE:
            raise ValueError(f"batch of {len(requests)} exceeds {MAX_BATCH_SIZE}")
        return json.loads(
            self._request("POST", "/messages/batches", json_body={"requests": list(requests)})
        )

    def get_batch(self, batch_id: str) -> Dict:
        return json.loads(self._request("GET", f"/messages/batches/{batch_id}"))

    def wait_for_batch(self, batch_id: str, poll_interval: float = 30.0,
                       timeout: float = 24 * 3600, sleep=time.sleep,
                       clock=time.monotonic) -> Dict:
        """Poll until ``processing_status == "ended"``; elapsed time uses a
        monotonic clock (injectable) so request latency and retry backoffs
        count toward ``timeout``, not just the sleeps."""
        started = clock()
        while True:
            batch = self.get_batch(batch_id)
            if batch.get("processing_status") == "ended":
                return batch
            if clock() - started >= timeout:
                raise TimeoutError(f"batch {batch_id} not done after {timeout}s")
            sleep(poll_interval)

    def batch_results(self, batch: Dict) -> List[Dict]:
        raw = self._request("GET", f"/messages/batches/{batch['id']}/results")
        return [json.loads(line) for line in raw.decode().splitlines() if line.strip()]

    def run_batches(self, requests: Sequence[Dict], poll_interval: float = 30.0,
                    sleep=time.sleep) -> List[Dict]:
        results: List[Dict] = []
        for start in range(0, len(requests), MAX_BATCH_SIZE):
            chunk = list(requests[start : start + MAX_BATCH_SIZE])
            batch = self.create_batch(chunk)
            batch = self.wait_for_batch(batch["id"], poll_interval, sleep=sleep)
            results.extend(self.batch_results(batch))
        return results


def build_batch_request(custom_id: str, model: str, messages: Sequence[Dict],
                        max_tokens: int = 500, temperature: float = 0.0) -> Dict:
    return {
        "custom_id": custom_id,
        "params": {
            "model": model,
            "max_tokens": max_tokens,
            "temperature": temperature,
            "messages": list(messages),
        },
    }
