"""OpenAI client: chat completions and the Batch API (a copy of the JAX
package's ``api_backends/openai_client.py``).

- Non-reasoning models: temperature 0, ``logprobs=True``,
  ``top_logprobs=20``, ``max_tokens=500``; reasoning models (o1/o3/o4,
  gpt-5): ``max_completion_tokens=2000`` and no logprobs.
- Batch pipeline: JSONL upload (``purpose=batch``), ``batches`` create
  (completion window 24h), poll, download the output file; requests are
  chunked at 50,000 a batch.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence

from ..utils.retry import RetryPolicy, retry_with_exponential_backoff
from .transport import TransportError, UrllibTransport, multipart_form

BASE_URL = "https://api.openai.com/v1"
MAX_BATCH_REQUESTS = 50_000  # requests a batch, at most

REASONING_PREFIXES = ("o1", "o3", "o4", "gpt-5")


def is_reasoning_model(model: str) -> bool:
    return model.startswith(REASONING_PREFIXES)


class OpenAIClient:
    def __init__(self, api_key: str, transport=None, base_url: str = BASE_URL,
                 retry_policy: Optional[RetryPolicy] = None):
        self.api_key = api_key
        self.transport = transport or UrllibTransport()
        self.base_url = base_url
        self.retry_policy = retry_policy or RetryPolicy(
            retry_on=(TransportError,), max_retries=10
        )

    def _headers(self):
        return {"Authorization": f"Bearer {self.api_key}"}

    def _request(self, method: str, path: str, json_body=None, data=None, headers=None):
        hdrs = {**self._headers(), **(headers or {})}

        @retry_with_exponential_backoff(self.retry_policy)
        def call():
            try:
                status, body = self.transport.request(
                    method, f"{self.base_url}{path}", hdrs, json_body, data
                )
            except TransportError as err:
                if not err.retryable:
                    raise RuntimeError(str(err)) from err
                raise
            return body

        return call()

    # -- chat ------------------------------------------------------------

    def chat_completion(
        self,
        model: str,
        messages: Sequence[Dict],
        temperature: float = 0.0,
        max_tokens: int = 500,
        logprobs: bool = True,
        top_logprobs: int = 20,
    ) -> Dict:
        body: Dict = {"model": model, "messages": list(messages)}
        if is_reasoning_model(model):
            body["max_completion_tokens"] = 2000
        else:
            body.update(
                temperature=temperature,
                max_tokens=max_tokens,
                logprobs=logprobs,
                top_logprobs=top_logprobs if logprobs else None,
            )
            if not logprobs:
                body.pop("top_logprobs")
        return json.loads(self._request("POST", "/chat/completions", json_body=body))

    # -- batch -----------------------------------------------------------

    def upload_batch_file(self, jsonl_lines: Sequence[Dict]) -> str:
        content = "\n".join(json.dumps(l) for l in jsonl_lines).encode()
        ctype, body = multipart_form(
            {"purpose": "batch"}, {"file": ("batch.jsonl", content)}
        )
        resp = json.loads(
            self._request("POST", "/files", data=body, headers={"Content-Type": ctype})
        )
        return resp["id"]

    def create_batch(self, file_id: str, endpoint: str = "/v1/chat/completions",
                     completion_window: str = "24h") -> Dict:
        return json.loads(
            self._request(
                "POST", "/batches",
                json_body={
                    "input_file_id": file_id,
                    "endpoint": endpoint,
                    "completion_window": completion_window,
                },
            )
        )

    def get_batch(self, batch_id: str) -> Dict:
        return json.loads(self._request("GET", f"/batches/{batch_id}"))

    def download_file(self, file_id: str) -> bytes:
        return self._request("GET", f"/files/{file_id}/content")

    def wait_for_batch(self, batch_id: str, poll_interval: float = 60.0,
                       timeout: float = 24 * 3600, sleep=time.sleep,
                       clock=time.monotonic) -> Dict:
        """Poll until a terminal state (every 60 s by default; failed,
        cancelled and expired are errors).  Elapsed time is
        measured with a monotonic clock (injectable), so get_batch latency
        and retry backoffs count toward ``timeout`` too."""
        started = clock()
        while True:
            batch = self.get_batch(batch_id)
            status = batch.get("status")
            if status == "completed":
                return batch
            if status in ("failed", "cancelled", "expired"):
                raise RuntimeError(f"batch {batch_id} terminal state: {status}")
            if clock() - started >= timeout:
                raise TimeoutError(f"batch {batch_id} not done after {timeout}s")
            sleep(poll_interval)

    def retrieve_batch_results(self, batch: Dict) -> List[Dict]:
        raw = self.download_file(batch["output_file_id"])
        return [json.loads(line) for line in raw.decode().splitlines() if line.strip()]

    def run_batch(self, requests: Sequence[Dict], poll_interval: float = 60.0,
                  sleep=time.sleep) -> List[Dict]:
        """Submit (chunked at 50k), wait, download, concatenate."""
        results: List[Dict] = []
        chunks = [
            list(requests[i : i + MAX_BATCH_REQUESTS])
            for i in range(0, len(requests), MAX_BATCH_REQUESTS)
        ]
        for chunk in chunks:
            file_id = self.upload_batch_file(chunk)
            batch = self.create_batch(file_id)
            batch = self.wait_for_batch(batch["id"], poll_interval, sleep=sleep)
            results.extend(self.retrieve_batch_results(batch))
        return results


def build_batch_request(custom_id: str, model: str, messages: Sequence[Dict],
                        temperature: float = 0.0, max_tokens: int = 500,
                        logprobs: bool = True, top_logprobs: int = 20) -> Dict:
    """One JSONL line of the batch input."""
    body: Dict = {"model": model, "messages": list(messages)}
    if is_reasoning_model(model):
        body["max_completion_tokens"] = 2000
    else:
        body.update(
            temperature=temperature, max_tokens=max_tokens,
            logprobs=logprobs, top_logprobs=top_logprobs,
        )
    return {
        "custom_id": custom_id,
        "method": "POST",
        "url": "/v1/chat/completions",
        "body": body,
    }
