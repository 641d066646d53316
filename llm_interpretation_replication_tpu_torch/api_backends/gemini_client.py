"""Gemini client: generateContent with logprobs and safety filters off,
threaded fan-out, and batch jobs (a copy of the JAX package's
``api_backends/gemini_client.py``).

- ``responseLogprobs`` with 19 candidates; a client-side token-bucket rate
  limiter; :meth:`GeminiClient.generate_many` fans out over 20 threads.
- Batch jobs: inlined requests, ``JOB_STATE_*`` polling every 30 s, and a
  resume file holding the batch name so an interrupted run re-attaches
  instead of submitting again.
- ``maxOutputTokens`` is left unset by default: setting it made the
  service return empty responses in the study's runs.
- Every wait takes an injectable sleep and clock, so tests never wait.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from ..utils.retry import RateLimiter, RetryPolicy, retry_with_exponential_backoff
from .transport import TransportError, UrllibTransport

BASE_URL = "https://generativelanguage.googleapis.com/v1beta"

SAFETY_OFF = [
    {"category": c, "threshold": "BLOCK_NONE"}
    for c in (
        "HARM_CATEGORY_HARASSMENT",
        "HARM_CATEGORY_HATE_SPEECH",
        "HARM_CATEGORY_SEXUALLY_EXPLICIT",
        "HARM_CATEGORY_DANGEROUS_CONTENT",
    )
]


class BatchTerminalError(RuntimeError):
    """A batch reached FAILED/CANCELLED/EXPIRED — the saved id is dead."""


class GeminiClient:
    def __init__(self, api_key: str, transport=None, base_url: str = BASE_URL,
                 retry_policy: Optional[RetryPolicy] = None,
                 requests_per_second: Optional[float] = None):
        self.api_key = api_key
        self.transport = transport or UrllibTransport()
        self.base_url = base_url
        self.retry_policy = retry_policy or RetryPolicy(
            retry_on=(TransportError,), max_retries=10,
            initial_delay=60.0, max_delay=300.0,
        )
        self.rate_limiter = (
            RateLimiter(requests_per_second) if requests_per_second else None
        )

    def generate_content(
        self,
        model: str,
        prompt: str,
        temperature: float = 0.0,
        max_output_tokens: Optional[int] = None,  # None on purpose (bug dodge)
        response_logprobs: bool = False,
        logprobs: int = 19,
        safety_off: bool = True,
    ) -> Dict:
        if self.rate_limiter:
            self.rate_limiter.acquire()
        generation_config: Dict = {"temperature": temperature}
        if max_output_tokens is not None:
            generation_config["maxOutputTokens"] = max_output_tokens
        if response_logprobs:
            generation_config["responseLogprobs"] = True
            generation_config["logprobs"] = logprobs
        body = {
            "contents": [{"parts": [{"text": prompt}]}],
            "generationConfig": generation_config,
        }
        if safety_off:
            body["safetySettings"] = SAFETY_OFF
        path = f"/models/{model}:generateContent?key={self.api_key}"

        @retry_with_exponential_backoff(self.retry_policy)
        def call():
            try:
                _, raw = self.transport.request("POST", f"{self.base_url}{path}", {}, body)
            except TransportError as err:
                if not err.retryable:
                    raise RuntimeError(str(err)) from err
                raise
            return raw

        return json.loads(call())

    @staticmethod
    def text_of(response: Dict) -> str:
        try:
            parts = response["candidates"][0]["content"]["parts"]
            return "".join(p.get("text", "") for p in parts).strip()
        except (KeyError, IndexError):
            return ""

    @staticmethod
    def top_candidates_of(response: Dict) -> List[List[tuple]]:
        """Per-position [(token, logprob)] lists from logprobsResult."""
        try:
            lr = response["candidates"][0]["logprobsResult"]
        except (KeyError, IndexError):
            return []
        positions = []
        for pos in lr.get("topCandidates", []):
            positions.append(
                [
                    (c.get("token", ""), float(c.get("logProbability", 0.0)))
                    for c in pos.get("candidates", [])
                ]
            )
        return positions

    def generate_many(self, model: str, prompts: Sequence[str], max_workers: int = 20,
                      **kwargs) -> List[Dict]:
        """Threaded fan-out (the reference's 'parallel'/'batch auto' mode)."""
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            futures = [
                pool.submit(self.generate_content, model, p, **kwargs) for p in prompts
            ]
            return [f.result() for f in futures]

    # -- batch jobs ----------------------------------------------------------
    #
    # Submit inlined requests to the Batch API, poll every 30 s against the
    # JOB_STATE_* machine, and persist the batch name to a resume file so an
    # interrupted run re-attaches instead of re-submitting
    # (save/load/clear_batch_id).

    TERMINAL_STATES = frozenset({
        "JOB_STATE_SUCCEEDED", "JOB_STATE_FAILED",
        "JOB_STATE_CANCELLED", "JOB_STATE_EXPIRED",
    })

    def create_batch(self, model: str, prompts: Sequence[str],
                     display_name: Optional[str] = None, temperature: float = 0.0,
                     response_logprobs: bool = False, logprobs: int = 19,
                     safety_off: bool = True) -> str:
        """Submit a batch of inlined generateContent requests; returns the
        batch resource name (``batches/...``) used for polling/retrieval."""
        generation_config: Dict = {"temperature": temperature}
        if response_logprobs:
            generation_config["responseLogprobs"] = True
            generation_config["logprobs"] = logprobs
        requests = []
        for i, prompt in enumerate(prompts):
            req: Dict = {
                "contents": [{"parts": [{"text": prompt}]}],
                "generationConfig": generation_config,
            }
            if safety_off:
                req["safetySettings"] = SAFETY_OFF
            requests.append({"request": req, "metadata": {"key": str(i)}})
        body = {
            "batch": {
                "displayName": display_name or f"sweep-batch-{len(prompts)}",
                "inputConfig": {"requests": {"requests": requests}},
            }
        }
        path = f"/models/{model}:batchGenerateContent?key={self.api_key}"

        @retry_with_exponential_backoff(self.retry_policy)
        def call():
            try:
                _, raw = self.transport.request("POST", f"{self.base_url}{path}", {}, body)
            except TransportError as err:
                if not err.retryable:   # 400 payload-too-large / 403: surface now
                    raise RuntimeError(str(err)) from err
                raise
            return raw

        return json.loads(call())["name"]

    def get_batch(self, name: str) -> Dict:
        @retry_with_exponential_backoff(self.retry_policy)
        def call():
            try:
                _, raw = self.transport.request(
                    "GET", f"{self.base_url}/{name}?key={self.api_key}", {}, None
                )
            except TransportError as err:
                if not err.retryable:
                    raise RuntimeError(str(err)) from err
                raise
            return raw

        return json.loads(call())

    @staticmethod
    def batch_state(batch: Dict) -> str:
        return (batch.get("metadata", {}).get("state")
                or batch.get("state", "JOB_STATE_UNSPECIFIED"))

    def wait_for_batch(self, name: str, poll_interval: float = 30.0,
                       max_wait: float = 24 * 3600.0, sleep_fn=None,
                       clock_fn=None) -> Dict:
        """Poll until a terminal JOB_STATE_*; raises on failed/cancelled/
        expired (each ends the run).

        Elapsed time is measured with a monotonic clock (injectable as
        ``clock_fn`` for tests), not by summing sleep intervals — get_batch
        latency and its retry backoffs count toward ``max_wait`` too.
        """
        import time as _time

        sleep_fn = sleep_fn or _time.sleep
        clock_fn = clock_fn or _time.monotonic
        started = clock_fn()
        while True:
            batch = self.get_batch(name)
            state = self.batch_state(batch)
            if state == "JOB_STATE_SUCCEEDED":
                return batch
            if state in self.TERMINAL_STATES:
                raise BatchTerminalError(f"gemini batch {name} ended in {state}")
            waited = clock_fn() - started
            if waited >= max_wait:
                raise TimeoutError(f"gemini batch {name} still {state} after {waited:.0f}s")
            sleep_fn(poll_interval)

    @staticmethod
    def batch_responses(batch: Dict) -> List[Dict]:
        """Per-request response dicts, re-paired to submit order.

        Each submitted request carries ``metadata.key = str(i)``; when the
        service echoes it, responses are ordered by that key rather than
        trusting wire order (mis-pairing would silently attribute every
        logprob to the wrong prompt).  Keyless responses keep wire order."""
        inlined = (batch.get("response", {}).get("inlinedResponses", {})
                   .get("inlinedResponses", []))
        def _key(r):
            try:
                return int(r.get("metadata", {}).get("key"))
            except (TypeError, ValueError):
                return None

        keys = [_key(r) for r in inlined]
        if keys and None not in keys and len(set(keys)) == len(keys):
            inlined = [r for _, r in sorted(zip(keys, inlined))]
        return [r.get("response", {}) for r in inlined]

    def run_batch(self, model: str, prompts: Sequence[str],
                  resume_file: Optional[str] = None, poll_interval: float = 30.0,
                  sleep_fn=None, **kwargs) -> List[Dict]:
        """Submit-or-resume → wait → collect.  With ``resume_file``, a saved
        batch name is re-attached to (and cleared on success) so a crashed
        orchestrator never double-submits 20k requests."""
        name = load_batch_id(resume_file) if resume_file else None
        if name is None:
            name = self.create_batch(model, prompts, **kwargs)
            if resume_file:
                save_batch_id(resume_file, name)
        try:
            batch = self.wait_for_batch(name, poll_interval, sleep_fn=sleep_fn)
        except BatchTerminalError:
            # FAILED/CANCELLED/EXPIRED: the saved id is dead — clear it so the
            # next run resubmits.  Other errors (transient poll failures, auth
            # hiccups) keep the file: the batch may still be running.
            if resume_file:
                clear_batch_id(resume_file)
            raise
        if resume_file:
            clear_batch_id(resume_file)
        return self.batch_responses(batch)


# Resume-file helpers ride utils/checkpoint.CheckpointFile (atomic tmp +
# os.replace writes) so a crash mid-save can never leave a truncated batch
# name for the next run to poll.

def save_batch_id(path: str, name: str) -> None:
    from ..utils.checkpoint import CheckpointFile

    CheckpointFile(path).save({"batch_name": name})


def load_batch_id(path: str) -> Optional[str]:
    from ..utils.checkpoint import CheckpointFile

    return CheckpointFile(path).load().get("batch_name") or None


def clear_batch_id(path: str) -> None:
    from ..utils.checkpoint import CheckpointFile

    CheckpointFile(path).clear()


# ---------------------------------------------------------------------------
# Batch-response repair
#
# A buggy batch download can leave each JSONL row's text field holding the
# *string repr* of a response object instead of the text itself, with the
# custom_id lost.  The repair pass re-pairs rows with the original request
# custom_ids (by line position) and regex-recovers the text.
# ---------------------------------------------------------------------------

def extract_text_from_response_string(response_str: str) -> str:
    """Recover the reply text from a stringified response object (the
    ``text='...'`` group, else '').

    Unlike a plain ``[^']*`` regex, this also handles Python reprs
    that switch to double quotes (``text="It's likely"``) and backslash-
    escaped quotes inside the literal, so apostrophed answers survive the
    repair instead of being silently truncated or blanked.
    """
    import re

    s = str(response_str)
    for pattern, unescape in (
        (r"text='((?:[^'\\]|\\.)*)'", (("\\'", "'"),)),
        (r'text="((?:[^"\\]|\\.)*)"', (('\\"', '"'),)),
    ):
        match = re.search(pattern, s)
        if match:
            text = match.group(1)
            for src, dst in unescape + (("\\\\", "\\"),):
                text = text.replace(src, dst)
            return text
    return ""


def repair_batch_responses(request_jsonl: str, response_jsonl: str,
                           output_jsonl: str) -> int:
    """Rewrite a corrupted batch-response JSONL.

    Reads custom_ids from ``request_jsonl`` (positional pairing; rows past the
    request list get ``result_{i}`` ids), extracts the real text out of each
    stringified response, and writes rows in the canonical
    ``{"custom_id", "response": {"candidates": [{"content": {"parts":
    [{"text": ...}]}, "logprobs_result": None}]}}`` shape.  Returns the number
    of rows repaired.
    """
    with open(request_jsonl) as f:
        request_ids = [json.loads(line)["custom_id"] for line in f if line.strip()]
    with open(response_jsonl) as f:
        responses = [json.loads(line) for line in f if line.strip()]

    fixed = 0
    with open(output_jsonl, "w") as f:
        for idx, row in enumerate(responses):
            custom_id = request_ids[idx] if idx < len(request_ids) else f"result_{idx}"
            try:
                raw = row["response"]["candidates"][0]["content"]["parts"][0]["text"]
            except (KeyError, IndexError, TypeError):
                raw = ""
            f.write(json.dumps({
                "custom_id": custom_id,
                "response": {
                    "candidates": [{
                        "content": {"parts": [{"text": extract_text_from_response_string(raw)}]},
                        "logprobs_result": None,
                    }]
                },
            }) + "\n")
            fixed += 1
    return fixed
