"""Vendor-side pieces of the port: the HTTP transport, the OpenAI,
Anthropic and Gemini clients, the response cache, the evaluators and
baselines, and the cost tracker the serve pool's remote backends price
requests with."""

from .anthropic_client import AnthropicClient
from .anthropic_client import build_batch_request as build_anthropic_batch_request
from .cache import REQUIRED_FIELDS, ResponseCache, cache_key
from .cost import CostTracker
from .evaluators import (
    evaluate_claude,
    evaluate_gemini_binary,
    evaluate_gemini_confidence,
    evaluate_gpt_binary,
    evaluate_gpt_confidence,
    evaluate_normal_baseline,
    evaluate_random_baseline,
    first_token_target_probs,
)
from .gemini_client import (
    GeminiClient,
    extract_text_from_response_string,
    repair_batch_responses,
)
from .openai_client import OpenAIClient
from .openai_client import build_batch_request as build_openai_batch_request
from .openai_client import is_reasoning_model
from .transport import FakeTransport, TransportError, UrllibTransport
