"""Run configuration shared by the port's modules (a copy of what the port
needs from ``llm_interpretation_replication_tpu/config``): the length
buckets, the legal scenarios of the perturbation study, the questions and
model pairs of the 100-question sweep, the instruct-model roster and the
word-meaning model pairs, and ``RunConfig``."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

# Length buckets of the sweep: prompts pad to the smallest bucket that holds
# the longest prompt of their batch.  Step 16 in the two hot zones (the
# perturbation corpus, 64-256; the few-shot shape, 400-448).
DEFAULT_BUCKETS = (64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240,
                   256, 320, 384, 416, 432, 448,
                   512, 640, 768, 1024, 1536, 2048)

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "data_assets")


def _load(name: str):
    with open(os.path.join(_ASSETS, name)) as f:
        return json.load(f)


def legal_scenarios() -> List[dict]:
    """The 5 scenarios of the prompt-sensitivity study: original_main,
    response_format, target_tokens[2], confidence_format (a byte-identical
    copy of the JAX package's ``data_assets/legal_scenarios.json``)."""
    return _load("legal_scenarios.json")


def ordinary_meaning_questions() -> List[str]:
    """The 100 ordinary-meaning questions, survey 1 then survey 2 (a
    byte-identical copy of ``data_assets/ordinary_meaning_questions.json``)."""
    q = _load("ordinary_meaning_questions.json")
    return q["survey1"] + q["survey2"]


def model_pairs_100q() -> List[dict]:
    """The 6 base/instruct pairs of the 100-question sweep (a byte-identical
    copy of ``data_assets/model_pairs_100q.json``)."""
    return _load("model_pairs_100q.json")


def model_pairs_word_meaning() -> List[dict]:
    """The base/instruct pairs of the word-meaning sweep (a byte-identical
    copy of ``data_assets/model_pairs_word_meaning.json``)."""
    return _load("model_pairs_word_meaning.json")


def instruct_sweep_models() -> List[str]:
    """The 10-model instruct roster (a byte-identical copy of
    ``data_assets/instruct_sweep_models.json``)."""
    return _load("instruct_sweep_models.json")


@dataclasses.dataclass
class RunConfig:
    """One typed config for the local-model sweep (the reference's
    ``RunConfig`` with ``device`` ``"cuda"`` or ``"cpu"``; its mesh and
    plan-search fields are not ported)."""

    device: str = "cuda"                 # 'cuda' | 'cpu'
    dtype: str = "bfloat16"              # weights/compute dtype on the device
    quant: str = "none"                  # 'none' | 'int8' (w8a8 projections)
    kv_dtype: str = "bf16"               # 'bf16' | 'int8' KV cache storage
    prefill_chunk: int = 0               # > 0: chunked prefill of longer buckets
    pooled_confidence: bool = True       # confidence leg through the pool
    phase2_pool_target: int = 0          # rows per pooled decode; 0 = batch
    slot_repack: bool = True             # slot ring (False: whole flushes)
    decode_k: int = 1                    # joint next-K decode block size
    attention_impl: str = "xla"          # 'xla' | 'flash' | 'auto'
    batch_size: int = 32
    checkpoint_dir: str = "checkpoints"  # local snapshots root
    output_dir: str = "results"

    def snapshot_path(self, model_name: str) -> str:
        """Local snapshot dir for a model id or path (nothing is
        downloaded: it must exist)."""
        flat = model_name.replace("/", "--")
        candidates = [
            os.path.join(self.checkpoint_dir, model_name),
            os.path.join(self.checkpoint_dir, flat),
            os.path.join(self.checkpoint_dir, f"models--{flat}", "snapshots"),
        ]
        for c in candidates:
            if os.path.isdir(c):
                if c.endswith("snapshots"):
                    subs = sorted(os.listdir(c))
                    if subs:
                        return os.path.join(c, subs[0])
                    continue
                return c
        raise FileNotFoundError(
            f"no local snapshot for {model_name!r} under {self.checkpoint_dir}")
