"""PyTorch/CUDA port of ``llm_interpretation_replication_tpu``.

The JAX package is the reference and stays as it is; this package imports
``torch`` and nothing of JAX or of the JAX package.  Ported so far: the
study's ``run-perturbation`` entry point (``python -m
llm_interpretation_replication_tpu_torch run-perturbation``) from a local
Falcon snapshot through the sweep shell (``sweeps/``) and
``ScoringEngine.score_prefixed`` to the 15-column workbook, with the
engine's scoring routes, w8a8 weights, an int8 KV cache and chunked
prefill; every prefill's attention runs a hand-written Hopper kernel
(``ops/csrc/causal_grouped_attention.cu``).
"""
