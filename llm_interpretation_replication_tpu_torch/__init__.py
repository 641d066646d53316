"""PyTorch/CUDA port of the scoring path of ``llm_interpretation_replication_tpu``.

The JAX package is the reference and stays as it is; this package imports
``torch`` and nothing of JAX or of the JAX package.  The slice ported so far
is the binary-leg scoring path of ``ScoringEngine.score_prompts`` (prefill,
position-0 scan, scored look-ahead of the undecided rows, yes/no scan) with
bf16 weights, whose prefill attention runs a hand-written Hopper kernel
(``ops/csrc/causal_grouped_attention.cu``).
"""
