#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure (the exit code is then non-zero and no result
line is printed; the order of the run is 1-8, 10, 16, 17, 18, 19, 9, 11,
18's CLI leg, 12-15):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile every CUDA source of ``ops/csrc`` (one ``nvcc`` each, all
   started together) and print, for each kernel template instance, its
   ptxas registers, spills and shared memory;
3. kernels: hold each kernel (causal grouped, head-major grouped, head-major
   flash; all three on ``attention_tile.cuh``) against its plain PyTorch
   version (float32 from the same bf16 inputs) at the shapes the main paths
   give it, and time it beside its plain version, its bound and one
   PyTorch library call computing the same function.  The kernel and the
   library call are timed as a CUDA graph of 20 calls, replayed after
   warm-up, between CUDA events (device time only); the wrapper's host
   cost per call is a column of its own; the plain version is timed call
   after call between CUDA events.  This phase draws first from the seeded
   generator, so its q, k and lengths are those of earlier runs of the
   script, and its v theirs up to the clamp;
4. edge: the three kernels on ``attention_tile.cuh`` (causal grouped,
   head-major grouped with K/V unrepeated, flash) against their plain
   versions, causal and not, at the shapes where a pipelined tile loop goes
   wrong: S in {1, 63, 64, 65, 127, 129} x D in {64, 96, 128} x (N, G) in
   {(71, 1), (8, 2), (4, 4)} with a full, a length-1, a length-0 and a
   mid-tile row, and S=4097 (B=1, (4, 4)): 114 cases a kernel, 342 in all;
5. slice: Falcon-7B at its published width and depth, bf16, random weights
   from ``--seed``, scores 96 pre-tokenized prompts of 100-440 tokens in
   batches of 32 through ``ScoringEngine.score_prompts`` with the causal
   kernel carrying every prefill; the launch counters must show the kernel
   ran, the same prompts go through the dense path, and the position-0
   logits of both are held against a float32 reference of the same weights;
6. forced routes: the slice's longest batch through
   ``decoder.forward_last_logits`` with every layer's attention forced
   through ``attention_bsnd(force="grouped")`` and then ``force="pallas"``
   (each kernel must launch once a layer), held against the same float32
   reference, and each route's prefill timed;
7. pooled: the engine's default binary schedule on the slice's weights:
   384 prompts of 100-440 tokens, batch 32 (12 batches), per-prompt
   targets from a pre-pass so that 339 rows are decided at position 0
   (one batch of the 448 bucket holds 12 undecided rows, more than the
   8-row selection slice, and takes the overflow route).  Six runs on the
   same prompts: the per-batch route, the pooled whole-flush route, the
   defaults (slot ring, ``pipeline_depth=2``), the defaults at depth 1,
   ``score_prompts_slotted`` admitting the second half mid-decode, and
   ``export_kv_slab`` + ``decode_kv_slabs`` of the same halves.  Runs 2-4
   must agree with run 1 (verdicts and position-0 fields identical,
   relative_prob within 0.02), the ring must refill lanes, run 6 must equal
   run 5 bit for bit, and each run's prefills must launch the kernel.
   Last, one real OOM: under a per-process memory cap between the batch-32
   and the batch-64 need, the 128 longest prompts at batch 64 must step
   down to 32 and give run 3's rows;
8. full study: the full-study row on the slice's weights at
   ``EngineConfig()``: 96 prefixes of 100-440 tokens, each with a binary
   and a confidence suffix of a scenario's format lengths (19-21 and 30-35
   words).  A greedy pre-pass decodes both legs as the per-batch route
   does, and gives the id tokenizer a decode map under which chosen tokens
   read as a terminated number, so confidence rows retire mid-decode and
   some position-0 candidates read as digits.  Five runs on the same rows:
   the binary leg with its 50-token completion, the confidence leg
   (``max_new_tokens=10``) on the ring, on whole flushes and per batch, and
   ``score_prefixed`` with both legs over one prefix cache.  The per-batch
   runs must reproduce the pre-pass; the pooled confidence rows and the
   fused legs are held against them: position-0 fields identical (pooled)
   or within FUSED_PROB_TOL (fused); completions may part only at a
   near-tie, a step whose top-1 logit leads by less than twice the largest
   rounding measured between two bf16 computations of the same logits;
   rows that do not part agree in verdict, relative_prob and first
   integer, and weighted confidence within STUDY_WC_TOL / FUSED_WC_TOL.
   Each pooled row must be cut at the step its own tokens retire it, and
   the retirement counters must be those of these steps; every prefill
   must launch the causal kernel once a layer;
9. int8: the int8 product's int32 accumulators on the card against a CPU
   int32 product at Falcon-7B's and Mistral-7B's projection shapes (the
   gated MLP's among them); then the slice's prompts scored with w8a8 int8
   weights (quantized as they are made), once with a bf16 and once with an
   int8 KV cache, held against the bf16 rows;
10. sweep (before the int8 phase, on the first SWEEP_LAYERS (8) of the
   slice's 32 layers, views of its tensors): the 5 legal
   scenarios with 24 seeded word-level edits each of original_main (60-140
   words, one token a word under a word tokenizer of the scenarios' words,
   whose decode writes token i as " t<i>", and whose target tokens take
   ids these weights often rank in position 0's top 20) go through
   ``sweeps.run_model_perturbation_sweep`` in chunks of 40 rows: (a) the
   fused default route, (b) a run an engine wrapper interrupts on its
   second chunk, then the same call again (the side-log resumes it),
   (c) the two-string route, (d) an engine whose top filter is 5, so the
   shell takes ``first_token_relative_prob``, (e) ``prefill_chunk=64``.
   Each workbook is read back (15 columns, 120 rows, no side-log left) and
   held against (a)'s with the full-study gates (completions part only
   where (a)'s lead, from one forward over prompt and completion, is below
   twice the near-tie, measured as the full-study phase measures it on
   these prompts at this depth; position-0 fields within
   FUSED_PROB_TOL); every prompt forward launches the causal kernel once a
   layer, and (e)'s ``prefill_chunks`` is the batches' buckets' count.
   Then the slice's bucket-448 batch prefills through all 32 layers
   monolithic and in chunks of 128, timed, with peak memory;
11. CLI: a snapshot of Falcon-7B's published width cut to 2 layers
   (random bf16 weights, target rows scaled as in phase 10, written by
   the phase's own safetensors writer,
   legacy config keys, a tokenizer.json in Falcon's published format,
   its Sequence pre-tokenizer, learned on the scenarios' texts) in a
   temporary directory; ``load_model`` must give the
   written tensors back bit for bit; ``__main__.main(["run-perturbation",
   ...])`` runs in this process in bf16 (its workbook must equal an
   in-process sweep over the loaded weights) and with ``--quant int8
   --kv-dtype int8 --prefill-chunk 64`` (verdicts and relative_prob within
   0.05 of bf16's, but for rows whose target lies within the int8 path's
   measured logit deviation, doubled, of the top-20 edge); then
   ``--packed 4`` (the packed workbook with its extractor tag, and the
   drift line) and ``--decode-k 4`` twice (the first run distills a
   K-head and writes ``k_head.npz``, the second loads it and writes the
   same workbook; both keep the bf16 run's position-0 columns);
12. families: Pythia-6.9B (GPT-NeoX), Mistral-7B-Instruct-v0.2 (the
   LLaMA family, 32 query heads on 8 K/V heads) and BLOOM-7b1 (ALiBi) at
   their published width and FAMILY_LAYERS (8) of their 30-32 layers:
   random bf16 weights from ``--seed``
   made as a HF checkpoint and read through the port's converter, the two
   targets' rows swapped with ids the weights rank high; each scores the
   100 questions as base (the few-shot prefix through ``score_prefixed``)
   and as instruct through ``sweeps.run_model_on_prompts`` at
   ``EngineConfig(batch_size=32)``: NeoX and Mistral under the causal
   kernel and dense, Mistral also with an int8 KV cache, under bf16 and
   under w8a8 weights, BLOOM dense.  Completions may part only where the dense route's lead is
   below the tie measured on these weights (twice NEAR_TIE_FACTOR times the
   largest top-1 difference of two bf16 computations), verdicts only where
   a target lies within the tie of the top-5 edge or of the other target;
   position-0 fields within twice one bf16 forward's deviation from a
   float32 forward; the int8 KV cache, under bf16 and under w8a8 weights,
   against bf16 on the rows read at position 0 and clear of that route's
   own tie (its deviation measured on the prefix prefill and suffix
   extension the sweep runs), with the same verdict and log-probabilities
   within twice that deviation (|d relative_prob| reported against the
   int8 KV class); the w8a8 route also against a float32 fake-quant of
   the same tree that skips the int8 product (``_fake_quant_witness``:
   codes within half a step of the weights, each projection within one
   bf16 step of its float twin, log-probabilities within twice the bf16
   fake-quant's deviation); every kernel route launches the kernel once
   a layer a prefill.  The causal kernel is timed at each
   family's prefix-prefill shape, and at StableLM-alpha-7B's heads;
13. run-100q: 2-layer snapshots of every geometry of the sweep's twelve
   models at their published widths (BLOOM as sharded ``pytorch_model.bin``
   with its index, the rest safetensors; tokenizers learned on the
   questions in each model's published format: Falcon's Sequence,
   BLOOM's Split and ByteLevel(use_regex=false), Mistral's byte-fallback
   BPE with its BOS, byte-level BPE for the NeoX ones with the NFC
   normalizer);
   ``python -m llm_interpretation_replication_tpu_torch run-100q
   --attention-impl flash`` in a child process must write 1200 rows in the
   10 columns, each with ``success``, and name each model's attention
   (dense for BLOOM and Mistral-7B-v0.1); a run stopped by SIGTERM after
   its first model must leave exactly that model's rows in its
   checkpoint, resuming it must write the same CSV, and a rerun over the
   finished output must score nothing;
14. instruct: the instruct roster's new models at their published width
   (random bf16 HF-named checkpoints from ``--seed`` through the port's
   converters; T5's at its own initialization scales; T0_3B and the T5
   pair at their depth, the decoders at FAMILY_LAYERS), under the
   families phase's word tokenizer with the targets swapped to ids the
   weights rank high.  T0_3B (T5 XL) scores the 100 instruct prompts
   through the instruct sweep's per-model call, and the word-meaning pair
   (t5-v1_1-base, flan-t5-base) runs through
   ``sweeps.run_base_vs_instruct_word_meaning`` (the base model's few-shot
   prompt on T5): each T5 model's rows against the same prompts at batch
   8 (partings only below the tie measured between the decode and one
   forward over its tokens) and position-0 fields within twice one bf16
   forward's deviation from float32, and ms a decode step.  Qwen-7B-Chat,
   Baichuan2-7B-Chat (NormHead) and OPT-IML-1.3B run phase 12's routes and
   gates (kernel and dense) on the instruct prompts, the causal kernel
   timed at each one's longest prompt batch;
15. run-instruct-sweep: 2-layer snapshots of the roster's six geometries
   phase 13 did not write (a Unigram ``tokenizer.json`` behind a
   Precompiled charsmap for the T5s, Mistral v0.3's Metaspace "first"
   byte-fallback BPE, ``qwen.tiktoken`` for Qwen, OPT's ``vocab.json`` +
   ``merges.txt``, byte-level BPE for the rest) beside phase 13's Falcon, BLOOM and
   RedPajama snapshots; ``python -m llm_interpretation_replication_tpu_torch
   run-instruct-sweep --attention-impl flash --quant int8`` in a child
   process must write 1000 rows in the 7 columns, none a ``MODEL_ERROR``,
   name each model's attention (dense for BLOOMZ and the T5s, which warn
   and load bf16), keep exactly the first model's rows after a SIGTERM,
   resume to the same CSV and score nothing on a rerun;
16. packed (after the sweep phase, on the slice's weights): the sweep
   phase's corpus (its perturbations.json, targets on ids these weights
   often rank in the top 20) through ``run_packed_perturbation_sweep`` at
   Q=4 with drift parity (120 questions in 30 packs; the drift report
   holds 120 questions, none skipped, finite fields); questions/s packed
   against isolated; then on the kernel and the dense route,
   single-question packs and question 0 of each pack against isolated
   scoring (a target may cross the top-20 edge only within the tie of it,
   the verdict turn only where the targets lie within the tie, the fields
   move by at most FUSED_PROB_TOL elsewhere); every prompt forward of the
   kernel route launches the causal kernel once a layer; the causal kernel
   timed at the packed batch's shape;
17. k_decode (after phase 16): the full-study row (``score_prefixed``, both
   legs) on the full-study phase's 96 rows at K=1, then at K=4 with a
   distilled head (its distillation seconds and size), with oracle
   proposals (``oracle_engine``: the K=1 chain, so blocks are accepted)
   and with a random head (every speculative block rejects), then K=1 and
   the oracle with an int8 KV cache.  The random head's rows equal K=1's;
   the distilled and oracle rows (and the int8 oracle's against its K=1)
   part only below the tie (the int8 pair's widened by the int8 cache's
   measured logit deviation) and keep their probabilities within it; the
   oracle saves steps; passes a chunk, ms of a sequential chunk against
   the accepted K path's, and the accept rate are printed;
18. obs (after phase 17, on the slice's weights; guards and device
   observability): 20 rows of the sweep phase's corpus (5 scenarios x 4
   rephrasings) through ``run_model_perturbation_sweep`` after a warm-up
   run: (a) plain, (b) with strict mode, the span tracer, the metrics log
   and a ``profile_window`` capture all armed, a warm repeat under strict
   mode alone, and (c) with the tracer in sync mode.  The rows of every
   run equal (a)'s; under strict mode every prefill ran at sync debug mode
   2, (b) and the repeat add no ``blocked_transfers`` and the repeat no
   ``recompile_events``; every span's phase is in
   ``KNOWN_PHASES`` and the phase self-times sum to no more than the
   call's wall time; ``top_device_ops`` of (b)'s capture names the causal
   kernel, whose events there number layers x prefills;
   ``device_memory_snapshot`` reads between 0 and the card's total.  The
   negative control: inside ``strict.scoring_guard`` a ``.item()`` on a
   CUDA tensor must raise and add exactly 1 to ``blocked_transfers``, and
   not raise inside ``sanctioned_fetch``; the same guard is asked about
   13 other operations (what sync debug mode catches).  Printed: rows/s
   of each run, the phase tables with their coverage, the top 10 device
   ops.  Its CLI leg (after phase 11, on that phase's 2-layer snapshot):
   ``run-perturbation --strict --trace T --profile D --metrics M`` writes
   the workbook of the same call without the flags, and ``obs report
   --trace T`` prints the phase table.  Phases 13 and 15 run their first
   CLI call with ``--strict``: its audit line must read
   ``blocked_transfers`` 0;
19. tokenizers (after phase 18, on the slice's weights): each published
   tokenizer format of ``TOKENIZER_FORMATS`` (Falcon's, BLOOM's, Llama-2 /
   Mistral's byte-fallback BPE, Mistral v0.3's Metaspace "first", T5's
   Precompiled charsmap), written as plain JSON and read back through
   ``load_tokenizer``: the sweep corpus encoded (tokens/s on the card's
   host) and decoded back, and a sha256 of its ids over the fixed
   ``_tokenizer_digest_texts()`` equal to ``TOKENIZER_DIGESTS`` (the
   ``tokenizers`` package's and the JAX loader's on the CPU, so a
   different ``unicodedata`` on the card's Python shows); then 20 rows
   of the corpus encoded by the Falcon-format reader through
   ``run_model_perturbation_sweep`` at 32 layers on the causal kernel,
   traced (rows/s, the prefetcher's encode spans' share of the wall) and
   again untraced: every row finite, the rerun's rows equal, 32 causal
   launches a prefill.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Per-shape details go to
``chiprun_out/chip_smoke.json``.  Needs one CUDA device; runs nothing on the
CPU in its place.
"""

import argparse
import dataclasses
import functools
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ERR_TOL = 1e-2            # kernel vs plain, bf16 output of unit-normal inputs
V_CLAMP = 3.5             # |v| bound, so outputs stay where bf16 rounds < ERR_TOL
# position-0 logits: the kernel path's relative L2 distance from a float32
# reference may exceed the dense bf16 path's by at most this factor
KERNEL_VS_DENSE_ERR_RATIO = 1.25
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak, same source
KERNEL_SHAPES = [         # (label, B, S, N, G, D) of the causal kernel
    ("falcon-7b", 32, 432, 71, 1, 64),
    ("falcon-7b-long", 4, 2048, 71, 1, 64),
    ("gqa", 16, 448, 32, 8, 128),
    ("mha-small-1b", 16, 320, 16, 16, 128),
]
HEAD_MAJOR_SHAPES = [     # of the head-major kernels (the slice's bucket 448)
    ("falcon-7b", 32, 448, 71, 1, 64),
    ("falcon-7b-long", 4, 2048, 71, 1, 64),
    ("gqa", 16, 448, 32, 8, 128),
]
FLASH_ONLY_SHAPES = [     # Llama-2-7B's width at its 4096 context
    ("llama-2-7b-4096", 2, 4096, 32, 32, 128),
]
N_PROMPTS, BATCH = 96, 32
# the pooled phase: prompts, ring capacity, and per batch the rows decided at
# position 0, resolved at look-ahead step 1, and never resolved; the longest
# batch (bucket 448) gets more undecided rows than the 8-row selection slice
POOL_PROMPTS, POOL_TARGET = 384, 16
POOL_ROLES, OVERFLOW_ROLES = (29, 2, 1), (20, 6, 6)
POOL_RELPROB_TOL = 0.02      # pooled routes vs the per-batch route
# the memory cap of the OOM run: the batch-32 need times this factor; a
# batch of 64 at bucket 384 holds 1.71x the tokens of one of 32 at 448
OOM_BATCH, OOM_CAP_FACTOR, OOM_LONGEST = 64, 1.4, 128
# the full-study phase: per scenario of data_assets/irrelevant_scenarios.json,
# the word counts of its response_format (the binary suffix) and its
# confidence_format (the confidence suffix); one token a word here
SCENARIO_SUFFIX_WORDS = ((19, 32), (21, 35), (21, 31), (20, 30), (20, 31))
STUDY_PROMPTS, CONF_CAP = 96, 10
# per batch of 32: targets deciding rows at position 0, at look-ahead step 1
# and never; a step-1 target lies outside position 0's top 64
STUDY_ROLES, STUDY_OUTSIDE = (12, 10, 10), 64
# confidence rows planned to retire, at most, in each batch of 32
RETIRE_PER_BATCH = 18
# Greedy decoding of random weights keeps meeting near-ties: a few tokens
# take turns at the top.  Two bf16 computations of the same logits (another
# batch composition, another cache layout) may then pick different tokens,
# and the rows part there.  The phase measures that rounding: the largest
# difference between the pre-pass decode's top-1 logit and one forward's
# over the same tokens.  Two runs' completions may part only at a step
# whose top-1 logit leads the next by less than NEAR_TIE_FACTOR times it
# (two logits, each off by up to that much), and a planned retirement's
# steps lead by more.
NEAR_TIE_FACTOR = 2.0
# weighted_confidence (0-100 scale): pooled vs per-batch rows, whose
# position-0 candidates come from the same prefill, and fused vs unfused
# rows, whose come from two bf16 computations of the same logits
STUDY_WC_TOL, FUSED_WC_TOL = 0.01, 0.5
# position-0 fields and relative_prob of rows that did not part: fused vs
# unfused, where every logit differs by bf16 rounding (pooled vs per-batch:
# position-0 fields identical, relative_prob as this)
FUSED_PROB_TOL = 0.05
# the top-20 filter of the position-0 fields: a target whose logit lies
# within the near-tie of the 20th largest may fall on either side of it
TOP_FILTER = 20
# int8 runs against the bf16 engine on the same weights and prompts
# (PARITY.md's w8a8 audit bounds) and int8 KV against bf16 KV (ROADMAP.md)
W8A8_MEAN_DREL, W8A8_MAX_DREL = 0.02, 0.10
INT8_KV_MAX_DREL = 0.05
# an int8 projection against the same projection in floating point (the
# activations rounded to the same codes, the dequantized weight, float32
# products), both cast to bf16: one bf16 step of the largest output
PROJECTION_TOL = 2.0 ** -7
# Falcon-7B's projections (K, N): QKV (q, then MQA's k or v), out, MLP in/out;
# then Mistral-7B's: q/o, its 8 K/V heads, the gated MLP's gate/up and down
INT8_SHAPES = [(4544, 4544), (4544, 64), (4544, 18176), (18176, 4544),
               (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# the sweep and CLI phases: rephrasings a scenario, their token range (the
# real corpus's; the originals are 71-102 words), the sweep's chunk and
# checkpoint sizes, the chunked-prefill run's chunk and the timing's, the
# snapshot's layers (Falcon-7B's published width, its depth cut to bound
# the time the snapshot takes to write and read)
SWEEP_PER_SCENARIO, SWEEP_TOKENS = 24, (60, 140)
SWEEP_CHUNK, SWEEP_CHECKPOINT = 40, 20
SWEEP_PREFILL_CHUNK, TIMING_PREFILL_CHUNK = 64, 128
SNAPSHOT_LAYERS = 2
# the sweep phase's depth: its eight sweeps run on the first 8 of the
# slice's 32 layers (views, nothing copied), the cheapest cut of the
# smoke's time; its gates' near-tie is measured at that depth
SWEEP_LAYERS = 8
SWEEP_MODEL = "tiiuae/falcon-7b (random weights)"
# the sweep phase's boosted runs scale the (tied) embedding rows of the
# scenarios' own target ids by this factor: their logits, and the bf16
# rounding of them, spread that much wider, and the phase measures that
# rounding on those weights for their gates
TARGET_BOOST = 5.0
# the int8 CLI run (w8a8 weights, int8 KV, chunked prefill) against the bf16
# one: |d relative_prob| bound of the int8 class (ROADMAP.md)
CLI_INT8_MAX_DREL = 0.05
# the packed phase: questions a pack; the K-decode phase: the block size and
# the distillation sample (binary and confidence prompts, the CLI's counts)
PACK_Q = 4
K_DECODE = 4
K_DISTILL = (24, 12)
# (wrapper, source in ops/csrc, line of the TPU kernel it replaces in
# llm_interpretation_replication_tpu/ops/attention.py, shapes, layout)
KERNELS = [
    ("causal_grouped_attention", "causal_grouped_attention", 355,
     KERNEL_SHAPES, "bsnd"),
    ("grouped_attention", "head_major_attention", 183,
     HEAD_MAJOR_SHAPES, "bnsd"),
    ("flash_attention", "head_major_attention", 50,
     HEAD_MAJOR_SHAPES + FLASH_ONLY_SHAPES, "bnsd"),
]
KERNEL_NAMES = [k[0] for k in KERNELS]
LAYOUTS = {k[0]: k[4] for k in KERNELS}
# the kernels on ops/csrc/attention_tile.cuh, and the edge phase's shapes;
# a kernel added here goes last, so the ones before it keep drawing the
# same inputs from the seeded generator
TILE_KERNELS = ("causal_grouped_attention", "flash_attention",
                "grouped_attention")
EDGE_SEQS = (1, 63, 64, 65, 127, 129)
EDGE_DIMS = (64, 96, 128)
EDGE_HEADS = ((71, 1), (8, 2), (4, 4))
EDGE_BATCH = 4
# S=4097 with one batch row and 4 heads only: the float32 plain version's
# scores at 71 heads would take ~5 GB
EDGE_LONG = (1, 4097, 4, 4)               # (B, S, N, G)
GRAPH_CALLS = 20


def say(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=GRAPH_CALLS, replays=5):
    """Mean device time of one call of ``fn``: ``calls`` calls captured in
    a CUDA graph, replayed once to warm up and then ``replays`` times
    between CUDA events, so no host cost of the call is in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def host_us(fn, calls=GRAPH_CALLS):
    """Host microseconds one call of ``fn`` takes to return (checks,
    allocation, launch), the device left to run behind it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def ptxas_instances(log):
    """One dict per kernel template instance in ``nvcc -Xptxas -v`` output:
    its mangled name, registers, spill bytes and static shared memory."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(function=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)),
                       static_smem=int(smem.group(1)) if smem else 0)
    return out


def build_phase(_build, attention):
    """Build every source (one nvcc each, all at once) and print each
    kernel instance's registers, spills and shared memory (the tile
    kernels' dynamic shared memory as their launch requests it)."""
    t0 = time.perf_counter()
    recs = _build.build_all(attention.KERNEL_SOURCES)
    say(f"build: {time.perf_counter() - t0:.2f} s")
    instances = []
    for source, rec in recs.items():
        say(f"build {source}: {rec.seconds:.2f} s")
        smem_bytes = _build.load(source).attention_tile_smem_bytes
        for inst in ptxas_instances(rec.log):
            m = re.search(r"tile_kernelILi(\d+)E", inst["function"])
            inst.update(source=source,
                        dynamic_smem=smem_bytes(int(m.group(1))) if m else 0)
            instances.append(inst)
            say("build", json.dumps(inst))
    if not instances:
        raise AssertionError("no ptxas output for any kernel")
    return dict(seconds={s: r.seconds for s, r in recs.items()},
                instances=instances)


def _check_output(what, out, ref, lengths, valid=None):
    """Raise unless ``out`` is finite, zero on length-0 rows and within
    ERR_TOL of ``ref`` (on the ``valid`` rows when given); return the max
    abs error."""
    import torch

    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite output")
    zero_rows = out[lengths == 0]
    if zero_rows.numel() and bool((zero_rows != 0).any()):
        raise AssertionError(f"{what}: length-0 rows are not zero")
    diff = (out.float() - ref).abs()
    if valid is not None:
        diff = diff * valid
    err = float(diff.max())
    if err > ERR_TOL:
        raise AssertionError(f"{what}: max abs err {err} > {ERR_TOL}")
    return err


def edge_phase(attention, gen):
    """The tile-core kernels against their plain versions, causal and not,
    on every edge shape and on all rows; returns one row per case."""
    import torch

    cases = [(EDGE_BATCH, s, n, g, d) for s in EDGE_SEQS for d in EDGE_DIMS
             for n, g in EDGE_HEADS]
    cases += [(*EDGE_LONG, d) for d in EDGE_DIMS]
    rows = []
    for kname in TILE_KERNELS:
        fn = getattr(attention, kname)
        plain = getattr(attention, kname + "_plain")
        for b, s, n, g, d in cases:
            q, k, v, _ = _inputs(gen, b, s, n, g, d, LAYOUTS[kname])
            # a full row, a length-1, a length-0 and a mid-tile row
            lengths = torch.tensor([s, 1, 0, s - s // 3][:b], device=q.device,
                                   dtype=torch.int32)
            if kname == "flash_attention":       # the dispatcher's repeat
                k = k.repeat_interleave(n // g, dim=1)
                v = v.repeat_interleave(n // g, dim=1)
            for causal in (True, False):
                out = fn(q, k, v, lengths, causal)
                torch.cuda.synchronize()
                ref = plain(q.float(), k.float(), v.float(), lengths, causal)
                err = _check_output(f"edge {kname} B={b} S={s} N={n} G={g} "
                                    f"D={d} causal={causal}", out, ref, lengths)
                rows.append(dict(kernel=kname, B=b, S=s, N=n, G=g, D=d,
                                 causal=causal, max_abs_err=err))
                del out, ref
        worst = max((r for r in rows if r["kernel"] == kname),
                    key=lambda r: r["max_abs_err"])
        say("edge", json.dumps(dict(kernel=kname, cases=2 * len(cases),
                                    worst=worst)))
    torch.cuda.empty_cache()
    return rows


def attention_bound_ms(b, s, n, g, d, lengths, causal):
    """Least time for the attention call: the bytes it must move at the HBM
    rate (q of the rows with a length > 0, K/V up to each row's length, the
    whole output written once, the lengths), vs the tensor-core operations
    these lengths need (QK and PV, 2*D each per valid key) at the bf16 peak."""
    lengths = [min(max(int(length), 0), s) for length in lengths]
    rows_read = sum(length > 0 for length in lengths)
    nbytes = 2 * (rows_read * s * n * d + b * s * n * d
                  + 2 * sum(lengths) * g * d) + 4 * b
    keys = 0
    for length in lengths:
        if causal:   # row p sees min(length, p + 1) keys
            keys += length * (length + 1) // 2 + (s - length) * length
        else:
            keys += s * length
    flops = keys * n * 4 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _inputs(gen, b, s, n, g, d, layout):
    """bf16 unit-normal q, k, v in ``layout`` ("bsnd" or "bnsd") and ragged
    int32 lengths with a full row, a length-1 row and a length-0 row.

    v is clamped to +-V_CLAMP: every output is a convex combination of V
    rows, so it stays below 4, where rounding to bf16 costs at most 0.0078
    and ERR_TOL leaves room for the kernel's own error (at |out| >= 4 the
    rounding alone reaches 0.0156)."""
    import torch

    dev = torch.device("cuda")
    qs, ks = ((b, s, n, d), (b, s, g, d)) if layout == "bsnd" else \
        ((b, n, s, d), (b, g, s, d))
    q = torch.randn(qs, generator=gen, device=dev).bfloat16()
    k = torch.randn(ks, generator=gen, device=dev).bfloat16()
    v = torch.randn(ks, generator=gen, device=dev).clamp(
        -V_CLAMP, V_CLAMP).bfloat16()
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = s
    if b > 2:
        lengths[1], lengths[2] = 1, 0
    return q, k, v, lengths


def kernel_phase(attention, gen):
    """Every kernel at every shape, causal and not: error vs the plain
    version, times.  The causal kernel's error is taken on the valid rows
    (as its first measurements were); the head-major kernels' on all rows."""
    import torch

    rows = []
    for kname, _, _, shapes, layout in KERNELS:
        for label, b, s, n, g, d in shapes:
            q, k, v, lengths = _inputs(gen, b, s, n, g, d, layout)
            if kname == "flash_attention":   # the dispatcher's repeat
                k = k.repeat_interleave(n // g, dim=1)
                v = v.repeat_interleave(n // g, dim=1)
            rows += _kernel_rows(attention, kname, layout, label, g, q, k, v,
                                 lengths, (True, False))
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def _kernel_rows(attention, kname, layout, label, g, q, k, v, lengths,
                 causals):
    """One kernel on one input of ``g`` K/V heads (the flash kernel's K/V
    come repeated to the query heads), for each of ``causals``: its error
    against its plain version, its time as a replayed CUDA graph, the
    wrapper's host time, the plain version's time, its bound and the time
    of one PyTorch library call computing the same function."""
    import torch
    import torch.nn.functional as F

    fn = getattr(attention, kname)
    plain = getattr(attention, kname + "_plain")
    if layout == "bsnd":
        b, s, n, d = q.shape
        kv_heads = k.shape[2]
    else:
        b, n, s, d = q.shape
        kv_heads = k.shape[1]
    # the library call takes head-major tensors
    qh, kh, vh = (q, k, v) if layout == "bnsd" else \
        (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    pos = torch.arange(s, device=q.device)
    valid = None
    if layout == "bsnd":
        valid = (pos[None, :] < lengths[:, None])[:, :, None, None]
    rows = []
    for causal in causals:
        out = fn(q, k, v, lengths, causal)
        torch.cuda.synchronize()
        ref = plain(q.float(), k.float(), v.float(), lengths, causal)
        err = _check_output(f"{kname} {label} causal={causal}", out,
                            ref, lengths, valid)
        del out, ref

        def call():
            return fn(q, k, v, lengths, causal)

        ms = graph_ms(call)
        wrapper_us = host_us(call)
        plain_ms = time_ms(lambda: plain(q, k, v, lengths, causal),
                           iters=3, warmup=1)
        # yardstick only: one PyTorch call computing the same function
        bound = torch.minimum(lengths[:, None].long(), pos[None, :] + 1) \
            if causal else lengths[:, None].long().expand(b, s)
        mask = (pos[None, None, :] < bound[:, :, None])[:, None]
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=kv_heads != n))
        bound_ms, bound_by = attention_bound_ms(
            b, s, n, kv_heads, d, lengths.tolist(), causal)
        row = dict(kernel=kname, shape=label, B=b, S=s, N=n, G=g, D=d,
                   causal=causal, max_abs_err=err, ms=ms,
                   host_us=wrapper_us, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, x_bound=ms / bound_ms)
        rows.append(row)
        say("kernel", json.dumps(row))
    return rows


def _to_float32(tree):
    """Every float leaf to float32; int8 codes stay as they are."""
    return {k: _to_float32(v) if isinstance(v, dict) else
            v.float() if v.is_floating_point() else v
            for k, v in tree.items()}


def _reset_launches(attention):
    for name in KERNEL_NAMES:
        getattr(attention, name).launches = 0


def _launches(attention):
    return {name: getattr(attention, name).launches for name in KERNEL_NAMES}


def _rel_l2(a, ref):
    return float((a - ref).norm() / ref.norm())


def _prompts(seed, tok, n=N_PROMPTS):
    """``n`` random-token prompts whose lengths spread evenly over
    100-440."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.linspace(100, 440, n).astype(int))
    return [rng.integers(3, len(tok), int(m)).tolist() for m in lengths]


def slice_phase(seed, attention):
    """Falcon-7B binary-leg scoring through the port's engine, then the
    forced head-major routes on its longest batch.  Returns the phase's
    results, the scored rows and the weights."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.scoring import yes_no
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        default_tokenizer)

    device = "cuda"
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    dense_cfg = dataclasses.replace(cfg, attention_impl="xla")
    t0 = time.perf_counter()
    weights = convert.random_params(cfg, seed=seed, device=device, dtype="bf16")
    torch.cuda.synchronize()
    say(f"slice: Falcon-7B {cfg.num_layers} layers, width {cfg.hidden_size}, "
        f"bf16 random weights (seed {seed}) in "
        f"{time.perf_counter() - t0:.1f} s")
    tok = default_tokenizer()
    prompts = _prompts(seed, tok)
    ecfg = emod.EngineConfig(decode_completions=False, phase2_pool=False,
                             batch_size=BATCH)
    engine = emod.ScoringEngine("falcon", cfg, weights, tok, engine_config=ecfg,
                                device=device)
    engine.score_prompts(prompts[:BATCH])              # warm-up, not counted
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    _reset_launches(attention)
    t0 = time.perf_counter()
    rows = engine.score_prompts(prompts)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _launches(attention)["causal_grouped_attention"]
    peak = torch.cuda.max_memory_allocated()

    batches = list(batching.batches_for_prompts(
        prompts, BATCH, ecfg.buckets, pad_id=tok.pad_token_id,
        length_sorted=True))
    if launches < cfg.num_layers * len(batches):
        raise AssertionError(f"kernel launched {launches} times; the "
                             f"{len(batches)} prefills need "
                             f"{cfg.num_layers * len(batches)}")
    _check_rows(rows)

    dense = emod.ScoringEngine("falcon", dense_cfg, weights, tok,
                               engine_config=ecfg, device=device)
    dense.score_prompts(prompts[:BATCH])               # warm-up, not counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_rows = dense.score_prompts(prompts)
    torch.cuda.synchronize()
    dense_elapsed = time.perf_counter() - t0
    same_found = sum(a["scan_found"] == b["scan_found"]
                     for a, b in zip(rows, dense_rows)) / N_PROMPTS
    # a row not found reads position 0 (the fallback) on either path
    found_rows = [sum(r["scan_found"] for r in rs) for rs in (rows, dense_rows)]
    max_drel = max(abs(a["relative_prob"] - b["relative_prob"])
                   for a, b in zip(rows, dense_rows))

    # Position-0 logits on the engine's batches: the kernel path and the
    # dense path (both bf16) against a float32 dense reference on the same
    # weights.  Two bf16 paths differ by bf16 noise accumulated over the
    # layers; the gate is that the kernel path is no further from float32
    # than the plain dense path is.
    ref_weights = decoder.DecoderWeights(cfg, _to_float32(weights.tree()))
    sq = {"kernel_vs_dense": 0.0, "kernel_vs_fp32": 0.0, "dense_vs_fp32": 0.0}
    den_bf16 = den_fp32 = 0.0
    same_hit0 = undecided = 0
    yes_id, no_id = engine.target_ids(["Yes", "No"])
    for batch in batches:
        ids = torch.as_tensor(batch.token_ids, device=device).long()
        mask = torch.as_tensor(batch.attention_mask, device=device)
        real = torch.as_tensor(batch.indices >= 0, device=device)
        a = decoder.forward_last_logits(weights, cfg, ids, mask)[real]
        b = decoder.forward_last_logits(weights, dense_cfg, ids, mask)[real]
        r = decoder.forward_last_logits(ref_weights, dense_cfg, ids, mask)[real]
        for t in (a, b, r):
            if t.shape != (int(real.sum()), cfg.vocab_size) or not torch.isfinite(t).all():
                raise AssertionError("bad position-0 logits")
        last_batch_logits = (b, r)      # dense bf16 and float32, longest batch
        sq["kernel_vs_dense"] += float((a - b).square().sum())
        sq["kernel_vs_fp32"] += float((a - r).square().sum())
        sq["dense_vs_fp32"] += float((b - r).square().sum())
        den_bf16 += float(b.square().sum())
        den_fp32 += float(r.square().sum())
        hit_a = yes_no.first_token_scan(a, yes_id, no_id, ecfg.top_k)[4]
        hit_b = yes_no.first_token_scan(b, yes_id, no_id, ecfg.top_k)[4]
        same_hit0 += int((hit_a == hit_b).sum())
        undecided += int((~hit_a).sum())
    forced = forced_route_phase(attention, weights, cfg, ref_weights,
                                batches[-1], *last_batch_logits)
    del ref_weights, last_batch_logits

    # where the time goes, on the longest batch: one prefill through the
    # kernel and through the dense path, and one scored look-ahead chunk
    batch = batches[-1]
    ids = torch.as_tensor(batch.token_ids, device=device).long()
    mask = torch.as_tensor(batch.attention_mask, device=device)
    prefill_ms = time_ms(lambda: decoder.prefill(
        weights, cfg, ids, mask, batch.bucket_len), iters=3, warmup=1)
    dense_prefill_ms = time_ms(lambda: decoder.prefill(
        weights, dense_cfg, ids, mask, batch.bucket_len), iters=3, warmup=1)
    last, cache = decoder.prefill(weights, cfg, ids, mask, batch.bucket_len)
    tgt = torch.tensor([[yes_id, no_id]] * BATCH, device=device)
    chunk = ecfg.scan_chunk
    step_ms = time_ms(lambda: decoder.decode_steps(
        weights, cfg, cache, last, mask.sum(-1), 0, chunk, None, None,
        with_scores="reduced", target_ids=tgt), iters=2, warmup=1) / chunk
    del last, cache
    rel = {k: (v / (den_bf16 if k == "kernel_vs_dense" else den_fp32)) ** 0.5
           for k, v in sq.items()}
    if rel["kernel_vs_fp32"] > KERNEL_VS_DENSE_ERR_RATIO * rel["dense_vs_fp32"]:
        raise AssertionError(f"position-0 logits: kernel path is further from "
                             f"float32 than the dense path: {rel}")
    result = dict(prompts=N_PROMPTS, batches=len(batches),
                  buckets=[b.bucket_len for b in batches],
                  kernel_launches=launches, seconds=elapsed,
                  rows_per_s=N_PROMPTS / elapsed,
                  dense_rows_per_s=N_PROMPTS / dense_elapsed,
                  longest_batch=dict(bucket=batch.bucket_len,
                                     prefill_ms=prefill_ms,
                                     dense_prefill_ms=dense_prefill_ms,
                                     lookahead_step_ms=step_ms),
                  undecided_share=undecided / N_PROMPTS,
                  peak_memory_bytes=peak,
                  logits_rel_l2={k: v for k, v in rel.items()},
                  same_scan_found_share=same_found,
                  scan_found_rows=dict(kernel=found_rows[0], dense=found_rows[1]),
                  same_position0_verdict_share=same_hit0 / N_PROMPTS,
                  max_abs_delta_relative_prob=max_drel)
    say("slice", json.dumps(result))
    engine.close()
    dense.close()
    result["forced_routes"] = forced
    return result, rows, weights


def _check_rows(rows, n=N_PROMPTS):
    import numpy as np

    if len(rows) != n or not all(r["success"] for r in rows):
        raise AssertionError("missing or failed rows")
    for r in rows:
        vals = [r[f] for f in ("yes_prob", "no_prob", "relative_prob",
                               "first_token_relative_prob")]
        if not all(np.isfinite(vals)) or not 0 <= r["relative_prob"] <= 1:
            raise AssertionError(f"bad row {r}")


def forced_route_phase(attention, weights, cfg, ref_weights, batch,
                       dense_logits, ref_logits):
    """The longest batch's position-0 logits with every layer's attention
    forced through ``attention_bsnd(force=...)``: each forced kernel must
    launch exactly once a layer (and no other kernel), and its logits be no
    further from the float32 reference than the dense bf16 path's allow."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    device = "cuda"
    ids = torch.as_tensor(batch.token_ids, device=device).long()
    mask = torch.as_tensor(batch.attention_mask, device=device)
    real = torch.as_tensor(batch.indices >= 0, device=device)
    dense_err = _rel_l2(dense_logits, ref_logits)
    routed = decoder.attention_bsnd
    out = {}
    for force, kname in (("grouped", "grouped_attention"),
                         ("pallas", "flash_attention")):
        decoder.attention_bsnd = functools.partial(attention.attention_bsnd,
                                                   force=force)
        try:
            _reset_launches(attention)
            logits = decoder.forward_last_logits(weights, cfg, ids, mask)[real]
            torch.cuda.synchronize()
            launches = _launches(attention)
            if launches != {**dict.fromkeys(KERNEL_NAMES, 0),
                            kname: cfg.num_layers}:
                raise AssertionError(f"force={force}: launches {launches}; "
                                     f"want {cfg.num_layers} of {kname} only")
            if logits.shape != ref_logits.shape or not torch.isfinite(logits).all():
                raise AssertionError(f"force={force}: bad position-0 logits")
            err = _rel_l2(logits, ref_logits)
            if err > KERNEL_VS_DENSE_ERR_RATIO * dense_err:
                raise AssertionError(
                    f"force={force}: position-0 logits {err} from float32, "
                    f"dense bf16 {dense_err}")
            prefill_ms = time_ms(lambda: decoder.prefill(
                weights, cfg, ids, mask, batch.bucket_len), iters=3, warmup=1)
        finally:
            decoder.attention_bsnd = routed
        out[force] = dict(kernel=kname, launches=launches[kname],
                          logits_rel_l2_vs_fp32=err, prefill_ms=prefill_ms)
    out["dense_logits_rel_l2_vs_fp32"] = dense_err
    out["bucket"] = batch.bucket_len
    say("forced_routes", json.dumps(out))
    return out


def _id_tokenizer(vocab_size, decode_map=None):
    """A tokenizer in which the word ``t<i>`` is token ``i``, for every id of
    the vocabulary: any token can then be named as a scoring target (the
    engine takes the first id of ``" " + target``).  Token ``i`` decodes to
    ``" t<i>"``, or to ``decode_map[i]`` where given (the full-study phase
    makes chosen tokens read as numbers)."""
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        Encoding)

    texts = dict(decode_map or {})

    class IdTokenizer:
        pad_token_id, eos_token_id = 0, 1

        def __len__(self):
            return vocab_size

        def encode(self, text, add_special_tokens=True):
            return [int(w[1:]) for w in text.split()]

        def __call__(self, text, add_special_tokens=True):
            if isinstance(text, str):
                return Encoding(input_ids=self.encode(text))
            return Encoding(input_ids=[self.encode(t) for t in text])

        def decode(self, ids, skip_special_tokens=False):
            return "".join(texts.get(int(i), f" t{int(i)}") for i in ids)

    return IdTokenizer()


def _pool_targets(seed, weights, cfg, batches, n, roles=POOL_ROLES,
                  last_roles=OVERFLOW_ROLES, outside=5, by_lead=False):
    """Per-prompt (yes, no) targets from the prefill logits and one greedy
    look-ahead step of each batch: in every batch ``roles`` rows are
    decided at position 0 (yes = the top token there), resolve at step 1
    (yes = step 1's top token, outside position 0's top ``outside``) or
    never resolve (both targets among position 0's lowest logits); the
    longest batch takes ``last_roles``.  The step-1 rows are drawn at
    random, or (``by_lead``) are those whose greedy step-0 token leads the
    next by the most, so that rounding does not change their step 1."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    rng = np.random.default_rng(seed)
    pairs = [None] * n
    for bi, b in enumerate(batches):
        ids = torch.as_tensor(b.token_ids, device="cuda").long()
        mask = torch.as_tensor(b.attention_mask, device="cuda")
        last, cache = decoder.prefill(weights, cfg, ids, mask, b.bucket_len)
        _, sc, _, _, _ = decoder.decode_steps(
            weights, cfg, cache, last, mask.sum(-1), 0, 2, None, None,
            with_scores=True)
        top0, wide0 = (t.cpu().numpy() for t in torch.topk(
            sc[:, 0], max(5, outside)).indices.split([5, max(0, outside - 5)],
                                                       dim=-1))
        vals0 = torch.topk(sc[:, 0], 2).values
        gap0 = (vals0[:, 0] - vals0[:, 1]).cpu().numpy()
        low0 = torch.topk(sc[:, 0], 2, largest=False).indices.cpu().numpy()
        top1 = sc[:, 1].argmax(-1).cpu().numpy()
        del last, cache, sc
        _, n_step1, n_never = (last_roles if bi == len(batches) - 1
                               else roles)
        real = np.flatnonzero(b.indices >= 0)
        eligible = [r for r in real if top1[r] not in top0[r]
                    and top1[r] not in wide0[r] and top1[r] not in low0[r]]
        if len(eligible) < n_step1:
            raise AssertionError(f"batch {bi}: {len(eligible)} rows can "
                                 f"resolve at step 1, {n_step1} needed")
        if by_lead:
            step1 = set(sorted(eligible, key=lambda r: -gap0[r])[:n_step1])
        else:
            step1 = set(rng.choice(eligible, n_step1,
                                   replace=False).tolist())
        never = set(rng.permutation([r for r in real if r not in step1])
                    [:n_never].tolist())
        for r in real:
            if r in step1:
                yes, no = top1[r], low0[r][0]
            elif r in never:
                yes, no = low0[r]
            else:
                yes, no = top0[r][:2]
            pairs[int(b.indices[r])] = (f"t{yes}", f"t{no}")
    return pairs


def _check_pooled_rows(what, rows, ref):
    """Verdicts and position-0 fields identical to ``ref``, relative_prob
    within POOL_RELPROB_TOL; returns the largest relative_prob gap."""
    _check_rows(rows, len(ref))
    worst = 0.0
    for i, (a, b) in enumerate(zip(rows, ref)):
        if a["scan_found"] != b["scan_found"]:
            raise AssertionError(f"{what}: row {i} scan_found "
                                 f"{a['scan_found']} vs {b['scan_found']}")
        for f in ("first_token_yes_prob", "first_token_no_prob",
                  "first_token_relative_prob"):
            if a[f] != b[f]:
                raise AssertionError(f"{what}: row {i} {f} {a[f]} vs {b[f]}")
        worst = max(worst, abs(a["relative_prob"] - b["relative_prob"]))
    if worst > POOL_RELPROB_TOL:
        raise AssertionError(f"{what}: relative_prob {worst} apart")
    return worst


def _merge_slab_rows(results, slabs, decoded):
    """Rows decoded from slabs (flat feed order) back onto prompt indices."""
    merged = list(results)
    i = 0
    for slab in slabs:
        for m in slab.metas:
            merged[m["orig"]] = decoded[i]
            i += 1
    return merged


def pooled_phase(seed, attention, weights):
    """The engine's default binary schedule on Falcon-7B: the per-batch
    route, the pooled whole-flush and ring routes, the serve-side ring
    entries and one real OOM, on prompts with a realistic decided share."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    device = "cuda"
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    tok = _id_tokenizer(cfg.vocab_size)
    prompts = _prompts(seed, tok, POOL_PROMPTS)
    base = emod.EngineConfig(decode_completions=False, batch_size=BATCH,
                             phase2_pool_target=POOL_TARGET)
    batches = list(batching.batches_for_prompts(
        prompts, BATCH, base.buckets, pad_id=tok.pad_token_id,
        length_sorted=True))
    t0 = time.perf_counter()
    targets = _pool_targets(seed, weights, cfg, batches, POOL_PROMPTS)
    decided = POOL_PROMPTS - (len(batches) - 1) * sum(POOL_ROLES[1:]) \
        - sum(OVERFLOW_ROLES[1:])
    say(f"pooled: {POOL_PROMPTS} prompts, {len(batches)} batches, buckets "
        f"{[b.bucket_len for b in batches]}, targets in "
        f"{time.perf_counter() - t0:.1f} s, decided share "
        f"{decided / POOL_PROMPTS:.4f}")

    prefills = [0]
    real_prefill = decoder.prefill

    def counted_prefill(*args, **kwargs):
        prefills[0] += 1
        return real_prefill(*args, **kwargs)

    def timed(name, call, n_batches, pooled):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _reset_launches(attention)
        prefills[0] = 0
        t0 = time.perf_counter()
        rows = call()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = _launches(attention)["causal_grouped_attention"]
        overflow = prefills[0] - n_batches
        res = dict(run=name, rows_per_s=len(rows) / elapsed, seconds=elapsed,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   memory_before_bytes=before, kernel_launches=launches,
                   prefills=prefills[0], overflow_batches=overflow)
        if launches < cfg.num_layers * prefills[0] or \
                prefills[0] < n_batches or overflow != int(pooled):
            raise AssertionError(f"pooled {name}: {launches} launches, "
                                 f"{prefills[0]} prefills of {n_batches} "
                                 f"batches")
        return rows, res

    runs, rows = [], {}
    decoder.prefill = counted_prefill
    try:
        # runs 1-4: score_prompts on four schedules
        for name, ecfg, pooled in (
                ("per_batch", dataclasses.replace(base, phase2_pool=False),
                 False),
                ("whole_flush", dataclasses.replace(base, slot_repack=False),
                 True),
                ("ring", base, True),
                ("ring_depth1", dataclasses.replace(base, pipeline_depth=1),
                 True)):
            engine = emod.ScoringEngine("falcon", cfg, weights, tok,
                                        engine_config=ecfg, device=device)
            engine.score_prompts(prompts[:BATCH], targets[:BATCH])  # warm-up
            engine.occupancy_report()
            rows[name], res = timed(
                name, lambda: engine.score_prompts(prompts, targets),
                len(batches), pooled)
            res["occupancy"] = engine.occupancy_report()
            if name != "per_batch":
                res["max_abs_delta_relative_prob_vs_per_batch"] = \
                    _check_pooled_rows(name, rows[name], rows["per_batch"])
            runs.append(res)
            say("pooled", json.dumps(res))
            engine.close()
        if not runs[2]["occupancy"]["refills"] > 0:
            raise AssertionError(f"the ring never refilled a lane: "
                                 f"{runs[2]['occupancy']}")

        # runs 5-6: the serve-side entries, the second half admitted
        # mid-decode in both
        engine = emod.ScoringEngine("falcon", cfg, weights, tok,
                                    engine_config=base, device=device)
        engine.score_prompts_slotted(prompts[:BATCH], targets[:BATCH])
        engine.occupancy_report()
        half = POOL_PROMPTS // 2
        first, second = (prompts[:half], targets[:half]), \
            (prompts[half:], targets[half:])
        admit = [second]
        rows["slotted"], res = timed(
            "slotted", lambda: engine.score_prompts_slotted(
                *first, admit_fn=lambda: admit.pop() if admit else None),
            len(batches), False)
        res["occupancy"] = engine.occupancy_report()
        runs.append(res)
        say("pooled", json.dumps(res))

        def handoff():
            r1, s1 = engine.export_kv_slab(*first)
            r2, s2 = engine.export_kv_slab(*second)
            later = [s2]
            decoded = engine.decode_kv_slabs(
                s1, admit_fn=lambda: later.pop() if later else None)
            n1 = sum(s.rows() for s in s1)
            return (_merge_slab_rows(r1, s1, decoded[:n1])
                    + _merge_slab_rows(r2, s2, decoded[n1:]))

        rows["kv_slabs"], res = timed("kv_slabs", handoff, len(batches),
                                      False)
        res["occupancy"] = engine.occupancy_report()
        res["identical_to_slotted"] = rows["kv_slabs"] == rows["slotted"]
        runs.append(res)
        say("pooled", json.dumps(res))
        if not res["identical_to_slotted"]:
            raise AssertionError("KV-slab rows differ from the slotted rows")
        engine.close()
    finally:
        decoder.prefill = real_prefill
    oom = oom_run(cfg, weights, tok, prompts, targets, base, rows["ring"],
                  runs[2])
    return dict(prompts=POOL_PROMPTS, batches=len(batches),
                buckets=[b.bucket_len for b in batches],
                decided_share=decided / POOL_PROMPTS,
                pool_target=POOL_TARGET, runs=runs, oom=oom)


def oom_run(cfg, weights, tok, prompts, targets, base, ring_rows, ring_res):
    """One real device OOM: the 128 longest prompts at batch 64 under a
    per-process memory cap of the weights plus OOM_CAP_FACTOR times the
    batch-32 ring run's own need.  Each batch of 64 must step down to 32
    (``oom_batch_ladder=(32,)``) and give the ring run's rows."""
    import torch

    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
    idx = sorted(order[-OOM_LONGEST:])
    need32 = ring_res["peak_memory_bytes"] - ring_res["memory_before_bytes"]
    torch.cuda.empty_cache()
    cap = torch.cuda.memory_reserved() + OOM_CAP_FACTOR * need32
    total = torch.cuda.get_device_properties(0).total_memory
    engine = emod.ScoringEngine(
        "falcon", cfg, weights, tok, device="cuda",
        engine_config=dataclasses.replace(base, batch_size=OOM_BATCH,
                                          oom_batch_ladder=(BATCH,)))
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        t0 = time.perf_counter()
        rows = engine.score_prompts([prompts[i] for i in idx],
                                    [targets[i] for i in idx])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    events = [{k: e[k] for k in ("batch", "new_batch", "bucket_len", "rows")}
              for e in engine.fault_events]
    engine.close()
    res = dict(prompts=len(idx), batch=OOM_BATCH, cap_bytes=int(cap),
               batch32_need_bytes=int(need32), fault_events=events,
               seconds=elapsed)
    say("pooled oom", json.dumps(res))
    if not events or any((e["batch"], e["new_batch"]) != (OOM_BATCH, BATCH)
                         for e in events) \
            or sum(e["rows"] for e in events) != len(idx):
        raise AssertionError(f"OOM run: every batch of {OOM_BATCH} must step "
                             f"to {BATCH}: {events}")
    res["max_abs_delta_relative_prob_vs_ring"] = _check_pooled_rows(
        "oom", rows, [ring_rows[i] for i in idx])
    return res


def _study_inputs(seed, vocab_size):
    """The full-study rows: ``STUDY_PROMPTS`` prefixes of 100-440 tokens
    (``_prompts``) and, for row i, scenario i % 5's binary and confidence
    suffixes, random ids of ``SCENARIO_SUFFIX_WORDS``'s lengths.  Returns
    (prefixes, [(binary suffix, confidence suffix)] a row)."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    scenarios = [(rng.integers(3, vocab_size, nb).tolist(),
                  rng.integers(3, vocab_size, nc).tolist())
                 for nb, nc in SCENARIO_SUFFIX_WORDS]
    prefixes = _prompts(seed, _id_tokenizer(vocab_size), STUDY_PROMPTS)
    return prefixes, [scenarios[i % len(scenarios)]
                      for i in range(STUDY_PROMPTS)]


def _retire_steps(tok, tokens, steps=CONF_CAP, completion_chars=100):
    """Each row's retirement step under the pooled confidence leg's own rule
    (``engine._Phase2Pool._conf_retired_at``) over its greedy tokens
    ``[N, steps]``, checked from step 3: the first k whose k-token window
    freezes the row, or -1."""
    import types

    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    pool = types.SimpleNamespace(
        eos_id=tok.eos_token_id, engine=types.SimpleNamespace(
            tokenizer=tok, ecfg=types.SimpleNamespace(
                completion_chars=completion_chars)))
    return [next((k for k in range(min(3, steps), steps + 1)
                  if emod._Phase2Pool._conf_retired_at(pool, row, k)), -1)
            for row in tokens]


def _retirement_plan(tokens, top_ids, batches, vocab_size, logits3,
                     margin, per_batch=RETIRE_PER_BATCH,
                     digit_ranks=range(1, 19)):
    """Rows of the confidence leg to retire, and the decode map that makes
    them retire, from a greedy pre-pass: ``tokens`` ``[N, steps]`` greedy
    ids, ``top_ids`` ``[N, steps, k]`` each step's candidate ids by rank,
    ``batches`` the rows of each batch.  Returns (decode map, {row: step}),
    the plan holding every row the map retires.

    A mapped token reads ``" <d>."`` (a number, then a non-word character):
    a window that holds it holds a terminated integer, so a row retires at
    the step of its first mapped token, or at step 3 (the first checked)
    when that comes earlier.  Tokens are tried in order of the earliest
    index they take in any window, and one is mapped unless a batch would
    pass ``per_batch`` retiring rows.  Two of each row's position-0
    candidates (at ``digit_ranks``) that no window holds read ``" 4"`` and
    ``" 8"``, so ``weighted_confidence_digits`` sees digits; from the first
    three positions' logits ``logits3`` ``[N, 3, V]``, only ids at least
    ``margin`` from the top-19 edge at each of those positions of their
    row, and ``margin`` below it everywhere else, so rounding moves no
    digit into or out of a candidate list."""
    import collections

    import numpy as np

    tokens = np.asarray(tokens)
    n, steps = tokens.shape
    batch_of = {int(r): bi for bi, rows in enumerate(batches) for r in rows}
    holders = collections.defaultdict(set)
    earliest = {}
    for r in range(n):
        for j, t in enumerate(tokens[r].tolist()):
            holders[t].add(r)
            if t not in (0, 1):
                earliest[t] = min(earliest.get(t, steps), j)
    decode_map = {}
    plan = {r: k for r, k in enumerate(_retire_steps(
        _id_tokenizer(vocab_size), tokens)) if k >= 0}
    per = collections.Counter(batch_of[r] for r in plan)
    for t in sorted(earliest, key=lambda t: (earliest[t], t)):
        trial = {**decode_map, t: f" {1 + t % 9}."}
        rows = sorted(holders[t])
        new = dict(zip(rows, _retire_steps(_id_tokenizer(vocab_size, trial),
                                           tokens[rows])))
        added = collections.Counter(batch_of[r] for r in new if r not in plan)
        if not added or any(per[b] + c > per_batch for b, c in added.items()):
            continue
        decode_map = trial
        plan.update(new)
        per.update(added)
    k = top_ids.shape[2]
    edge = -np.partition(-logits3, k - 1, axis=-1)[..., k - 1]      # [N, 3]

    def clear(r, c):
        off = logits3[:, :, c] - edge                                # [N, 3]
        others = np.delete(off, r, axis=0)
        return bool((np.abs(off[r]) >= margin).all()
                    and (others <= -margin).all())

    for r in range(n):
        free = [int(c) for c in top_ids[r, 0, list(digit_ranks)]
                if int(c) not in holders and int(c) not in decode_map
                and clear(r, int(c))]
        for c, text in zip(free, (" 4", " 8")):
            decode_map[c] = text
    return decode_map, plan


def _observed_retirements(tok, decode_map, rows, steps=CONF_CAP):
    """Each confidence row's retirement step, read off its own completion
    (the rule of ``_retire_steps`` over the tokens its words name; a row
    whose words end early without retiring met an EOS, on which it
    retires), or -1; and whether it met an EOS."""
    import numpy as np

    ids = {text.strip(): t for t, text in decode_map.items()}
    out, eos = [], []
    for row in rows:
        words = row["completion"].split()
        toks = [int(w[1:]) if w[:1] == "t" and w[1:].isdigit() else ids[w]
                for w in words]
        r = (_retire_steps(tok, np.asarray([toks]), steps=len(toks))[0]
             if toks else -1)
        eos.append(r < 0 and len(toks) < steps)
        out.append(max(3, len(toks) + 1) if eos[-1] else r)
    return out, eos


def _ring_steps_saved(r_stars, steps=CONF_CAP, chunk=5):
    """``conf_steps_saved`` of rows on the slot ring: a row decodes whole
    chunks from its admission, so one retiring at step r* leaves at the
    end of the chunk holding r*."""
    return sum(steps - min(steps, -(-r // chunk) * chunk)
               for r in r_stars if r >= 0)


def _flush_checkpoints(steps=CONF_CAP, chunk=5):
    """The decoded counts after which a whole flush reads retirements:
    after every chunk (3 positions, then ``chunk``) but the last."""
    out, offset = [], 3
    while offset < steps:
        out.append(offset)
        offset += chunk
    return out


def _flush_retirements(r_stars, steps=CONF_CAP, chunk=5):
    """(retired rows, ``conf_steps_saved``) of one whole flush of these
    rows, as ``engine._Phase2Pool._flush_confidence`` schedules it: chunks
    of 3 then ``chunk`` positions, retirements read after every chunk but
    the last; the rows retired so far leave the decode only when the
    menu-padded count of live rows shrinks it."""
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    n = len(r_stars)
    m = emod._pad_slice(n, max(n, emod._SLICE_MENU[-1]))
    in_cache, decoded, offset, last_check = list(range(n)), [0] * n, 0, 0
    while offset < steps:
        step = 3 if offset == 0 else min(chunk, steps - offset)
        for r in in_cache:
            decoded[r] = offset + step
        offset += step
        if offset >= steps:
            break
        last_check = offset
        alive = [r for r in in_cache if not 0 <= r_stars[r] <= offset]
        if not alive:
            break
        m2 = emod._pad_slice(len(alive), m)
        if m2 < m:
            in_cache, m = alive, m2
    return (sum(0 <= r <= last_check for r in r_stars),
            sum(steps - d for d in decoded))


def _study_prepass(weights, cfg, batches, n, total, chunk, eos_id,
                   target_ids, keep=0):
    """Greedy tokens ``[n, total]``, each step's candidate ids by rank, its
    top-1 logit and that logit's lead over the next, decoded as the per-batch
    route decodes a leg: one prefill of each batch, then chunks of
    ``chunk`` steps from the cache (the same calls on the same shapes, so
    the same tokens).  Also each row's distance of its two target logits
    ``target_ids`` ``[n, 2]`` from the TOP_FILTER-th largest at position 0
    (the nearer of the two), and, for ``keep`` > 0, the full logits of the
    first ``keep`` positions ``[n, keep, V]``."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    tokens = np.zeros((n, total), np.int64)
    top_ids = np.zeros((n, total, decoder.REDUCED_TOPK), np.int64)
    top1 = np.zeros((n, total), np.float32)
    gaps = np.zeros((n, total), np.float32)
    edge0 = np.zeros((n,), np.float32)
    kept = np.zeros((n, keep, cfg.vocab_size), np.float32) if keep else None
    dev = _device_of(weights)
    for b in batches:
        ids = torch.as_tensor(b.token_ids, device=dev).long()
        mask = torch.as_tensor(b.attention_mask, device=dev)
        lengths = mask.sum(-1)
        prev, cache = decoder.prefill(weights, cfg, ids, mask, b.bucket_len)
        real = b.indices >= 0
        rows, done = b.indices[real], None
        tgt = torch.as_tensor(np.asarray(target_ids)[
            np.where(real, b.indices, b.indices[0])], device=dev)
        kth = torch.topk(prev, TOP_FILTER).values[:, -1:]
        edge0[rows] = (prev.gather(1, tgt) - kth).abs().min(1).values \
            .cpu().numpy()[real]
        for offset in range(0, total, chunk):
            k = min(chunk, total - offset)
            full = offset < keep
            toks, sc, cache, prev, done = decoder.decode_steps(
                weights, cfg, cache, prev, lengths, offset, k, eos_id, done,
                with_scores=True if full else "reduced", target_ids=tgt)
            if full:
                kept[rows, :keep - offset] = \
                    sc[:, :keep - offset].cpu().numpy()[real]
                sc = decoder.ReducedScores(
                    *torch.topk(sc, decoder.REDUCED_TOPK), None, None)
            vals = sc.topk_vals.cpu().numpy()[real]
            tokens[rows, offset:offset + k] = toks.cpu().numpy()[real]
            top_ids[rows, offset:offset + k] = sc.topk_ids.cpu().numpy()[real]
            top1[rows, offset:offset + k] = vals[..., 0]
            gaps[rows, offset:offset + k] = vals[..., 0] - vals[..., 1]
        del prev, cache, sc
    return tokens, top_ids, top1, gaps, edge0, kept


def _completion_of(tok, toks, completion_chars=100):
    """The completion text the engine records for these greedy tokens
    (``ScoringEngine._completion_text``)."""
    import types

    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    stub = types.SimpleNamespace(tokenizer=tok, ecfg=types.SimpleNamespace(
        completion_chars=completion_chars))
    return emod.ScoringEngine._completion_text(stub, toks, tok.eos_token_id)


def _device_of(weights):
    """The device the weights lie on."""
    return next(iter(weights.buffers())).device


def _padded(seqs, device):
    """Right-padded ``ids`` (int64) and ``mask`` (int32) ``[len(seqs),
    longest]`` of token-id lists, on ``device``."""
    import torch

    width = max(map(len, seqs))
    ids = torch.zeros((len(seqs), width), dtype=torch.long)
    mask = torch.zeros((len(seqs), width), dtype=torch.int32)
    for i, seq in enumerate(seqs):
        ids[i, :len(seq)] = torch.as_tensor(seq, dtype=torch.long)
        mask[i, :len(seq)] = 1
    return ids.to(device), mask.to(device)


def _filtered_target_probs(logits, tgt):
    """Position-0 probabilities ``[B, 2]`` of each row's two target ids
    ``tgt`` ``[B, 2]`` under the top-TOP_FILTER filter, as the workbook's
    Token_1_Prob / Token_2_Prob read them."""
    import torch

    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    yes, no, _ = yes_no.relative_prob_first_token(
        logits, tgt[:, 0], tgt[:, 1], top_filter=TOP_FILTER)
    return torch.stack([yes, no], 1)


def _teacher_top1(weights, cfg, prompts, continuations, batch=BATCH,
                  target_ids=None):
    """Top-1 logit and its lead over the second at every step of each row's
    continuation ``[N, L + 1]`` (step L follows the last given token), from
    one forward over prompt + continuation: a second bf16 computation of
    the logits the decode saw.  With ``target_ids`` ``[N, 2]``, also each
    row's distance of its nearer target logit from the TOP_FILTER-th
    largest at step 0 ``[N]`` and its two filtered target probabilities
    there ``[N, 2]`` (else NaN)."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    tree, dev = decoder._tree(weights), _device_of(weights)
    n, steps = len(prompts), max(map(len, continuations)) + 1
    top1 = np.full((n, steps), np.nan, np.float32)
    leads = np.full((n, steps), np.nan, np.float32)
    edge0 = np.full((n,), np.nan, np.float32)
    probs0 = np.full((n, 2), np.nan, np.float32)
    for lo in range(0, n, batch):
        seqs = [list(p) + list(c) for p, c in
                zip(prompts[lo:lo + batch], continuations[lo:lo + batch])]
        ids, mask = _padded(seqs, dev)
        starts = torch.as_tensor([len(p) - 1 for p in prompts[lo:lo + batch]])
        pos = (starts[:, None] + torch.arange(steps)).clamp(
            max=ids.shape[1] - 1).to(dev)
        x, _ = decoder._trunk(tree, cfg, ids, mask)
        h = x[torch.arange(len(seqs), device=dev)[:, None], pos]
        logits = decoder._unembed(cfg, tree, h)
        top2 = torch.topk(logits, 2, dim=-1).values.cpu().numpy()
        if target_ids is not None:
            tgt = torch.as_tensor(np.asarray(target_ids[lo:lo + batch]),
                                  device=dev)
            kth = torch.topk(logits[:, 0], TOP_FILTER).values[:, -1:]
            edge0[lo:lo + len(seqs)] = (logits[:, 0].gather(1, tgt) - kth) \
                .abs().min(1).values.cpu().numpy()
            probs0[lo:lo + len(seqs)] = _filtered_target_probs(
                logits[:, 0], tgt).cpu().numpy()
        for i in range(len(seqs)):
            k = len(continuations[lo + i]) + 1
            top1[lo + i, :k] = top2[i, :k, 0]
            leads[lo + i, :k] = top2[i, :k, 0] - top2[i, :k, 1]
        del x, h, logits
    return top1, leads, edge0, probs0


def _compare_rows(what, rows, ref, ref_gaps, ref_edge0, near_tie,
                  exact_pos0, wc_tol, cut=()):
    """Hold study rows against ``ref`` of another run.

    The position-0 fields come from the prefill: identical
    (``exact_pos0``) or within FUSED_PROB_TOL, unless a target logit lies
    within ``near_tie`` of the top-filter's edge (``ref_edge0`` ``[N]``).  Where the two completions
    part (at the first differing word; a row in ``cut`` may stop early, a
    prefix of the reference's), the reference's step there must lead by
    less than ``near_tie`` (``ref_gaps`` ``[N, steps]``): a near-tie
    rounding may turn.  Rows that never part must agree in first-integer
    parse and, unless cut (their scan reads only the positions before their
    retirement), in verdict and relative_prob within FUSED_PROB_TOL;
    weighted_confidence (read at positions 0-2) is held to ``wc_tol`` on
    every row that agrees through its first two tokens.  Returns (stats,
    failures)."""
    from llm_interpretation_replication_tpu_torch.scoring.confidence import (
        extract_first_int)

    _check_rows(rows, len(ref))
    fails, parted, cut_rows = [], [], 0
    worst = dict(relative_prob=0.0, position0=0.0, weighted_confidence=0.0)
    for i, (a, b) in enumerate(zip(rows, ref)):
        for f in ("first_token_yes_prob", "first_token_no_prob",
                  "first_token_relative_prob"):
            d = abs(a[f] - b[f])
            worst["position0"] = max(worst["position0"], d)
            if ((exact_pos0 and d) or d > FUSED_PROB_TOL) \
                    and not ref_edge0[i] < near_tie:
                fails.append(f"row {i} {f} {a[f]} vs {b[f]}")
        wa, wb = a["completion"].split(), b["completion"].split()
        n = min(len(wa), len(wb))
        part = next((j for j in range(n) if wa[j] != wb[j]), None)
        if part is None and len(wa) != len(wb) and not (
                i in cut and len(wa) < len(wb)):
            part = n
        if part is not None:
            gap = float(ref_gaps[i, part]) if part < ref_gaps.shape[1] \
                else float("inf")
            parted.append(gap)
            if not gap < near_tie:
                fails.append(f"row {i} parts at step {part} (lead {gap}): "
                             f"{a['completion']!r} vs {b['completion']!r}")
        else:
            if extract_first_int(a["completion"]) != \
                    extract_first_int(b["completion"]):
                fails.append(f"row {i} first integer")
            if len(wa) < len(wb):
                cut_rows += 1
            else:
                if a["scan_found"] != b["scan_found"]:
                    fails.append(f"row {i} scan_found")
                d = abs(a["relative_prob"] - b["relative_prob"])
                worst["relative_prob"] = max(worst["relative_prob"], d)
                if d > FUSED_PROB_TOL:
                    fails.append(f"row {i} relative_prob {d}")
        if "weighted_confidence" in b and (part is None or part >= 2):
            wca, wcb = a["weighted_confidence"], b["weighted_confidence"]
            if (wca is None) != (wcb is None):
                fails.append(f"row {i} weighted_confidence {wca} vs {wcb}")
            elif wca is not None:
                worst["weighted_confidence"] = max(
                    worst["weighted_confidence"], abs(wca - wcb))
                if abs(wca - wcb) > wc_tol:
                    fails.append(f"row {i} weighted_confidence {wca} "
                                 f"vs {wcb}")
    worst.update(parted_rows=len(parted), cut_rows=cut_rows,
                 widest_lead_where_parted=max(parted, default=None))
    return worst, [f"{what}: {f}" for f in fails]


def _quantiles(a):
    import numpy as np

    a = np.asarray(a, np.float64).ravel()
    a = a[np.isfinite(a)]
    return [float(q) for q in np.quantile(a, (0, 0.01, 0.1, 0.5, 0.9, 1))] \
        if a.size else []


def full_study_phase(seed, attention, weights):
    """The full-study row on Falcon-7B: the binary leg with its 50-token
    completion and the confidence leg, unfused through ``score_prompts``
    (the confidence leg on the ring, on whole flushes and per batch) and
    fused through ``score_prefixed`` over one prefix cache, on prompts
    whose decode map makes planned confidence rows retire mid-decode."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    device = "cuda"
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    base = emod.EngineConfig()
    prefixes, suffixes = _study_inputs(seed, cfg.vocab_size)
    binary = [p + s[0] for p, s in zip(prefixes, suffixes)]
    conf = [p + s[1] for p, s in zip(prefixes, suffixes)]
    pairs = [(p, s) for p, s in zip(prefixes, suffixes)]

    def batches(prompts):
        return list(batching.batches_for_prompts(
            prompts, base.batch_size, base.buckets, pad_id=0,
            length_sorted=True))

    t0 = time.perf_counter()
    conf_batches, bin_batches = batches(conf), batches(binary)
    targets = _pool_targets(seed, weights, cfg, bin_batches,
                            STUDY_PROMPTS, roles=STUDY_ROLES,
                            last_roles=STUDY_ROLES, outside=STUDY_OUTSIDE,
                            by_lead=True)
    # the per-batch runs' own decodes: the confidence leg (one chunk of
    # CONF_CAP) and the binary leg (max_new_tokens in scan_steps chunks)
    target_ids = np.asarray([[int(t[1:]) for t in pair] for pair in targets])
    tokens, top_ids, top1, gaps, edge0, logits3 = _study_prepass(
        weights, cfg, conf_batches, STUDY_PROMPTS, CONF_CAP, CONF_CAP, 1,
        target_ids, keep=3)
    steps, gen_total = base.max_look_ahead, base.max_new_tokens
    bin_tokens, _, _, bin_gaps, bin_edge0, _ = _study_prepass(
        weights, cfg, bin_batches, STUDY_PROMPTS, gen_total, steps, 1,
        target_ids)
    # the rounding between two bf16 computations of the same logits: the
    # pre-pass's decode and one forward over the prompt and its tokens
    tf_top1 = _teacher_top1(weights, cfg, conf, tokens.tolist())[0][:, :-1]
    noise = np.abs(tf_top1 - top1)
    near_tie = NEAR_TIE_FACTOR * float(noise.max())
    groups = [b.indices[b.indices >= 0] for b in conf_batches]
    decode_map, plan = _retirement_plan(tokens, top_ids, groups,
                                        cfg.vocab_size, logits3, near_tie)
    del logits3
    tok = _id_tokenizer(cfg.vocab_size, decode_map)
    r_stars = _retire_steps(tok, tokens)
    planned = {r: k for r, k in enumerate(r_stars) if k >= 0}

    def schedule(obs):
        """(retired rows, steps saved) on the ring and on whole flushes
        (one a batch) for these retirement steps."""
        flushes = [_flush_retirements([obs[int(i)] for i in g])
                   for g in groups]
        return dict(ring=(sum(r >= 0 for r in obs), _ring_steps_saved(obs)),
                    flush=tuple(map(sum, zip(*flushes))))

    expect = schedule(r_stars)
    os.makedirs("chiprun_out", exist_ok=True)
    np.savez_compressed(
        os.path.join("chiprun_out", "full_study_prepass.npz"),
        tokens=tokens, top_ids=top_ids, top1=top1, gaps=gaps,
        teacher_top1=tf_top1, edge0=edge0, target_ids=target_ids,
        batches=np.asarray([b.indices for b in conf_batches]))
    say("full_study: " + json.dumps(dict(
        prompts=STUDY_PROMPTS, prefix_buckets=[b.bucket_len for b in
                                               batches(prefixes)],
        planned_retirements={str(k): sum(v == k for v in plan.values())
                             for k in sorted(set(plan.values()))},
        natural_retirements=len(planned) - len(plan), expected=expect,
        lead_quantiles=_quantiles(gaps),
        top1_logit_quantiles=_quantiles(top1),
        top1_two_computations_abs_diff_quantiles=_quantiles(noise),
        near_tie=near_tie,
        planned_rows_leading_by_near_tie=sum(
            float(gaps[r, :k].min()) >= near_tie for r, k in plan.items()),
        prepass_s=time.perf_counter() - t0)))
    fails = []
    if planned != plan or not plan:
        fails.append(f"the decode map retires {planned}, planned {plan}")

    counted = {"prefill": 0, "extend_prefill": 0}
    real = {name: getattr(decoder, name) for name in counted}

    def counting(name):
        def call(*args, **kwargs):
            counted[name] += 1
            return real[name](*args, **kwargs)
        return call

    runs, rows = {}, {}

    def timed(name, call, ecfg):
        engine = emod.ScoringEngine("falcon", cfg, weights, tok,
                                    engine_config=ecfg, device=device)
        call(engine, slice(0, base.batch_size))             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        telemetry.clear_counters()
        _reset_launches(attention)
        for k in counted:
            counted[k] = 0
        t0 = time.perf_counter()
        out = call(engine, slice(None))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        c = telemetry.counters()
        launches = _launches(attention)["causal_grouped_attention"]
        res = dict(run=name, rows_per_s=STUDY_PROMPTS / elapsed,
                   seconds=elapsed,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   kernel_launches=launches, prefills=counted["prefill"],
                   extend_prefills=counted["extend_prefill"],
                   **{k: c.get(k, 0) for k in (
                       "decode_steps_saved", "conf_steps_saved",
                       "pooled_conf_retired_rows", "pooled_conf_rows",
                       "completion_cache_bytes_freed", "prefix_hit",
                       "prefix_miss")})
        engine.close()
        runs[name], rows[name] = res, out
        say("full_study", json.dumps(res))

    conf_kw = dict(with_confidence=True, max_new_tokens=CONF_CAP)
    legs = [emod.LegSpec("binary"), emod.LegSpec("confidence", **conf_kw)]
    for name in counted:
        setattr(decoder, name, counting(name))
    try:
        timed("binary", lambda e, sl: e.score_prompts(binary[sl],
                                                      targets[sl]), base)
        for name, ecfg in (
                ("confidence_ring", base),
                ("confidence_flush",
                 dataclasses.replace(base, slot_repack=False)),
                ("confidence_per_batch",
                 dataclasses.replace(base, pooled_confidence=False))):
            timed(name, lambda e, sl: e.score_prompts(
                conf[sl], targets[sl], **conf_kw), ecfg)
        timed("fused", lambda e, sl: e.score_prefixed(
            pairs[sl], targets[sl], legs=legs), base)
    finally:
        for name in counted:
            setattr(decoder, name, real[name])
    unfused_s = runs["binary"]["seconds"] + runs["confidence_ring"]["seconds"]
    runs["unfused"] = dict(run="unfused (binary + confidence_ring)",
                           rows_per_s=STUDY_PROMPTS / unfused_s,
                           seconds=unfused_s)

    # where the time goes, on the longest prefix batch: the prefix prefill,
    # the confidence suffix's extension, the joined prompt's prefill, and a
    # look-ahead chunk from the extended cache
    pb = batches(prefixes)[-1]
    ids = torch.as_tensor(pb.token_ids, device=device).long()
    mask = torch.as_tensor(pb.attention_mask, device=device)
    plen = mask.sum(-1)
    members = [int(i) if i >= 0 else int(pb.indices[0]) for i in pb.indices]
    sb = batching.suffix_bucket_for(max(len(suffixes[i][1])
                                        for i in members))
    sids = torch.zeros((ids.shape[0], sb), dtype=torch.long, device=device)
    smask = torch.zeros((ids.shape[0], sb), dtype=torch.int32, device=device)
    for r, i in enumerate(members):
        suf = suffixes[i][1]
        sids[r, :len(suf)] = torch.tensor(suf, device=device)
        smask[r, :len(suf)] = 1
    _, pcache = decoder.prefill(weights, cfg, ids, mask, pb.bucket_len)
    prefix_ms = time_ms(lambda: decoder.prefill(
        weights, cfg, ids, mask, pb.bucket_len), iters=3, warmup=1)
    extend_ms = time_ms(lambda: decoder.extend_prefill(
        weights, cfg, pcache, sids, smask, plen), iters=3, warmup=1)
    joined = [conf[i] for i in members]
    jb = batching._emit_batch(
        list(enumerate(joined)), len(joined),
        batching.bucket_for(max(map(len, joined)), base.buckets), 0)
    jids = torch.as_tensor(jb.token_ids, device=device).long()
    jmask = torch.as_tensor(jb.attention_mask, device=device)
    joined_ms = time_ms(lambda: decoder.prefill(
        weights, cfg, jids, jmask, jb.bucket_len), iters=3, warmup=1)
    last, cache, lens = decoder.extend_prefill(weights, cfg, pcache, sids,
                                               smask, plen)
    tgt = torch.zeros((ids.shape[0], 2), dtype=torch.long, device=device)
    step_ms = time_ms(lambda: decoder.decode_steps(
        weights, cfg, cache, last, lens, 0, base.scan_chunk, None, None,
        with_scores="reduced", target_ids=tgt), iters=2,
        warmup=1) / base.scan_chunk
    del pcache, last, cache
    timing = dict(prefix_bucket=pb.bucket_len, suffix_bucket=sb,
                  joined_bucket=jb.bucket_len, prefix_prefill_ms=prefix_ms,
                  extend_prefill_ms=extend_ms, joined_prefill_ms=joined_ms,
                  lookahead_step_ms=step_ms)
    say("full_study timing", json.dumps(timing))

    # gates.  The per-batch confidence run decodes as the pre-pass did, so
    # its tokens are the pre-pass's and its leads are known; the pooled
    # routes and the fused leg are held against it.  The fused binary leg is
    # held against the unfused binary run, whose leads come from one
    # forward over each prompt and its completion.
    stats = {}
    for name, toks in (("confidence_per_batch", tokens),
                       ("binary", bin_tokens)):
        same = [r["completion"] == _completion_of(tok, t)
                for r, t in zip(rows[name], toks)]
        stats[f"{name}_rows_as_prepass"] = sum(same)
        if not all(same):
            fails.append(f"{name}: {len(same) - sum(same)} completions "
                         f"differ from the pre-pass decode")
    cut = set(planned)
    for name, got, ref, ref_gaps, ref_edge0, exact, tol, c in (
            ("confidence_ring", rows["confidence_ring"],
             rows["confidence_per_batch"], gaps, edge0, True, STUDY_WC_TOL,
             cut),
            ("confidence_flush", rows["confidence_flush"],
             rows["confidence_per_batch"], gaps, edge0, True, STUDY_WC_TOL,
             cut),
            ("fused_confidence", rows["fused"][1],
             rows["confidence_per_batch"], gaps, edge0, False, FUSED_WC_TOL,
             cut),
            ("fused_binary", rows["fused"][0], rows["binary"], bin_gaps,
             bin_edge0, False, FUSED_WC_TOL, ())):
        stats[name], f = _compare_rows(name, got, ref, ref_gaps, ref_edge0,
                                       near_tie, exact, tol, c)
        fails += f
    # retirements: each pooled run's rows are cut at the step their own
    # tokens retire them (a row that parted from the pre-pass may retire
    # elsewhere), and the counters are those of these steps; on the rows
    # that did not part, the steps are the planned ones
    for name, kind, got_rows in (
            ("confidence_ring", "ring", rows["confidence_ring"]),
            ("confidence_flush", "flush", rows["confidence_flush"]),
            ("fused", "ring", rows["fused"][1])):
        obs, eos = _observed_retirements(tok, decode_map, got_rows)
        last_check = CONF_CAP if kind == "ring" else _flush_checkpoints()[-1]
        for i, (row, r) in enumerate(zip(got_rows, obs)):
            words = len(row["completion"].split())
            if not eos[i] and words != (r if 0 <= r <= last_check
                                        else CONF_CAP):
                fails.append(f"{name}: row {i} cut after {words} tokens, "
                             f"retires at {r}")
        got = (runs[name]["pooled_conf_retired_rows"],
               runs[name]["conf_steps_saved"])
        want = schedule(obs)[kind]
        stats[f"{name}_retired_as_planned"] = sum(
            obs[r] == k for r, k in planned.items())
        if got != want or not all(got):
            fails.append(f"{name}: retired rows and steps saved {got}, "
                         f"{want} by the rows' own retirements "
                         f"(planned {expect[kind]})")
    for name, res in runs.items():
        if "prefills" in res and (
                res["kernel_launches"] != cfg.num_layers * res["prefills"]
                or not res["prefills"]):
            fails.append(f"{name}: {res['kernel_launches']} causal launches "
                         f"for {res['prefills']} prefills")
    wc = [r["weighted_confidence"] for r in rows["confidence_per_batch"]]
    stats["weighted_confidence_rows"] = sum(w is not None for w in wc)
    if not stats["weighted_confidence_rows"]:
        fails.append("no confidence row saw a digit candidate")
    stats["binary_lead_quantiles"] = _quantiles(bin_gaps)
    result = dict(prompts=STUDY_PROMPTS, runs=list(runs.values()),
                  timing=timing, expected=expect, stats=stats,
                  near_tie=near_tie, failures=fails[:50])
    say("full_study gates", json.dumps(dict(stats=stats,
                                            failures=len(fails))))
    if fails:
        raise AssertionError(f"full_study: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


def int8_phase(seed, attention, bf16_rows):
    """The int8 product's accumulators on the card, then w8a8 scoring of the
    slice's prompts with a bf16 and an int8 KV cache."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.ops import quant
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        default_tokenizer)

    device = "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    products = []
    for k, n in INT8_SHAPES:
        w = quant.int8_matmul_layout(torch.randint(
            -127, 128, (k, n), generator=gen, device=device, dtype=torch.int8))
        for m in (64, 1):
            x = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                              dtype=torch.int8)
            got = quant.int8_accumulate(x, w).cpu()
            want = quant.int8_accumulate(x.cpu(), w.cpu())
            if got.dtype != torch.int32 or not torch.equal(got, want):
                raise AssertionError(f"int8 accumulators differ at M={m} "
                                     f"K={k} N={n}")
            products.append(dict(M=m, K=k, N=n, identical=True))
    say("int8 accumulators", json.dumps(products))

    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    t0 = time.perf_counter()
    weights = convert.random_params(cfg, seed=seed, device=device,
                                    dtype="bf16", quant="int8")
    torch.cuda.synchronize()
    weight_bytes = sum(b.numel() * b.element_size() for b in weights.buffers())
    say(f"int8: Falcon-7B w8a8 weights (seed {seed}, {weight_bytes} bytes) "
        f"in {time.perf_counter() - t0:.1f} s")
    tok = default_tokenizer()
    prompts = _prompts(seed, tok)
    batches = list(batching.batches_for_prompts(
        prompts, BATCH, emod.EngineConfig().buckets, pad_id=tok.pad_token_id,
        length_sorted=True))
    runs = {}
    for kv in ("bf16", "int8"):
        ecfg = emod.EngineConfig(decode_completions=False, phase2_pool=False,
                                 batch_size=BATCH, kv_dtype=kv)
        engine = emod.ScoringEngine("falcon", cfg, weights, tok,
                                    engine_config=ecfg, device=device)
        engine.score_prompts(prompts[:BATCH])          # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(attention)
        t0 = time.perf_counter()
        rows = engine.score_prompts(prompts)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = _launches(attention)["causal_grouped_attention"]
        peak = torch.cuda.max_memory_allocated()
        _check_rows(rows)
        yes_id, no_id = engine.target_ids(["Yes", "No"])
        if launches < cfg.num_layers * len(batches):
            raise AssertionError(f"int8 kv={kv}: causal kernel launched "
                                 f"{launches} times")
        runs[kv] = dict(rows=rows, result=dict(
            kv_dtype=kv, rows_per_s=N_PROMPTS / elapsed, seconds=elapsed,
            peak_memory_bytes=peak, kernel_launches=launches))
        engine.close()

    def drel(a_rows, b_rows):
        d = np.abs([a["relative_prob"] - b["relative_prob"]
                    for a, b in zip(a_rows, b_rows)])
        return float(d.mean()), float(d.max())

    for kv in ("bf16", "int8"):
        mean, mx = drel(runs[kv]["rows"], bf16_rows)
        runs[kv]["result"].update(mean_abs_delta_relative_prob_vs_bf16=mean,
                                  max_abs_delta_relative_prob_vs_bf16=mx)
    kv_mean, kv_max = drel(runs["int8"]["rows"], runs["bf16"]["rows"])
    runs["int8"]["result"].update(mean_abs_delta_relative_prob_vs_w8a8=kv_mean,
                                  max_abs_delta_relative_prob_vs_w8a8=kv_max)

    # The longest batch: the w8a8 prefill and a scored look-ahead chunk from
    # each cache, for where the time goes.  Random weights leave every row
    # undecided, so the rows read position 0 and cannot show what the int8
    # cache does to the look-ahead; the first look-ahead step's logits can
    # (both caches take the same token there; later steps follow greedy
    # tokens that near-tied random logits let diverge).
    batch = batches[-1]
    ids = torch.as_tensor(batch.token_ids, device=device).long()
    mask = torch.as_tensor(batch.attention_mask, device=device)
    prefill_ms = time_ms(lambda: decoder.prefill(
        weights, cfg, ids, mask, batch.bucket_len), iters=3, warmup=1)
    tgt = torch.tensor([[yes_id, no_id]] * BATCH, device=device)
    chunk = emod.EngineConfig().scan_chunk
    step_ms, first_step, tokens = {}, {}, {}
    for kv in ("bf16", "int8"):
        kcfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        last, cache = decoder.prefill(weights, kcfg, ids, mask, batch.bucket_len)

        def look_ahead():
            return decoder.decode_steps(
                weights, kcfg, cache, last, mask.sum(-1), 0, chunk, None,
                None, with_scores="reduced", target_ids=tgt)

        toks, scores, _, _, _ = look_ahead()
        # scores[:, 0] are the prefill's; step 1 is the first to read the cache
        first_step[kv] = torch.cat([scores.topk_vals[:, 1],
                                    scores.target_logits[:, 1]], dim=-1)
        tokens[kv] = toks
        step_ms[kv] = time_ms(look_ahead, iters=2, warmup=1) / chunk
        del last, cache
    result = dict(accumulators=products, weight_bytes=weight_bytes,
                  longest_batch=dict(
                      bucket=batch.bucket_len, prefill_ms=prefill_ms,
                      lookahead_step_ms=step_ms,
                      int8_kv_first_step_logits_rel_l2=_rel_l2(
                          first_step["int8"], first_step["bf16"]),
                      int8_kv_same_greedy_token_share=float(
                          (tokens["int8"] == tokens["bf16"]).float().mean())),
                  runs=[runs[kv]["result"] for kv in ("bf16", "int8")])
    say("int8", json.dumps(result))
    w8 = runs["bf16"]["result"]
    if not (w8["mean_abs_delta_relative_prob_vs_bf16"] < W8A8_MEAN_DREL
            and w8["max_abs_delta_relative_prob_vs_bf16"] < W8A8_MAX_DREL):
        raise AssertionError(f"w8a8 rows too far from bf16: {w8}")
    if kv_max > INT8_KV_MAX_DREL:
        raise AssertionError(f"int8 KV rows {kv_max} from the bf16-KV rows")
    return result


def _rephrasings(scenarios, seed, per=SWEEP_PER_SCENARIO, lo=SWEEP_TOKENS[0],
                 hi=SWEEP_TOKENS[1]):
    """``per`` distinct word-level edits of each scenario's original_main:
    three swaps of neighbouring words, then random words of the original
    inserted or deleted until the edit has a length drawn from [lo, hi]
    words (one token a word under the sweep's word tokenizer)."""
    import numpy as np

    rng = np.random.default_rng(seed + 3)
    out = []
    for s in scenarios:
        base = s["original_main"].split()
        seen = set()
        while len(seen) < per:
            words = list(base)
            for _ in range(3):
                i = int(rng.integers(0, len(words) - 1))
                words[i], words[i + 1] = words[i + 1], words[i]
            n = int(rng.integers(lo, hi + 1))
            while len(words) < n:
                words.insert(int(rng.integers(0, len(words) + 1)),
                             base[int(rng.integers(0, len(base)))])
            while len(words) > n:
                del words[int(rng.integers(0, len(words)))]
            text = " ".join(words)
            if text not in seen and text != s["original_main"]:
                seen.add(text)
                out.append((s["original_main"], text))
    return [[t for o, t in out if o == s["original_main"]] for s in scenarios]


def _scenario_words(scenarios):
    words = []
    for s in scenarios:
        for key in ("original_main", "response_format", "confidence_format"):
            words += s[key].split()
        words += list(s["target_tokens"])
    return words


def _sweep_tokenizer(scenarios, target_ids=None):
    """A ``WordTokenizer`` over the scenarios' words whose decode writes
    every id ``i``, special ids too, as the word ``" t<i>"``: each generated
    token is one word of a completion, any id of the model's vocabulary has
    a text, and ``t<i>`` never reads as an integer.  ``target_ids`` (token
    -> id, e.g. ``{" Covered": 331}``) moves those tokens to those ids
    (swapping with the token there, or with a filler past the words)."""
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        WordTokenizer)

    class SweepTokenizer(WordTokenizer):
        def decode(self, ids, skip_special_tokens=False):
            return "".join(f" t{int(i)}" for i in ids)

    tok = SweepTokenizer(_scenario_words(scenarios))
    for token, tid in (target_ids or {}).items():
        tok.vocab += [f"<filler{i}>" for i in range(len(tok.vocab), tid + 1)]
        old = tok.ids[token]
        tok.vocab[old], tok.vocab[tid] = tok.vocab[tid], token
        tok.ids = {t: i for i, t in enumerate(tok.vocab)}
    return tok


def _popular_targets(weights, cfg, scenarios, tok, taken, batch=BATCH):
    """Ids for the scenarios' target tokens that random weights rank in
    position 0's top 20 often: over the rows of each distinct target pair,
    the two ids most often in the top 20 of one forward over each binary
    prompt (rephrasing and response format), not in ``taken`` and not
    taken by another pair.  Returns ``{" <target>": id}``."""
    from collections import Counter

    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    prompts = [tok(f"{r} {s['response_format']}")["input_ids"]
               for s in scenarios for r in s["rephrasings"]]
    pairs = [tuple(s["target_tokens"]) for s in scenarios
             for _ in s["rephrasings"]]
    counts = {p: Counter() for p in pairs}
    for lo in range(0, len(prompts), batch):
        ids, mask = _padded(prompts[lo:lo + batch], _device_of(weights))
        top = torch.topk(decoder.forward_last_logits(weights, cfg, ids, mask),
                         TOP_FILTER).indices.cpu().tolist()
        for pair, row in zip(pairs[lo:lo + batch], top):
            counts[pair].update(row)
    chosen, taken = {}, set(taken)
    for pair, c in counts.items():
        ranked = [i for i, _ in c.most_common() if i not in taken]
        if len(ranked) < len(pair):
            raise ValueError(f"{pair}: {len(ranked)} free ids in the top "
                             f"{TOP_FILTER} of its rows")
        for word, tid in zip(pair, ranked):
            chosen[" " + word] = tid
            taken.add(tid)
    return chosen


def _expected_prefill_chunks(buckets, chunk):
    """The ``prefill_chunks`` count of prefix batches of these buckets: a
    bucket longer than ``chunk`` replays in ceil(bucket / chunk) chunks."""
    return sum(-(-b // chunk) for b in buckets if b > chunk)


def _sweep_prefix_buckets(scenarios, tok, chunk_rows=SWEEP_CHUNK,
                          batch=BATCH):
    """The buckets of the fused route's prefix batches: the sweep's rows in
    chunks of ``chunk_rows``, each chunk's rephrasings batched by length as
    the engine batches them."""
    from llm_interpretation_replication_tpu_torch.config import DEFAULT_BUCKETS
    from llm_interpretation_replication_tpu_torch.runtime import batching

    items = [r for s in scenarios for r in s["rephrasings"]]
    out = []
    for lo in range(0, len(items), chunk_rows):
        enc = tok(items[lo:lo + chunk_rows])["input_ids"]
        out += [b.bucket_len for b in batching.batches_for_prompts(
            enc, batch, DEFAULT_BUCKETS, pad_id=tok.pad_token_id,
            length_sorted=True)]
    return out


def _completion_ids(text, completion_chars=100):
    """The ids of a completion the sweep tokenizer decoded (``" t<i>"``
    words); a last word the ``completion_chars`` cut may have shortened is
    left out."""
    words = text.split()
    if len(text) >= completion_chars and words:
        words = words[:-1]
    return [int(w[1:]) for w in words]


def _compare_workbooks(what, rows, ref, bin_leads, conf_leads, edge0, tie,
                       prob_tol=FUSED_PROB_TOL):
    """Hold one sweep workbook's rows against the reference run's, with the
    full-study phase's gates.  Text columns of the prompt identical;
    Token_1_Prob and Token_2_Prob within ``prob_tol`` unless a target
    logit lies within ``tie`` of the top filter's edge (``edge0``); each
    completion identical, or parting at a step (word) where the reference's
    lead (``bin_leads`` / ``conf_leads`` ``[N, steps]``) is below ``tie``;
    a confidence completion that does not part keeps its first integer and
    weighted confidence within FUSED_WC_TOL.  Returns (stats, failures)."""
    import math

    fails, parted = [], []
    worst = identical = 0
    fixed = ("Model", "Original Main Part", "Response Format",
             "Confidence Format", "Rephrased Main Part",
             "Full Rephrased Prompt", "Full Confidence Prompt",
             "Log Probabilities")
    if len(rows) != len(ref):
        return {}, [f"{what}: {len(rows)} rows, the reference has {len(ref)}"]
    for i, (a, b) in enumerate(zip(rows, ref)):
        identical += a == b
        for c in fixed:
            if a[c] != b[c]:
                fails.append(f"row {i} {c}")
        for c in ("Token_1_Prob", "Token_2_Prob"):
            x, y = a[c], b[c]
            if not all(isinstance(v, (int, float)) and not math.isnan(v)
                       for v in (x, y)):
                fails.append(f"row {i} {c} {x!r} vs {y!r}")
                continue
            worst = max(worst, abs(x - y))
            if abs(x - y) > prob_tol and not edge0[i] < tie:
                fails.append(f"row {i} {c} {x} vs {y}")
        for c, leads in (("Model Response", bin_leads),
                         ("Model Confidence Response", conf_leads)):
            wa, wb = a[c].split(), b[c].split()
            n = min(len(wa), len(wb))
            part = next((j for j in range(n) if wa[j] != wb[j]), None)
            if part is None and len(wa) != len(wb):
                part = n
            if part is not None:
                gap = float(leads[i, part]) if part < leads.shape[1] \
                    else float("inf")
                parted.append(gap)
                if not gap < tie:
                    fails.append(f"row {i} {c} parts at step {part} (lead "
                                 f"{gap}): {a[c]!r} vs {b[c]!r}")
            elif c == "Model Confidence Response":
                if a["Confidence Value"] != b["Confidence Value"]:
                    fails.append(f"row {i} Confidence Value")
                x, y = a["Weighted Confidence"], b["Weighted Confidence"]
                if (x is None) != (y is None) or (
                        x is not None and abs(x - y) > FUSED_WC_TOL):
                    fails.append(f"row {i} Weighted Confidence {x} vs {y}")
    stats = dict(identical_rows=identical, parted_completions=len(parted),
                 widest_lead_where_parted=max(parted, default=None),
                 max_abs_delta_token_prob=worst)
    return stats, [f"{what}: {f}" for f in fails]


def _boost_targets(weights, tok, scenarios):
    """Scale, in place, the embedding rows of the scenarios' target tokens
    (the ids the engine scores) by TARGET_BOOST."""
    import torch

    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    ids = sorted({i for s in scenarios
                  for i in yes_no.target_token_ids(tok, s["target_tokens"])})
    with torch.no_grad():
        weights.tree()["embed"]["tokens"][ids] *= TARGET_BOOST
    return ids


def _swap_embedding_rows(weights, tok, chosen):
    """Swap, in place, the embedding row of each target token with the row
    of the id ``chosen`` gives it (``{" <target>": id}``), and an untied
    head's columns the same way, so the id the tokenizer gives the target
    scores as that id did.  Returns the swapped ``(target id, chosen id)``
    pairs."""
    import torch

    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    tree = weights.tree()
    emb, head = tree["embed"]["tokens"], tree.get("lm_head")
    pairs = [(yes_no.target_token_ids(tok, [word[1:]])[0], tid)
             for word, tid in chosen.items()]
    with torch.no_grad():
        for a, b in pairs:
            emb[[a, b]] = emb[[b, a]]
            if head is not None:
                head[:, [a, b]] = head[:, [b, a]]
    return pairs


def _target_shares(rows):
    """Shares of workbook rows whose Token_1_Prob / Token_2_Prob is not 0
    (the target inside position 0's top 20)."""
    return [sum(r[c] > 0 for r in rows) / len(rows)
            for c in ("Token_1_Prob", "Token_2_Prob")]


class _InjectedCrash(RuntimeError):
    """The sweep phase's interruption of run (b)."""


class _CrashOnSecondChunk:
    """An engine that raises on its second ``score_prefixed`` call and
    delegates everything else."""

    def __init__(self, engine):
        self._engine, self.calls = engine, 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def score_prefixed(self, *args, **kwargs):
        self.calls += 1
        if self.calls == 2:
            raise _InjectedCrash("injected crash on the second chunk")
        return self._engine.score_prefixed(*args, **kwargs)


def _sweep_prompts(scenarios, tok):
    """Each sweep row's prefix ids, the ids of its two format suffixes
    (response, confidence) and its two target ids, in the sweep's row
    order."""
    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    prefixes = [tok(r)["input_ids"] for s in scenarios
                for r in s["rephrasings"]]
    suffixes = [[tok(" " + s[k], add_special_tokens=False)["input_ids"]
                 for k in ("response_format", "confidence_format")]
                for s in scenarios for _ in s["rephrasings"]]
    target_ids = [yes_no.target_token_ids(tok, s["target_tokens"])
                  for s in scenarios for _ in s["rephrasings"]]
    return prefixes, suffixes, target_ids


def _workbook_leads(weights, cfg, scenarios, tok, ref):
    """The leads of a reference workbook ``ref``'s completions and its rows'
    target distances from the top filter's edge (``_compare_workbooks``'s
    ``bin_leads``, ``conf_leads``, ``edge0``): one forward over each prompt
    and its completion."""
    prefixes, suffixes, target_ids = _sweep_prompts(scenarios, tok)
    _, bin_leads, edge0, _ = _teacher_top1(
        weights, cfg, [p + x[0] for p, x in zip(prefixes, suffixes)],
        [_completion_ids(r["Model Response"]) for r in ref],
        target_ids=target_ids)
    _, conf_leads, _, _ = _teacher_top1(
        weights, cfg, [p + x[1] for p, x in zip(prefixes, suffixes)],
        [_completion_ids(r["Model Confidence Response"]) for r in ref])
    return bin_leads, conf_leads, edge0


def _top1_rounding(weights, cfg, scenarios, tok, ecfg):
    """|top-1 logit of a pre-pass decode of the sweep's binary prompts
    (``ecfg``'s completion length, in its look-ahead chunks) - the same
    logit from one forward over each prompt and its tokens|: the rounding
    between two bf16 computations of the same logits, ``[N, steps]``."""
    import numpy as np

    from llm_interpretation_replication_tpu_torch.runtime import batching

    prefixes, suffixes, target_ids = _sweep_prompts(scenarios, tok)
    prompts = [p + x[0] for p, x in zip(prefixes, suffixes)]
    batches = list(batching.batches_for_prompts(
        prompts, BATCH, ecfg.buckets, pad_id=tok.pad_token_id,
        length_sorted=True))
    tokens, _, top1, _, _, _ = _study_prepass(
        weights, cfg, batches, len(prompts), ecfg.max_new_tokens,
        ecfg.max_look_ahead, tok.eos_token_id, target_ids)
    return np.abs(
        _teacher_top1(weights, cfg, prompts, tokens.tolist())[0][:, :-1]
        - top1)


def _first_layers(weights, n):
    """``weights`` cut to their first ``n`` layers: views of the stacked
    layer tensors (nothing copied; the embedding and final norm shared),
    with the config at that depth."""
    from llm_interpretation_replication_tpu_torch.models import decoder

    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:n]
                for k, v in tree.items()}

    tree = weights.tree()
    return decoder.DecoderWeights(
        dataclasses.replace(weights.cfg, num_layers=n),
        dict(tree, layers=cut(tree["layers"])))


def _bf16_rounding(weights, cfg, scenarios, tok, ecfg):
    """The bf16 rounding of the sweep's binary logits on these weights.
    (1) The top-1 logit of two bf16 computations: a pre-pass decode of the
    binary prompts (``ecfg``'s completion length, in its look-ahead chunks)
    against one forward over each prompt and its tokens; the tie is 2 x
    NEAR_TIE_FACTOR x its largest difference.  (2) The filtered position-0
    target probabilities of one bf16 forward of each binary prompt against
    a float32 one (a float32 copy of the weights, dense attention), on the
    rows whose targets lie clear of the float32 filter edge by the tie.
    Returns (readings, the float32 probabilities ``[N, 2]``, the clear rows
    ``[N]``)."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    prefixes, suffixes, target_ids = _sweep_prompts(scenarios, tok)
    prompts = [p + x[0] for p, x in zip(prefixes, suffixes)]
    top1_diff = _top1_rounding(weights, cfg, scenarios, tok, ecfg)
    tie = 2 * NEAR_TIE_FACTOR * float(top1_diff.max())
    dev = _device_of(weights)
    ref = decoder.DecoderWeights(cfg, _to_float32(weights.tree()))
    dense = dataclasses.replace(cfg, attention_impl="xla")
    p16, p32, edge = [], [], []
    for lo in range(0, len(prompts), BATCH):
        ids, mask = _padded(prompts[lo:lo + BATCH], dev)
        tgt = torch.as_tensor(np.asarray(target_ids[lo:lo + BATCH]),
                              device=dev)
        a = decoder.forward_last_logits(weights, cfg, ids, mask)
        r = decoder.forward_last_logits(ref, dense, ids, mask)
        kth = torch.topk(r, TOP_FILTER).values[:, -1:]
        edge.append((r.gather(1, tgt) - kth).abs().min(1).values.cpu())
        p16.append(_filtered_target_probs(a, tgt).cpu())
        p32.append(_filtered_target_probs(r, tgt).cpu())
    del ref
    clear = torch.cat(edge).numpy() >= tie
    p16, p32 = torch.cat(p16).numpy(), torch.cat(p32).numpy()
    readings = dict(top1_max_abs_diff=float(top1_diff.max()),
                    top1_abs_diff_quantiles=_quantiles(top1_diff), tie=tie,
                    prob_bf16_vs_fp32=float(
                        np.abs(p16 - p32)[clear].max(initial=0.0)),
                    rows_clear_of_edge=int(clear.sum()))
    return readings, p32, clear


def _perturbation_records(seed):
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios

    scenarios = legal_scenarios()
    return [dict(s, rephrasings=r)
            for s, r in zip(scenarios, _rephrasings(scenarios, seed))]


def sweep_phase(seed, attention, full_weights, workdir, card):
    """``run_model_perturbation_sweep`` on Falcon-7B's width at its first
    SWEEP_LAYERS layers (views of the slice's weights) over the legal
    scenarios' rephrasings: the fused route (a), a run interrupted on its
    second chunk and resumed (b), the two-string route (c), the
    ``first_token_relative_prob`` fallback (d) and chunked prefill (e),
    each workbook held against (a)'s with the near-tie measured at that
    depth; then one bucket-448 prefill of all 32 layers, monolithic
    against chunked.  The scenarios' target tokens take ids
    that these weights often rank in position 0's top 20
    (``_popular_targets``).  Then (a), (c) and (e) again with the targets'
    own ids, their embedding rows scaled by TARGET_BOOST (larger target
    logits, larger rounding of them), held against that (a) with the
    bf16 rounding measured on those weights (``_bf16_rounding``)."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.config import legal_scenarios
    from llm_interpretation_replication_tpu_torch.gen.rephrase import (
        load_perturbations)
    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.sweeps import (
        PERTURBATION_COLUMNS, run_model_perturbation_sweep)
    from llm_interpretation_replication_tpu_torch.utils import telemetry
    from llm_interpretation_replication_tpu_torch.utils.logging import (
        SessionLogger)
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        default_tokenizer)
    from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx

    device = "cuda"
    cfg = mconfig.DecoderConfig(**{**mconfig.FALCON_7B_GEOMETRY,
                                   "num_layers": SWEEP_LAYERS},
                                attention_impl="flash")
    weights = _first_layers(full_weights, SWEEP_LAYERS)
    path = os.path.join(workdir, "perturbations.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(_perturbation_records(seed), f)
    scenarios = load_perturbations(path, expected_scenarios=legal_scenarios())
    word_tok = _sweep_tokenizer(scenarios)
    tok = _sweep_tokenizer(scenarios, _popular_targets(
        weights, cfg, scenarios, word_tok, range(len(word_tok.special))))
    n_rows = sum(len(s["rephrasings"]) for s in scenarios)
    lengths = [len(tok(r)["input_ids"]) for s in scenarios
               for r in s["rephrasings"]]
    log = SessionLogger(log_file=os.path.join("chiprun_out", "sweep_phase.log"),
                        stream=io.StringIO())
    base = emod.EngineConfig(batch_size=BATCH)

    counted = {"prefill": 0, "forward_last_logits": 0}
    real = {name: getattr(decoder, name) for name in counted}

    def counting(name):
        def call(*args, **kwargs):
            counted[name] += 1
            return real[name](*args, **kwargs)
        return call

    runs, books = {}, {}

    def sweep(name, ecfg=base, fuse=True, crash=False, tok=tok):
        out = os.path.join(workdir, f"sweep_{name}.xlsx")
        engine = emod.ScoringEngine("falcon", cfg, weights, tok,
                                    engine_config=ecfg, device=device)
        calls = []
        for attempt in ((True, False) if crash else (False,)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            telemetry.clear_counters()
            _reset_launches(attention)
            for k in counted:
                counted[k] = 0
            t0 = time.perf_counter()
            scored = sum(len(s["rephrasings"]) for s in scenarios)
            try:
                rows = run_model_perturbation_sweep(
                    _CrashOnSecondChunk(engine) if attempt else engine,
                    SWEEP_MODEL, scenarios, out,
                    checkpoint_every=SWEEP_CHECKPOINT,
                    score_chunk=SWEEP_CHUNK, fuse_prefix=fuse, log=log)
            except _InjectedCrash:
                rows = None
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            c = telemetry.counters()
            if rows is None:
                scored = SWEEP_CHUNK
                sidelog = out + ".rows.jsonl"
                with open(sidelog) as f:
                    logged = sum(1 for line in f if line.strip())
                if logged != SWEEP_CHUNK or os.path.exists(out):
                    raise AssertionError(
                        f"sweep {name}: the crash left {logged} side-log "
                        f"rows, not the first chunk's {SWEEP_CHUNK}")
            else:
                scored -= SWEEP_CHUNK if crash else 0
            calls.append(dict(
                seconds=elapsed, rows_scored=scored,
                rows_per_s=scored / elapsed,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                kernel_launches=_launches(attention)[
                    "causal_grouped_attention"],
                prefills=counted["prefill"],
                forward_last_logits=counted["forward_last_logits"],
                prefill_chunks=c.get("prefill_chunks", 0),
                interrupted=rows is None))
        engine.close()
        if os.path.exists(out + ".rows.jsonl"):
            raise AssertionError(f"sweep {name}: the side-log outlived the run")
        cols, book = read_xlsx(out)
        if cols != PERTURBATION_COLUMNS or len(book) != n_rows:
            raise AssertionError(f"sweep {name}: workbook of {len(book)} rows "
                                 f"and columns {cols}")
        books[name] = book
        res = dict(run=name, calls=calls, **{
            k: sum(c[k] for c in calls) for k in (
                "seconds", "rows_scored", "kernel_launches", "prefills",
                "forward_last_logits", "prefill_chunks")})
        res["rows_per_s"] = res["rows_scored"] / res["seconds"]
        res["peak_memory_bytes"] = max(c["peak_memory_bytes"] for c in calls)
        runs[name] = res
        say("sweep", json.dumps(dict(res, card=card)))

    for name in counted:
        setattr(decoder, name, counting(name))
    try:
        sweep("fused")
        sweep("resumed", crash=True)
        sweep("legacy", fuse=False)
        sweep("fallback", dataclasses.replace(base, first_token_top_filter=5))
        sweep("chunked", dataclasses.replace(
            base, prefill_chunk=SWEEP_PREFILL_CHUNK))
        emb = weights.tree()["embed"]["tokens"]
        unboosted = emb.clone()
        _boost_targets(weights, word_tok, scenarios)
        try:
            sweep("boosted_fused", tok=word_tok)
            sweep("boosted_legacy", fuse=False, tok=word_tok)
            sweep("boosted_chunked", dataclasses.replace(
                base, prefill_chunk=SWEEP_PREFILL_CHUNK), tok=word_tok)
            boosted_leads = _workbook_leads(weights, cfg, scenarios, word_tok,
                                            books["boosted_fused"])
            rounding, fp32_probs, clear = _bf16_rounding(
                weights, cfg, scenarios, word_tok, base)
        finally:
            emb.copy_(unboosted)
            del unboosted
    finally:
        for name in counted:
            setattr(decoder, name, real[name])
        log.close()

    # the reference's leads: one forward over each prompt and its
    # completion; a lead there adds one more bf16 computation of both
    # logits, so completions may part below twice the near-tie (the
    # full-study phase's measure, taken here on these prompts at this
    # depth)
    near_tie = NEAR_TIE_FACTOR * float(
        _top1_rounding(weights, cfg, scenarios, tok, base).max())
    tie = 2 * near_tie
    leads = _workbook_leads(weights, cfg, scenarios, tok, books["fused"])
    fails, stats = [], {}
    for name in ("resumed", "legacy", "fallback", "chunked"):
        stats[name], f = _compare_workbooks(name, books[name], books["fused"],
                                            *leads, tie)
        fails += f
    # the boosted runs: completions part only where the lead is below the
    # tie of the rounding measured on the boosted weights; on rows clear of
    # the filter's edge, each run's position-0 fields no further from
    # float32 than NEAR_TIE_FACTOR times one bf16 forward's distance, and
    # so two runs' no further apart than twice that
    boosted = dict(rounding, prob_tol=NEAR_TIE_FACTOR
                   * rounding["prob_bf16_vs_fp32"],
                   target_in_top20_share=_target_shares(
                       books["boosted_fused"]))
    for name in ("boosted_fused", "boosted_legacy", "boosted_chunked"):
        got = np.asarray([[r["Token_1_Prob"], r["Token_2_Prob"]]
                          for r in books[name]])
        d = float(np.abs(got - fp32_probs)[clear].max(initial=0.0))
        boosted[f"{name}_vs_fp32"] = d
        if not d <= boosted["prob_tol"]:
            fails.append(f"{name}: position-0 fields {d} from float32, one "
                         f"bf16 forward {rounding['prob_bf16_vs_fp32']}")
    for name in ("boosted_legacy", "boosted_chunked"):
        stats[name], f = _compare_workbooks(
            name, books[name], books["boosted_fused"], *boosted_leads,
            boosted["tie"], prob_tol=2 * boosted["prob_tol"])
        fails += f
    say("sweep boosted rounding", json.dumps(dict(boosted, card=card)))
    expect_chunks = _expected_prefill_chunks(
        _sweep_prefix_buckets(scenarios, tok), SWEEP_PREFILL_CHUNK)
    for name in ("chunked", "boosted_chunked"):
        if runs[name]["prefill_chunks"] != expect_chunks or not expect_chunks:
            fails.append(f"{name}: prefill_chunks "
                         f"{runs[name]['prefill_chunks']}, the batches' "
                         f"buckets give {expect_chunks}")
    if not runs["fallback"]["forward_last_logits"]:
        fails.append("fallback: first_token_relative_prob never ran")
    for name, res in runs.items():
        forwards = res["prefills"] + res["forward_last_logits"]
        if not forwards or res["kernel_launches"] != cfg.num_layers * forwards:
            fails.append(f"{name}: {res['kernel_launches']} causal launches "
                         f"for {forwards} prompt forwards")

    # one bucket-448 batch of the slice phase through all 32 layers,
    # monolithic and chunked
    weights = full_weights
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    ptok = default_tokenizer()
    batch = list(batching.batches_for_prompts(
        _prompts(seed, ptok), BATCH, base.buckets, pad_id=ptok.pad_token_id,
        length_sorted=True))[-1]
    ids = torch.as_tensor(batch.token_ids, device=device).long()
    mask = torch.as_tensor(batch.attention_mask, device=device)
    timing = dict(card=card, bucket=batch.bucket_len,
                  chunk=TIMING_PREFILL_CHUNK)
    for name, fn in (
            ("monolithic", lambda: decoder.prefill(weights, cfg, ids, mask,
                                                   batch.bucket_len)),
            ("chunked", lambda: decoder.chunked_prefill(
                weights, cfg, ids, mask, TIMING_PREFILL_CHUNK))):
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del out
        timing[f"{name}_ms"] = time_ms(fn, iters=3, warmup=1)
        timing[f"{name}_peak_gb"] = peak / 1e9
        timing[f"{name}_transient_gb"] = (peak - base_bytes) / 1e9
    say("sweep prefill timing", json.dumps(timing))
    result = dict(card=card, rows=n_rows,
                  token_lengths=[min(lengths), max(lengths)],
                  target_in_top20_share=_target_shares(books["fused"]),
                  layers=SWEEP_LAYERS, near_tie=near_tie,
                  runs=list(runs.values()), expected_prefill_chunks=expect_chunks,
                  parting_tie=tie, boosted=boosted, stats=stats, timing=timing,
                  failures=fails[:50])
    say("sweep gates", json.dumps(dict(card=card, stats=stats,
                                       failures=len(fails))))
    if fails:
        raise AssertionError(f"sweep: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


def _bpe_merges(pieces):
    """BPE merges learned on ``pieces`` (pre-tokenized words in the byte
    alphabet -> count): the most frequent pair merges first (ties to the
    smaller pair), until every piece is one symbol."""
    import heapq
    from collections import Counter, defaultdict

    words = [list(p) for p in pieces]
    freq = list(pieces.values())
    counts, where = Counter(), defaultdict(set)

    def tally(wi, sign):
        w = words[wi]
        for pair in zip(w, w[1:]):
            counts[pair] += sign * freq[wi]
            where[pair].add(wi)

    for wi in range(len(words)):
        tally(wi, 1)
    heap = [(-c, p) for p, c in counts.items()]
    heapq.heapify(heap)
    merges = []
    while heap:
        c, pair = heapq.heappop(heap)
        if -c <= 0 or counts.get(pair, 0) != -c:
            continue
        merges.append(pair)
        a, b = pair
        changed = set()
        for wi in sorted(where.pop(pair)):
            w = words[wi]
            if not any(w[i] == a and w[i + 1] == b for i in range(len(w) - 1)):
                continue
            changed.update(zip(w, w[1:]))
            tally(wi, -1)
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            words[wi] = out
            tally(wi, 1)
            changed.update(zip(out, out[1:]))
        for p in changed:
            if counts[p] > 0:
                heapq.heappush(heap, (-counts[p], p))
    return merges


def _bpe_tokenizer_files(texts, nfc=False):
    """(tokenizer.json, tokenizer_config.json, special_tokens_map.json) of
    a byte-level BPE tokenizer: the 256 byte symbols, merges learned on the
    ByteLevel pieces of ``texts`` until each piece is one token, and
    ``<|endoftext|>`` as an added special token and the EOS (which then
    pads, by the loader's rule).  ``nfc``: with the ``NFC`` normalizer
    (GPT-NeoX-20B's tokenizer has it)."""
    from collections import Counter

    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        _byte_level_split, _bytes_to_unicode)

    byte_map = _bytes_to_unicode()
    pieces = Counter()
    for text in texts:
        for m in _byte_level_split().finditer(text):
            pieces["".join(byte_map[b] for b in m.group(0).encode())] += 1
    vocab = {byte_map[b]: b for b in range(256)}
    merges = _bpe_merges(pieces)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    eos = "<|endoftext|>"
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": len(vocab), "content": eos,
                          "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False,
                          "special": True}],
        "normalizer": {"type": "NFC"} if nfc else None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": {"type": "ByteLevel", "add_prefix_space": True,
                           "trim_offsets": False, "use_regex": True},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }
    config = {"eos_token": eos, "clean_up_tokenization_spaces": False,
              "tokenizer_class": "PreTrainedTokenizerFast",
              "model_max_length": 2048}
    return spec, config, {"eos_token": eos}


def _charsmap(mapping):
    """A SentencePiece precompiled charsmap of ``mapping`` (key text ->
    normalized text): a little-endian u32 trie size in bytes, a
    darts-clone double array of the keys' UTF-8 bytes (u32 units: label in
    bits 0-7, has-leaf bit 8, offset to the children's base from bit 10;
    a leaf's value unit, bit 31 set, sits at its node's base), then the
    NUL-terminated normalized strings the values point into.  Each node's
    base is the smallest free one no other node uses, so a label probed at
    a foreign base never matches; the array covers every base's 256
    slots."""
    import struct

    blob, where = bytearray(), {}
    for v in mapping.values():
        if v not in where:
            where[v] = len(blob)
            blob += v.encode("utf-8") + b"\0"
    root = {}
    for key, v in mapping.items():
        node = root
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[None] = where[v]
    units, bases = {0: 0}, set()
    queue = [(0, root)]
    while queue:
        pos, node = queue.pop(0)
        labels = [0 if k is None else k for k in node]
        base = 1
        while base in bases or any((base ^ lab) in units or base ^ lab == 0
                                   for lab in labels):
            base += 1
        bases.add(base)
        units[pos] |= (pos ^ base) << 10
        for k, child in node.items():
            if k is None:
                units[base] = child | (1 << 31)
                units[pos] |= 1 << 8
            else:
                units[base ^ k] = k
                queue.append((base ^ k, child))
    size = max(b | 0xFF for b in bases) + 1
    trie = struct.pack(f"<{size}I", *(units.get(i, 0) for i in range(size)))
    return struct.pack("<I", len(trie)) + trie + bytes(blob)


def _charsmap_b64(mapping):
    """``_charsmap`` as ``tokenizer.json`` stores it (base64)."""
    import base64

    return base64.b64encode(_charsmap(mapping)).decode("ascii")


def _unigram_tokenizer_files(texts, charsmap=None):
    """(tokenizer.json, tokenizer_config.json, special_tokens_map.json) of
    a T5-style Unigram tokenizer: ``<pad>``, ``</s>`` and ``<unk>`` at ids
    0-2 (special added tokens), ``"▁"`` plus every whitespace word of
    ``texts`` after a ``"▁"`` scored by its log frequency, every
    character of them scored 5 lower, the Metaspace pre-tokenizer and
    decoder, a normalizer folding runs of spaces (after a ``Precompiled``
    normalizer of ``charsmap``, a key -> normalized text mapping, as
    T5's published files carry one; the words are learned on the
    normalized texts), and a post-processor appending ``</s>`` (the
    EOS)."""
    import math
    from collections import Counter

    from llm_interpretation_replication_tpu_torch.utils import (
        tokenizer_parts)

    norms = [{"type": "Replace", "pattern": {"Regex": " {2,}"},
              "content": " "}]
    if charsmap is not None:
        norms.insert(0, {"type": "Precompiled",
                         "precompiled_charsmap": _charsmap_b64(charsmap)})
    normalizer = {"type": "Sequence", "normalizers": norms}
    normalize = tokenizer_parts.normalizer(normalizer)
    words, chars = Counter(), Counter()
    for text in map(normalize, texts):
        for w in text.split():
            words["▁" + w] += 1
            chars.update(w)
    total = sum(words.values()) + sum(chars.values()) + 1
    vocab = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0],
             ["▁", math.log(1 / total)]]
    vocab += [[w, math.log(c / total)] for w, c in sorted(words.items())]
    vocab += [[ch, math.log(c / total) - 5.0] for ch, c in sorted(chars.items())
              if ch != "▁"]
    meta = {"type": "Metaspace", "replacement": "▁",
            "prepend_scheme": "always", "split": True}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, t in enumerate(("<pad>", "</s>", "<unk>"))],
        "normalizer": normalizer,
        "pre_tokenizer": meta,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                        "tokens": ["</s>"]}}},
        "decoder": meta,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab,
                  "byte_fallback": False},
    }
    special = {"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>"}
    config = dict(special, tokenizer_class="T5Tokenizer",
                  clean_up_tokenization_spaces=False, model_max_length=512)
    return spec, config, special


#: edge strings the tokenizer formats are held to (digit runs, numerals
#: of other scripts, ASCII symbols, CJK and Arabic punctuation, emoji ZWJ
#: and flag sequences, combining marks, whitespace at the ends, added
#: tokens mid-text, Hangul, runs of spaces)
TOKENIZER_EDGE_TEXTS = (
    "", " ", "  ", "Yes", " Yes", " No", "\n",
    "0 12 345 6789 1234567 3.14159 1,000,000 2024-01-31",
    "²½٣一 ³¼ ٠١٢٣ 一二三 Ⅻ ⑤ x²",
    "$+<^~ !\"#%&'()*,-./:;=>?@[\\]_`{|} a$b+c<d^e~f",
    "中文，标点。「引号」、顿号！ العربية، فاصلة؛ منقوطة؟ ۔ । …",
    "👩‍👧‍👦 👍🏽 🇺🇸🇫🇷 ❤️ 1️⃣ 🏳️‍🌈",
    "café naïve q́ ä é́ ́lead",
    "  two leading spaces", "trailing spaces   ", " \t tab\n\nnew\r\nCRLF ",
    "mid<|endoftext|>text</s>and<s>more<unk>then<pad>>>TITLE<<",
    "ﬁ ½ … Ａｂｃ “quotes”  nbsp 　ideo ​zw",
    "안녕하세요 가각 각",
    "x‍y q́́ ab ​\r\n",
    "A long  run   of    spaces     here",
    "don't I'D we've 're 'S ſ K ß ΣΑΣ",
    "Answer: Yes Answer:No  Answer:",
)
#: the smoke's charsmap for the T5 snapshots, after nmt_nfkc's kind
#: (spaces, ligatures, fullwidth forms, quotes, a zero-width space to
#: nothing); "q" is a prefix of "q́", and a cluster starting with
#: "q" takes the first match, as SentencePiece's code does
T5_CHARSMAP = {" ": " ", "　": " ", "​": "", "ﬁ": "fi",
               "ﬂ": "fl", "…": "...", "“": "\"", "”": "\"", "‘": "'",
               "’": "'", "½": "1/2", "²": "2", "Ａ": "A", "ｂ": "b",
               "ｃ": "c", "q": "q", "q́": "q", "\r\n": "\n",
               "x‍": "x"}
#: the published tokenizer formats of the roster, and the models whose
#: snapshots carry them
TOKENIZER_FORMATS = {
    "falcon": "tiiuae/falcon-7b: BPE behind a Sequence of Punctuation, "
              "ByteLevel, Digits and a Split",
    "bloom": "bigscience/bloom-7b1: BPE behind a Split on a custom regex "
             "and ByteLevel(use_regex=false)",
    "llama": "mistralai/Mistral-7B-Instruct-v0.2 (v0.1, Llama-2): "
             "byte-fallback BPE, Prepend/Replace normalizers, a BOS template",
    "mistral_v03": "mistralai/Mistral-7B-Instruct-v0.3: byte-fallback BPE "
                   "behind Metaspace prepend_scheme 'first'",
    "t5": "T0_3B, tk-instruct, the T5 pair: Unigram behind a Precompiled "
          "charsmap",
}
FALCON_PRE_TOKENIZER = {"type": "Sequence", "pretokenizers": [
    {"type": "Punctuation", "behavior": "Contiguous"},
    {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
     "use_regex": True},
    {"type": "Digits", "individual_digits": False},
    {"type": "Split", "pattern": {"Regex": "[0-9][0-9][0-9]"},
     "behavior": "Isolated", "invert": False}]}
BLOOM_PRE_TOKENIZER = {"type": "Sequence", "pretokenizers": [
    {"type": "Split", "pattern": {"Regex": " ?[^(\\s|[.,!?…。，、।۔،])]+"},
     "behavior": "Isolated", "invert": False},
    {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
     "use_regex": False}]}
#: Llama-2's and Mistral's decoder
SPM_DECODER = {"type": "Sequence", "decoders": [
    {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
    {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}


def _added(tokens, first_id, special=True):
    return [{"id": first_id + i, "content": t, "single_word": False,
             "lstrip": False, "rstrip": False, "normalized": not special,
             "special": special} for i, t in enumerate(tokens)]


def _byte_level_format(texts, pre, specials, post, decoder):
    """A byte-level BPE ``tokenizer.json`` behind ``pre``: the 256 byte
    symbols, merges learned (``_bpe_merges``) on the pieces the port's own
    reader of ``pre`` cuts ``texts`` into, then ``specials`` as special
    added tokens."""
    from collections import Counter

    from llm_interpretation_replication_tpu_torch.utils import (
        tokenizer_parts)

    byte_map = tokenizer_parts.bytes_to_unicode()
    split = tokenizer_parts.pre_tokenizer(pre)
    pieces = Counter(w for t in texts for w, _ in split([(t, None)]))
    vocab = {byte_map[b]: b for b in range(256)}
    merges = _bpe_merges(pieces)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added(specials, len(vocab)),
        "normalizer": None, "pre_tokenizer": pre, "post_processor": post,
        "decoder": decoder,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]}}


def _byte_fallback_format(texts, normalizer, pre, decoder):
    """A SentencePiece-converted BPE ``tokenizer.json`` (Llama-2's and
    Mistral's layout): ``<unk>``, ``<s>``, ``</s>`` at ids 0-2, the 256
    ``<0xXX>`` byte tokens at 3-258, the characters of ``texts``, then
    merges learned on the words between ``▁`` marks (so no merge spans
    two words); byte fallback, fused unknowns, ``<s>`` in front."""
    import re as _re
    from collections import Counter

    words = Counter()
    for t in texts:
        words.update(_re.findall("▁?[^▁]+|▁", "▁" + t.replace(" ", "▁")))
    vocab = {t: i for i, t in enumerate(("<unk>", "<s>", "</s>"))}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    for ch in sorted({c for w in words for c in w}):
        vocab.setdefault(ch, len(vocab))
    merges = _bpe_merges(words)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added(("<unk>", "<s>", "</s>"), 0),
        "normalizer": normalizer, "pre_tokenizer": pre,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                       "tokens": ["<s>"]}}},
        "decoder": decoder,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]}}


def _format_tokenizer_files(fmt, texts):
    """(tokenizer.json, tokenizer_config.json, special_tokens_map.json) in
    the published format ``fmt`` of ``TOKENIZER_FORMATS``, learned on
    ``texts``: Falcon's and BLOOM's pre-tokenizers over byte-level BPE,
    Llama-2/Mistral's byte-fallback BPE (``LlamaTokenizer``,
    ``add_bos_token``), Mistral v0.3's Metaspace "first", T5's Unigram
    behind ``T5_CHARSMAP``."""
    if fmt == "falcon":
        eos = "<|endoftext|>"
        spec = _byte_level_format(
            texts, FALCON_PRE_TOKENIZER,
            (">>TITLE<<", ">>ABSTRACT<<", ">>QUESTION<<", ">>ANSWER<<", eos),
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": True, "use_regex": True})
        config = {"eos_token": eos, "add_prefix_space": False,
                  "tokenizer_class": "PreTrainedTokenizerFast",
                  "clean_up_tokenization_spaces": False,
                  "model_max_length": 2048}
        return spec, config, {"eos_token": eos}
    if fmt == "bloom":
        special = {"unk_token": "<unk>", "bos_token": "<s>",
                   "eos_token": "</s>", "pad_token": "<pad>"}
        spec = _byte_level_format(
            texts, BLOOM_PRE_TOKENIZER, ("<unk>", "<s>", "</s>", "<pad>"),
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": False},
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": True, "use_regex": False})
        config = dict(special, tokenizer_class="BloomTokenizerFast",
                      padding_side="left", clean_up_tokenization_spaces=False,
                      model_max_length=2048)
        return spec, config, special
    if fmt in ("llama", "mistral_v03"):
        special = {"bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>"}
        if fmt == "llama":
            spec = _byte_fallback_format(
                texts, {"type": "Sequence", "normalizers": [
                    {"type": "Prepend", "prepend": "▁"},
                    {"type": "Replace", "pattern": {"String": " "},
                     "content": "▁"}]}, None, SPM_DECODER)
        else:
            spec = _byte_fallback_format(
                texts, None, {"type": "Metaspace", "replacement": "▁",
                              "prepend_scheme": "first", "split": False},
                SPM_DECODER)
        config = dict(special, tokenizer_class="LlamaTokenizer",
                      add_bos_token=True, add_eos_token=False, pad_token=None,
                      legacy=fmt == "llama",
                      clean_up_tokenization_spaces=False,
                      model_max_length=32768)
        return spec, config, special
    if fmt == "t5":
        return _unigram_tokenizer_files(texts, T5_CHARSMAP)
    raise ValueError(f"unknown tokenizer format {fmt!r}")


def _write_tokenizer_files(snap, files):
    for name, obj in zip(("tokenizer.json", "tokenizer_config.json",
                          "special_tokens_map.json"), files):
        with open(os.path.join(snap, name), "w", encoding="utf-8") as f:
            json.dump(obj, f)


def _qwen_tiktoken(texts):
    """The lines of a Qwen-1 ``qwen.tiktoken`` (base64 token, rank): the
    256 bytes at ranks 0-255, then BPE merges learned on Qwen's split
    pieces of ``texts`` (``_bpe_merges``), in merge order."""
    import base64
    from collections import Counter

    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        _bytes_to_unicode, _qwen_split)

    byte_map = _bytes_to_unicode()
    char_byte = {c: b for b, c in byte_map.items()}
    pieces = Counter()
    for text in texts:
        for m in _qwen_split().finditer(text):
            pieces["".join(byte_map[b] for b in m.group(0).encode())] += 1
    ranks = {bytes([b]): b for b in range(256)}
    for a, b in _bpe_merges(pieces):
        ranks.setdefault(bytes(char_byte[c] for c in a + b), len(ranks))
    return b"".join(base64.b64encode(t) + b" %d\n" % r
                    for t, r in ranks.items())


def _write_gpt2_tokenizer(snap, texts):
    """A GPT-2-style ``vocab.json`` + ``merges.txt`` (OPT's format: no
    ``tokenizer.json``) of ``_bpe_tokenizer_files``' BPE, with OPT's
    tokenizer config (``</s>`` the BOS and EOS, added in front of every
    encoding, ``<pad>`` the pad)."""
    spec, _, _ = _bpe_tokenizer_files(texts)
    vocab = dict(spec["model"]["vocab"])
    for tok in ("<pad>", "</s>"):
        vocab.setdefault(tok, len(vocab))
    with open(os.path.join(snap, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(snap, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in spec["model"]["merges"])
    special = {"bos_token": "</s>", "eos_token": "</s>", "unk_token": "</s>",
               "pad_token": "<pad>"}
    for name, obj in (("tokenizer_config.json",
                       dict(special, tokenizer_class="GPT2Tokenizer",
                            add_bos_token=True, add_prefix_space=False,
                            errors="replace")),
                      ("special_tokens_map.json", special)):
        with open(os.path.join(snap, name), "w", encoding="utf-8") as f:
            json.dump(obj, f)


def _write_safetensors(path, tensors):
    """A safetensors file of ``tensors`` (name -> tensor, any device): an
    8-byte little-endian header length, the JSON header (padded with spaces
    to a multiple of 8), then each tensor's bytes in order."""
    import struct

    import torch

    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1)
                    .view(torch.uint8).numpy().data)


def _falcon_state_dict(tree, cfg):
    """The HF Falcon checkpoint of a stacked param tree with one K/V head
    (Falcon-7B's layout: fused QKV rows ``[q(N*D); k(D); v(D)]``, torch
    ``Linear`` weights ``[out, in]``, tied embeddings): the inverse of
    ``models.convert.convert_falcon``."""
    import torch

    if cfg.num_kv_heads != 1 or not cfg.shared_layernorm:
        raise ValueError("the writer takes Falcon-7B's layout only")
    layers, sd = tree["layers"], {}
    sd["transformer.word_embeddings.weight"] = tree["embed"]["tokens"]
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        attn, mlp = layers["attn"], layers["mlp"]
        sd[pre + "self_attention.query_key_value.weight"] = torch.cat(
            [attn["wq"][i].t(), attn["wk"][i].t(), attn["wv"][i].t()])
        sd[pre + "self_attention.dense.weight"] = attn["wo"][i].t()
        sd[pre + "mlp.dense_h_to_4h.weight"] = mlp["wi"][i].t()
        sd[pre + "mlp.dense_4h_to_h.weight"] = mlp["wo"][i].t()
        sd[pre + "input_layernorm.weight"] = layers["ln1"]["scale"][i]
        sd[pre + "input_layernorm.bias"] = layers["ln1"]["bias"][i]
    sd["transformer.ln_f.weight"] = tree["final_ln"]["scale"]
    sd["transformer.ln_f.bias"] = tree["final_ln"]["bias"]
    return sd


def _falcon_config_json(cfg):
    """Falcon-7B's ``config.json`` at this depth, with the legacy key names
    of the original snapshots (``n_embed``, ``n_head``, ``n_layer``)."""
    return {"model_type": "falcon", "architectures": ["FalconForCausalLM"],
            "n_embed": cfg.hidden_size, "n_head": cfg.num_heads,
            "n_layer": cfg.num_layers, "vocab_size": cfg.vocab_size,
            "multi_query": True, "new_decoder_architecture": False,
            "parallel_attn": True, "bias": False, "alibi": False,
            "layer_norm_epsilon": 1e-5, "torch_dtype": "bfloat16",
            "bos_token_id": 11, "eos_token_id": 11}


def _cli_packed_and_k_runs(cli, argv, snap, workdir, attention, cfg, n_rows,
                           books, runs, card):
    """``run-perturbation --packed PACK_Q`` (the packed workbook with its
    extractor tag, and the drift line on stdout), then ``--decode-k
    K_DECODE`` twice: the first run distills a K-head and writes
    ``k_head.npz`` beside the snapshot, the second loads it and writes the
    same workbook.  The K runs' position-0 columns are the bf16 run's
    (the K path changes the decode only).  Appends each run to ``runs``;
    returns the failures."""
    import contextlib

    import torch

    from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx

    fails = []
    logs = {}
    for name, extra, book in (
            ("packed", ["--packed", str(PACK_Q)],
             "perturbation_results_packed.xlsx"),
            ("k4", ["--decode-k", str(K_DECODE)], "perturbation_results.xlsx"),
            ("k4_loaded", ["--decode-k", str(K_DECODE)],
             "perturbation_results.xlsx")):
        out = os.path.join(workdir, f"cli_{name}")
        _reset_launches(attention)
        stdout, stderr = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            cli.main(argv + ["--output-dir", out] + extra)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        logs[name] = (stdout.getvalue(), stderr.getvalue())
        books[name] = read_xlsx(os.path.join(out, book))[1]
        res = dict(run=name, seconds=elapsed, rows=len(books[name]),
                   rows_per_s=len(books[name]) / elapsed,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   kernel_launches=_launches(attention)[
                       "causal_grouped_attention"],
                   stdout_tail=logs[name][0].splitlines()[-2:],
                   stderr_k_head=[x for x in logs[name][1].splitlines()
                                  if "K-head" in x])
        runs.append(res)
        say("cli", json.dumps(dict(res, card=card)))
        if len(books[name]) != n_rows:
            fails.append(f"cli {name}: {len(books[name])} rows")
        if not res["kernel_launches"] or \
                res["kernel_launches"] % cfg.num_layers:
            fails.append(f"cli {name}: {res['kernel_launches']} causal "
                         f"launches")
    tag = f"local:packed{PACK_Q}:first_token_top{TOP_FILTER}"
    if any(r["Log Probabilities"] != tag for r in books["packed"]):
        fails.append("cli packed: rows without the packed extractor's tag")
    drift = [json.loads(x)["packed_drift"]
             for x in logs["packed"][0].splitlines()
             if x.startswith('{"packed_drift"')]
    if len(drift) != 1 or drift[0]["n_questions"] != n_rows:
        fails.append(f"cli packed: drift lines {drift}")
    if "# K-head distilled" not in logs["k4"][1] or not os.path.exists(
            os.path.join(snap, "k_head.npz")):
        fails.append("cli k4: no K-head distilled and written")
    if "# K-head loaded from snapshot" not in logs["k4_loaded"][1] \
            or "distilled" in logs["k4_loaded"][1]:
        fails.append("cli k4_loaded: the K-head was not loaded")
    if books["k4_loaded"] != books["k4"]:
        fails.append("cli k4_loaded: workbook differs from the first run's")
    cols = ("Token_1_Prob", "Token_2_Prob", "Odds_Ratio")
    for i, (a, b) in enumerate(zip(books["k4"], books["bf16"])):
        if any(a[c] != b[c] for c in cols):
            fails.append(f"cli k4: row {i} position-0 columns differ")
    say("cli packed and K", json.dumps(dict(
        card=card, drift=drift[:1], k4_completions_as_bf16=sum(
            a["Model Response"] == b["Model Response"]
            for a, b in zip(books["k4"], books["bf16"])),
        k4_confidence_as_bf16=sum(
            a["Model Confidence Response"] == b["Model Confidence Response"]
            for a, b in zip(books["k4"], books["bf16"])))))
    return fails


def cli_phase(seed, attention, workdir, card):
    """``python -m llm_interpretation_replication_tpu_torch
    run-perturbation`` in this process, from a snapshot of Falcon-7B's
    published width at SNAPSHOT_LAYERS layers that the phase writes (random
    bf16 weights, a tokenizer in Falcon's published format it learns on the
    scenarios), in bf16 and then
    with int8 weights, int8 KV and chunked prefill."""
    import math

    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios
    from llm_interpretation_replication_tpu_torch.gen.rephrase import (
        load_perturbations)
    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.scoring import yes_no
    from llm_interpretation_replication_tpu_torch.runtime.loader import (
        load_model, load_tokenizer)
    from llm_interpretation_replication_tpu_torch.sweeps import (
        run_model_perturbation_sweep)
    from llm_interpretation_replication_tpu_torch.utils.logging import (
        SessionLogger)
    from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx

    device = "cuda"
    cfg = mconfig.DecoderConfig(**{**mconfig.FALCON_7B_GEOMETRY,
                                   "num_layers": SNAPSHOT_LAYERS},
                                attention_impl="flash")
    weights = convert.random_params(cfg, seed=seed + 2, device=device,
                                    dtype="bf16")
    snap = os.path.join(workdir, "falcon-7b-2l")
    os.makedirs(snap)
    pert = os.path.join(workdir, "perturbations.json")
    scenarios = load_perturbations(pert, expected_scenarios=legal_scenarios())
    texts = [s[k] for s in scenarios for k in ("original_main",
                                                "response_format",
                                                "confidence_format")]
    texts += [" " + t for s in scenarios for t in s["target_tokens"]]
    t0 = time.perf_counter()
    # Falcon's published tokenizer format (its Sequence pre-tokenizer)
    _write_tokenizer_files(snap, _format_tokenizer_files("falcon", texts))
    with open(os.path.join(snap, "config.json"), "w", encoding="utf-8") as f:
        json.dump(_falcon_config_json(cfg), f)
    tokenizer_s = time.perf_counter() - t0
    # the targets score as the ids these weights rank in the top 20 most
    # often (past the tokenizer's vocabulary, which the prompts use)
    snap_tok = load_tokenizer(snap)
    swapped = _swap_embedding_rows(weights, snap_tok, _popular_targets(
        weights, cfg, scenarios, snap_tok, range(len(snap_tok))))
    t0 = time.perf_counter()
    _write_safetensors(os.path.join(snap, "model.safetensors"),
                       _falcon_state_dict(weights.tree(), cfg))
    write_s = time.perf_counter() - t0
    snap_bytes = os.path.getsize(os.path.join(snap, "model.safetensors"))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    family, lcfg, loaded = load_model(snap, dtype="bf16",
                                      attention_impl="flash", device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    fails = []
    if (family, dataclasses.replace(lcfg, fused_qkv=False)) != ("falcon", cfg):
        fails.append(f"loaded config {lcfg}, written {cfg}")
    written = dict(decoder._flatten(weights.tree()))
    got = dict(decoder._flatten(loaded.tree()))
    if written.keys() != got.keys() or not all(
            got[k].dtype == v.dtype and torch.equal(got[k], v)
            for k, v in written.items()):
        fails.append("load_model does not give back the written tensors")
    del weights, written

    counted = {"prefill": 0}
    real_prefill = decoder.prefill

    def counting(*args, **kwargs):
        counted["prefill"] += 1
        return real_prefill(*args, **kwargs)

    n_rows = sum(len(s["rephrasings"]) for s in scenarios)
    runs, books = [], {}
    argv = ["run-perturbation", "--model", snap, "--perturbations", pert,
            "--attention-impl", "flash", "--batch-size", str(BATCH)]
    decoder.prefill = counting
    try:
        for name, extra in (("bf16", []),
                            ("int8", ["--quant", "int8", "--kv-dtype", "int8",
                                      "--prefill-chunk",
                                      str(SWEEP_PREFILL_CHUNK)])):
            out = os.path.join(workdir, f"cli_{name}")
            _reset_launches(attention)
            counted["prefill"] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cli.main(argv + ["--output-dir", out] + extra)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            cols, books[name] = read_xlsx(
                os.path.join(out, "perturbation_results.xlsx"))
            res = dict(run=name, seconds=elapsed, rows=len(books[name]),
                       rows_per_s=len(books[name]) / elapsed,
                       peak_memory_bytes=torch.cuda.max_memory_allocated(),
                       kernel_launches=_launches(attention)[
                           "causal_grouped_attention"],
                       prefills=counted["prefill"])
            runs.append(res)
            say("cli", json.dumps(dict(res, card=card)))
            if len(books[name]) != n_rows:
                fails.append(f"cli {name}: {len(books[name])} rows")
            if not res["prefills"] or res["kernel_launches"] != \
                    cfg.num_layers * res["prefills"]:
                fails.append(f"cli {name}: {res['kernel_launches']} causal "
                             f"launches for {res['prefills']} prefills")
    finally:
        decoder.prefill = real_prefill
    fails += _cli_packed_and_k_runs(cli, argv, snap, workdir, attention, cfg,
                                    n_rows, books, runs, card)

    # the same sweep in this process over the weights load_model gave back
    tok = snap_tok
    engine = emod.ScoringEngine(family, lcfg, loaded, tok, device=device,
                                engine_config=emod.EngineConfig(
                                    batch_size=BATCH))
    out = os.path.join(workdir, "in_process.xlsx")
    run_model_perturbation_sweep(engine, snap, scenarios, out,
                                 log=SessionLogger(stream=io.StringIO()))
    engine.close()
    in_process = read_xlsx(out)[1]
    same = sum(a == b for a, b in zip(books["bf16"], in_process))
    if same != n_rows:
        fails.append(f"cli bf16: {n_rows - same} rows differ from the "
                     f"in-process sweep")

    # int8 against bf16.  The int8 path's own deviation, measured on these
    # prompts by one plain forward with bf16 and with w8a8 weights: of the
    # target logits and the filter's edge (twice it makes the tie), and of
    # the targets' log-probabilities.  On rows whose targets lie clear of
    # the edge by the tie: a target is in the top 20 in both workbooks or
    # in neither; each probability in it within NEAR_TIE_FACTOR times the
    # log-probability deviation (the workbook adds the int8 cache and
    # chunked prefill to it); the relative probability within
    # CLI_INT8_MAX_DREL; the verdict kept unless the two target logits lie
    # within the tie
    _, _, qweights = load_model(snap, dtype="bf16", quant="int8",
                                attention_impl="flash", device=device)
    prompts = [tok(f"{r} {s['response_format']}")["input_ids"]
               for s in scenarios for r in s["rephrasings"]]
    target_ids = np.asarray([yes_no.target_token_ids(tok, s["target_tokens"])
                             for s in scenarios for _ in s["rephrasings"]])
    dev_max = logp_dev = 0.0
    edge, split = np.zeros(n_rows), np.zeros(n_rows)
    for lo in range(0, n_rows, BATCH):
        ids, mask = _padded(prompts[lo:lo + BATCH], device)
        tgt = torch.as_tensor(target_ids[lo:lo + BATCH], device=device)
        a = decoder.forward_last_logits(loaded, lcfg, ids, mask).float()
        b = decoder.forward_last_logits(qweights, lcfg, ids, mask).float()
        kth_a = torch.topk(a, TOP_FILTER).values[:, -1:]
        kth_b = torch.topk(b, TOP_FILTER).values[:, -1:]
        la, lb = a.gather(1, tgt), b.gather(1, tgt)
        dev_max = max(dev_max, float((la - lb).abs().max()),
                      float((kth_a - kth_b).abs().max()))
        logp_dev = max(logp_dev, float(
            (a.log_softmax(-1).gather(1, tgt)
             - b.log_softmax(-1).gather(1, tgt)).abs().max()))
        edge[lo:lo + len(ids)] = (la - kth_a).abs().min(1).values.cpu().numpy()
        split[lo:lo + len(ids)] = (la[:, 0] - la[:, 1]).abs().cpu().numpy()
    del loaded, qweights
    tie, logp_tol = 2 * dev_max, NEAR_TIE_FACTOR * logp_dev

    def rel(row):
        t1, t2 = row["Token_1_Prob"], row["Token_2_Prob"]
        return t1 / (t1 + t2) if t1 + t2 > 0 else 0.5

    worst_rel = worst_logp = 0.0
    flips = near = compared = both = 0
    for i, (a, b) in enumerate(zip(books["int8"], books["bf16"])):
        if edge[i] < tie:
            near += 1
            continue
        inside = 0
        for c in ("Token_1_Prob", "Token_2_Prob"):
            x, y = a[c], b[c]
            if (x > 0) != (y > 0):
                fails.append(f"cli int8: row {i} {c} {x} vs {y}")
            elif x > 0:
                inside += 1
                d = abs(math.log(x) - math.log(y))
                worst_logp = max(worst_logp, d)
                if d > logp_tol:
                    fails.append(f"cli int8: row {i} {c} {x} vs {y}")
        compared += inside > 0
        both += inside == 2
        d = abs(rel(a) - rel(b))
        worst_rel = max(worst_rel, d)
        if d > CLI_INT8_MAX_DREL:
            fails.append(f"cli int8: row {i} relative_prob {rel(a)} vs "
                         f"{rel(b)}")
        if (np.sign(a["Token_1_Prob"] - a["Token_2_Prob"])
                != np.sign(b["Token_1_Prob"] - b["Token_2_Prob"])):
            flips += 1
            if not split[i] < tie:
                fails.append(f"cli int8: row {i} verdict flips")
    if not both:
        fails.append("cli int8: no row away from the edge has both targets "
                     "in the top 20")
    result = dict(card=card, layers=SNAPSHOT_LAYERS, snapshot_bytes=snap_bytes,
                  snapshot_write_s=write_s, tokenizer_build_s=tokenizer_s,
                  tokenizer_vocab=len(tok), snapshot_load_s=load_s, runs=runs,
                  in_process_identical_rows=same,
                  swapped_target_rows=swapped,
                  target_in_top20_share=_target_shares(books["bf16"]),
                  int8=dict(max_abs_delta_relative_prob=worst_rel,
                            max_abs_delta_log_prob=worst_logp,
                            log_prob_tol=logp_tol, verdict_flips=flips,
                            rows_near_the_edge=near,
                            rows_compared_share=compared / n_rows,
                            rows_with_both_targets_share=both / n_rows,
                            logit_deviation=dev_max,
                            log_prob_deviation=logp_dev),
                  failures=fails[:50])
    say("cli gates", json.dumps({k: v for k, v in result.items()
                                 if k != "runs"}))
    if fails:
        raise AssertionError(f"cli: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


# ---------------------------------------------------------------------------
# The 100-question sweep: the GPT-NeoX, BLOOM and LLaMA/Mistral families
# ---------------------------------------------------------------------------

# Published geometries, each the config.json of the model's Hugging Face
# repository (the keys the port's translators read; BLOOM's with its own
# short names)
PYTHIA_6_9B = {   # EleutherAI/pythia-6.9b (databricks/dolly-v2-7b: the same)
    "model_type": "gpt_neox", "vocab_size": 50432, "hidden_size": 4096,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "intermediate_size": 16384, "rotary_pct": 0.25, "rotary_emb_base": 10000,
    "max_position_embeddings": 2048, "use_parallel_residual": True,
    "layer_norm_eps": 1e-5, "hidden_act": "gelu",
    "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 0}
STABLELM_ALPHA_7B = {   # stabilityai/stablelm-base-alpha-7b (and -tuned-)
    "model_type": "gpt_neox", "vocab_size": 50432, "hidden_size": 6144,
    "num_hidden_layers": 16, "num_attention_heads": 48,
    "intermediate_size": 24576, "rotary_pct": 0.25, "rotary_emb_base": 10000,
    "max_position_embeddings": 4096, "use_parallel_residual": True,
    "layer_norm_eps": 1e-5, "hidden_act": "gelu",
    "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 0}
REDPAJAMA_7B = {   # togethercomputer/RedPajama-INCITE-7B-Base (and -Instruct)
    "model_type": "gpt_neox", "vocab_size": 50432, "hidden_size": 4096,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "intermediate_size": 16384, "rotary_pct": 1.0, "rotary_emb_base": 10000,
    "max_position_embeddings": 2048, "use_parallel_residual": False,
    "layer_norm_eps": 1e-5, "hidden_act": "gelu",
    "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 0}
BLOOM_7B1 = {   # bigscience/bloom-7b1 (bigscience/bloomz-7b1: the same)
    "model_type": "bloom", "vocab_size": 250880, "hidden_size": 4096,
    "n_layer": 30, "n_head": 32, "layer_norm_epsilon": 1e-5,
    "apply_residual_connection_post_layernorm": False,
    "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 3}
MISTRAL_7B_V02 = {   # mistralai/Mistral-7B-Instruct-v0.2
    "model_type": "mistral", "vocab_size": 32000, "hidden_size": 4096,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "intermediate_size": 14336,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5,
    "rope_theta": 1000000.0, "sliding_window": None, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2}
MISTRAL_7B_V01 = dict(   # mistralai/Mistral-7B-v0.1
    MISTRAL_7B_V02, rope_theta=10000.0, sliding_window=4096)
# the families phase: (label, model, config, routes); "int8kv" is bf16
# weights with an int8 KV cache, "w8a8-int8kv" int8 weights with one, both
# under the kernel
FAMILY_MODELS = [
    ("pythia-6.9b", "EleutherAI/pythia-6.9b", PYTHIA_6_9B, ("flash", "xla")),
    ("mistral-7b-instruct-v0.2", "mistralai/Mistral-7B-Instruct-v0.2",
     MISTRAL_7B_V02, ("flash", "xla", "int8kv", "w8a8-int8kv")),
    ("bloom-7b1", "bigscience/bloom-7b1", BLOOM_7B1, ("xla",)),
]
# the run-100q CLI phase: each distinct geometry of model_pairs_100q.json at
# SNAPSHOT_LAYERS layers, the models that share it, and its weight format
# (one family as sharded pytorch_model.bin with its index); Mistral-7B-v0.1
# reads v0.2's weights through symlinks beside its own config.json
CLI_SNAPSHOTS = [
    ("tiiuae/falcon-7b", None, ("tiiuae/falcon-7b-instruct",), "safetensors"),
    ("stabilityai/stablelm-base-alpha-7b", STABLELM_ALPHA_7B,
     ("stabilityai/stablelm-tuned-alpha-7b",), "safetensors"),
    ("togethercomputer/RedPajama-INCITE-7B-Base", REDPAJAMA_7B,
     ("togethercomputer/RedPajama-INCITE-7B-Instruct",), "safetensors"),
    ("bigscience/bloom-7b1", BLOOM_7B1, ("bigscience/bloomz-7b1",), "bin"),
    ("EleutherAI/pythia-6.9b", PYTHIA_6_9B, ("databricks/dolly-v2-7b",),
     "safetensors"),
    ("mistralai/Mistral-7B-Instruct-v0.2", MISTRAL_7B_V02, (), "safetensors"),
]
# the run-100q snapshots written in their published tokenizer format
# (``TOKENIZER_FORMATS``; Mistral-7B-v0.1 reads v0.2's files, the models
# sharing a geometry its directory); the NeoX ones are byte-level BPE
CLI_TOKENIZERS = {"tiiuae/falcon-7b": "falcon", "bigscience/bloom-7b1": "bloom",
                  "mistralai/Mistral-7B-Instruct-v0.2": "llama"}
# models of the CLI phase that must run dense under --attention-impl flash
CLI_DENSE = {"bigscience/bloom-7b1", "bigscience/bloomz-7b1",
             "mistralai/Mistral-7B-v0.1"}
SCAN_STEPS = 10          # the look-ahead the yes/no scan reads
FAMILY_LAYERS = 8        # the families and instruct decoders' depth (of
#                          their 24-32 layers)

# ---------------------------------------------------------------------------
# The instruct roster: T5, Qwen-1, Baichuan2 and OPT
# ---------------------------------------------------------------------------

# Published geometries (each model's config.json; the T5 ones with the
# activation keys transformers writes beside feed_forward_proj)
T0_3B = {   # bigscience/T0_3B (allenai/tk-instruct-3b-def: the same)
    "model_type": "t5", "vocab_size": 32128, "d_model": 2048, "d_kv": 64,
    "d_ff": 5120, "num_layers": 24, "num_decoder_layers": 24,
    "num_heads": 32, "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
    "feed_forward_proj": "gated-gelu", "dense_act_fn": "gelu_new",
    "is_gated_act": True, "tie_word_embeddings": False,
    "decoder_start_token_id": 0, "eos_token_id": 1, "pad_token_id": 0}
T5_V1_1_BASE = dict(   # google/t5-v1_1-base (google/flan-t5-base: the same)
    T0_3B, d_model=768, d_ff=2048, num_layers=12, num_decoder_layers=12,
    num_heads=12)
QWEN_7B_CHAT = {   # Qwen/Qwen-7B-Chat
    "model_type": "qwen", "vocab_size": 151936, "hidden_size": 4096,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "intermediate_size": 22016, "kv_channels": 128,
    "layer_norm_epsilon": 1e-6, "max_position_embeddings": 8192,
    "seq_length": 8192, "rotary_emb_base": 10000, "rotary_pct": 1.0,
    "tie_word_embeddings": False}
BAICHUAN2_7B_CHAT = {   # baichuan-inc/Baichuan2-7B-Chat
    "model_type": "baichuan", "vocab_size": 125696, "hidden_size": 4096,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "intermediate_size": 11008, "max_position_embeddings": 4096,
    "model_max_length": 4096, "rms_norm_eps": 1e-6, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
    "pad_token_id": 0}
OPT_IML_1_3B = {   # facebook/opt-iml-1.3b
    "model_type": "opt", "vocab_size": 50272, "hidden_size": 2048,
    "num_hidden_layers": 24, "num_attention_heads": 32, "ffn_dim": 8192,
    "max_position_embeddings": 2048, "activation_function": "relu",
    "do_layer_norm_before": True, "word_embed_proj_dim": 2048,
    "bos_token_id": 2, "eos_token_id": 2, "pad_token_id": 1}
H2OGPT_12B = {   # h2oai/h2ogpt-oasst1-512-12b (GPT-NeoX, Pythia-12B's shape)
    "model_type": "gpt_neox", "vocab_size": 50688, "hidden_size": 5120,
    "num_hidden_layers": 36, "num_attention_heads": 40,
    "intermediate_size": 20480, "rotary_pct": 0.25, "rotary_emb_base": 10000,
    "max_position_embeddings": 2048, "use_parallel_residual": True,
    "layer_norm_eps": 1e-5, "hidden_act": "gelu",
    "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 0}
MISTRAL_7B_V03 = dict(   # mistralai/Mistral-7B-Instruct-v0.3
    MISTRAL_7B_V02, vocab_size=32768)
# the instruct phase's decoder models, at FAMILY_LAYERS of their layers, on
# the causal kernel and dense
INSTRUCT_DECODERS = [
    ("qwen-7b-chat", "Qwen/Qwen-7B-Chat", QWEN_7B_CHAT, ("flash", "xla")),
    ("baichuan2-7b-chat", "baichuan-inc/Baichuan2-7B-Chat", BAICHUAN2_7B_CHAT,
     ("flash", "xla")),
    ("opt-iml-1.3b", "facebook/opt-iml-1.3b", OPT_IML_1_3B, ("flash", "xla")),
]
# the word-meaning sweep's T5 pair
T5_PAIR = {"base": "google/t5-v1_1-base", "instruct": "google/flan-t5-base"}
# the run-instruct-sweep CLI phase: each roster geometry the run-100q
# phase did not write (model, config, models sharing it, tokenizer format)
INSTRUCT_SNAPSHOTS = [
    ("allenai/tk-instruct-3b-def", T0_3B, ("bigscience/T0_3B",), "t5"),
    ("baichuan-inc/Baichuan2-7B-Chat", BAICHUAN2_7B_CHAT, (), "bpe"),
    ("facebook/opt-iml-1.3b", OPT_IML_1_3B, (), "gpt2"),
    ("h2oai/h2ogpt-oasst1-512-12b", H2OGPT_12B, (), "bpe"),
    ("mistralai/Mistral-7B-Instruct-v0.3", MISTRAL_7B_V03, (), "mistral_v03"),
    ("Qwen/Qwen-7B-Chat", QWEN_7B_CHAT, (), "tiktoken"),
]
# the run-100q phase's snapshots the instruct roster reads again
INSTRUCT_REUSED = ("tiiuae--falcon-7b", "tiiuae--falcon-7b-instruct",
                   "bigscience--bloom-7b1", "bigscience--bloomz-7b1",
                   "togethercomputer--RedPajama-INCITE-7B-Base",
                   "togethercomputer--RedPajama-INCITE-7B-Instruct")
# roster models that run dense under --attention-impl flash
INSTRUCT_DENSE = {"bigscience/bloomz-7b1", "bigscience/T0_3B",
                  "allenai/tk-instruct-3b-def"}


def _hf_state_dict(family, cfg, seed, device, dtype):
    """A random checkpoint of ``cfg`` under the HF tensor names the port's
    converter of ``family`` reads (torch ``Linear`` weights ``[out, in]``;
    NeoX and BLOOM fuse QKV as rows ``[q; k; v]`` per head, Qwen's
    ``c_attn`` and Baichuan's ``W_pack`` as ``[q; k; v]`` whole, Qwen's MLP
    is half its config's ``intermediate_size``; OPT ties its head and
    stores positions with the +2 offset), made on ``device``: projections,
    embeddings and linear biases N(0, 0.02^2), norm scales 1 and norm
    biases 0."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, n, g, d = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f, v = cfg.intermediate_size, cfg.vocab_size

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(0.02)

    def norm(name, bias=True):
        sd[name + ".weight"] = torch.ones(h, device=device, dtype=dtype)
        if bias:
            sd[name + ".bias"] = torch.zeros(h, device=device, dtype=dtype)

    def linear(name, out, inp, bias=True):
        sd[name + ".weight"] = rnd(out, inp)
        if bias:
            sd[name + ".bias"] = rnd(out)

    sd = {}
    if family in ("neox", "bloom"):
        pre = "gpt_neox.layers" if family == "neox" else "transformer.h"
        attn = "attention" if family == "neox" else "self_attention"
        if family == "neox":
            sd["gpt_neox.embed_in.weight"] = rnd(v, h)
        else:
            sd["transformer.word_embeddings.weight"] = rnd(v, h)
            norm("transformer.word_embeddings_layernorm")
        for i in range(cfg.num_layers):
            norm(f"{pre}.{i}.input_layernorm")
            norm(f"{pre}.{i}.post_attention_layernorm")
            linear(f"{pre}.{i}.{attn}.query_key_value", 3 * n * d, h)
            linear(f"{pre}.{i}.{attn}.dense", h, n * d)
            linear(f"{pre}.{i}.mlp.dense_h_to_4h", f, h)
            linear(f"{pre}.{i}.mlp.dense_4h_to_h", h, f)
        if family == "neox":
            norm("gpt_neox.final_layer_norm")
            sd["embed_out.weight"] = rnd(v, h)
        else:
            norm("transformer.ln_f")
    elif family == "llama":
        sd["model.embed_tokens.weight"] = rnd(v, h)
        for i in range(cfg.num_layers):
            pre = f"model.layers.{i}"
            norm(f"{pre}.input_layernorm", bias=False)
            norm(f"{pre}.post_attention_layernorm", bias=False)
            for name, out, inp in (("q", n * d, h), ("k", g * d, h),
                                   ("v", g * d, h), ("o", h, n * d)):
                linear(f"{pre}.self_attn.{name}_proj", out, inp, bias=False)
            for name, out, inp in (("gate", f, h), ("up", f, h),
                                   ("down", h, f)):
                linear(f"{pre}.mlp.{name}_proj", out, inp, bias=False)
        norm("model.norm", bias=False)
        sd["lm_head.weight"] = rnd(v, h)
    elif family in ("qwen", "baichuan"):
        qwen = family == "qwen"
        emb = "transformer.wte" if qwen else "model.embed_tokens"
        sd[emb + ".weight"] = rnd(v, h)
        for i in range(cfg.num_layers):
            if qwen:
                pre = f"transformer.h.{i}"
                norm(f"{pre}.ln_1", bias=False)
                norm(f"{pre}.ln_2", bias=False)
                linear(f"{pre}.attn.c_attn", 3 * n * d, h)
                linear(f"{pre}.attn.c_proj", h, n * d, bias=False)
                for name, out, inp in (("w1", f, h), ("w2", f, h),
                                       ("c_proj", h, f)):
                    linear(f"{pre}.mlp.{name}", out, inp, bias=False)
                continue
            pre = f"model.layers.{i}"
            norm(f"{pre}.input_layernorm", bias=False)
            norm(f"{pre}.post_attention_layernorm", bias=False)
            linear(f"{pre}.self_attn.W_pack", 3 * n * d, h, bias=False)
            linear(f"{pre}.self_attn.o_proj", h, n * d, bias=False)
            for name, out, inp in (("gate", f, h), ("up", f, h),
                                   ("down", h, f)):
                linear(f"{pre}.mlp.{name}_proj", out, inp, bias=False)
        norm("transformer.ln_f" if qwen else "model.norm", bias=False)
        sd["lm_head.weight"] = rnd(v, h)
    elif family == "opt":
        pre = "model.decoder"
        sd[f"{pre}.embed_tokens.weight"] = rnd(v, h)
        sd[f"{pre}.embed_positions.weight"] = rnd(
            cfg.max_position_embeddings + cfg.learned_pos_offset, h)
        for i in range(cfg.num_layers):
            lay = f"{pre}.layers.{i}"
            norm(f"{lay}.self_attn_layer_norm")
            norm(f"{lay}.final_layer_norm")
            for name in ("q", "k", "v"):
                linear(f"{lay}.self_attn.{name}_proj", n * d, h)
            linear(f"{lay}.self_attn.out_proj", h, n * d)
            linear(f"{lay}.fc1", f, h)
            linear(f"{lay}.fc2", h, f)
        norm(f"{pre}.final_layer_norm")
    else:
        raise ValueError(f"no writer for family {family!r}")
    return sd


def _family_config(config, layers=None):
    """(family, DecoderConfig) of a published ``config.json`` dict, at
    ``layers`` layers when given."""
    import types

    from llm_interpretation_replication_tpu_torch.models import config as mconfig

    return mconfig.from_hf_config(
        types.SimpleNamespace(**_at_depth(config, layers)))


def _at_depth(config, layers):
    if layers is None:
        return dict(config)
    key = "n_layer" if "n_layer" in config else "num_hidden_layers"
    return {**config, key: layers}


def _question_tokenizer():
    """A ``WordTokenizer`` over the words of the 100 questions and both
    prompt formats, whose decode writes every id ``i`` as the word
    ``" t<i>"`` (each generated token one word of a completion)."""
    from llm_interpretation_replication_tpu_torch.config import (
        ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.scoring import prompts
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        WordTokenizer)

    class QuestionTokenizer(WordTokenizer):
        def decode(self, ids, skip_special_tokens=False):
            return "".join(f" t{int(i)}" for i in ids)

    words = (prompts.FEW_SHOT_PREFIX + " " + prompts.ANSWER_INSTRUCTION + " "
             + " ".join(ordinary_meaning_questions())).split()
    return QuestionTokenizer(words + ["Yes", "No", "<human>:", "<bot>:"])


def _boost_target_columns(weights, cfg, prompts, target_ids,
                          factors=(1.0, 1.5, 2.0, 3.0, 4.0)):
    """Scale, in place, the output columns of the two target ids (an
    untied head's, else the embedding rows) by the smallest of ``factors``
    that puts each target in the top TOP_FILTER of one forward at half of
    ``prompts`` or more (a wide vocabulary leaves even the most popular
    ids in few rows' top 20, and the position-0 gates would then compare
    few rows).  Returns (factor, each target's top-20 share)."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    tree, dev = weights.tree(), _device_of(weights)
    ids = list(target_ids[0])
    table = tree.get("lm_head")
    orig = (table[:, ids] if table is not None
            else tree["embed"]["tokens"][ids]).clone()
    for factor in factors:
        with torch.no_grad():
            if table is not None:
                table[:, ids] = (orig.float() * factor).to(table.dtype)
            else:
                emb = tree["embed"]["tokens"]
                emb[ids] = (orig.float() * factor).to(emb.dtype)
        hits = []
        for lo in range(0, len(prompts), BATCH):
            logits = decoder.forward_last_logits(
                weights, cfg, *_padded(prompts[lo:lo + BATCH], dev))
            kth = torch.topk(logits, TOP_FILTER).values[:, -1:]
            hits.append((logits[:, ids] >= kth).cpu())
        share = torch.cat(hits).float().mean(0).tolist()
        if min(share) >= 0.5:
            break
    return factor, share


def _question_prompts(tok):
    """The sweep's 200 prompts (100 base, then 100 instruct) as the engine
    sees them: ``(prefix, suffix)`` pairs tokenized as ``score_prefixed``
    tokenizes them, prefix and suffix ids joined."""
    from llm_interpretation_replication_tpu_torch.config import (
        ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.scoring import prompts

    pairs = [prompts.format_prompt_parts(q, base)
             for base in (True, False) for q in ordinary_meaning_questions()]
    pre, suf = batching.encode_prefix_pairs(tok, [(p, (s,)) for p, s in pairs])
    return [a + b for a, b in zip(pre, suf[0])], [len(a) for a in pre]


def _popular_ids(weights, cfg, prompts, tok, n=2, batch=BATCH):
    """The ``n`` ids past the tokenizer's vocabulary that random weights
    most often rank in the top 20 of one forward over ``prompts``."""
    from collections import Counter

    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    counts = Counter()
    for lo in range(0, len(prompts), batch):
        ids, mask = _padded(prompts[lo:lo + batch], _device_of(weights))
        top = torch.topk(decoder.forward_last_logits(weights, cfg, ids, mask),
                         TOP_FILTER).indices.cpu().tolist()
        for row in top:
            counts.update(i for i in row if i >= len(tok))
    return [i for i, _ in counts.most_common(n)]


def _teacher_scan(weights, cfg, prompts, continuations, target_ids,
                  steps=SCAN_STEPS, top_k=5, batch=BATCH):
    """From one forward over each prompt and its continuation: the top-1
    lead at every step ``[N, L + 1]`` (``_teacher_top1``'s), and over the
    first ``steps`` steps each step's distance of the nearer target logit
    from the ``top_k``-th largest and the two targets' logit gap ``[N,
    steps]`` (NaN past a row's continuation)."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    tree, dev = decoder._tree(weights), _device_of(weights)
    n = len(prompts)
    width = max(max(map(len, continuations)) + 1, steps)
    leads = np.full((n, width), np.nan, np.float32)
    edge = np.full((n, steps), np.nan, np.float32)
    split = np.full((n, steps), np.nan, np.float32)
    for lo in range(0, n, batch):
        seqs = [list(p) + list(c) for p, c in
                zip(prompts[lo:lo + batch], continuations[lo:lo + batch])]
        ids, mask = _padded(seqs, dev)
        starts = torch.as_tensor([len(p) - 1 for p in prompts[lo:lo + batch]])
        pos = (starts[:, None] + torch.arange(width)).clamp(
            max=ids.shape[1] - 1).to(dev)
        x, _ = decoder._trunk(tree, cfg, ids, mask)
        logits = decoder._unembed(cfg, tree, x[torch.arange(
            len(seqs), device=dev)[:, None], pos])
        top2 = torch.topk(logits, 2, dim=-1).values.cpu().numpy()
        kth = torch.topk(logits[:, :steps], top_k, dim=-1).values[..., -1:]
        tgt = torch.as_tensor(np.asarray(target_ids[lo:lo + batch]),
                              device=dev)[:, None, :].expand(-1, steps, -1)
        tl = logits[:, :steps].gather(2, tgt)
        e = (tl - kth).abs().min(2).values.cpu().numpy()
        sp = (tl[..., 0] - tl[..., 1]).abs().cpu().numpy()
        for i in range(len(seqs)):
            k = len(continuations[lo + i]) + 1
            leads[lo + i, :k] = top2[i, :k, 0] - top2[i, :k, 1]
            edge[lo + i, :min(k, steps)] = e[i, :k]
            split[lo + i, :min(k, steps)] = sp[i, :k]
        del x, logits
    return leads, edge, split


class _Recorder:
    """An engine that keeps the rows each ``score_prompts`` call returns
    (the sweep keeps only the CSV's fields) and delegates everything
    else."""

    def __init__(self, engine):
        self._engine, self.rows = engine, []

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def score_prompts(self, *args, **kwargs):
        rows = self._engine.score_prompts(*args, **kwargs)
        self.rows += rows
        return rows


def _family_kernel_row(attention, label, gen, b, s, n, g, d, lengths):
    """The causal kernel at one prefill shape of a family (ragged
    ``lengths`` of the phase's batch), causal, as the kernel phase takes
    it."""
    import torch

    q, k, v, _ = _inputs(gen, b, s, n, g, d, "bsnd")
    lengths = torch.as_tensor(lengths, device=q.device, dtype=torch.int32)
    return _kernel_rows(attention, "causal_grouped_attention", "bsnd", label,
                        g, q, k, v, lengths, (True,))[0]


def _verdict(row):
    return (row["scan_found"], row["yes_prob"] > row["no_prob"])


def _parting(a, b):
    """The first step (word) at which two completions differ, or None."""
    wa, wb = a.split(), b.split()
    n = min(len(wa), len(wb))
    part = next((j for j in range(n) if wa[j] != wb[j]), None)
    if part is None and len(wa) != len(wb):
        part = n
    return part


def _compare_family_rows(what, rows, ref, leads, edge, split, tie, p32,
                         clear, pos0_tol):
    """Hold one route's rows against the reference route's.  Completions
    may part only at a step where the reference's lead is below ``tie``;
    a verdict (scan hit, yes over no) may differ only on a row where, at
    a step the scan reads before the two part, a target logit lies within
    ``tie`` of the top-5 edge or the two target logits within ``tie`` of
    each other.  The position-0 fields of ``rows`` lie within ``pos0_tol``
    of the float32 forward's (``p32`` ``[N, 2]``) on the ``clear`` rows.
    Returns (stats, failures)."""
    import numpy as np

    fails, parted, flips = [], [], 0
    worst_pos0 = worst_rel = 0.0
    for i, (a, b) in enumerate(zip(rows, ref)):
        if not (a["success"] and b["success"]):
            fails.append(f"row {i} failed")
            continue
        if clear[i]:
            for j, f in enumerate(("first_token_yes_prob",
                                   "first_token_no_prob")):
                d = abs(a[f] - float(p32[i, j]))
                worst_pos0 = max(worst_pos0, d)
                if d > pos0_tol:
                    fails.append(f"row {i} {f} {a[f]} vs float32 {p32[i, j]}")
        part = _parting(a["completion"], b["completion"])
        if part is not None:
            gap = float(leads[i, part]) if part < leads.shape[1] else np.inf
            parted.append(gap)
            if not gap < tie:
                fails.append(f"row {i} parts at step {part} (lead {gap}): "
                             f"{a['completion']!r} vs {b['completion']!r}")
        seen = SCAN_STEPS if part is None else min(part + 1, SCAN_STEPS)
        near = bool(np.nanmin(edge[i, :seen]) < tie
                    or np.nanmin(split[i, :seen]) < tie)
        if _verdict(a) != _verdict(b):
            flips += 1
            if not near and (part is None or part >= SCAN_STEPS):
                fails.append(f"row {i} verdict {_verdict(a)} vs "
                             f"{_verdict(b)}")
        elif not near and (part is None or part >= SCAN_STEPS):
            worst_rel = max(worst_rel, abs(a["relative_prob"]
                                           - b["relative_prob"]))
    stats = dict(parted_rows=len(parted), verdict_flips=flips,
                 widest_lead_where_parted=max(parted, default=None),
                 max_abs_delta_position0_vs_fp32=worst_pos0,
                 max_abs_delta_relative_prob_clear=worst_rel)
    return stats, [f"{what}: {f}" for f in fails]


def families_phase(seed, attention, card, instruct=False):
    """Pythia-6.9B, Mistral-7B-Instruct-v0.2 and BLOOM-7b1 at their
    published width (random bf16 weights from ``seed``, made as a HF
    checkpoint and read through the port's converter; FAMILY_LAYERS of
    their layers) score the 100 questions as base (the few-shot prefix
    through ``score_prefixed``) and as instruct, through the sweep's
    per-model call, on each route; then the gates of
    ``_compare_family_rows``, and w8a8 with an int8 KV cache against bf16
    for Mistral.  With ``instruct``, INSTRUCT_DECODERS score the 100
    instruct prompts (each model's own format) through the instruct
    sweep's per-model call instead, their targets' columns
    scaled until the targets sit in most rows' top 20
    (``_boost_target_columns``), and the causal kernel is timed at each
    model's longest prompt batch."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.config import (
        ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.ops import quant as qops
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.scoring import yes_no
    from llm_interpretation_replication_tpu_torch.scoring.prompts import (
        format_prompt)
    from llm_interpretation_replication_tpu_torch.sweeps import (
        instruct_sweep, run_model_on_prompts)

    device = "cuda"
    phase, models = (("instruct", INSTRUCT_DECODERS) if instruct
                     else ("families", FAMILY_MODELS))
    questions = ordinary_meaning_questions()
    tok = _question_tokenizer()
    if not instruct:
        prompts, prefix_lens = _question_prompts(tok)
    ecfg = emod.EngineConfig(batch_size=BATCH)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 11)
    results, kernel_rows, fails = [], [], []
    counted = {"prefill": 0}
    real_prefill = decoder.prefill

    def counting(*args, **kwargs):
        counted["prefill"] += 1
        return real_prefill(*args, **kwargs)

    for mi, (label, model, config, routes) in enumerate(models):
        family, cfg = _family_config(config, FAMILY_LAYERS)
        dense = dataclasses.replace(cfg, attention_impl="xla")
        if instruct:
            prompts = [tok(format_prompt(q, False, model)).input_ids
                       for q in questions]
            prefix_lens = None
        target_ids = [yes_no.target_token_ids(tok, ["Yes", "No"])] * len(prompts)
        t0 = time.perf_counter()
        sd = _hf_state_dict(family, cfg, seed + (60 if instruct else 20) + mi,
                            device, torch.bfloat16)
        tree = convert.CONVERTERS[family](sd.__getitem__, cfg)
        del sd
        weights = decoder.DecoderWeights(dense, tree)
        del tree
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        make_s = time.perf_counter() - t0
        swapped = _swap_embedding_rows(weights, tok, dict(zip(
            (" Yes", " No"), _popular_ids(weights, dense, prompts, tok))))
        boost = _boost_target_columns(weights, dense, prompts,
                                      target_ids) if instruct else None
        # the rounding of these weights: two bf16 computations of the same
        # top-1 logits (the tie), and one bf16 forward's position-0 target
        # probabilities against a float32 one
        batches = list(batching.batches_for_prompts(
            prompts, BATCH, ecfg.buckets, pad_id=tok.pad_token_id,
            length_sorted=True))
        tokens, _, top1, _, _, _ = _study_prepass(
            weights, dense, batches, len(prompts), SCAN_STEPS,
            ecfg.scan_chunk, tok.eos_token_id, target_ids)
        top1_diff = np.abs(_teacher_top1(weights, dense, prompts,
                                         tokens.tolist())[0][:, :-1] - top1)
        tie = 2 * NEAR_TIE_FACTOR * float(top1_diff.max())
        ref_w = decoder.DecoderWeights(dense, _to_float32(weights.tree()))
        p16, p32, edge0 = [], [], []
        for lo in range(0, len(prompts), BATCH):
            ids, mask = _padded(prompts[lo:lo + BATCH], device)
            tgt = torch.as_tensor(target_ids[lo:lo + BATCH], device=device)
            a = decoder.forward_last_logits(weights, dense, ids, mask)
            r = decoder.forward_last_logits(ref_w, dense, ids, mask)
            kth = torch.topk(r, TOP_FILTER).values[:, -1:]
            edge0.append((r.gather(1, tgt) - kth).abs().min(1).values.cpu())
            p16.append(_filtered_target_probs(a, tgt).cpu())
            p32.append(_filtered_target_probs(r, tgt).cpu())
        del ref_w
        torch.cuda.empty_cache()
        clear = torch.cat(edge0).numpy() >= tie
        p16, p32 = torch.cat(p16).numpy(), torch.cat(p32).numpy()
        dev16 = float(np.abs(p16 - p32)[clear].max(initial=0.0))
        pos0_tol = 2 * dev16
        rounding = dict(top1_max_abs_diff=float(top1_diff.max()), tie=tie,
                        position0_bf16_vs_fp32=dev16,
                        rows_clear_of_edge=int(clear.sum()))

        runs, rows_by = [], {}
        for route in routes:
            rcfg = dataclasses.replace(
                cfg, attention_impl="xla" if route == "xla" else "flash")
            rweights = weights
            rcfg_e = ecfg
            if route.startswith("w8a8"):
                rweights = decoder.DecoderWeights(
                    rcfg, qops.quantize_decoder_params(weights.tree()))
            if route.endswith("int8kv"):
                rcfg_e = dataclasses.replace(ecfg, kv_dtype="int8")
            engine = _Recorder(emod.ScoringEngine(
                family, rcfg, rweights, tok, engine_config=rcfg_e,
                device=device))
            engine.score_prompts([("a b", " c")])       # warm-up, not counted
            engine.rows = []
            _reset_launches(attention)
            counted["prefill"] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            decoder.prefill = counting
            try:
                t0 = time.perf_counter()
                if instruct:
                    csv_rows = list(instruct_sweep._score_model(
                        engine, model, questions, False).values())
                else:
                    csv_rows = []
                    for base in (True, False):
                        csv_rows += run_model_on_prompts(engine, model,
                                                         questions, base)
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
            finally:
                decoder.prefill = real_prefill
            launches = _launches(attention)["causal_grouped_attention"]
            # one prefill of the longest base prefix+suffix batch, timed
            longest = max(batches, key=lambda bt: bt.bucket_len)
            ids = torch.as_tensor(longest.token_ids, device=device).long()
            mask = torch.as_tensor(longest.attention_mask, device=device)
            kcfg = dataclasses.replace(rcfg, kv_cache_dtype=rcfg_e.kv_dtype)
            prefill_ms = time_ms(lambda: decoder.prefill(
                rweights, kcfg, ids, mask, longest.bucket_len), iters=3,
                warmup=1)
            # ms a look-ahead step: one scan chunk from that prefill's cache
            last, cache = decoder.prefill(rweights, kcfg, ids, mask,
                                          longest.bucket_len)
            tgt = torch.as_tensor([target_ids[0]] * ids.shape[0],
                                  device=device)
            step_ms = time_ms(lambda: decoder.decode_steps(
                rweights, kcfg, cache, last, mask.sum(-1), 0, ecfg.scan_chunk,
                None, None, with_scores="reduced", target_ids=tgt),
                iters=2, warmup=1) / ecfg.scan_chunk
            del last, cache
            res = dict(model=label, route=route, rows=len(csv_rows),
                       seconds=elapsed, rows_per_s=len(csv_rows) / elapsed,
                       prefills=counted["prefill"], kernel_launches=launches,
                       prefill_ms_bucket=[longest.bucket_len, prefill_ms],
                       decode_ms_per_step=step_ms,
                       peak_memory_bytes=torch.cuda.max_memory_allocated(),
                       success_rows=sum(bool(r["success"]) for r in csv_rows),
                       scan_found_rows=sum(r["scan_found"]
                                           for r in engine.rows),
                       target_in_top20_share=[
                           sum(r[f] > 0 for r in engine.rows) / len(prompts)
                           for f in ("first_token_yes_prob",
                                     "first_token_no_prob")])
            runs.append(res)
            say(phase, json.dumps(dict(res, card=card)))
            if res["success_rows"] != len(prompts) or len(engine.rows) != \
                    len(prompts):
                fails.append(f"{label} {route}: {res['success_rows']} rows "
                             f"with success of {len(prompts)}")
            want = cfg.num_layers * counted["prefill"] if route != "xla" else 0
            if launches != want or (route != "xla" and not launches):
                fails.append(f"{label} {route}: {launches} causal launches "
                             f"for {counted['prefill']} prefills")
            rows_by[route] = engine.rows
            engine._engine.close()
            del engine, rweights
            torch.cuda.empty_cache()

        # gates, against the dense route (or itself) and float32
        ref_route = "xla"
        ref_rows = rows_by[ref_route]
        leads, edge, split = _teacher_scan(
            weights, dense, prompts,
            [_completion_ids(r["completion"]) for r in ref_rows], target_ids)
        gates = {}
        for route in ("flash", "xla"):
            if route not in routes:
                continue
            stats, f = _compare_family_rows(
                f"{label} {route}", rows_by[route], ref_rows, leads, edge,
                split, tie, p32, clear, pos0_tol)
            gates[route] = stats
            fails += f
        for route in ("int8kv", "w8a8-int8kv"):
            if route not in routes:
                continue
            kv8 = dataclasses.replace(dense, kv_cache_dtype="int8")
            qweights = decoder.DecoderWeights(
                kv8, qops.quantize_decoder_params(weights.tree())) \
                if route.startswith("w8a8") else weights
            gates[route] = _quantized_route_gate(
                f"{label} {route}", rows_by[route], rows_by["flash"],
                [(weights, dense), (qweights, kv8)], prompts, prefix_lens,
                target_ids, fails)
            if route.startswith("w8a8"):
                gates[route]["fake_quant"] = _fake_quant_witness(
                    f"{label} {route}", weights, qweights, kv8, prompts,
                    prefix_lens, target_ids, fails)
            del qweights
        # the causal kernel at this family's prefix-prefill shape (the
        # longest prompt batch's, for instruct prompts)
        if "flash" in routes:
            if instruct:
                bt = max(batches, key=lambda b: (b.bucket_len,
                                                 int((b.indices >= 0).sum())))
            else:
                pre = [p[:n] for p, n in zip(prompts, prefix_lens)]
                bt = next(iter(batching.batches_for_prompts(
                    pre[:BATCH], BATCH, ecfg.buckets, pad_id=tok.pad_token_id,
                    length_sorted=True)))
            kernel_rows.append(_family_kernel_row(
                attention, label, gen, BATCH, bt.bucket_len, cfg.num_heads,
                cfg.num_kv_heads, cfg.head_dim,
                bt.attention_mask.sum(-1).tolist()))
        result = dict(model=label, hf_name=model, family=family,
                      layers=cfg.num_layers, width=cfg.hidden_size,
                      heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
                      vocab=cfg.vocab_size, weights_s=make_s,
                      swapped_target_rows=swapped, target_boost=boost,
                      rounding=rounding, runs=runs, gates=gates, card=card)
        say(f"{phase} gates", json.dumps({k: v for k, v in result.items()
                                          if k != "runs"}))
        results.append(result)
        del weights
        torch.cuda.empty_cache()
    if not instruct:
        # StableLM-alpha-7B's head shape (48 heads of 128) at the same
        # prefix shape: its model runs only in the CLI phase, at 2 layers
        fam, scfg = _family_config(STABLELM_ALPHA_7B)
        kernel_rows.append(_family_kernel_row(
            attention, "stablelm-alpha-7b", gen, BATCH, kernel_rows[0]["S"],
            scfg.num_heads, scfg.num_kv_heads, scfg.head_dim,
            [kernel_rows[0]["S"]] * BATCH))
    if fails:
        raise AssertionError(f"{phase}: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return dict(models=results, kernel_rows=kernel_rows,
                runs=[r for m in results for r in m["runs"]])


def _quantized_route_gate(label, rows, ref, paths, prompts, prefix_lens,
                          target_ids, fails):
    """A quantized route's rows (an int8 KV cache, w8a8 weights) against
    the bf16 rows, with the route's own deviation on these weights: each
    row's position-0 logits computed as the sweep computes them (the
    prefix prefilled, the suffix extended over its cache) on both
    ``paths`` (``[(weights, cfg), (weights, cfg)]``, bf16 first), of the
    target logits and the top-5 edge (twice it makes the tie) and of the
    targets' log-probabilities.  On the rows both runs read at position 0
    whose targets lie clear of the edge and of each other by the tie: the
    same verdict, and each target's log-probability within
    NEAR_TIE_FACTOR times the deviation.  |d relative_prob| is reported
    against INT8_KV_MAX_DREL, ROADMAP.md's int8 KV class."""
    import math

    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    dev = _device_of(paths[0][0])
    dev_max = logp_dev = 0.0
    edge, split = [], []
    for lo in range(0, len(prompts), BATCH):
        part = list(zip(prompts[lo:lo + BATCH], prefix_lens[lo:lo + BATCH]))
        pre_ids, pre_mask = _padded([p[:n] for p, n in part], dev)
        suf_ids, suf_mask = _padded([p[n:] for p, n in part], dev)
        tgt = torch.as_tensor(target_ids[lo:lo + BATCH], device=dev)
        a, b = (decoder.extend_prefill(
            w, c, decoder.prefill(w, c, pre_ids, pre_mask, pre_ids.shape[1])[1],
            suf_ids, suf_mask, pre_mask.sum(-1))[0] for w, c in paths)
        ka, kb = (torch.topk(x, 5).values[:, -1:] for x in (a, b))
        la, lb = a.gather(1, tgt), b.gather(1, tgt)
        dev_max = max(dev_max, float((la - lb).abs().max()),
                      float((ka - kb).abs().max()))
        logp_dev = max(logp_dev, float(
            (a.log_softmax(-1).gather(1, tgt)
             - b.log_softmax(-1).gather(1, tgt)).abs().max()))
        edge.append((la - ka).abs().min(1).values.cpu())
        split.append((la[:, 0] - la[:, 1]).abs().cpu())
    tie, logp_tol = 2 * dev_max, NEAR_TIE_FACTOR * logp_dev
    edge, split = torch.cat(edge).numpy(), torch.cat(split).numpy()
    worst_logp = worst_rel = worst_rel0 = 0.0
    compared = at0 = 0
    for i, (a, b) in enumerate(zip(rows, ref)):
        if not (_read_at_position0(a) and _read_at_position0(b)):
            continue
        at0 += 1
        d_rel = abs(a["relative_prob"] - b["relative_prob"])
        worst_rel0 = max(worst_rel0, d_rel)
        if edge[i] < tie or split[i] < tie:
            continue
        compared += 1
        worst_rel = max(worst_rel, d_rel)
        for f in ("yes_prob", "no_prob"):
            d = abs(math.log(max(a[f], 1e-300)) - math.log(max(b[f], 1e-300)))
            worst_logp = max(worst_logp, d)
            if d > logp_tol:
                fails.append(f"{label}: row {i} {f} {a[f]} vs {b[f]}")
        if _verdict(a) != _verdict(b):
            fails.append(f"{label}: row {i} verdict {_verdict(a)} vs "
                         f"{_verdict(b)}")
    if not compared:
        fails.append(f"{label}: no row compared")
    return dict(rows_compared=compared, max_abs_delta_log_prob=worst_logp,
                log_prob_tol=logp_tol, logit_deviation=dev_max,
                log_prob_deviation=logp_dev, tie=tie,
                max_abs_delta_relative_prob_compared=worst_rel,
                rows_read_at_position0=at0,
                max_abs_delta_relative_prob_position0=worst_rel0,
                rows_over_int8_kv_class=sum(
                    abs(a["relative_prob"] - b["relative_prob"])
                    > INT8_KV_MAX_DREL for a, b in zip(rows, ref)
                    if _read_at_position0(a) and _read_at_position0(b)),
                max_abs_delta_relative_prob_all=max(
                    abs(a["relative_prob"] - b["relative_prob"])
                    for a, b in zip(rows, ref)))


def _fake_quant_linear(p, key, x):
    """A projection of a w8a8 tree in floating point, without the int8
    product: each token's activations rounded to its own symmetric int8
    grid (step max|x| / 127), times the dequantized weight (the codes times
    their channel scales), in float32, cast to the activations' dtype."""
    import torch

    scale = p.get(key + "_qscale")
    if scale is None:
        return x @ p[key]
    x32 = x.float()
    step = x32.abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x32 / step), -127, 127) * step
    return (xq @ (p[key].float() * scale.unsqueeze(-2))).to(x.dtype)


def _quantized_tree_half_step(label, weights, qweights, fails):
    """Each w8a8 projection of ``qweights`` against the weight it was made
    from: its channel scales are the channels' max |w| / 127, and codes
    times scale lie within half a step of ``w``.  Returns the largest
    |codes * scale - w| / scale."""
    import torch

    src, q = weights.tree()["layers"], qweights.tree()["layers"]
    worst = 0.0
    for group, leaves in q.items():
        for key, scales in leaves.items():
            if not key.endswith("_qscale"):
                continue
            name = key[:-len("_qscale")]
            for i in range(scales.shape[0]):
                w = src[group][name][i].float()
                want = w.abs().amax(0).clamp(min=1e-8) / 127.0
                if not torch.allclose(scales[i], want, rtol=1e-6, atol=0):
                    fails.append(f"{label}: layer {i} {group}.{name} scales "
                                 f"are not max|w| / 127")
                off = (leaves[name][i].float() * scales[i] - w).abs() \
                    / scales[i]
                worst = max(worst, float(off.max()))
    if worst > 0.5 + 1e-4:
        fails.append(f"{label}: w8a8 codes {worst} steps from the weights")
    return worst


def _fake_quant_witness(label, weights, qweights, kv8, prompts, prefix_lens,
                        target_ids, fails):
    """The w8a8 route against a computation of the same quantized model
    that does not use the int8 product: ``_fake_quant_linear`` in float32
    (the witness) and in bf16 (its rounding class).  The tree is first
    held to the bf16 weights it came from (``_quantized_tree_half_step``).
    Each run prefills the prefix and extends the suffix over its int8 KV
    cache, as the sweep does, and reads the targets' position-0
    log-probabilities.  Gates: every projection of the int8 route within
    PROJECTION_TOL (one bf16 step of its largest output) of the bf16
    fake-quant of the same input; the int8 route's deviation from the
    float32 witness within NEAR_TIE_FACTOR times the bf16 fake-quant's, a
    class that no part of the int8 path sets.  Reported beside them: the
    bf16 weights (no w8a8, same int8 KV cache) against the witness, and
    |d relative_prob| of each run against the witness."""
    import time

    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.ops import quant

    half_step = _quantized_tree_half_step(label, weights, qweights, fails)
    witness = decoder.DecoderWeights(kv8, _to_float32(qweights.tree()))
    runs = {"int8_route": (qweights, False),
            "fake_quant_bf16": (qweights, True),
            "bf16_weights": (weights, False),
            "fake_quant_fp32": (witness, True)}
    dev = _device_of(weights)
    logp = {name: [] for name in runs}
    real_linear = quant.linear
    projection = [0.0]

    def checked(p, key, x):
        """The int8 route's projection, held to the bf16 fake-quant of the
        same input (identical codes and steps: one bf16 rounding apart)."""
        y = real_linear(p, key, x)
        if p.get(key + "_qscale") is not None:
            ref = _fake_quant_linear(p, key, x).float()
            projection[0] = max(projection[0], float(
                (y.float() - ref).abs().max() / ref.abs().max()))
        return y

    t0 = time.perf_counter()
    try:
        for lo in range(0, len(prompts), BATCH):
            part = list(zip(prompts[lo:lo + BATCH],
                            prefix_lens[lo:lo + BATCH]))
            pre_ids, pre_mask = _padded([p[:n] for p, n in part], dev)
            suf_ids, suf_mask = _padded([p[n:] for p, n in part], dev)
            tgt = torch.as_tensor(target_ids[lo:lo + BATCH], device=dev)
            for name, (w, fake) in runs.items():
                quant.linear = _fake_quant_linear if fake else \
                    checked if name == "int8_route" else real_linear
                _, cache = decoder.prefill(w, kv8, pre_ids, pre_mask,
                                           pre_ids.shape[1])
                logits = decoder.extend_prefill(
                    w, kv8, cache, suf_ids, suf_mask, pre_mask.sum(-1))[0]
                logp[name].append(
                    logits.float().log_softmax(-1).gather(1, tgt).cpu())
    finally:
        quant.linear = real_linear
    del witness
    logp = {k: torch.cat(v) for k, v in logp.items()}
    ref = logp["fake_quant_fp32"]

    def rel(lp):
        return torch.sigmoid(lp[:, 0] - lp[:, 1])

    out = dict(max_code_offset_steps=half_step, rows=int(ref.shape[0]),
               seconds=time.perf_counter() - t0,
               projection_max_rel_d=projection[0],
               projection_tol=PROJECTION_TOL)
    if not projection[0] <= PROJECTION_TOL:
        fails.append(f"{label}: an int8 projection {projection[0]} of its "
                     f"largest output from its bf16 fake-quant")
    for name in ("int8_route", "fake_quant_bf16", "bf16_weights"):
        out[f"{name}_max_abs_d_log_prob"] = float(
            (logp[name] - ref).abs().max())
        out[f"{name}_max_abs_d_relative_prob"] = float(
            (rel(logp[name]) - rel(ref)).abs().max())
    out["int8_route_vs_fake_quant_bf16_max_abs_d_log_prob"] = float(
        (logp["int8_route"] - logp["fake_quant_bf16"]).abs().max())
    out["log_prob_tol"] = tol = (NEAR_TIE_FACTOR
                                 * out["fake_quant_bf16_max_abs_d_log_prob"])
    if not out["int8_route_max_abs_d_log_prob"] <= tol:
        fails.append(f"{label}: int8 route {out['int8_route_max_abs_d_log_prob']}"
                     f" from the float32 fake-quant witness (tol {tol})")
    return out


def _read_at_position0(row):
    """The scan read position 0: no hit within the look-ahead (the
    fallback), or a hit there, where the top-20-filtered position-0 fields
    equal the scan's (both targets in the top 20)."""
    return not row["scan_found"] or (
        row["first_token_yes_prob"] == row["yes_prob"]
        and row["first_token_no_prob"] == row["no_prob"])


def _write_bin_shards(snap, sd, shards=2):
    """``sd`` as ``pytorch_model-0000i-of-0000n.bin`` shards (whole
    tensors, split by count) with ``pytorch_model.bin.index.json``."""
    import torch

    names = list(sd)
    per = -(-len(names) // shards)
    weight_map, total = {}, 0
    for s in range(shards):
        fname = f"pytorch_model-{s + 1:05d}-of-{shards:05d}.bin"
        part = {n: sd[n].detach().cpu().contiguous()
                for n in names[s * per:(s + 1) * per]}
        torch.save(part, os.path.join(snap, fname))
        for n, t in part.items():
            weight_map[n] = fname
            total += t.numel() * t.element_size()
    with open(os.path.join(snap, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)


def _write_100q_snapshots(root, seed, tokenizer_texts):
    """Snapshots of each distinct geometry of ``CLI_SNAPSHOTS`` at
    SNAPSHOT_LAYERS layers under ``root`` (``org--name`` directories; a
    model that shares a geometry is a symlink to it; Mistral-7B-v0.1 a
    directory of its own config.json and symlinks to v0.2's other files),
    random bf16 weights from ``seed``, a tokenizer learned on
    ``tokenizer_texts`` in the published format of the model it stands for
    (``CLI_TOKENIZERS``: Falcon's, BLOOM's, Mistral's byte-fallback BPE),
    else byte-level BPE (with GPT-NeoX-20B's NFC normalizer for the NeoX
    models).  Returns (bytes written, seconds)."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import convert

    device = "cuda"
    t0, nbytes = time.perf_counter(), 0
    for si, (model, config, shared, fmt) in enumerate(CLI_SNAPSHOTS):
        snap = os.path.join(root, model.replace("/", "--"))
        os.makedirs(snap)
        if config is None:        # Falcon-7B, legacy keys, its own writer
            cfg = mconfig.DecoderConfig(**{**mconfig.FALCON_7B_GEOMETRY,
                                           "num_layers": SNAPSHOT_LAYERS})
            sd = _falcon_state_dict(convert.random_params(
                cfg, seed=seed + 40 + si, device=device,
                dtype="bf16").tree(), cfg)
            hf_json = _falcon_config_json(cfg)
        else:
            family, cfg = _family_config(config, SNAPSHOT_LAYERS)
            sd = _hf_state_dict(family, cfg, seed + 40 + si, device,
                                torch.bfloat16)
            hf_json = _at_depth(config, SNAPSHOT_LAYERS)
        fmt_tok = CLI_TOKENIZERS.get(model)
        _write_tokenizer_files(snap, _format_tokenizer_files(
            fmt_tok, tokenizer_texts) if fmt_tok else _bpe_tokenizer_files(
                tokenizer_texts, nfc=hf_json["model_type"] == "gpt_neox"))
        with open(os.path.join(snap, "config.json"), "w",
                  encoding="utf-8") as f:
            json.dump(hf_json, f)
        if fmt == "bin":
            _write_bin_shards(snap, sd)
        else:
            _write_safetensors(os.path.join(snap, "model.safetensors"), sd)
        nbytes += sum(t.numel() * t.element_size() for t in sd.values())
        del sd
        for other in shared:
            os.symlink(os.path.basename(snap),
                       os.path.join(root, other.replace("/", "--")))
    v02 = os.path.join(root, "mistralai--Mistral-7B-Instruct-v0.2")
    v01 = os.path.join(root, "mistralai--Mistral-7B-v0.1")
    os.makedirs(v01)
    for name in os.listdir(v02):
        if name != "config.json":
            os.symlink(os.path.join(os.pardir, os.path.basename(v02), name),
                       os.path.join(v01, name))
    with open(os.path.join(v01, "config.json"), "w") as f:
        json.dump(_at_depth(MISTRAL_7B_V01, SNAPSHOT_LAYERS), f)
    torch.cuda.empty_cache()
    return nbytes, time.perf_counter() - t0


def _run_100q(snaps, out, extra=(), signal_after_first=False):
    """``python -m llm_interpretation_replication_tpu_torch run-100q`` in a
    child process (the repository on its path).  With
    ``signal_after_first`` a SIGTERM goes to it as soon as its checkpoint
    file appears.  Returns (exit code, stdout, stderr, seconds)."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = [sys.executable, "-m", "llm_interpretation_replication_tpu_torch",
            "run-100q", "--checkpoint-dir", snaps, "--output-dir", out,
            "--attention-impl", "flash", "--batch-size", str(BATCH), *extra]
    ck = os.path.join(out, "base_vs_instruct_100q_checkpoint.json")
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as so, tempfile.TemporaryFile("w+") as se:
        proc = subprocess.Popen(argv, stdout=so, stderr=se, env=env, cwd=root)
        try:
            if signal_after_first:
                while proc.poll() is None and not os.path.exists(ck):
                    time.sleep(0.005)
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        so.seek(0)
        se.seek(0)
        return rc, so.read(), se.read(), time.perf_counter() - t0


def run100q_cli_phase(seed, workdir, card):
    """``run-100q --attention-impl flash`` over 2-layer snapshots of the
    sweep's twelve models at their published widths, in a child process:
    1200 rows in the CSV's 10 columns, each with ``success``; one attention
    line a model (dense for BLOOM and Mistral-7B-v0.1); then a run that a
    SIGTERM stops after its first model leaves a checkpoint of exactly that
    model's rows, and resuming it skips that model and writes the same
    CSV; a rerun over a finished output directory skips all twelve."""
    import csv

    from llm_interpretation_replication_tpu_torch.config import (
        model_pairs_100q, ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.scoring import prompts
    from llm_interpretation_replication_tpu_torch.sweeps import (
        BASE_VS_INSTRUCT_100Q_COLUMNS)

    questions = ordinary_meaning_questions()
    names = [m for p in model_pairs_100q() for m in (p["base"], p["instruct"])]
    snaps = os.path.join(workdir, "snapshots")
    os.makedirs(snaps)
    texts = questions + [prompts.FEW_SHOT_PREFIX, prompts.ANSWER_INSTRUCTION,
                         " Yes", " No"]
    nbytes, write_s = _write_100q_snapshots(snaps, seed, texts)
    say(f"run-100q: {len(CLI_SNAPSHOTS) + 1} snapshot directories, "
        f"{nbytes / 1e9:.2f} GB of weights written in {write_s:.1f} s")
    fails, runs = [], []

    def csv_of(out):
        path = os.path.join(out, "base_vs_instruct_100q_results.csv")
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))
        return raw, rows

    def attention_lines(err):
        return dict(re.findall(r"^# (\S+): attention (\w+) ", err, re.M))

    # (1) the whole sweep
    out = os.path.join(workdir, "run100q")
    rc, so, se, secs = _run_100q(snaps, out, extra=("--strict",))
    audit = _strict_audit(se)
    runs.append(dict(run="full", rc=rc, seconds=secs, strict=audit,
                     rows_per_s=len(names) * len(questions) / secs))
    say("run-100q", json.dumps(dict(runs[-1], card=card)))
    if rc != 0:
        raise AssertionError(f"run-100q exited {rc}: {se[-3000:]}")
    if len(audit) != 1 or audit[0]["blocked_transfers"] != 0:
        fails.append(f"run-100q --strict: audit {audit}")
    raw, rows = csv_of(out)
    n = len(names) * len(questions)
    if rows[0] != BASE_VS_INSTRUCT_100Q_COLUMNS or len(rows) != n + 1:
        fails.append(f"run-100q: header {rows[0]}, {len(rows) - 1} rows")
    success = rows[0].index("success") if "success" in rows[0] else 4
    if any(r[success] != "True" for r in rows[1:]):
        fails.append(f"run-100q: "
                     f"{sum(r[success] != 'True' for r in rows[1:])} rows "
                     f"without success")
    if f"{n} rows" not in so.splitlines():
        fails.append(f"run-100q printed {so.splitlines()[-1:]}")
    lines = attention_lines(se)
    want = {m: "xla" if m in CLI_DENSE else "flash" for m in names}
    if lines != want:
        fails.append(f"run-100q attention lines {lines}, want {want}")
    order = [r[rows[0].index("model")] for r in rows[1:]]
    if order != [m for m in names for _ in questions]:
        fails.append("run-100q: rows not in roster order")

    # (2) SIGTERM after the first model, then the resume
    out2 = os.path.join(workdir, "run100q_preempted")
    rc2, _, se2, secs2 = _run_100q(snaps, out2, signal_after_first=True)
    with open(os.path.join(out2, "base_vs_instruct_100q_checkpoint.json")) as f:
        state = json.load(f)
    kept = sorted({r["model"] for r in state["results"]})
    runs.append(dict(run="sigterm", rc=rc2, seconds=secs2,
                     completed_models=state["completed_models"],
                     checkpoint_rows=len(state["results"])))
    say("run-100q", json.dumps(dict(runs[-1], card=card)))
    if (rc2 != 143 or state["completed_models"] != names[:1]
            or kept != names[:1] or len(state["results"]) != len(questions)):
        fails.append(f"run-100q SIGTERM: exit {rc2}, checkpoint "
                     f"{state['completed_models']} with "
                     f"{len(state['results'])} rows of {kept}")
    rc3, so3, se3, secs3 = _run_100q(snaps, out2)
    runs.append(dict(run="resume", rc=rc3, seconds=secs3))
    say("run-100q", json.dumps(dict(runs[-1], card=card)))
    if rc3 != 0:
        raise AssertionError(f"run-100q resume exited {rc3}: {se3[-3000:]}")
    if f"Skipping {names[0]} (already completed)" not in so3 or \
            set(attention_lines(se3)) != set(names[1:]):
        fails.append("run-100q resume did not skip just the first model")
    if csv_of(out2)[0] != raw:
        fails.append("run-100q resume: the CSV differs from the whole run's")

    # (3) a rerun over the finished output: nothing to score
    rc4, so4, se4, secs4 = _run_100q(snaps, out)
    runs.append(dict(run="rerun", rc=rc4, seconds=secs4))
    say("run-100q", json.dumps(dict(runs[-1], card=card)))
    if rc4 != 0 or attention_lines(se4) or csv_of(out)[0] != raw or \
            so4.count("(already completed)") != len(names):
        fails.append(f"run-100q rerun: exit {rc4}, it scored "
                     f"{sorted(attention_lines(se4))}")
    result = dict(card=card, layers=SNAPSHOT_LAYERS, snapshot_bytes=nbytes,
                  snapshot_write_s=write_s, rows=n, runs=runs,
                  attention=lines, failures=fails[:50])
    say("run-100q gates", json.dumps({k: v for k, v in result.items()
                                      if k != "runs"}))
    if fails:
        raise AssertionError(f"run-100q: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


def _t5_popular_ids(weights, cfg, prompts, tok, n=2, batch=BATCH):
    """The ``n`` ids past the tokenizer's vocabulary that random T5 weights
    most often rank in the top 20 of the first decoder step."""
    from collections import Counter

    import torch

    from llm_interpretation_replication_tpu_torch.models import t5

    counts = Counter()
    for lo in range(0, len(prompts), batch):
        ids, mask = _padded(prompts[lo:lo + batch], _device_of(weights))
        dec = torch.full((ids.shape[0], 1), cfg.decoder_start_token_id,
                         dtype=torch.long, device=ids.device)
        top = torch.topk(t5.forward(weights, cfg, ids, mask, dec)[:, 0],
                         TOP_FILTER).indices.cpu().tolist()
        for row in top:
            counts.update(i for i in row if i >= len(tok))
    return [i for i, _ in counts.most_common(n)]


def _t5_swap_targets(weights, tok, chosen):
    """Swap, in place, the decoder-input rows (``shared``) and the untied
    head's columns of each target id with those of the id ``chosen`` gives
    it (``{"Yes": id}``: T5 reads the bare word's first id).  Returns the
    swapped pairs."""
    import torch

    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    tree = weights.tree()
    shared, head = tree["shared"], tree.get("lm_head")
    pairs = [(yes_no.target_token_ids(tok, [word], True)[0], tid)
             for word, tid in chosen.items()]
    with torch.no_grad():
        for a, b in pairs:
            shared[[a, b]] = shared[[b, a]]
            if head is not None:
                head[:, [a, b]] = head[:, [b, a]]
    return pairs


def _t5_teacher(weights, cfg, prompts, continuations, target_ids,
                steps=SCAN_STEPS, top_k=5, batch=BATCH):
    """One T5 forward over each prompt with its continuation fed to the
    decoder (from the start token): the top-1 logit and its lead at every
    step ``[N, L + 1]``; over the first ``steps`` steps the nearer target
    logit's distance from the ``top_k``-th largest and the two targets'
    gap ``[N, steps]``; at step 0 the nearer target's distance from the
    TOP_FILTER-th largest ``[N]`` and the filtered target probabilities
    ``[N, 2]`` (NaN past a row's continuation)."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import t5

    dev, n = _device_of(weights), len(prompts)
    width = max(max(map(len, continuations)) + 1, steps)
    top1 = np.full((n, width), np.nan, np.float32)
    leads = np.full((n, width), np.nan, np.float32)
    edge = np.full((n, steps), np.nan, np.float32)
    split = np.full((n, steps), np.nan, np.float32)
    edge0 = np.zeros((n,), np.float32)
    probs0 = np.zeros((n, 2), np.float32)
    for lo in range(0, n, batch):
        ids, mask = _padded(prompts[lo:lo + batch], dev)
        conts = continuations[lo:lo + batch]
        dec = torch.full((len(conts), width), cfg.decoder_start_token_id,
                         dtype=torch.long)
        for i, c in enumerate(conts):
            dec[i, 1:1 + len(c)] = torch.as_tensor(c[:width - 1],
                                                   dtype=torch.long)
        logits = t5.forward(weights, cfg, ids, mask, dec.to(dev))
        top2 = torch.topk(logits, 2, dim=-1).values.cpu().numpy()
        tgt = torch.as_tensor(np.asarray(target_ids[lo:lo + batch]), device=dev)
        kth = torch.topk(logits[:, :steps], top_k, dim=-1).values[..., -1:]
        tl = logits[:, :steps].gather(2, tgt[:, None, :].expand(-1, steps, -1))
        e = (tl - kth).abs().min(2).values.cpu().numpy()
        sp = (tl[..., 0] - tl[..., 1]).abs().cpu().numpy()
        kth0 = torch.topk(logits[:, 0], TOP_FILTER).values[:, -1:]
        edge0[lo:lo + len(conts)] = (logits[:, 0].gather(1, tgt) - kth0) \
            .abs().min(1).values.cpu().numpy()
        probs0[lo:lo + len(conts)] = _filtered_target_probs(
            logits[:, 0], tgt).cpu().numpy()
        for i, c in enumerate(conts):
            k = min(len(c) + 1, width)
            top1[lo + i, :k] = top2[i, :k, 0]
            leads[lo + i, :k] = top2[i, :k, 0] - top2[i, :k, 1]
            edge[lo + i, :min(k, steps)] = e[i, :k][:steps]
            split[lo + i, :min(k, steps)] = sp[i, :k][:steps]
        del logits
    return top1, leads, edge, split, edge0, probs0


def _t5_weights(config, seed, device):
    """(config, bf16 T5Weights) of a published T5 ``config.json`` dict:
    a random HF-named checkpoint at T5's initialization scales
    (``convert.random_t5_state_dict``) through the port's converter."""
    from llm_interpretation_replication_tpu_torch.models import convert, t5

    _, cfg = _family_config(config)
    sd = convert.random_t5_state_dict(cfg, seed=seed, device=device,
                                      dtype="bf16")
    weights = t5.T5Weights(cfg, convert.convert_t5(sd.__getitem__, cfg))
    del sd
    return cfg, weights


def _t5_gated_run(label, model, cfg, weights, tok, prompts, rows, card,
                  attention):
    """Gates of one T5 model's rows (``rows``: the sweep's, batch BATCH)
    against a second bf16 route (the same prompts at batch 8, another set
    of GEMM shapes) and a float32 forward of the same weights: completions
    part only where the batch-BATCH route's lead is below the tie (twice
    NEAR_TIE_FACTOR times the largest top-1 difference between the decode
    and one forward over its tokens, two bf16 computations), verdicts only
    near it, position-0 fields within twice one bf16 forward's deviation
    from float32 on the rows clear of the tie; no causal launch.  Returns
    (result, failures)."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import t5
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    target_ids = [yes_no.target_token_ids(tok, ["Yes", "No"], True)] * len(prompts)
    fails = []
    # two bf16 computations of the decode's top-1 logits
    diffs = []
    for lo in range(0, len(prompts), BATCH):
        ids, mask = _padded(prompts[lo:lo + BATCH], "cuda")
        toks, sc = t5.greedy_decode(weights, cfg, ids, mask, SCAN_STEPS,
                                    tok.eos_token_id, SCAN_STEPS)
        dec = torch.cat([torch.full_like(toks[:, :1], cfg.decoder_start_token_id),
                         toks[:, :-1]], 1).long()
        teach = t5.forward(weights, cfg, ids, mask, dec)
        diffs.append((teach.max(-1).values - sc.max(-1).values).abs()
                     .max().item())
        del sc, teach
    tie = 2 * NEAR_TIE_FACTOR * max(diffs)
    conts = [_completion_ids(r["completion"]) for r in rows]
    _, leads, edge, split, _, p16 = _t5_teacher(weights, cfg, prompts, conts,
                                                target_ids)
    ref_w = t5.T5Weights(cfg, _to_float32(weights.tree()))
    _, _, _, _, edge32, p32 = _t5_teacher(ref_w, cfg, prompts,
                                          [[]] * len(prompts), target_ids)
    del ref_w
    torch.cuda.empty_cache()
    clear = edge32 >= tie
    dev16 = float(np.abs(p16 - p32)[clear].max(initial=0.0))
    _reset_launches(attention)
    eng = emod.ScoringEngine("t5", cfg, weights, tok, device="cuda",
                             engine_config=emod.EngineConfig(batch_size=8))
    t0 = time.perf_counter()
    rows8 = eng.score_prompts(prompts)
    torch.cuda.synchronize()
    secs8 = time.perf_counter() - t0
    eng.close()
    stats, f = _compare_family_rows(f"{label} batch 8", rows8, rows, leads,
                                    edge, split, tie, p32, clear, 2 * dev16)
    fails += f
    stats32, f = _compare_family_rows(f"{label} batch {BATCH}", rows, rows,
                                      leads, edge, split, tie, p32, clear,
                                      2 * dev16)
    fails += f
    launches = _launches(attention)["causal_grouped_attention"]
    if launches:
        fails.append(f"{label}: {launches} causal launches on the T5 route")
    # ms a decode step: 50 steps against 10 on the longest batch
    ids, mask = _padded(max((prompts[lo:lo + BATCH]
                             for lo in range(0, len(prompts), BATCH)),
                            key=lambda b: (len(b), max(map(len, b)))), "cuda")
    t50 = time_ms(lambda: t5.greedy_decode(weights, cfg, ids, mask, 50,
                                           tok.eos_token_id, SCAN_STEPS),
                  iters=2, warmup=1)
    t10 = time_ms(lambda: t5.greedy_decode(weights, cfg, ids, mask, 10,
                                           tok.eos_token_id, SCAN_STEPS),
                  iters=2, warmup=1)
    result = dict(model=label, hf_name=model, family="t5",
                  layers=[cfg.num_layers, cfg.num_decoder_layers],
                  width=cfg.d_model, heads=[cfg.num_heads, cfg.d_kv],
                  vocab=cfg.vocab_size, tie=tie,
                  top1_max_abs_diff=max(diffs),
                  position0_bf16_vs_fp32=dev16,
                  rows_clear_of_edge=int(clear.sum()),
                  gates={"batch8": stats, "position0": stats32},
                  batch8_s=secs8, ms_per_decode_step=(t50 - t10) / 40,
                  decode_ms=[t10, t50], card=card)
    return result, fails


def instruct_phase(seed, attention, workdir, card):
    """The instruct roster's new models at their published width and
    depth, random bf16 weights from ``seed`` made as HF checkpoints and
    read through the port's converters, under the phase's word tokenizer
    with the targets swapped to ids the weights rank high: T0_3B scores
    the 100 instruct prompts through the instruct sweep's per-model call;
    the word-meaning T5 pair (t5-v1_1-base, flan-t5-base) runs through
    ``sweeps.run_base_vs_instruct_word_meaning`` (the base model's few-shot
    prompt on T5); each T5 model is held by ``_t5_gated_run``.  Qwen-7B-
    Chat, Baichuan2-7B-Chat (NormHead) and OPT-IML-1.3B run the families
    phase's routes and gates on the instruct prompts
    (``families_phase(instruct=True)``), the causal kernel timed at each
    one's longest prompt batch."""
    import torch

    from llm_interpretation_replication_tpu_torch.config import (
        ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.scoring.prompts import (
        format_prompt)
    from llm_interpretation_replication_tpu_torch.sweeps import (
        instruct_sweep, run_base_vs_instruct_word_meaning)

    questions = ordinary_meaning_questions()
    tok = _question_tokenizer()
    fails, t5_results, runs = [], [], []

    def t5_model(label, model, config, mseed):
        t0 = time.perf_counter()
        cfg, weights = _t5_weights(config, mseed, "cuda")
        torch.cuda.synchronize()
        make_s = time.perf_counter() - t0
        is_base = model == T5_PAIR["base"]
        prompts = [tok(format_prompt(q, is_base, model)).input_ids
                   for q in questions]
        swapped = _t5_swap_targets(weights, tok, dict(zip(
            ("Yes", "No"), _t5_popular_ids(weights, cfg, prompts, tok))))
        return cfg, weights, prompts, dict(weights_s=make_s,
                                           swapped_target_rows=swapped)

    def scored(label, model, cfg, weights, prompts, call):
        engine = _Recorder(emod.ScoringEngine(
            "t5", cfg, weights, tok, device="cuda",
            engine_config=emod.EngineConfig(batch_size=BATCH)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = call(engine)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run = dict(model=label, route="t5", rows=len(engine.rows),
                   seconds=secs, rows_per_s=len(engine.rows) / secs,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   success_rows=sum(bool(r["success"]) for r in engine.rows),
                   scan_found_rows=sum(r["scan_found"] for r in engine.rows),
                   kernel_launches=0)
        say("instruct", json.dumps(dict(run, card=card)))
        runs.append(run)
        if run["success_rows"] != len(prompts):
            fails.append(f"{label}: {run['success_rows']} rows with success "
                         f"of {len(prompts)}")
        engine._engine.close()
        return engine.rows, out

    # T0_3B through the instruct sweep's per-model call
    cfg, weights, prompts, extra = t5_model("t0-3b", "bigscience/T0_3B",
                                            T0_3B, seed + 50)
    rows, _ = scored("t0-3b", "bigscience/T0_3B", cfg, weights, prompts,
                     lambda e: instruct_sweep._score_model(
                         e, "bigscience/T0_3B", questions, False))
    res, f = _t5_gated_run("t0-3b", "bigscience/T0_3B", cfg, weights, tok,
                           prompts, rows, card, attention)
    t5_results.append(dict(res, **extra))
    fails += f
    say("instruct gates", json.dumps(t5_results[-1]))
    del weights
    torch.cuda.empty_cache()

    # the word-meaning pair through its sweep: one engine a model, made by
    # the factory as the CLI's would be
    made = {}

    def factory(name):
        label = name.split("/")[1]
        cfg, weights, prompts, extra = t5_model(
            label, name, T5_V1_1_BASE, seed + 55 + len(made))
        made[name] = (cfg, weights, prompts, extra)
        engine = _Recorder(emod.ScoringEngine(
            "t5", cfg, weights, tok, device="cuda",
            engine_config=emod.EngineConfig(batch_size=BATCH)))
        made[name] += (engine,)
        return engine

    t0 = time.perf_counter()
    pair_rows = run_base_vs_instruct_word_meaning(
        factory, questions, model_pairs=[T5_PAIR],
        checkpoint_path=os.path.join(workdir, "word_meaning_checkpoint.json"),
        results_csv=os.path.join(workdir, "model_comparison_results.csv"))
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    if len(pair_rows) != 2 * len(questions) or any(
            r["model_output"].startswith("MODEL_ERROR") for r in pair_rows):
        fails.append(f"word meaning: {len(pair_rows)} rows, "
                     f"{sum(r['model_output'].startswith('MODEL_ERROR') for r in pair_rows)} errors")
    runs.append(dict(model="t5-pair", route="word-meaning sweep",
                     rows=len(pair_rows), seconds=pair_s,
                     rows_per_s=len(pair_rows) / pair_s, kernel_launches=0))
    say("instruct", json.dumps(dict(runs[-1], card=card)))
    for name, (cfg, weights, prompts, extra, engine) in made.items():
        label = name.split("/")[1]
        res, f = _t5_gated_run(label, name, cfg, weights, tok, prompts,
                               engine.rows, card, attention)
        t5_results.append(dict(res, **extra))
        fails += f
        say("instruct gates", json.dumps(t5_results[-1]))
        engine._engine.close()
    made.clear()
    torch.cuda.empty_cache()

    dec = families_phase(seed, attention, card, instruct=True)
    if fails:
        raise AssertionError(f"instruct: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return dict(t5=t5_results, decoders=dec["models"],
                kernel_rows=dec["kernel_rows"], runs=runs + dec["runs"])


def _write_instruct_snapshots(root, seed, texts):
    """2-layer snapshots of ``INSTRUCT_SNAPSHOTS`` beside the run-100q
    phase's (whose other models go first): random bf16 weights from
    ``seed`` as safetensors, tokenizers in each model's format learned on
    ``texts`` (the T5s' Unigram ``tokenizer.json`` behind a Precompiled
    charsmap, Mistral v0.3's Metaspace "first" byte-fallback BPE,
    ``qwen.tiktoken``, OPT's ``vocab.json`` + ``merges.txt``, byte-level
    BPE for the rest, Baichuan's SentencePiece file among them).  Returns
    (bytes written, seconds)."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import convert

    for name in os.listdir(root):
        if name not in INSTRUCT_REUSED:
            path = os.path.join(root, name)
            if os.path.islink(path):
                os.unlink(path)
            else:
                shutil.rmtree(path)
    t0, nbytes = time.perf_counter(), 0
    for si, (model, config, shared, fmt) in enumerate(INSTRUCT_SNAPSHOTS):
        snap = os.path.join(root, model.replace("/", "--"))
        os.makedirs(snap)
        hf_json = (dict(config, num_layers=SNAPSHOT_LAYERS,
                        num_decoder_layers=SNAPSHOT_LAYERS)
                   if fmt == "t5" else _at_depth(config, SNAPSHOT_LAYERS))
        family, cfg = _family_config(hf_json)
        if family == "t5":
            sd = convert.random_t5_state_dict(cfg, seed=seed + 80 + si,
                                              device="cuda", dtype="bf16")
        else:
            sd = _hf_state_dict(family, cfg, seed + 80 + si, "cuda",
                                torch.bfloat16)
        files = {"config.json": hf_json}
        if fmt in ("t5", "mistral_v03"):
            files.update(zip(("tokenizer.json", "tokenizer_config.json",
                              "special_tokens_map.json"),
                             _format_tokenizer_files(fmt, texts)))
        elif fmt == "bpe":
            files.update(zip(("tokenizer.json", "tokenizer_config.json",
                              "special_tokens_map.json"),
                             _bpe_tokenizer_files(texts)))
        elif fmt == "tiktoken":
            with open(os.path.join(snap, "qwen.tiktoken"), "wb") as f:
                f.write(_qwen_tiktoken(texts))
        else:
            _write_gpt2_tokenizer(snap, texts)
        for name, obj in files.items():
            with open(os.path.join(snap, name), "w", encoding="utf-8") as f:
                json.dump(obj, f)
        _write_safetensors(os.path.join(snap, "model.safetensors"), sd)
        nbytes += sum(t.numel() * t.element_size() for t in sd.values())
        del sd
        for other in shared:
            os.symlink(os.path.basename(snap),
                       os.path.join(root, other.replace("/", "--")))
    torch.cuda.empty_cache()
    return nbytes, time.perf_counter() - t0


def _run_instruct(snaps, out, extra=(), signal_after_first=False):
    """``python -m llm_interpretation_replication_tpu_torch
    run-instruct-sweep --attention-impl flash --quant int8`` in a child
    process (the repository on its path); with ``signal_after_first`` a
    SIGTERM goes to it as soon as its checkpoint file appears.  Returns
    (exit code, stdout, stderr, seconds)."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = [sys.executable, "-m", "llm_interpretation_replication_tpu_torch",
            "run-instruct-sweep", "--checkpoint-dir", snaps, "--output-dir",
            out, "--attention-impl", "flash", "--quant", "int8",
            "--batch-size", str(BATCH), *extra]
    ck = os.path.join(out, "instruct_sweep_checkpoint.json")
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as so, tempfile.TemporaryFile("w+") as se:
        proc = subprocess.Popen(argv, stdout=so, stderr=se, env=env, cwd=root)
        try:
            if signal_after_first:
                while proc.poll() is None and not os.path.exists(ck):
                    time.sleep(0.005)
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        so.seek(0)
        se.seek(0)
        return rc, so.read(), se.read(), time.perf_counter() - t0


def instruct_cli_phase(seed, workdir, card):
    """``run-instruct-sweep --attention-impl flash --quant int8`` over
    2-layer snapshots of the 10-model roster (the run-100q phase's Falcon,
    BLOOM and RedPajama snapshots read again), in a child process: 1000
    rows in the CSV's 7 columns, none a ``MODEL_ERROR``, every probability
    in [0, 1]; one attention line a model (dense for BLOOMZ and the T5
    models, whose int8 request loads bf16 with a warning); then a run a
    SIGTERM stops after its first model keeps exactly that model's rows,
    resuming it writes the same CSV, and a rerun over the finished output
    scores nothing."""
    import csv

    from llm_interpretation_replication_tpu_torch.config import (
        instruct_sweep_models, ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.scoring.prompts import (
        format_prompt)
    from llm_interpretation_replication_tpu_torch.sweeps import (
        INSTRUCT_COMPARISON_COLUMNS)

    questions = ordinary_meaning_questions()
    names = instruct_sweep_models()
    snaps = os.path.join(workdir, "snapshots")
    texts = [format_prompt(q, False, m) for q in questions
             for m in ("", "baichuan")] + ["Yes", "No", " Yes", " No"]
    nbytes, write_s = _write_instruct_snapshots(snaps, seed, texts)
    say(f"run-instruct-sweep: {len(INSTRUCT_SNAPSHOTS)} snapshots, "
        f"{nbytes / 1e9:.2f} GB of weights written in {write_s:.1f} s")
    fails, runs = [], []
    n = len(names) * len(questions)

    def csv_of(out):
        path = os.path.join(out, "instruct_model_comparison_results.csv")
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, newline="", encoding="utf-8") as f:
            return raw, list(csv.reader(f))

    def attention_lines(err):
        return dict(re.findall(r"^# (\S+): attention (\w+) ", err, re.M))

    out = os.path.join(workdir, "instruct")
    rc, so, se, secs = _run_instruct(snaps, out, extra=("--strict",))
    audit = _strict_audit(se)
    runs.append(dict(run="full", rc=rc, seconds=secs, strict=audit,
                     rows_per_s=n / secs))
    say("run-instruct-sweep", json.dumps(dict(runs[-1], card=card)))
    if rc != 0:
        raise AssertionError(f"run-instruct-sweep exited {rc}: {se[-3000:]}")
    if len(audit) != 1 or audit[0]["blocked_transfers"] != 0:
        fails.append(f"run-instruct-sweep --strict: audit {audit}")
    raw, rows = csv_of(out)
    if rows[0] != INSTRUCT_COMPARISON_COLUMNS or len(rows) != n + 1:
        fails.append(f"run-instruct-sweep: header {rows[0]}, "
                     f"{len(rows) - 1} rows")
    col = {c: i for i, c in enumerate(rows[0])}
    bad = [r for r in rows[1:] if r[col["model_output"]].startswith(
        "MODEL_ERROR") or not all(0.0 <= float(r[col[c]]) <= 1.0 for c in
                                  ("yes_prob", "no_prob", "relative_prob"))]
    if bad:
        fails.append(f"run-instruct-sweep: {len(bad)} rows failed, e.g. "
                     f"{bad[0]}")
    if f"{n} rows over {len(questions)} questions" not in so.splitlines():
        fails.append(f"run-instruct-sweep printed {so.splitlines()[-1:]}")
    lines = attention_lines(se)
    want = {m: "xla" if m in INSTRUCT_DENSE else "flash" for m in names}
    if lines != want:
        fails.append(f"run-instruct-sweep attention lines {lines}, want {want}")
    if se.count("UserWarning: int8 quantization unsupported for T5") != 2:
        fails.append("run-instruct-sweep: no int8 warning for the T5 models")
    order = [r[col["model"]] for r in rows[1:]]
    if order != [m for m in names for _ in questions]:
        fails.append("run-instruct-sweep: rows not in roster order")

    out2 = os.path.join(workdir, "instruct_preempted")
    rc2, _, _, secs2 = _run_instruct(snaps, out2, signal_after_first=True)
    with open(os.path.join(out2, "instruct_sweep_checkpoint.json")) as f:
        state = json.load(f)
    kept = list(state["outputs"])
    runs.append(dict(run="sigterm", rc=rc2, seconds=secs2, kept=kept,
                     checkpoint_rows=sum(map(len, state["outputs"].values()))))
    say("run-instruct-sweep", json.dumps(dict(runs[-1], card=card)))
    if rc2 != 143 or kept != names[:1] or \
            len(state["outputs"][names[0]]) != len(questions):
        fails.append(f"run-instruct-sweep SIGTERM: exit {rc2}, checkpoint of "
                     f"{kept}")
    rc3, so3, se3, secs3 = _run_instruct(snaps, out2)
    runs.append(dict(run="resume", rc=rc3, seconds=secs3))
    say("run-instruct-sweep", json.dumps(dict(runs[-1], card=card)))
    if rc3 != 0:
        raise AssertionError(f"run-instruct-sweep resume exited {rc3}: "
                             f"{se3[-3000:]}")
    if f"Skipping {names[0]} (checkpointed)" not in so3 or \
            set(attention_lines(se3)) != set(names[1:]):
        fails.append("run-instruct-sweep resume did not skip just the first "
                     "model")
    if csv_of(out2)[0] != raw:
        fails.append("run-instruct-sweep resume: the CSV differs from the "
                     "whole run's")
    rc4, so4, se4, secs4 = _run_instruct(snaps, out)
    runs.append(dict(run="rerun", rc=rc4, seconds=secs4))
    say("run-instruct-sweep", json.dumps(dict(runs[-1], card=card)))
    if rc4 != 0 or attention_lines(se4) or csv_of(out)[0] != raw or \
            so4.count("(checkpointed)") != len(names):
        fails.append(f"run-instruct-sweep rerun: exit {rc4}, it scored "
                     f"{sorted(attention_lines(se4))}")
    shutil.rmtree(snaps, ignore_errors=True)
    result = dict(card=card, layers=SNAPSHOT_LAYERS, snapshot_bytes=nbytes,
                  snapshot_write_s=write_s, rows=n, runs=runs,
                  attention=lines, failures=fails[:50])
    say("run-instruct-sweep gates", json.dumps(
        {k: v for k, v in result.items() if k != "runs"}))
    if fails:
        raise AssertionError(f"run-instruct-sweep: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


# ---------------------------------------------------------------------------
# Packed scoring and the joint K-token decode
# ---------------------------------------------------------------------------

def oracle_engine(emod, dmod, decode_k=K_DECODE):
    """A ``ScoringEngine`` subclass of the engine module ``emod`` (the
    port's or the JAX package's, with its decoder module ``dmod``) whose
    K-decode proposals replay the K=1 chain: each chunk first decodes its
    tokens sequentially from the chunk's entry state, and every block then
    proposes the next of them, so the accept path runs whatever a head
    would propose.  Its placeholder head holds ``decode_k - 1`` empty
    projections (only their count is read)."""
    import numpy as np

    class OracleEngine(emod.ScoringEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.k_head = {"w": np.zeros((decode_k - 1, 0, 0), np.float32)}
            self._oracle = None

        def _k_decode_chunk(self, cache, prev, lens, offset, n, eos_id, done,
                            *rest):
            toks = dmod.decode_steps(self.params, self.cfg, cache, prev,
                                     lens, offset, n, eos_id, done,
                                     with_scores=False)[0]
            self._oracle = [toks, 0]
            return super()._k_decode_chunk(cache, prev, lens, offset, n,
                                           eos_id, done, *rest)

        def _k_propose(self, hidden, prev_logits, kb, done, eos_id):
            toks, j = self._oracle
            self._oracle[1] = j + kb
            return toks[:, j:j + kb]

    return OracleEngine


def sweep_packs(scenarios, packing, demos=None):
    """The sweep corpus as the packed sweep scores it: each row's binary
    prompt (rephrasing and response format), its (yes, no) target pair,
    and the packs of ``packing`` consecutive prompts (``demos`` their
    demonstration answers, the yes targets without)."""
    from llm_interpretation_replication_tpu_torch.scoring import packed

    prompts = [f"{r} {s['response_format']}" for s in scenarios
               for r in s["rephrasings"]]
    targets = [list(s["target_tokens"]) for s in scenarios
               for _ in s["rephrasings"]]
    return prompts, targets, packed.build_packs(prompts, packing, demos)


def causal_launches(*phase_results):
    """The causal kernel's launches over every main-path run: the sum of
    ``kernel_launches`` over each phase result's ``runs`` (each counted
    from 0 just before it), the slice phase's own count included."""
    total = 0
    for res in phase_results:
        total += res.get("kernel_launches", 0)
        total += sum(r.get("kernel_launches", 0) for r in res.get("runs", ()))
    return total


def _target_margins(weights, cfg, prompts, target_ids, batch=BATCH):
    """Per prompt, from one forward of it: the distance of its nearer target
    logit from the TOP_FILTER-th largest (``edge``) and the two target
    logits' difference (``split``), ``[N]`` each."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    dev = _device_of(weights)
    edge, split = np.zeros(len(prompts)), np.zeros(len(prompts))
    for lo in range(0, len(prompts), batch):
        ids, mask = _padded(prompts[lo:lo + batch], dev)
        tgt = torch.as_tensor(np.asarray(target_ids[lo:lo + batch]),
                              device=dev)
        logits = decoder.forward_last_logits(weights, cfg, ids, mask).float()
        kth = torch.topk(logits, TOP_FILTER).values[:, -1:]
        la = logits.gather(1, tgt)
        edge[lo:lo + len(ids)] = (la - kth).abs().min(1).values.cpu().numpy()
        split[lo:lo + len(ids)] = (la[:, 0] - la[:, 1]).abs().cpu().numpy()
    return edge, split


def _position0_partings(what, got, ref, edge, split, tie):
    """Packed rows' position-0 fields against isolated rows of the same
    prompts: a target may cross the top filter only where it lies within
    ``tie`` of its edge, the verdict turn only where the two targets lie
    within ``tie`` of each other, and every field moves by at most
    FUSED_PROB_TOL elsewhere.  Returns (stats, failures)."""
    fails, exact, worst, flips = [], 0, 0.0, 0
    for i, (a, b) in enumerate(zip(got, ref)):
        d = max(abs(a[k] - b[k]) for k in range(3))
        exact += d == 0
        worst = max(worst, d)
        if (a[0] > 0) != (b[0] > 0) or (a[1] > 0) != (b[1] > 0):
            if not edge[i] < tie:
                fails.append(f"{what}: row {i} target crosses the top "
                             f"{TOP_FILTER}: {a} vs {b}")
            continue
        if (a[2] >= 0.5) != (b[2] >= 0.5):
            flips += 1
            if not split[i] < tie:
                fails.append(f"{what}: row {i} verdict {a[2]} vs {b[2]}")
        if d > FUSED_PROB_TOL and not edge[i] < tie:
            fails.append(f"{what}: row {i} position-0 fields {a} vs {b}")
    return dict(rows=len(ref), exactly_equal=exact, max_abs_delta=worst,
                verdict_flips=flips), fails


def packed_phase(seed, attention, weights, near_tie, workdir, card):
    """Packed scoring on Falcon-7B over the sweep phase's corpus (its
    ``perturbations.json``, the targets on ids these weights often rank in
    the top 20): ``run_packed_perturbation_sweep`` at Q=PACK_Q with drift
    parity, then on the kernel and the dense route single-question packs
    and question 0 of each pack against isolated scoring, questions/s
    packed against isolated, and the causal kernel at the packed batch's
    shape."""
    import math

    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.config import legal_scenarios
    from llm_interpretation_replication_tpu_torch.gen.rephrase import (
        load_perturbations)
    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.scoring import packed
    from llm_interpretation_replication_tpu_torch.scoring import yes_no
    from llm_interpretation_replication_tpu_torch.sweeps import (
        PERTURBATION_COLUMNS, run_packed_perturbation_sweep)
    from llm_interpretation_replication_tpu_torch.utils.logging import (
        SessionLogger)
    from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx

    device = "cuda"
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    scenarios = load_perturbations(os.path.join(workdir, "perturbations.json"),
                                   expected_scenarios=legal_scenarios())
    word_tok = _sweep_tokenizer(scenarios)
    tok = _sweep_tokenizer(scenarios, _popular_targets(
        weights, cfg, scenarios, word_tok, range(len(word_tok.special))))
    prompts, targets, _ = sweep_packs(scenarios, PACK_Q)
    n = len(prompts)
    base = emod.EngineConfig(batch_size=BATCH)
    counted = {"forward_last_logits": 0, "forward_anchor_logits": 0}
    real = {name: getattr(decoder, name) for name in counted}

    def counting(name):
        def call(*args, **kwargs):
            counted[name] += 1
            return real[name](*args, **kwargs)
        return call

    def reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(attention)
        for k in counted:
            counted[k] = 0

    def launches_per_forward(name, res):
        forwards = sum(counted.values())
        res.update(kernel_launches=_launches(attention)[
            "causal_grouped_attention"], forwards=dict(counted))
        if not forwards or res["kernel_launches"] != cfg.num_layers * forwards:
            fails.append(f"{name}: {res['kernel_launches']} causal launches "
                         f"for {forwards} prompt forwards")

    fails, runs = [], []
    for name in counted:
        setattr(decoder, name, counting(name))
    try:
        # the packed sweep with drift parity: the isolated pass, then 30
        # packs of 4 in one prefill batch
        engine = emod.ScoringEngine("falcon", cfg, weights, tok,
                                    engine_config=base, device=device)
        out = os.path.join(workdir, "packed.xlsx")
        log = SessionLogger(
            log_file=os.path.join("chiprun_out", "packed_phase.log"),
            stream=io.StringIO())
        reset()
        t0 = time.perf_counter()
        _, drift = run_packed_perturbation_sweep(
            engine, SWEEP_MODEL, scenarios, out, packing=PACK_Q,
            checkpoint_every=SWEEP_CHECKPOINT, log=log)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        log.close()
        res = dict(run="packed_sweep", seconds=elapsed,
                   questions_per_s=n / elapsed,
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
        launches_per_forward("packed_sweep", res)
        runs.append(res)
        cols, book = read_xlsx(out)
        tag = f"local:packed{PACK_Q}:first_token_top{TOP_FILTER}"
        if cols != PERTURBATION_COLUMNS or len(book) != n or any(
                r["Log Probabilities"] != tag or r["Model Response"]
                or r["Confidence Value"] is not None for r in book):
            fails.append(f"packed sweep: workbook of {len(book)} rows")
        fields = ("mean_abs_delta", "p50_abs_delta", "p90_abs_delta",
                  "max_abs_delta", "flip_rate")
        if drift["n_questions"] != n or drift["n_skipped"] != 0 or not all(
                drift[f] is not None and math.isfinite(drift[f])
                for f in fields):
            fails.append(f"packed sweep: drift report {drift}")

        # questions/s, each call timed after a warm-up call
        iso = engine.first_token_relative_prob(prompts, targets,
                                               top_filter=TOP_FILTER)
        demos = packed.demos_from_relative_probs(iso[:, 2], targets)
        packs = packed.build_packs(prompts, PACK_Q, demos)
        speed = dict(card=card, questions=n, packs=len(packs))
        for name, call in (
                ("isolated", lambda: engine.first_token_relative_prob(
                    prompts, targets, top_filter=TOP_FILTER)),
                ("packed", lambda: engine.score_packed(
                    packs, targets, top_filter=TOP_FILTER))):
            call()
            reset()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            speed[f"{name}_questions_per_s"] = n / elapsed
            speed[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rows, _ = packed.encode_packs(tok, packs)
        lens = sorted(len(r) for r in rows)
        speed["packed_tokens"] = [lens[0], lens[-1]]
        speed["packed_bucket"] = batching.bucket_for(lens[-1], base.buckets)
        speed["isolated_buckets"] = sorted({
            b.bucket_len for b in batching.batches_for_prompts(
                batching.encode_prompts(tok, prompts), BATCH, base.buckets,
                length_sorted=True)})
        speed["packed_over_isolated"] = (speed["packed_questions_per_s"]
                                         / speed["isolated_questions_per_s"])
        engine.close()
        say("packed speed", json.dumps(speed))

        # kernel and dense routes: single-question packs and question 0 of
        # each pack against isolated scoring of the same prompts
        target_ids = [yes_no.target_token_ids(tok, t) for t in targets]
        edge, split = _target_margins(
            weights, cfg, [tok(p)["input_ids"] for p in prompts], target_ids)
        tie = 2 * near_tie
        stats = {}
        q0 = np.arange(0, n, PACK_Q)

        def fields(rows):
            return [(r["first_token_yes_prob"], r["first_token_no_prob"],
                     r["first_token_relative_prob"]) for r in rows]

        for route, rcfg in (("kernel", cfg), ("dense", dataclasses.replace(
                cfg, attention_impl="xla"))):
            eng = emod.ScoringEngine("falcon", rcfg, weights, tok,
                                     engine_config=base, device=device)
            reset()
            t0 = time.perf_counter()
            iso_r = eng.first_token_relative_prob(prompts, targets,
                                                  top_filter=TOP_FILTER)
            single = eng.score_packed(packed.build_packs(prompts, 1),
                                      targets, top_filter=TOP_FILTER)
            four = eng.score_packed(packs, targets, top_filter=TOP_FILTER)
            torch.cuda.synchronize()
            res = dict(run=f"packed_{route}", seconds=time.perf_counter() - t0,
                       peak_memory_bytes=torch.cuda.max_memory_allocated())
            if route == "kernel":
                launches_per_forward(res["run"], res)
            elif _launches(attention)["causal_grouped_attention"]:
                fails.append("dense route launched the causal kernel")
            runs.append(res)
            eng.close()
            iso_rows = [tuple(float(x) for x in r) for r in iso_r]
            stats[f"{route}_single"], f = _position0_partings(
                f"{route} Q=1", fields(single), iso_rows, edge, split, tie)
            fails += f
            stats[f"{route}_question0"], f = _position0_partings(
                f"{route} question 0", [fields(four)[i] for i in q0],
                [iso_rows[i] for i in q0], edge[q0], split[q0], tie)
            fails += f
            stats[f"{route}_drift"] = packed.drift_report(
                [r["first_token_relative_prob"] for r in four],
                iso_r[:, 2], PACK_Q)
    finally:
        for name in counted:
            setattr(decoder, name, real[name])

    # the causal kernel at the packed prefill's shape: the packs' real
    # lengths, in one batch of BATCH rows (pad rows repeat row 0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 10)
    b_lens = lens + [lens[0]] * (BATCH - len(lens))
    krow = _family_kernel_row(attention, "falcon-7b-packed", gen, BATCH,
                              speed["packed_bucket"], cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, b_lens)
    result = dict(card=card, packing=PACK_Q, questions=n, drift=drift,
                  speed=speed, runs=runs, stats=stats, parting_tie=tie,
                  kernel_rows=[krow], failures=fails[:50])
    say("packed gates", json.dumps(dict(card=card, drift=drift, stats=stats,
                                        failures=len(fails))))
    if fails:
        raise AssertionError(f"packed: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


def _k_chunk_timing(weights, cfg, prompts, head, n=10, kmax=K_DECODE):
    """One ``scan_steps`` chunk of the first BATCH prompts from their
    prefill cache: ms of the sequential ``decode_steps`` against ms of the
    accepted K path over the same positions (verify passes of a bootstrap
    block and then blocks of ``kmax``, the sequential tokens as proposals,
    each pass's acceptance read to the host as the engine reads it), and
    ms of one ``k_propose`` of ``head``'s ``kmax - 1`` projections.  Also
    where the passes' own argmax chain leaves the sequential one: each
    row's first mismatch in each block, with the sequential decode's lead
    (top-1 over top-2 logit) at that position."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    ids, mask = _padded(prompts[:BATCH], _device_of(weights))
    lengths = mask.sum(-1)
    last, cache = decoder.prefill(weights, cfg, ids, mask, ids.shape[1])
    tgt = torch.zeros((ids.shape[0], 2), dtype=torch.long, device=ids.device)
    seq, sc = decoder.decode_steps(weights, cfg, cache, last, lengths, 0, n,
                                   None, None, with_scores="reduced",
                                   target_ids=tgt)[:2]
    leads = (sc.topk_vals[..., 0] - sc.topk_vals[..., 1]).cpu().numpy()
    blocks = [1]
    while sum(blocks) < n:
        blocks.append(min(kmax, n - sum(blocks)))
    dt = cache.k.dtype

    mismatches = []           # (row, position) of each block's first

    def k_chunk(record=False):
        shape = (cfg.num_layers, ids.shape[0], n, cfg.num_kv_heads,
                 cfg.head_dim)
        tk = torch.zeros(shape, dtype=dt, device=ids.device)
        tv = torch.zeros(shape, dtype=dt, device=ids.device)
        prev, done, j = last, None, 0
        for kb in blocks:
            out = decoder.k_verify_block(
                weights, cfg, cache, tk, tv, prev, lengths, 0, j,
                seq[:, j:j + kb], None, done, tgt, fold=j + kb == n)
            a_len = torch.stack([out.a_len, out.accepted.long()]).cpu()[0]
            if record:
                mismatches.extend((r, j + int(a)) for r, a in
                                  enumerate(a_len.tolist()) if a < kb)
            prev, done, j = out.last_logits, out.done, j + kb
        return out

    hidden = k_chunk(record=True).last_hidden
    mismatch_leads = [float(leads[r, p]) for r, p in mismatches]
    res = dict(
        rows=int(ids.shape[0]), bucket=int(ids.shape[1]), chunk=n,
        blocks=blocks,
        sequential_ms=time_ms(lambda: decoder.decode_steps(
            weights, cfg, cache, last, lengths, 0, n, None, None,
            with_scores="reduced", target_ids=tgt), iters=3, warmup=1),
        k_path_ms=time_ms(k_chunk, iters=3, warmup=1),
        propose_ms=time_ms(lambda: decoder.k_propose(
            head, hidden, last, kmax), iters=3, warmup=1),
        row_blocks=int(ids.shape[0]) * len(blocks),
        mismatched_row_blocks=len(mismatches),
        widest_lead_at_a_mismatch=max(mismatch_leads, default=None),
        lead_quantiles=_quantiles(leads))
    del cache, last
    return res


def k_decode_phase(seed, attention, weights, near_tie, card):
    """The full-study row (``score_prefixed``, binary and confidence legs)
    on the full-study phase's 96 rows with the joint K-token decode:
    K=1, then K=K_DECODE with a distilled head, with oracle proposals
    (``oracle_engine``) and with a random head (every speculative block
    rejects); then K=1 and the oracle with an int8 KV cache."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    device = "cuda"
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    prefixes, suffixes = _study_inputs(seed, cfg.vocab_size)
    pairs = list(zip(prefixes, suffixes))
    n = len(pairs)
    joined = [[p + s[0] for p, s in pairs], [p + s[1] for p, s in pairs]]
    base = emod.EngineConfig()
    targets = _pool_targets(
        seed, weights, cfg, list(batching.batches_for_prompts(
            joined[0], base.batch_size, base.buckets, pad_id=0,
            length_sorted=True)), n, roles=STUDY_ROLES,
        last_roles=STUDY_ROLES, outside=STUDY_OUTSIDE, by_lead=True)
    target_ids = [[int(t[1:]) for t in pair] for pair in targets]
    tok = _id_tokenizer(cfg.vocab_size)
    legs = [emod.LegSpec("binary"),
            emod.LegSpec("confidence", with_confidence=True,
                         max_new_tokens=CONF_CAP)]
    oracle_cls = oracle_engine(emod, decoder)
    counted = {"prefill": 0, "k_verify_block": 0}
    real = {name: getattr(decoder, name) for name in counted}
    real_chunk = emod.ScoringEngine._k_decode_chunk
    chunks = [0]

    def counting(name):
        def call(*args, **kwargs):
            counted[name] += 1
            return real[name](*args, **kwargs)
        return call

    def counting_chunk(self, *args, **kwargs):
        chunks[0] += 1
        return real_chunk(self, *args, **kwargs)

    runs, rows = {}, {}
    keys = ("k_blocks_proposed", "k_blocks_rejected", "k_steps_saved",
            "k_steps_saved|leg=completion", "k_steps_saved|leg=confidence",
            "decode_steps_saved", "k_decode_head_missing")

    def run(name, engine):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        telemetry.clear_counters()
        hist = telemetry.hist_snapshot()
        _reset_launches(attention)
        for k in counted:
            counted[k] = 0
        chunks[0] = 0
        t0 = time.perf_counter()
        out = engine.score_prefixed(pairs, targets, legs=legs)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        c = telemetry.counters()
        acc = telemetry.hist_since(hist).get("accepted_k")
        res = dict(run=name, rows_per_s=n / elapsed, seconds=elapsed,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   kernel_launches=_launches(attention)[
                       "causal_grouped_attention"],
                   prefills=counted["prefill"],
                   verify_passes=counted["k_verify_block"],
                   k_chunks=chunks[0],
                   accepted_k_mean=(acc["sum"] / acc["count"]
                                    if acc else None),
                   **{k: c.get(k, 0) for k in keys})
        if res["k_blocks_proposed"]:
            res["accept_rate"] = 1 - (res["k_blocks_rejected"]
                                      / res["k_blocks_proposed"])
        if res["k_chunks"]:
            res["passes_per_chunk"] = res["verify_passes"] / res["k_chunks"]
        engine.close()
        runs[name], rows[name] = res, out
        say("k_decode", json.dumps(dict(res, card=card)))

    def engine(cls=emod.ScoringEngine, **kw):
        return cls("falcon", cfg, weights, tok, device=device,
                   engine_config=dataclasses.replace(base, **kw))

    fails, extra = [], {}
    for name in counted:
        setattr(decoder, name, counting(name))
    emod.ScoringEngine._k_decode_chunk = counting_chunk
    try:
        warm = engine()
        warm.score_prefixed(pairs[:base.batch_size],
                            targets[:base.batch_size], legs=legs)
        warm.close()
        run("k1", engine())
        distilled = engine(decode_k=K_DECODE)
        sample = ([p + s[0] for p, s in pairs[:K_DISTILL[0]]]
                  + [p + s[1] for p, s in pairs[:K_DISTILL[1]]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        head = distilled.distill_k_head_on(sample)
        torch.cuda.synchronize()
        extra.update(distill_s=time.perf_counter() - t0,
                     distill_rows=min(len(sample), 32),
                     k_head_gb=head["w"].numel() * head["w"].element_size()
                     / 1e9, k_head_dtype=str(head["w"].dtype))
        run("distilled", distilled)
        run("oracle", engine(oracle_cls, decode_k=K_DECODE))
        rejecting = engine(decode_k=K_DECODE)
        rejecting.k_head = decoder.init_k_head(
            cfg, K_DECODE, seed=seed + 11, dtype=torch.bfloat16, device=device)
        run("forced_rejection", rejecting)
        del rejecting
        run("k1_int8kv", engine(kv_dtype="int8"))
        run("oracle_int8kv", engine(oracle_cls, decode_k=K_DECODE,
                                    kv_dtype="int8"))
    finally:
        for name in counted:
            setattr(decoder, name, real[name])
        emod.ScoringEngine._k_decode_chunk = real_chunk

    timing = _k_chunk_timing(weights, cfg, joined[0], head)
    timing["card"] = card
    del head
    say("k_decode timing", json.dumps(timing))
    tie = 2 * near_tie
    # the sequential tokens proposed to the passes: the passes' own chain
    # may leave them only where the sequential lead is below the tie
    widest = timing["widest_lead_at_a_mismatch"]
    if widest is not None and not widest < tie:
        fails.append(f"k_decode timing: a pass left the sequential chain at "
                     f"a lead of {widest} (tie {tie})")

    # the int8 cache's own deviation: the top-1 logit of a greedy decode of
    # the confidence prompts from an int8 cache against one bf16 forward
    # over the same tokens; a K=1-vs-oracle parting on the int8 runs may
    # lie that much further from the bf16 forward's lead
    icfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    conf_batches = list(batching.batches_for_prompts(
        joined[1], base.batch_size, base.buckets, pad_id=0,
        length_sorted=True))
    itoks, _, itop1, _, _, _ = _study_prepass(
        weights, icfg, conf_batches, n, CONF_CAP, CONF_CAP, None, target_ids)
    int8_dev = float(np.abs(_teacher_top1(
        weights, cfg, joined[1], itoks.tolist())[0][:, :-1] - itop1).max())
    stats = {}
    for leg in (0, 1):
        leg_name = legs[leg].name
        for name, ref, leg_tie in (("distilled", "k1", tie),
                                   ("oracle", "k1", tie),
                                   ("oracle_int8kv", "k1_int8kv",
                                    tie + 2 * int8_dev)):
            ref_rows = rows[ref][leg]
            _, leads, edge0, _ = _teacher_top1(
                weights, cfg, joined[leg],
                [_completion_ids(r["completion"]) for r in ref_rows],
                target_ids=target_ids)
            stats[f"{name}_{leg_name}"], f = _compare_rows(
                f"{name} {leg_name}", rows[name][leg], ref_rows, leads,
                edge0, leg_tie, True, FUSED_WC_TOL)
            fails += f
        if rows["forced_rejection"][leg] != rows["k1"][leg]:
            fails.append(f"forced_rejection {leg_name}: rows differ from "
                         f"K=1")
    for name in ("oracle", "oracle_int8kv"):
        if not (runs[name]["k_blocks_proposed"] and runs[name]["k_steps_saved"]):
            fails.append(f"{name}: k_blocks_proposed "
                         f"{runs[name]['k_blocks_proposed']}, k_steps_saved "
                         f"{runs[name]['k_steps_saved']}")
    if not runs["forced_rejection"]["k_blocks_rejected"] \
            or runs["forced_rejection"]["k_steps_saved"]:
        fails.append("forced_rejection: no rejection, or steps saved")
    for name, res in runs.items():
        if not res["prefills"] or res["kernel_launches"] != \
                cfg.num_layers * res["prefills"]:
            fails.append(f"{name}: {res['kernel_launches']} causal launches "
                         f"for {res['prefills']} prefills")
        if name != "k1" and name != "k1_int8kv" and not res["k_chunks"]:
            fails.append(f"{name}: the K path never ran")
    result = dict(card=card, rows=n, decode_k=K_DECODE, runs=list(
        runs.values()), timing=timing, stats=stats, parting_tie=tie,
        int8_logit_deviation=int8_dev, failures=fails[:50], **extra)
    say("k_decode gates", json.dumps(dict(card=card, stats=stats, **extra,
                                          failures=len(fails))))
    if fails:
        raise AssertionError(f"k_decode: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result



# ---------------------------------------------------------------------------
# Guards and device observability (phase 18)
# ---------------------------------------------------------------------------

# the obs phase's rows: this many rephrasings of each scenario of the sweep
# phase's corpus (5 x 4 = 20 rows, one chunk, one batch)
OBS_PER_SCENARIO = 4
# what sync debug mode "error" is asked about on the card: each op once,
# inside a scoring guard (the negative control is the first)
SYNC_PROBES = ("item", "cpu", "bool_of_tensor", "nonzero", "bool_mask_index",
               "stream_synchronize", "device_synchronize",
               "event_synchronize", "pinned_nonblocking_d2h",
               "pageable_h2d_as_tensor", "scalar_tensor_h2d",
               "pinned_nonblocking_h2d", "pageable_nonblocking_h2d",
               "empty_cache")


def _same_rows(a, b):
    """Row lists equal field for field (NaN equal to NaN)."""
    return (len(a) == len(b) and all(
        json.dumps(x, sort_keys=True) == json.dumps(y, sort_keys=True)
        for x, y in zip(a, b)))


def _sync_probes(strict, telemetry):
    """The negative control and what the mode catches: with strict mode
    armed, each probe runs inside ``strict.scoring_guard``; returns
    ``{probe: raised}``, the ``blocked_transfers`` the probes added and the
    failures.  ``.item()`` must raise and add exactly 1, and not raise
    inside ``sanctioned_fetch``."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.device import to_device

    x = torch.arange(8, device="cuda", dtype=torch.float32)
    pinned = torch.empty(8, pin_memory=True)
    arr = np.arange(8, dtype=np.float32)

    def event_sync():
        event = torch.cuda.Event()
        event.record()
        event.synchronize()

    ops = {
        "item": lambda: x.sum().item(),
        "cpu": lambda: x.cpu(),
        "bool_of_tensor": lambda: bool((x > 3).any()),
        "nonzero": lambda: torch.nonzero(x),
        "bool_mask_index": lambda: x[x > 3],
        "stream_synchronize": lambda: (
            torch.cuda.current_stream().synchronize()),
        "device_synchronize": torch.cuda.synchronize,
        "event_synchronize": event_sync,
        "pinned_nonblocking_d2h": lambda: pinned.copy_(x, non_blocking=True),
        "pageable_h2d_as_tensor": lambda: torch.as_tensor(arr, device="cuda"),
        "scalar_tensor_h2d": lambda: torch.tensor(10000.0, device="cuda"),
        "pinned_nonblocking_h2d": lambda: to_device(arr, "cuda"),
        "pageable_nonblocking_h2d": lambda: torch.as_tensor(arr).to(
            "cuda", non_blocking=True),
        "empty_cache": torch.cuda.empty_cache,
    }
    assert tuple(ops) == SYNC_PROBES
    fails, raised = [], {}
    strict.activate(sentry=False)
    try:
        added = _run_sync_probes(strict, telemetry, ops, x, raised, fails)
    finally:
        strict.deactivate()
    return raised, added, fails


def _run_sync_probes(strict, telemetry, ops, x, raised, fails):
    import torch

    before = telemetry.counter(strict.BLOCKED_COUNTER)
    for name, op in ops.items():
        torch.cuda.synchronize()
        one = telemetry.counter(strict.BLOCKED_COUNTER)
        try:
            with strict.scoring_guard("sync_probe"):
                op()
            raised[name] = False
        except RuntimeError as err:
            if not strict._is_transfer_guard_error(err):
                raise
            raised[name] = True
        if telemetry.counter(strict.BLOCKED_COUNTER) - one != raised[name]:
            fails.append(f"probe {name}: blocked_transfers moved by "
                         f"{telemetry.counter(strict.BLOCKED_COUNTER) - one}")
        if strict.sync_debug_mode() != 0:
            fails.append(f"probe {name}: the mode was left at "
                         f"{strict.sync_debug_mode()}")
    if not raised["item"]:
        fails.append("negative control: .item() inside scoring_guard did "
                     "not raise")
    with strict.scoring_guard("sync_probe"):
        with strict.sanctioned_fetch():
            x.sum().item()
    return int(telemetry.counter(strict.BLOCKED_COUNTER) - before)


def obs_phase(seed, attention, weights, workdir, card):
    """Phase 18 on Falcon-7B at full width and depth (the slice's weights,
    the causal kernel): 20 rows of the sweep phase's corpus through
    ``run_model_perturbation_sweep``, after a warm-up run: (a) plain, (b)
    with strict mode, the tracer, the metrics log and a ``profile_window``
    capture all armed, (b') strict alone again (the warm repeat), (c) with
    the tracer in sync mode; then the negative control and the sync
    probes."""
    import torch

    from llm_interpretation_replication_tpu_torch import obs
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios
    from llm_interpretation_replication_tpu_torch.gen.rephrase import (
        load_perturbations)
    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.obs import metrics, report
    from llm_interpretation_replication_tpu_torch.obs.profiler import (
        device_memory_snapshot, profile_window)
    from llm_interpretation_replication_tpu_torch.obs.tracer import (
        KNOWN_PHASES)
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.runtime import strict
    from llm_interpretation_replication_tpu_torch.sweeps import (
        run_model_perturbation_sweep)
    from llm_interpretation_replication_tpu_torch.utils import (
        profiling, telemetry)
    from llm_interpretation_replication_tpu_torch.utils.logging import (
        SessionLogger)

    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    scenarios = [dict(s, rephrasings=s["rephrasings"][:OBS_PER_SCENARIO])
                 for s in load_perturbations(
                     os.path.join(workdir, "perturbations.json"),
                     expected_scenarios=legal_scenarios())]
    n_rows = sum(len(s["rephrasings"]) for s in scenarios)
    tok = _sweep_tokenizer(scenarios)
    engine = emod.ScoringEngine("falcon", cfg, weights, tok, device="cuda",
                                engine_config=emod.EngineConfig(
                                    batch_size=BATCH))
    out_dir = os.path.join(workdir, "obs")
    prof_dir = os.path.join(out_dir, "profile")
    counted = {"prefill": 0, "modes": set()}
    real_prefill = decoder.prefill

    def counting(*args, **kwargs):
        # the sync debug mode the launch path runs at (2: "error")
        counted["prefill"] += 1
        counted["modes"].add(strict.sync_debug_mode())
        return real_prefill(*args, **kwargs)

    runs, rows, fails = {}, {}, []

    def sweep(name, armed=(), sync=False):
        counted["prefill"] = 0
        counted["modes"] = set()
        _reset_launches(attention)
        obs.get_tracer().reset()
        if "strict" in armed:
            strict.activate()
        if "trace" in armed:
            obs.enable(jsonl_path=os.path.join(out_dir, f"{name}.spans.jsonl"),
                       sync=sync, memory=True)
        if "metrics" in armed:
            metrics.enable_jsonl(
                os.path.join(out_dir, f"{name}.metrics.jsonl"))
        snap = telemetry.counters()
        try:
            with profile_window(prof_dir if "profile" in armed else None,
                                enabled="profile" in armed) as captured:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows[name] = run_model_perturbation_sweep(
                    engine, SWEEP_MODEL, scenarios,
                    os.path.join(out_dir, f"{name}.xlsx"),
                    log=SessionLogger(stream=io.StringIO()))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            obs.disable()
            metrics.get_registry().disable_jsonl()
            strict.deactivate()
        delta = telemetry.counters_since(snap)
        totals = obs.phase_totals(by_leg=True)
        res = dict(run=name, armed=list(armed), sync=sync, seconds=wall,
                   rows=len(rows[name]), rows_per_s=len(rows[name]) / wall,
                   prefills=counted["prefill"],
                   launch_modes=sorted(counted["modes"]),
                   kernel_launches=_launches(attention)[
                       "causal_grouped_attention"],
                   blocked_transfers=int(delta.get(strict.BLOCKED_COUNTER, 0)),
                   recompile_events=int(
                       delta.get(strict.RECOMPILE_COUNTER, 0)),
                   profile_started=captured)
        if totals:
            block = report.phases_block(totals, wall_s=wall, rows=n_rows)
            res["phases"] = block
            res["spans"] = len(obs.get_tracer().spans())
            unknown = set(totals) - KNOWN_PHASES
            if unknown:
                fails.append(f"obs {name}: phases outside KNOWN_PHASES "
                             f"{sorted(unknown)}")
            if not block["total_s"] <= wall:
                fails.append(f"obs {name}: phase self-times {block['total_s']}"
                             f" s exceed the call's {wall} s")
        runs[name] = res
        say("obs", json.dumps(dict({k: v for k, v in res.items()
                                    if k != "phases"}, card=card)))

    os.makedirs(out_dir, exist_ok=True)
    decoder.prefill = counting
    try:
        sweep("warmup")             # first use of these shapes: not compared
        sweep("plain")
        sweep("armed", ("strict", "trace", "metrics", "profile"))
        sweep("strict_repeat", ("strict",))
        sweep("sync_traced", ("trace",), sync=True)
    finally:
        decoder.prefill = real_prefill
    engine.close()
    memory = device_memory_snapshot("obs")
    raised, probe_blocked, probe_fails = _sync_probes(strict, telemetry)
    fails += probe_fails

    for name in ("warmup", "armed", "strict_repeat", "sync_traced"):
        if not _same_rows(rows[name], rows["plain"]):
            fails.append(f"obs {name}: rows differ from the plain run's")
    for name in ("armed", "strict_repeat"):
        if runs[name]["launch_modes"] != [2]:
            fails.append(f"obs {name}: the launch path ran at sync debug "
                         f"modes {runs[name]['launch_modes']}, not 2")
    for name, res in runs.items():
        if len(rows[name]) != n_rows:
            fails.append(f"obs {name}: {len(rows[name])} rows, not {n_rows}")
        if not res["prefills"] or res["kernel_launches"] != \
                cfg.num_layers * res["prefills"]:
            fails.append(f"obs {name}: {res['kernel_launches']} causal "
                         f"launches for {res['prefills']} prefills")
    armed = runs["armed"]
    if armed["blocked_transfers"] or \
            runs["strict_repeat"]["blocked_transfers"]:
        fails.append(f"obs: blocked_transfers {armed['blocked_transfers']} / "
                     f"{runs['strict_repeat']['blocked_transfers']}")
    if runs["strict_repeat"]["recompile_events"]:
        fails.append(f"obs: {runs['strict_repeat']['recompile_events']} nvcc "
                     f"builds on the warm repeat")
    if armed["profile_started"] is not True:
        fails.append("obs: profile_window did not start a capture")
    ranked = profiling.top_device_ops(prof_dir, 10 ** 6) if armed[
        "profile_started"] else []
    top = ranked[:10]
    events = profiling.device_op_events(prof_dir) if ranked else {}
    # the causal kernel's template instance (the projection-layout rows)
    causal = {name: n for name, (n, _) in events.items()
              if "tile_kernel" in name and "BsndRows" in name}
    causal_rank = [i for i, (name, _) in enumerate(ranked) if name in causal]
    causal_events = sum(causal.values())
    if not causal_rank:
        fails.append("obs: top_device_ops names no causal kernel")
    if causal_events != cfg.num_layers * armed["prefills"]:
        fails.append(f"obs: {causal_events} causal kernel events in the "
                     f"profile for {armed['prefills']} prefills")
    if not memory or not all(0 < m["bytes_in_use"] <= m["bytes_limit"]
                             for m in memory):
        fails.append(f"obs: device memory snapshot {memory}")
    coverage = armed["phases"]["coverage"]
    say("obs phase table\n" + report.format_phase_table(
        armed["phases"], title=f"phase attribution (Falcon-7B, {n_rows} "
                               f"rows, strict + trace + metrics + profile; "
                               f"{card})"))
    say("obs phase table, sync mode\n" + report.format_phase_table(
        runs["sync_traced"]["phases"],
        title=f"phase attribution (sync=True; {card})"))
    say("obs top device ops", json.dumps(dict(card=card, top=top)))
    summary = dict(card=card, rows=n_rows,
                   rows_per_s={k: r["rows_per_s"] for k, r in runs.items()},
                   coverage=coverage,
                   sync_coverage=runs["sync_traced"]["phases"]["coverage"],
                   causal_kernel_events=causal,
                   causal_kernel_rank=causal_rank[:1],
                   device_ops=len(ranked), memory=memory,
                   sync_probe_raised=raised,
                   probe_blocked_transfers=probe_blocked,
                   failures=len(fails))
    say("obs gates", json.dumps(summary))
    result = dict(summary, runs=list(runs.values()), top_device_ops=top,
                  failures=fails[:50])
    if fails:
        raise AssertionError(f"obs: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


def obs_cli_phase(workdir, card):
    """Phase 18's CLI leg, on the CLI phase's 2-layer snapshot:
    ``run-perturbation --strict --trace T --profile D --metrics M`` must
    write the workbook of the same call without them, and ``obs report
    --trace T`` must parse the trace and print the phase table."""
    import torch

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch.obs import report
    from llm_interpretation_replication_tpu_torch.runtime import strict
    from llm_interpretation_replication_tpu_torch.utils import (
        profiling, telemetry)
    from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx

    snap = os.path.join(workdir, "falcon-7b-2l")
    argv = ["run-perturbation", "--model", snap, "--perturbations",
            os.path.join(workdir, "perturbations.json"),
            "--attention-impl", "flash", "--batch-size", str(BATCH)]
    art = os.path.join(workdir, "obs_cli")
    trace = os.path.join(art, "trace.json")
    prof = os.path.join(art, "profile")
    mlog = os.path.join(art, "metrics.jsonl")
    books, runs, fails = {}, [], []
    for name, extra in (("plain", []),
                        ("flags", ["--strict", "--trace", trace, "--profile",
                                   prof, "--metrics", mlog])):
        out = os.path.join(art, name)
        snap_c = telemetry.counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(argv + ["--output-dir", out] + extra)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        delta = telemetry.counters_since(snap_c)
        books[name] = read_xlsx(os.path.join(out, "perturbation_results.xlsx"))
        runs.append(dict(run=name, seconds=elapsed,
                         rows_per_s=len(books[name][1]) / elapsed,
                         blocked_transfers=int(delta.get(
                             strict.BLOCKED_COUNTER, 0))))
        say("obs cli", json.dumps(dict(runs[-1], card=card)))
    if books["flags"] != books["plain"]:
        fails.append("obs cli: the flagged workbook differs")
    if runs[1]["blocked_transfers"]:
        fails.append(f"obs cli: blocked_transfers "
                     f"{runs[1]['blocked_transfers']}")
    buf = io.StringIO()
    real_stdout, sys.stdout = sys.stdout, buf
    try:
        rc = report.main(["report", "--trace", trace])
    finally:
        sys.stdout = real_stdout
    table = buf.getvalue()
    say("obs report --trace\n" + table.rstrip())
    if rc != 0 or "prefill" not in table:
        fails.append(f"obs cli: obs report exited {rc}")
    with open(mlog) as f:
        samples = sum(1 for line in f if line.strip())
    top = profiling.top_device_ops(prof, 5)
    if not samples or not top:
        fails.append(f"obs cli: {samples} metrics samples, profile top {top}")
    if not os.path.exists(trace + ".spans.jsonl"):
        fails.append("obs cli: no span log")
    result = dict(card=card, runs=runs, metrics_samples=samples,
                  profile_top=top, report_lines=len(table.splitlines()),
                  failures=fails[:50])
    say("obs cli gates", json.dumps({k: v for k, v in result.items()
                                     if k != "runs"}))
    if fails:
        raise AssertionError(f"obs cli: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


TOKENIZER_CHUNK = 10     # the phase's sweep chunk: two, so the prefetcher runs
#: sha256 of each format's ids (with special tokens, ``_ids_digest``) over
#: ``_tokenizer_digest_texts()``, the files learned on
#: ``_tokenizer_learn_texts()``: the ``tokenizers`` package and the JAX
#: package's loader compute the same on the CPU
#: (tests/test_torch_tokenizer.py)
TOKENIZER_DIGESTS = {
    "falcon": "0eab6160252d142550c8e11bb012e70939c4f6624c70409250d34a43360eaf60",
    "bloom": "657ea138c438af199faf905ee92e3979c81ea58f117704868efe1a09d4289d7c",
    "llama": "89fc69bc23c1f7b49158bed31fcc269c6002ec8aa0bc0cceb5ae5f6f2042e7ff",
    "mistral_v03":
        "9af18574ce5c6fe1355481d49f5a322b89c7e1ab0a1d624e51dc5faf0558b0a6",
    "t5": "754860bf3f1db2979a67bd143dbdc8b77941ae7466a7e9d257fd49e8931aa71b",
}


def _tokenizer_learn_texts():
    """What the tokenizers phase's files are learned on (no seed): the
    legal scenarios' texts and targets and the 100 questions."""
    from llm_interpretation_replication_tpu_torch.config import (
        legal_scenarios, ordinary_meaning_questions)

    out = [s[k] for s in legal_scenarios()
           for k in ("original_main", "response_format", "confidence_format")]
    out += [" " + t for s in legal_scenarios() for t in s["target_tokens"]]
    return out + ordinary_meaning_questions()


def _tokenizer_digest_texts():
    """The fixed texts the digests cover: the legal scenarios, the 100
    questions' prompts (base and instruct) and ``TOKENIZER_EDGE_TEXTS``."""
    from llm_interpretation_replication_tpu_torch.config import (
        legal_scenarios, ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.scoring import prompts

    out = [s[k] for s in legal_scenarios()
           for k in ("original_main", "response_format", "confidence_format")]
    out += [" " + t for s in legal_scenarios() for t in s["target_tokens"]]
    out += [prompts.format_prompt(q, base)
            for q in ordinary_meaning_questions() for base in (True, False)]
    return out + list(TOKENIZER_EDGE_TEXTS)


def _ids_digest(id_lists):
    import hashlib

    return hashlib.sha256(json.dumps(
        [list(map(int, ids)) for ids in id_lists],
        separators=(",", ":")).encode()).hexdigest()


def tokenizers_phase(seed, attention, weights, workdir, card):
    """Phase 19 on the card's host and Falcon-7B at full width and depth:
    each published tokenizer format of ``TOKENIZER_FORMATS``, written as
    plain JSON and read back through ``load_tokenizer`` from a directory,
    encodes the sweep corpus (the scenarios and their rephrasings;
    tokens/s) and decodes it back, and its ids over the fixed
    ``_tokenizer_digest_texts()`` hash to ``TOKENIZER_DIGESTS``; then 20
    rows of the corpus, encoded by the Falcon-format reader, go through
    ``run_model_perturbation_sweep`` on the slice's weights (32 layers,
    bf16, the causal kernel) with the span tracer on, and again without
    it: rows/s, the share of the traced run's wall time in the
    prefetcher's encode spans, every row finite, the rerun's rows
    equal."""
    import math

    import torch

    from llm_interpretation_replication_tpu_torch import obs
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios
    from llm_interpretation_replication_tpu_torch.gen.rephrase import (
        load_perturbations)
    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.runtime.loader import (
        load_tokenizer)
    from llm_interpretation_replication_tpu_torch.sweeps import (
        run_model_perturbation_sweep)
    from llm_interpretation_replication_tpu_torch.utils import tokenizer_parts
    from llm_interpretation_replication_tpu_torch.utils.logging import (
        SessionLogger)
    from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx

    scenarios = load_perturbations(os.path.join(workdir, "perturbations.json"),
                                   expected_scenarios=legal_scenarios())
    corpus = [s["original_main"] for s in scenarios] + [
        r for s in scenarios for r in s["rephrasings"]]
    learn, digest_texts = _tokenizer_learn_texts(), _tokenizer_digest_texts()
    formats, toks, fails = {}, {}, []
    for fmt, model in TOKENIZER_FORMATS.items():
        path = os.path.join(workdir, f"tokenizer_{fmt}")
        os.makedirs(path)
        t0 = time.perf_counter()
        files = _format_tokenizer_files(fmt, learn)
        _write_tokenizer_files(path, files)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok = toks[fmt] = load_tokenizer(path)
        load_s = time.perf_counter() - t0
        digest = _ids_digest(tok.encode(t) for t in digest_texts)
        t0 = time.perf_counter()
        ids = [tok.encode(t) for t in corpus]
        encode_s = time.perf_counter() - t0
        # T5's decode gives the normalized text (charsmap, folded spaces)
        normalize = tokenizer_parts.normalizer(files[0]["normalizer"])
        want = [normalize(t) for t in corpus] if fmt == "t5" else corpus
        back = [tok.decode(i, skip_special_tokens=True) for i in ids]
        bad = [t for t, b, w in zip(corpus, back, want) if b != w]
        n_tokens = sum(map(len, ids))
        formats[fmt] = dict(
            model=model, reader=type(tok).__name__, vocab=len(tok),
            pre_tokenizer=(files[0].get("pre_tokenizer") or {}).get("type"),
            normalizer=(files[0].get("normalizer") or {}).get("type"),
            texts=len(corpus), tokens=n_tokens, encode_s=encode_s,
            tokens_per_s=n_tokens / encode_s, write_s=write_s, load_s=load_s,
            digest=digest, round_trip_failures=len(bad))
        say("tokenizers", json.dumps(dict(format=fmt, **formats[fmt],
                                          card=card)))
        if digest != TOKENIZER_DIGESTS.get(fmt):
            fails.append(f"{fmt}: ids digest {digest}, pinned "
                         f"{TOKENIZER_DIGESTS.get(fmt)}")
        if bad:
            fails.append(f"{fmt}: {len(bad)} texts do not decode back, e.g. "
                         f"{bad[0][:80]!r}")
        want_reader = "UnigramTokenizer" if fmt == "t5" else \
            "ByteLevelBPETokenizer"
        if formats[fmt]["reader"] != want_reader:
            fails.append(f"{fmt}: read by {formats[fmt]['reader']}")

    # 20 rows through the sweep, encoded by the Falcon-format reader
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    rows_in = [dict(s, rephrasings=s["rephrasings"][:OBS_PER_SCENARIO])
               for s in scenarios]
    n_rows = sum(len(s["rephrasings"]) for s in rows_in)
    engine = emod.ScoringEngine("falcon", cfg, weights, toks["falcon"],
                                device="cuda", engine_config=emod.EngineConfig(
                                    batch_size=BATCH))
    counted = {"prefill": 0}
    real_prefill = decoder.prefill

    def counting(*args, **kwargs):
        counted["prefill"] += 1
        return real_prefill(*args, **kwargs)

    runs, rows = [], {}
    decoder.prefill = counting
    try:
        for name in ("traced", "rerun"):
            counted["prefill"] = 0
            _reset_launches(attention)
            obs.get_tracer().reset()
            if name == "traced":
                obs.enable()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows[name] = run_model_perturbation_sweep(
                    engine, SWEEP_MODEL, rows_in,
                    os.path.join(workdir, f"tokenizers_{name}.xlsx"),
                    score_chunk=TOKENIZER_CHUNK,
                    log=SessionLogger(stream=io.StringIO()))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                obs.disable()
            encode = [s["dur"] for s in obs.get_tracer().spans()
                      if s["name"] == "prefetch"]
            runs.append(dict(
                run=name, seconds=wall, rows=len(rows[name]),
                rows_per_s=len(rows[name]) / wall, prefills=counted["prefill"],
                kernel_launches=_launches(attention)[
                    "causal_grouped_attention"],
                encode_spans=len(encode), encode_s=sum(encode),
                tokenize_share=sum(encode) / wall if encode else None))
            say("tokenizers sweep", json.dumps(dict(runs[-1], card=card)))
    finally:
        decoder.prefill = real_prefill
        engine.close()
    for res in runs:
        if (not res["prefills"]
                or res["kernel_launches"] != cfg.num_layers * res["prefills"]):
            fails.append(f"sweep {res['run']}: {res['kernel_launches']} "
                         f"causal launches for {res['prefills']} prefills")
    traced = runs[0]
    if traced["encode_spans"] != math.ceil(n_rows / TOKENIZER_CHUNK):
        fails.append(f"sweep: {traced['encode_spans']} prefetch spans")
    for name, got in rows.items():
        if len(got) != n_rows or not all(
                math.isfinite(r["Token_1_Prob"])
                and math.isfinite(r["Token_2_Prob"]) for r in got):
            fails.append(f"sweep {name}: {len(got)} rows, or a probability "
                         "not finite")
    books = [read_xlsx(os.path.join(workdir, f"tokenizers_{name}.xlsx"))
             for name in rows]
    if not _same_rows(rows["traced"], rows["rerun"]) or books[0] != books[1]:
        fails.append("sweep: the rerun's rows or workbook differ")
    result = dict(card=card, formats=formats, runs=runs, rows=n_rows,
                  failures=fails[:50])
    say("tokenizers gates", json.dumps(dict(
        card=card, tokens_per_s={f: r["tokens_per_s"]
                                 for f, r in formats.items()},
        tokenize_share=traced["tokenize_share"], failures=len(fails))))
    if fails:
        raise AssertionError(f"tokenizers: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


def _strict_audit(stderr):
    """The ``# strict: {...}`` audit lines a ``--strict`` CLI run prints."""
    return [json.loads(line.split(": ", 1)[1]) for line in stderr.splitlines()
            if line.startswith("# strict: ")]

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llm_interpretation_replication_tpu_torch.ops import _build
    # the ops package re-exports a function named ``attention``
    attention = importlib.import_module(
        "llm_interpretation_replication_tpu_torch.ops.attention")

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    say(smi.splitlines()[0])

    seconds = {}

    def timed(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t0
        say(f"phase {name}: {seconds[name]:.1f} s")
        return out

    card = smi.splitlines()[0]
    build = timed("build", build_phase, _build, attention)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    krows = timed("kernels", kernel_phase, attention, gen)
    erows = timed("edge", edge_phase, attention, gen)
    sres, bf16_rows, weights = timed("slice", slice_phase, args.seed, attention)
    pres = timed("pooled", pooled_phase, args.seed, attention, weights)
    fres = timed("full_study", full_study_phase, args.seed, attention, weights)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        wres = timed("sweep", sweep_phase, args.seed, attention, weights,
                     workdir, card)
        pkres = timed("packed", packed_phase, args.seed, attention, weights,
                      fres["near_tie"], workdir, card)
        kres = timed("k_decode", k_decode_phase, args.seed, attention,
                     weights, fres["near_tie"], card)
        ores = timed("obs", obs_phase, args.seed, attention, weights,
                     workdir, card)
        tres = timed("tokenizers", tokenizers_phase, args.seed, attention,
                     weights, workdir, card)
        del weights
        torch.cuda.empty_cache()
        ires = timed("int8", int8_phase, args.seed, attention, bf16_rows)
        cres = timed("cli", cli_phase, args.seed, attention, workdir, card)
        ocres = timed("obs_cli", obs_cli_phase, workdir, card)
        torch.cuda.empty_cache()
        fam = timed("families", families_phase, args.seed, attention, card)
        qres = timed("run_100q", run100q_cli_phase, args.seed, workdir, card)
        torch.cuda.empty_cache()
        inst = timed("instruct", instruct_phase, args.seed, attention,
                     workdir, card)
        ires_cli = timed("run_instruct_sweep", instruct_cli_phase, args.seed,
                         workdir, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # the causal kernel's launches over every main-path run (each counted
    # from 0 just before it); the head-major kernels run on forced routes
    causal = causal_launches(sres, pres, fres, ires, wres, pkres, kres, ores,
                             tres, cres, fam, inst)
    launches = {"causal_grouped_attention": causal,
                "grouped_attention": sres["forced_routes"]["grouped"]["launches"],
                "flash_attention": sres["forced_routes"]["pallas"]["launches"]}
    kernels = []
    for name, source, line, _, _ in KERNELS:
        mine = [r for r in krows + erows + fam["kernel_rows"]
                + inst["kernel_rows"] + pkres["kernel_rows"]
                if r["kernel"] == name]
        main_row = next(r for r in mine
                        if r.get("shape") == "falcon-7b" and r["causal"])
        kernels.append(dict(
            name=name, route="cuda",
            source=f"llm_interpretation_replication_tpu_torch/ops/csrc/{source}.cu",
            replaces=f"llm_interpretation_replication_tpu/ops/attention.py:{line}",
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, build=build,
                       edge_rows=erows, kernel_rows=krows, slice=sres,
                       pooled=pres, full_study=fres, sweep=wres,
                       packed=pkres, k_decode=kres, obs=ores, obs_cli=ocres,
                       tokenizers=tres,
                       int8=ires, cli=cres, families=fam, run_100q=qres,
                       instruct=inst,
                       run_instruct_sweep=ires_cli, phase_seconds=seconds,
                       kernels=kernels), f, indent=1)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
