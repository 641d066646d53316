#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure (the exit code is then non-zero and no result
line is printed; the order of the run is 1-8, 10, 16, 17, 18, 19, 20, 9,
11, 18's CLI leg, 20's CLI leg, 21, 12, 23, 13-15, 22, 24, 25):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile every CUDA source of ``ops/csrc`` (one ``nvcc`` each, all
   started together) and print, for each kernel template instance (the
   tile core at padded head dims 64, 128 and 256), its ptxas registers,
   spills and shared memory;
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
   script, and its v theirs up to the clamp; the other decoder families'
   prompt batches (FAMILY_KERNEL_SHAPES: GPT-J-6B's 16 heads of 256
   through all three kernels, Qwen2-7B's 28/4 and GLM-4-9B's and
   ChatGLM3-6B's 32/2 heads of 128) come after the rest;
4. edge: the three kernels on ``attention_tile.cuh`` (causal grouped,
   head-major grouped with K/V unrepeated, flash) against their plain
   versions, causal and not, at the shapes where a pipelined tile loop goes
   wrong: S in {1, 63, 64, 65, 127, 129} x D in {64, 96, 128, 256} x
   (N, G) in {(71, 1), (8, 2), (4, 4)} with a full, a length-1, a
   length-0 and a mid-tile row, and S=4097 (B=1, (4, 4)): 152 cases a
   kernel, 456 in all;
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
8. full study: the full-study row on the slice's weights (their first
   FULL_STUDY_LAYERS, 8, of 32 layers) at ``EngineConfig()``: 96 prefixes
   of 100-440 tokens, each with a binary and a confidence suffix of a
   scenario's format lengths (19-21 and 30-35 words).  A greedy pre-pass
   decodes both legs as the per-batch route does, and gives the id
   tokenizer a decode map under which chosen tokens read as a terminated
   number, so confidence rows retire mid-decode and some position-0
   candidates read as digits.  Five runs on the same rows:
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
10. sweep (before the int8 phase, on the first SWEEP_LAYERS (2) of the
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
   their published width and FAMILY_LAYERS (2) of their 30-32 layers:
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
   --attention-impl flash`` in a child process, stopped by SIGTERM after
   its first model, must leave exactly that model's rows in its
   checkpoint; resuming it under ``--strict`` must skip that model, name
   each other model's attention (dense for BLOOM and Mistral-7B-v0.1) and
   write 1200 rows in the 10 columns, each with ``success``, the first
   model's equal to the checkpoint's; a rerun over the finished output
   (the same command in the smoke's own process: it starts no model)
   must score nothing;
14. instruct: the instruct roster's new models at their published width
   (random bf16 HF-named checkpoints from ``--seed`` through the port's
   converters; T5's at its own initialization scales; T0_3B and the T5
   pair at their depth, the decoders at FAMILY_LAYERS), under the
   families phase's word tokenizer with the targets swapped to ids the
   weights rank high.  T0_3B (T5 XL) scores the first
   INSTRUCT_T5_QUESTIONS (32) of the 100 instruct prompts through the
   instruct sweep's per-model call, and the word-meaning pair
   (t5-v1_1-base, flan-t5-base) runs through
   ``sweeps.run_base_vs_instruct_word_meaning`` (the base model's few-shot
   prompt on T5): each T5 model's rows against the same prompts at batch
   T5_SECOND_BATCH (16; partings only below the tie measured between the
   decode and one forward over its tokens) and position-0 fields within twice one bf16
   forward's deviation from float32, and ms a decode step.  Qwen-7B-Chat,
   Baichuan2-7B-Chat (NormHead) and OPT-IML-1.3B run phase 12's routes and
   gates (kernel and dense) on the instruct prompts, the causal kernel
   timed at each one's longest prompt batch;
15. run-instruct-sweep: 2-layer snapshots of the roster's six geometries
   phase 13 did not write (a Unigram ``tokenizer.json`` behind a
   Precompiled charsmap for the T5s, Baichuan2's SentencePiece BPE
   ``tokenizer.model`` alone, which the parent reads back first, Mistral
   v0.3's Metaspace "first" byte-fallback BPE, ``qwen.tiktoken`` for
   Qwen, OPT's ``vocab.json`` + ``merges.txt``, byte-level BPE for
   h2oGPT) beside phase 13's Falcon, BLOOM and
   RedPajama snapshots; ``python -m llm_interpretation_replication_tpu_torch
   run-instruct-sweep --attention-impl flash --quant int8`` in a child
   process must write 1000 rows in the 7 columns, none a ``MODEL_ERROR``,
   name each model's attention (dense for BLOOMZ and the T5s, which warn
   and load bf16), keep exactly the first model's rows after a SIGTERM,
   resume to the same CSV and score nothing on a rerun;
16. packed (after the sweep phase, on the slice's weights at
   FULL_STUDY_LAYERS, 8, of 32 layers, where the full-study phase measured
   the tie its gates take): the sweep
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
17. k_decode (after phase 16, on the first K_DECODE_LAYERS (2) of the
   slice's 32 layers, views; its near-tie measured there): the
   full-study row (``score_prefixed``, both
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
18. obs (after phase 17, on the first OBS_LAYERS (2) of the slice's
   layers, views; guards and device observability): 20 rows of the sweep phase's corpus (5 scenarios x 4
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
   Precompiled charsmap, written as plain JSON; a SentencePiece Unigram
   ``spiece.model`` and Baichuan2's byte-fallback BPE ``tokenizer.model``,
   written by the port's own ``ModelProto`` serializer) and read back
   through ``load_tokenizer``: the sweep corpus encoded (tokens/s on the
   card's host) and decoded back, and a sha256 of its ids over the fixed
   ``_tokenizer_digest_texts()`` equal to ``TOKENIZER_DIGESTS`` (the
   ``tokenizers`` package's and the JAX loader's on the CPU, for the
   model files ``transformers``' conversion's, so a different
   ``unicodedata`` on the card's Python shows); then 20 rows
   of the corpus encoded by the Falcon-format reader through
   ``run_model_perturbation_sweep`` at OBS_LAYERS layers on the causal
   kernel, traced (rows/s, the prefetcher's encode spans' share of the
   wall) and again untraced: every row finite, the rerun's rows equal, a
   causal launch a layer and prefill;
20. serve (after phase 19, on the slice's weights at full depth, batch 32,
   ``attention_impl="flash"``): the serving layer (``serve/``): replay
   of SERVE_REPLAY_PROMPTS (192) of the pooled phase's prompts with slot
   admission under strict
   mode (``blocked_transfers`` 0, rows admitted mid-decode),
   SERVE_PREFIX_PAIRS (16) of the full-study prefix/suffix pairs through
   ``score_prefixed``, an OOM
   split under a memory cap between the needs of a micro-batch of 16 and
   one of 32 (``serve_oom_split`` events, every request answered), a
   two-replica ``build_shared_pool`` over a copy of the weights serving
   SERVE_POOL_PROMPTS of the replay's prompts (both
   replicas answer; after both hot unloads ``memory_allocated`` within
   SERVE_MEMORY_SLACK of its value before the copy), prefill/decode roles
   with an int8 KV cache (slab export and import rows balance), a
   supervised pair in which ``BreakableEngine`` crashes one replica and
   wedges its rebuilt successor (crash and wedge counted, both rebuilt,
   the rebuild ms printed), and the load harness (a closed loop, then
   open loops at 0.25/0.5/0.9 of its rate: p50/p90/p99, phase medians,
   achieved against offered).  Every leg's rows equal an offline call's
   (``rows_equal``), and its causal launches equal its layers x prefills
   (at least that in the OOM leg).  Its CLI leg (after phase 18's, on
   phase 11's snapshot): ``serve --input`` over 64 JSONL lines, one
   malformed, under ``--strict`` with ``--metrics-port`` (``/healthz``
   and ``/metrics`` fetched while it serves), ``--replay`` (exit 0 on
   parity) and ``--load-rate`` with three rates through
   ``--pool-replicas 2 --supervise``;
21. api (after phase 20's CLI leg, on the slice's weights at full width
   and depth, the causal kernel; budget API_BUDGET_S, 40 s): the API leg
   over scripted vendors (``_api_transport``: each answer drawn from a CRC
   of the prompt, so no socket is opened).  ``generate-irrelevant``
   through the port's CLI writes the 3,400-row irrelevant-insertion
   corpus, whose JSON must hash to IRRELEVANT_CORPUS_SHA256; 256 of its
   binary prompts are scored on the card under a word tokenizer of the
   corpus (token counts, rows/s and the share decided at position 0 are
   printed, not gated; a causal launch a layer and prefill); a mixed pool
   of two local replicas beside ``RemoteBackend.openai``, ``.gemini`` and
   ``.anthropic`` serves 64 local and 24 remote requests under strict mode
   (local rows equal an offline call's, remote rows the evaluators' on
   the same answers, the shared cost tracker's total its expected sum,
   ``blocked_transfers`` 0, both local replicas answer); and a child
   process runs ``run-api-perturbation``, ``run-claude-perturbation``,
   ``run-gpt-perturbation`` and ``run-gemini-perturbation`` on 2
   scenarios x 5 rephrasings (10 rows each, the right columns; a second
   run resumes from the workbook and asks nothing), then
   ``generate-rephrasings`` and ``repair-batch``, and must end with no
   CUDA context and no pandas imported;
22. stats (last; budget STATS_BUDGET_S, 40 s): the pandas-free
   statistics layer in a child process on the card's host
   (``_stats_host_child``): the native Levenshtein built by ``cc`` and
   loaded (``using_native()``), equal to its plain version on
   STATS_PLAIN_PAIRS pairs; the BM25 and Levenshtein similarity matrices
   over scenario 0's original and 24 rephrasings, their float64 bytes
   hashing to SIMILARITY_SHA256 (the JAX package's on the CPU);
   ``power-analysis`` at its 10,000 simulations, its printed N(80%) a
   model and recommendation equal to POWER_N80 / POWER_RECOMMENDED_N
   (analytic; the simulated powers are printed, not gated); and
   ``sample-statements``, its file hashing to SAMPLE_STATEMENTS_SHA256;
   then, over the run-100q and run-instruct-sweep phases' CSVs and two
   synthetic Qualtrics exports, the analysis commands (``_analysis_leg``)
   and the vendor-evaluation commands (``_vendor_eval_leg``, budget
   VENDOR_EVAL_BUDGET_S, 10 s, inside the phase's 40: scripted vendors, no
   socket): ``run-closed-source --yes`` (100 rows in the section 2.8
   columns, finite MAEs, a rerun that asks nothing), ``run-irrelevant
   --limit 60`` over phase 21's corpus (a finite consistency table,
   reruns that ask nothing) and ``verify-replication`` over a reference
   tree of those files (a verdict on every check, exit 1 exactly when one
   fails, as on random weights it must); last, the lint leg
   (``_lint_leg``, budget LINT_BUDGET_S, 10 s, inside the phase's 40):
   ``python -m llm_interpretation_replication_tpu_torch lint`` and ``lint
   contracts`` over this tree, at once, both exiting 0 with no new
   finding against ``lint_baseline_torch.json`` and no drift; it prints
   their seconds, the files linted and the inline suppressions and
   baselined findings.  The child must end with no CUDA context and
   without pandas, matplotlib or sklearn;
23. other_families (after phase 12; budget OTHER_FAMILIES_BUDGET_S, 45 s):
   Qwen2-7B, GPT-J-6B, MPT-7B-Instruct, GLM-4-9B-chat-hf and ChatGLM3-6B
   at their published widths and FAMILY_LAYERS (2) of their depth, random
   bf16 weights from ``--seed`` written as a snapshot (``config.json``
   and safetensors under the HF names) and read through
   ``runtime/loader.load_model`` (the weights equal the converter's on
   the written tensors, bit for bit), score the 100 instruct prompts
   through ``sweeps.run_model_on_prompts`` at ``EngineConfig(batch_size=
   32)`` on the causal kernel and dense (MPT, ALiBi, dense only), under
   phase 12's gates; GPT-J's longest batch also goes through the forced
   grouped and flash routes (the head-major kernels at D=256);
24. plan (last, nothing of the other phases resident; budget
   PLAN_BUDGET_S, 30 s): the plan model on the card.  ``plan search``
   prints the ranked table for Falcon-7B, w8a8, the full-study row, on
   the causal kernel's route, at the card's memory; at every operating
   point where the phases above recorded a peak (each run's
   ``plan_point``: geometry at its depth, batch, bucket, quant, KV dtype,
   chunk, decode block and what was allocated at the reset) the budget
   model's live set must cover the measured increment (its whole need
   where a CLI run loads its own weights; T5's runs are unpriced); then
   ``run-perturbation --plan-search --quant int8 --attention-impl flash``
   on a Falcon-7B snapshot at full width and depth (random weights it
   writes) over one batch of the irrelevant-insertion corpus's rows:
   no OOM step, the measured peak within the predicted need and the need
   within the card's memory, the chosen plan run, a causal launch a layer
   a prefill;
25. train (last, nothing of the other phases resident; budget
   TRAIN_BUDGET_S, 45 s): the training step and the parallel package.
   (a) ``parallel.initialize_distributed`` brings up an NCCL group of one
   rank through a ``file://`` rendezvous, and ``make_mesh()`` is built on
   it; (b) Falcon-7B at its published width and full depth, random bf16
   weights (and bf16 moments) from ``--seed``, takes 4 steps of
   ``runtime.train.make_train_step`` (``make_optimizer(1e-4,
   warmup_steps=1, total_steps=10)``) on 4 x 128 tokens of the
   irrelevant-insertion corpus under a ``WordTokenizer``, on the dense
   route: step 1 (lr 0) leaves every parameter bit-equal (each leaf's
   16-bit patterns summed plain and position-weighted, modulo 2^64,
   before and after), every loss is
   finite, loss 4 is below loss 2, step 2's gradient reaches every leaf,
   finite, norm above 0; ms a step, tokens/s and the peak allocated
   memory are printed; (c) 2 float32 steps of its first FAMILY_LAYERS
   layers at full width on the card (TF32 off) and on the CPU from the
   same weights and batch (2 x 64): losses within rtol 1e-4, step 1's
   gradients within a relative L2 error of 1e-4; (d) a loss through
   ``attention_impl="flash"`` under grad raises ``NotImplementedError``
   (the kernels have no backward); (e) ``parallel.pipeline_decoder_forward``
   (pipe 1, 2 microbatches) on (b)'s weights through the causal kernel:
   one launch a layer a microbatch, logits as close to a float32 forward
   as the forced-route phase allows; (f) ring and Ulysses attention at seq
   1 on Falcon-7B's q/k/v (71 heads, S=448, D=64; bf16 draws compared in
   float32) against dense attention.  The group stays up for phase 26;
26. mesh (after train, on its NCCL world of one; budget MESH_BUDGET_S,
   80 s, printed beside the phase's time): the scoring engine on a mesh.
   (a) Falcon-7B at its published width and full depth, random bf16
   weights from ``--seed``: MESH_PROMPTS of the slice's prompts (one batch)
   through ``ScoringEngine.bind_mesh(make_mesh())`` and through the engine
   without a mesh, per batch: the rows equal bit for bit, the mesh run's
   prefill one causal launch a layer.  (b) Two spawned processes on the
   one card in a gloo group (NCCL refuses two ranks on one device) first
   probe gloo's ``all_reduce`` and ``all_gather`` on CUDA tensors; where
   gloo takes them, each runs the engine on ``device="cuda"`` bound to
   dp2 and then to tp2, Falcon-7B at full width and FAMILY_LAYERS
   layers, w8a8 weights and an int8 KV cache (seed + 26), on the same
   prompts: the rows held to the world of one's rows of the same weights
   in the CPU tests' w8a8 class (verdicts identical, probabilities within
   MESH_W8A8_RTOL), each rank's prefills launching the causal kernel at
   its own heads (71 at dp2; 36 and 35 at tp2); ms a batch, each rank's
   peak memory and the bytes through its collectives are printed.  The
   same two processes and weights then run (c) the prompts through the
   serve scheduler on dp2 and on tp2, rank 0 leading (it submits and reads
   the rows) and rank 1 following its decisions, slot admission on and
   micro-batches of MESH_SERVE_BATCH: the rows in the w8a8 class against
   the world of one's, mid-decode admissions on the leader, the same
   admissions and engine calls on both ranks; (d) the KV-slab handoff on
   dp2 (``export_kv_slab`` into ``decode_kv_slabs``): the rows in the class;
   (e) ``decode_k=K_DECODE`` on tp2 over MESH_K_TOKENS completion tokens of
   MESH_K_PROMPTS prompts, with a K-head distilled on them on the mesh:
   the rows in the class against tp2's
   ``decode_k=1`` rows, the head's digest equal on both ranks, the accept
   rate and the ms of a K chunk printed; (f) an ``EnginePool`` of two
   replicas on ``carve_slices(2)``, one rank each: each hosts one, both
   answer (``placement`` "sliced"), the rows in the class; (g) one MoE
   layer at Mixtral-8x7B's published widths (MOE_HIDDEN, MOE_FFN,
   MOE_EXPERTS, top-MOE_TOP_K; bf16 weights and MOE_TOKENS tokens from
   ``--seed``): ``moe_mlp_sharded`` over the two ranks against
   ``moe_mlp_dense`` on rank 0, within MOE_RTOL of the dense path's largest
   value on the tokens whose choices all found capacity and the aux losses
   within MOE_AUX_RTOL, each path's ms and the all_to_all bytes a rank
   printed.  A failure of either process, the probe included, fails the
   phase.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Per-shape details go to
``chiprun_out/chip_smoke.json``.  Needs one CUDA device; runs nothing on the
CPU in its place.
"""

import argparse
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import math
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
#: (wrapper, label, B, S, N, G, D): the other decoder families' prompt
#: batches, drawn after the shapes above (which so keep drawing the inputs
#: of earlier runs); GPT-J's head dim 256 through all three kernels
FAMILY_KERNEL_SHAPES = [
    ("causal_grouped_attention", "gpt-j-6b", 32, 64, 16, 16, 256),
    ("causal_grouped_attention", "qwen2-7b", 32, 64, 28, 4, 128),
    ("causal_grouped_attention", "glm-4-9b/chatglm3-6b", 32, 64, 32, 2, 128),
    ("grouped_attention", "gpt-j-6b", 32, 64, 16, 16, 256),
    ("flash_attention", "gpt-j-6b", 32, 64, 16, 16, 256),
]
#: the head dim of the tile core's widest instance (GPT-J's), which the
#: kernels line lists as an entry of its own for each kernel
WIDE_HEAD_DIM = 256
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
# the sweep phase's depth: its eight sweeps run on the first 2 of the
# slice's 32 layers (views, nothing copied), the cheapest cut of the
# smoke's time; its gates' near-tie is measured at that depth
SWEEP_LAYERS = 2
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
# the K-decode phase's depth: views of the slice's first layers (of 32)
K_DECODE_LAYERS = 2
# the full-study and packed phases' depth: views of the slice's first 8
# layers (of 32); the full-study phase measures its gates' near-tie at that
# depth, and the packed phase's gates take it
FULL_STUDY_LAYERS = 8
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
EDGE_DIMS = (64, 96, 128, 256)
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
    for kname, label, b, s, n, g, d in FAMILY_KERNEL_SHAPES:
        layout = LAYOUTS[kname]
        q, k, v, lengths = _inputs(gen, b, s, n, g, d, layout)
        if kname == "flash_attention":
            k = k.repeat_interleave(n // g, dim=1)
            v = v.repeat_interleave(n // g, dim=1)
        rows += _kernel_rows(attention, kname, layout, label, g, q, k, v,
                             lengths, (True, False))
        del q, k, v
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
    before = torch.cuda.memory_allocated()
    _reset_launches(attention)
    t0 = time.perf_counter()
    rows = engine.score_prompts(prompts)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _launches(attention)["causal_grouped_attention"]
    peak = torch.cuda.max_memory_allocated()
    point = _plan_point("binary", cfg, BATCH,
                        batching.bucket_for(max(map(len, prompts))), before)

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
                  peak_memory_bytes=peak, plan_point=point,
                  logits_rel_l2={k: v for k, v in rel.items()},
                  same_scan_found_share=same_found,
                  scan_found_rows=dict(kernel=found_rows[0], dense=found_rows[1]),
                  same_position0_verdict_share=same_hit0 / N_PROMPTS,
                  max_abs_delta_relative_prob=max_drel)
    say("slice", json.dumps(result))
    engine.close(release_params=False)
    dense.close(release_params=False)
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

    seq = batching.bucket_for(max(map(len, prompts)))

    def timed(name, call, n_batches, pooled, ecfg=base):
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
                   prefills=prefills[0], overflow_batches=overflow,
                   plan_point=_plan_point("binary", cfg, BATCH, seq, before,
                                          depth=ecfg.pipeline_depth))
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
                len(batches), pooled, ecfg)
            res["occupancy"] = engine.occupancy_report()
            if name != "per_batch":
                res["max_abs_delta_relative_prob_vs_per_batch"] = \
                    _check_pooled_rows(name, rows[name], rows["per_batch"])
            runs.append(res)
            say("pooled", json.dumps(res))
            engine.close(release_params=False)
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
        engine.close(release_params=False)
    finally:
        decoder.prefill = real_prefill
    oom = oom_run(cfg, weights, tok, prompts, targets, base, rows["ring"],
                  runs[2])
    return dict(prompts=POOL_PROMPTS, batches=len(batches),
                buckets=[b.bucket_len for b in batches],
                decided_share=decided / POOL_PROMPTS,
                pool_target=POOL_TARGET, runs=runs, oom=oom,
                inputs=(prompts, targets))


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
    engine.close(release_params=False)
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
    """The full-study row on Falcon-7B at FULL_STUDY_LAYERS of its depth
    (views of the slice's weights): the binary leg with its 50-token
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
    cfg = mconfig.DecoderConfig(**{**mconfig.FALCON_7B_GEOMETRY,
                                   "num_layers": FULL_STUDY_LAYERS},
                                attention_impl="flash")
    weights = _first_layers(weights, FULL_STUDY_LAYERS)
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

    def timed(name, call, ecfg, texts):
        engine = emod.ScoringEngine("falcon", cfg, weights, tok,
                                    engine_config=ecfg, device=device)
        call(engine, slice(0, base.batch_size))             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
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
                   plan_point=_plan_point(
                       "full", cfg, ecfg.batch_size,
                       batching.bucket_for(max(map(len, texts))), before,
                       kv=ecfg.kv_dtype, depth=ecfg.pipeline_depth,
                       pooled=ecfg.pooled_confidence and name != "binary",
                       repack=ecfg.slot_repack),
                   kernel_launches=launches, prefills=counted["prefill"],
                   extend_prefills=counted["extend_prefill"],
                   **{k: c.get(k, 0) for k in (
                       "decode_steps_saved", "conf_steps_saved",
                       "pooled_conf_retired_rows", "pooled_conf_rows",
                       "completion_cache_bytes_freed",
                       "completion_cache_bytes_retired", "prefix_hit",
                       "prefix_miss")})
        engine.close(release_params=False)
        runs[name], rows[name] = res, out
        say("full_study", json.dumps(res))

    conf_kw = dict(with_confidence=True, max_new_tokens=CONF_CAP)
    legs = [emod.LegSpec("binary"), emod.LegSpec("confidence", **conf_kw)]
    for name in counted:
        setattr(decoder, name, counting(name))
    try:
        timed("binary", lambda e, sl: e.score_prompts(binary[sl],
                                                      targets[sl]), base,
              binary)
        for name, ecfg in (
                ("confidence_ring", base),
                ("confidence_flush",
                 dataclasses.replace(base, slot_repack=False)),
                ("confidence_per_batch",
                 dataclasses.replace(base, pooled_confidence=False))):
            timed(name, lambda e, sl: e.score_prompts(
                conf[sl], targets[sl], **conf_kw), ecfg, conf)
        timed("fused", lambda e, sl: e.score_prefixed(
            pairs[sl], targets[sl], legs=legs), base, prefixes)
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
        before = torch.cuda.memory_allocated()
        _reset_launches(attention)
        t0 = time.perf_counter()
        rows = engine.score_prompts(prompts)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = _launches(attention)["causal_grouped_attention"]
        peak = torch.cuda.max_memory_allocated()
        point = _plan_point("binary", cfg, BATCH,
                            max(b.bucket_len for b in batches), before,
                            quant="int8", kv=kv)
        _check_rows(rows)
        yes_id, no_id = engine.target_ids(["Yes", "No"])
        if launches < cfg.num_layers * len(batches):
            raise AssertionError(f"int8 kv={kv}: causal kernel launched "
                                 f"{launches} times")
        runs[kv] = dict(rows=rows, result=dict(
            kv_dtype=kv, rows_per_s=N_PROMPTS / elapsed, seconds=elapsed,
            peak_memory_bytes=peak, plan_point=point,
            kernel_launches=launches))
        engine.close(release_params=False)

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
    head's columns (and its bias, GPT-J's) the same way, so the id the
    tokenizer gives the target scores as that id did.  Returns the swapped ``(target id, chosen id)``
    pairs."""
    import torch

    from llm_interpretation_replication_tpu_torch.scoring import yes_no

    tree = weights.tree()
    emb, head = tree["embed"]["tokens"], tree.get("lm_head")
    pairs = [(yes_no.target_token_ids(tok, [word[1:]])[0], tid)
             for word, tid in chosen.items()]
    bias = tree.get("lm_head_bias")
    with torch.no_grad():
        for a, b in pairs:
            emb[[a, b]] = emb[[b, a]]
            if head is not None:
                head[:, [a, b]] = head[:, [b, a]]
            if bias is not None:
                bias[[a, b]] = bias[[b, a]]
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
        # the legacy route scores each whole prompt, the fused one each
        # rephrasing's prefix; both buckets priced at the whole prompt's
        seq = batching.bucket_for(max(
            len(tok(f"{r} {s['confidence_format']}")["input_ids"])
            for s in scenarios for r in s["rephrasings"]))
        calls = []
        for attempt in ((True, False) if crash else (False,)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
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
                plan_point=_plan_point(
                    "full", cfg, ecfg.batch_size, seq, before,
                    kv=ecfg.kv_dtype, chunk=ecfg.prefill_chunk,
                    depth=ecfg.pipeline_depth,
                    pooled=ecfg.pooled_confidence,
                    repack=ecfg.slot_repack),
                kernel_launches=_launches(attention)[
                    "causal_grouped_attention"],
                prefills=counted["prefill"],
                forward_last_logits=counted["forward_last_logits"],
                prefill_chunks=c.get("prefill_chunks", 0),
                interrupted=rows is None))
        engine.close(release_params=False)
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
        timing.setdefault("points", []).append(dict(
            run=name, peak_memory_bytes=peak,
            plan_point=_plan_point(
                "prefill", cfg, ids.shape[0], batch.bucket_len, base_bytes,
                chunk=TIMING_PREFILL_CHUNK if name == "chunked" else 0)))
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
    "sp_unigram": "a T5 snapshot shipping only spiece.model: a SentencePiece "
                  "Unigram model with a charsmap (T5Converter's reading)",
    "sp_bpe": "baichuan-inc/Baichuan2-7B-Chat: a SentencePiece BPE "
              "tokenizer.model with byte fallback and no dummy prefix "
              "(LlamaConverter's reading)",
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


def _spm_unigram_files(texts, charsmap=T5_CHARSMAP):
    """((``"spiece.model"``, bytes), tokenizer_config.json,
    special_tokens_map.json) of a T5 snapshot that ships only its
    SentencePiece model: ``_unigram_tokenizer_files``' pieces and scores
    as a Unigram ``ModelProto`` (written by the port's own serializer;
    ``<pad>`` and ``</s>`` control pieces, ``<unk>`` the unknown one) with
    ``charsmap`` in its normalizer spec, T5's trainer ids and normalizer
    flags; ``T5Tokenizer`` with 100 extra ids."""
    from llm_interpretation_replication_tpu_torch.utils import (
        sentencepiece_model as spm)

    spec, config, special = _unigram_tokenizer_files(texts, charsmap)
    kinds = {"<pad>": spm.CONTROL, "</s>": spm.CONTROL, "<unk>": spm.UNKNOWN}
    model = spm.serialize_model_proto(
        [(p, score, kinds.get(p, spm.NORMAL))
         for p, score in spec["model"]["vocab"]],
        trainer_spec=dict(model_type=spm.UNIGRAM, unk_id=2, bos_id=-1,
                          eos_id=1, pad_id=0),
        normalizer_spec=dict(name="nmt_nfkc",
                             precompiled_charsmap=_charsmap(charsmap),
                             add_dummy_prefix=True,
                             remove_extra_whitespaces=True,
                             escape_whitespaces=True))
    return ("spiece.model", model), dict(config, extra_ids=100), special


def _spm_bpe_files(texts):
    """((``"tokenizer.model"``, bytes), tokenizer_config.json,
    special_tokens_map.json) in Baichuan2's layout: a BPE ``ModelProto``
    with byte fallback (the port's serializer), ``<unk>``, ``<s>``,
    ``</s>`` at ids 0-2, the 256 ``<0xXX>`` byte pieces, then the products
    of merges learned on the words of ``texts`` between ``"▁"`` marks and
    the characters, scored 0, -1, -2, ... in that order (merges go by
    score); no dummy prefix, no normalization, split digits; the
    ``BaichuanTokenizer`` class with ``add_bos_token`` and
    ``add_eos_token`` off and ``<unk>`` padding."""
    import re as _re
    from collections import Counter

    from llm_interpretation_replication_tpu_torch.utils import (
        sentencepiece_model as spm)

    words = Counter()
    for t in texts:
        words.update(_re.findall("▁?[^▁]+|▁", t.replace(" ", "▁")))
    pieces = [("<unk>", 0.0, spm.UNKNOWN), ("<s>", 0.0, spm.CONTROL),
              ("</s>", 0.0, spm.CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, spm.BYTE) for b in range(256)]
    seen = {p for p, _, _ in pieces}
    learned = [a + b for a, b in _bpe_merges(words)]
    for piece in learned + sorted({c for w in words for c in w}):
        if piece not in seen:
            seen.add(piece)
            pieces.append((piece, float(259 - len(pieces)), spm.NORMAL))
    model = spm.serialize_model_proto(
        pieces,
        trainer_spec=dict(model_type=spm.BPE, byte_fallback=True,
                          split_digits=True, unk_id=0, bos_id=1, eos_id=2),
        normalizer_spec=dict(name="identity", add_dummy_prefix=False,
                             remove_extra_whitespaces=False))
    special = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
               "pad_token": "<unk>"}
    config = dict(special, tokenizer_class="BaichuanTokenizer",
                  add_bos_token=False, add_eos_token=False,
                  clean_up_tokenization_spaces=False, model_max_length=4096,
                  auto_map={"AutoTokenizer": [
                      "tokenization_baichuan.BaichuanTokenizer", None]})
    return ("tokenizer.model", model), config, special


def _format_tokenizer_files(fmt, texts):
    """(tokenizer.json, tokenizer_config.json, special_tokens_map.json) in
    the published format ``fmt`` of ``TOKENIZER_FORMATS``, learned on
    ``texts``: Falcon's and BLOOM's pre-tokenizers over byte-level BPE,
    Llama-2/Mistral's byte-fallback BPE (``LlamaTokenizer``,
    ``add_bos_token``), Mistral v0.3's Metaspace "first", T5's Unigram
    behind ``T5_CHARSMAP``; the SentencePiece formats give their model
    file as (file name, bytes) in place of the ``tokenizer.json``: a
    Unigram ``spiece.model`` (``_spm_unigram_files``) and Baichuan2's BPE
    ``tokenizer.model`` (``_spm_bpe_files``)."""
    if fmt == "sp_unigram":
        return _spm_unigram_files(texts)
    if fmt == "sp_bpe":
        return _spm_bpe_files(texts)
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
    """Write ``_format_tokenizer_files``' files into ``snap``: the
    ``tokenizer.json`` (or a SentencePiece model file), the tokenizer
    config and the special tokens map."""
    for name, obj in zip(("tokenizer.json", "tokenizer_config.json",
                          "special_tokens_map.json"), files):
        if isinstance(obj, tuple):          # (model file name, bytes)
            name, blob = obj
            with open(os.path.join(snap, name), "wb") as f:
                f.write(blob)
            continue
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


def _pwrite_all(fd, view, at):
    """``os.pwrite`` of every byte of ``view`` at offset ``at``."""
    view = memoryview(view).cast("B")
    while view:
        done = os.pwrite(fd, view, at)
        view, at = view[done:], at + done


def _write_safetensors(path, tensors, chunk=64 << 20, threads=4):
    """A safetensors file of ``tensors`` (name -> tensor, any device): an
    8-byte little-endian header length, the JSON header (padded with spaces
    to a multiple of 8), then each tensor's bytes in order.  The bytes go
    out in ``chunk``-byte pieces written at their offsets by ``threads``
    writers (``os.pwrite``); a tensor on the card is staged through a ring
    of pinned host buffers, each reused once its write has finished."""
    import struct
    from concurrent.futures import ThreadPoolExecutor

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
    at = 8 + len(head)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.pwrite(fd, struct.pack("<Q", len(head)) + head, 0)
        staging, busy = [], {}
        with ThreadPoolExecutor(threads) as pool:
            for t in tensors.values():
                flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
                for lo in range(0, flat.numel(), chunk):
                    part = flat[lo:lo + chunk]
                    if part.is_cuda:
                        slot = len(staging) if len(staging) < 2 * threads \
                            else min(busy, key=lambda i: busy[i][0])
                        if slot == len(staging):
                            staging.append(torch.empty(
                                chunk, dtype=torch.uint8, pin_memory=True))
                        elif slot in busy:
                            busy.pop(slot)[1].result()
                        host = staging[slot][:part.numel()]
                        host.copy_(part)
                        busy[slot] = (at, pool.submit(
                            _pwrite_all, fd, host.numpy().data, at))
                    else:
                        busy[("cpu", at)] = (at, pool.submit(
                            _pwrite_all, fd, part.numpy().data, at))
                    at += part.numel()
            for _, job in busy.values():
                job.result()
    finally:
        os.close(fd)


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
                           books, runs, card, longest):
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
    # a pack of PACK_Q prompts and their demonstrations, priced at PACK_Q
    # times the longest prompt and a demonstration's few tokens each
    packed = _plan_point("packed", cfg, BATCH, _bucket(PACK_Q * (longest + 8)),
                         0, packing=PACK_Q, weights_in_run=True)
    k = _plan_point("full", cfg, BATCH, _bucket(longest), 0, pooled=True,
                    decode_k=K_DECODE, weights_in_run=True)
    for name, extra, book, point in (
            ("packed", ["--packed", str(PACK_Q)],
             "perturbation_results_packed.xlsx", packed),
            ("k4", ["--decode-k", str(K_DECODE)], "perturbation_results.xlsx",
             k),
            ("k4_loaded", ["--decode-k", str(K_DECODE)],
             "perturbation_results.xlsx", k)):
        out = os.path.join(workdir, f"cli_{name}")
        _reset_launches(attention)
        stdout, stderr = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        point = dict(point, memory_before_bytes=torch.cuda.memory_allocated())
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
                   plan_point=point,
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
    # the longest whole prompt a run scores, in the snapshot's tokens
    longest = max(len(snap_tok(f"{r} {s['confidence_format']}")["input_ids"])
                  for s in scenarios for r in s["rephrasings"])
    decoder.prefill = counting
    try:
        for name, extra, quant, kv, chunk in (
                ("bf16", [], "none", "bf16", 0),
                ("int8", ["--quant", "int8", "--kv-dtype", "int8",
                          "--prefill-chunk", str(SWEEP_PREFILL_CHUNK)],
                 "int8", "int8", SWEEP_PREFILL_CHUNK)):
            out = os.path.join(workdir, f"cli_{name}")
            _reset_launches(attention)
            counted["prefill"] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            cli.main(argv + ["--output-dir", out] + extra)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            cols, books[name] = read_xlsx(
                os.path.join(out, "perturbation_results.xlsx"))
            res = dict(run=name, seconds=elapsed, rows=len(books[name]),
                       rows_per_s=len(books[name]) / elapsed,
                       peak_memory_bytes=torch.cuda.max_memory_allocated(),
                       plan_point=_plan_point(
                           "full", cfg, BATCH, _bucket(longest), before,
                           quant=quant, kv=kv, chunk=chunk, pooled=True,
                           weights_in_run=True),
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
                                    n_rows, books, runs, card, longest)

    # the same sweep in this process over the weights load_model gave back
    tok = snap_tok
    engine = emod.ScoringEngine(family, lcfg, loaded, tok, device=device,
                                engine_config=emod.EngineConfig(
                                    batch_size=BATCH))
    out = os.path.join(workdir, "in_process.xlsx")
    run_model_perturbation_sweep(engine, snap, scenarios, out,
                                 log=SessionLogger(stream=io.StringIO()))
    engine.close(release_params=False)
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
# the other decoder families (phase other_families): each published
# config.json, at FAMILY_LAYERS of its depth in the phase
QWEN2_7B = {   # Qwen/Qwen2-7B
    "model_type": "qwen2", "vocab_size": 152064, "hidden_size": 3584,
    "num_hidden_layers": 28, "num_attention_heads": 28,
    "num_key_value_heads": 4, "intermediate_size": 18944,
    "max_position_embeddings": 131072, "max_window_layers": 28,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "sliding_window": 131072,
    "use_sliding_window": False, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 151643,
    "eos_token_id": 151643}
GPT_J_6B = {   # EleutherAI/gpt-j-6b
    "model_type": "gptj", "vocab_size": 50400, "n_embd": 4096, "n_layer": 28,
    "n_head": 16, "n_inner": None, "n_positions": 2048, "rotary_dim": 64,
    "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
    "tie_word_embeddings": False, "bos_token_id": 50256,
    "eos_token_id": 50256}
MPT_7B_INSTRUCT = {   # mosaicml/mpt-7b-instruct
    "model_type": "mpt", "vocab_size": 50432, "d_model": 4096, "n_heads": 32,
    "n_layers": 32, "expansion_ratio": 4, "max_seq_len": 2048,
    "no_bias": True, "learned_pos_emb": True,
    "attn_config": {"alibi": True, "alibi_bias_max": 8, "attn_impl": "torch",
                    "attn_pdrop": 0, "attn_type": "multihead_attention",
                    "clip_qkv": None, "prefix_lm": False, "qk_ln": False,
                    "softmax_scale": None}}
GLM_4_9B_CHAT_HF = {   # THUDM/glm-4-9b-chat-hf
    "model_type": "glm", "vocab_size": 151552, "hidden_size": 4096,
    "intermediate_size": 13696, "num_hidden_layers": 40,
    "num_attention_heads": 32, "num_key_value_heads": 2, "head_dim": 128,
    "partial_rotary_factor": 0.5, "rms_norm_eps": 1.5625e-07,
    "rope_theta": 10000.0, "max_position_embeddings": 131072,
    "attention_bias": True, "hidden_act": "silu",
    "tie_word_embeddings": False, "pad_token_id": 151329,
    "eos_token_id": [151329, 151336, 151338]}
CHATGLM3_6B = {   # THUDM/chatglm3-6b
    "model_type": "chatglm", "vocab_size": 65024, "padded_vocab_size": 65024,
    "hidden_size": 4096, "ffn_hidden_size": 13696, "kv_channels": 128,
    "num_layers": 28, "num_attention_heads": 32, "seq_length": 8192,
    "layernorm_epsilon": 1e-5, "rmsnorm": True, "add_bias_linear": False,
    "add_qkv_bias": True, "multi_query_attention": True,
    "multi_query_group_num": 2, "original_rope": True,
    "tie_word_embeddings": False}
# the other_families phase: (label, model, config, routes); MPT runs dense
# only (ALiBi: the causal kernel takes no bias, in both packages)
OTHER_FAMILY_MODELS = [
    ("qwen2-7b", "Qwen/Qwen2-7B", QWEN2_7B, ("flash", "xla")),
    ("gpt-j-6b", "EleutherAI/gpt-j-6b", GPT_J_6B, ("flash", "xla")),
    ("mpt-7b-instruct", "mosaicml/mpt-7b-instruct", MPT_7B_INSTRUCT,
     ("xla",)),
    ("glm-4-9b-chat-hf", "THUDM/glm-4-9b-chat-hf", GLM_4_9B_CHAT_HF,
     ("flash", "xla")),
    ("chatglm3-6b", "THUDM/chatglm3-6b", CHATGLM3_6B, ("flash", "xla")),
]
OTHER_FAMILIES_BUDGET_S = 45.0
SCAN_STEPS = 10          # the look-ahead the yes/no scan reads
FAMILY_LAYERS = 2        # the families and instruct decoders' depth (of
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
    ("baichuan-inc/Baichuan2-7B-Chat", BAICHUAN2_7B_CHAT, (), "sp_bpe"),
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
    stores positions with the +2 offset; GPT-J's one LayerNorm a layer and
    biased head; MPT's straight-concat ``Wqkv``, bias-free, tied;
    GLM-4's fused ``gate_up_proj``; ChatGLM's ``query_key_value`` as ``[q;
    k; v]`` whole and ``dense_h_to_4h`` as ``[gate; up]``), made on
    ``device``: projections, embeddings and linear biases N(0, 0.02^2),
    norm scales 1 and norm biases 0."""
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
                linear(f"{pre}.self_attn.{name}_proj", out, inp,
                       bias=cfg.qkv_bias and name != "o")
            for name, out, inp in (("gate", f, h), ("up", f, h),
                                   ("down", h, f)):
                linear(f"{pre}.mlp.{name}_proj", out, inp, bias=False)
        norm("model.norm", bias=False)
        sd["lm_head.weight"] = rnd(v, h)
    elif family == "glm":
        sd["model.embed_tokens.weight"] = rnd(v, h)
        for i in range(cfg.num_layers):
            pre = f"model.layers.{i}"
            norm(f"{pre}.input_layernorm", bias=False)
            norm(f"{pre}.post_attention_layernorm", bias=False)
            for name, out, inp in (("q", n * d, h), ("k", g * d, h),
                                   ("v", g * d, h), ("o", h, n * d)):
                linear(f"{pre}.self_attn.{name}_proj", out, inp,
                       bias=cfg.qkv_bias and name != "o")
            linear(f"{pre}.mlp.gate_up_proj", 2 * f, h, bias=False)
            linear(f"{pre}.mlp.down_proj", h, f, bias=False)
        norm("model.norm", bias=False)
        sd["lm_head.weight"] = rnd(v, h)
    elif family == "gptj":
        sd["transformer.wte.weight"] = rnd(v, h)
        for i in range(cfg.num_layers):
            pre = f"transformer.h.{i}"
            norm(f"{pre}.ln_1")
            for name in ("q", "k", "v", "out"):
                linear(f"{pre}.attn.{name}_proj", h, h, bias=False)
            linear(f"{pre}.mlp.fc_in", f, h)
            linear(f"{pre}.mlp.fc_out", h, f)
        norm("transformer.ln_f")
        linear("lm_head", v, h)
    elif family == "mpt":
        sd["transformer.wte.weight"] = rnd(v, h)
        for i in range(cfg.num_layers):
            pre = f"transformer.blocks.{i}"
            norm(f"{pre}.norm_1", bias=cfg.qkv_bias)
            norm(f"{pre}.norm_2", bias=cfg.qkv_bias)
            linear(f"{pre}.attn.Wqkv", 3 * h, h, bias=cfg.qkv_bias)
            linear(f"{pre}.attn.out_proj", h, h, bias=cfg.qkv_bias)
            linear(f"{pre}.ffn.up_proj", f, h, bias=cfg.qkv_bias)
            linear(f"{pre}.ffn.down_proj", h, f, bias=cfg.qkv_bias)
        norm("transformer.norm_f", bias=cfg.qkv_bias)
    elif family == "chatglm":
        pre = "transformer.encoder"
        sd["transformer.embedding.word_embeddings.weight"] = rnd(v, h)
        for i in range(cfg.num_layers):
            lay = f"{pre}.layers.{i}"
            norm(f"{lay}.input_layernorm", bias=False)
            norm(f"{lay}.post_attention_layernorm", bias=False)
            linear(f"{lay}.self_attention.query_key_value", (n + 2 * g) * d,
                   h, bias=cfg.qkv_bias)
            linear(f"{lay}.self_attention.dense", h, n * d, bias=False)
            linear(f"{lay}.mlp.dense_h_to_4h", 2 * f, h, bias=False)
            linear(f"{lay}.mlp.dense_4h_to_h", h, f, bias=False)
        norm(f"{pre}.final_layernorm", bias=False)
        sd["transformer.output_layer.weight"] = rnd(v, h)
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
    key = next(k for k in ("n_layer", "n_layers", "num_layers",
                           "num_hidden_layers") if k in config)
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


def families_phase(seed, attention, card, instruct=False, workdir=None):
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
    model's longest prompt batch.  With ``workdir``, OTHER_FAMILY_MODELS
    instead: each checkpoint is written under ``workdir`` as a snapshot
    (its ``config.json`` and a safetensors file) and read back through
    ``runtime/loader.load_model``, whose weights must equal the
    converter's on the written tensors bit for bit; each scores the 100
    instruct prompts through the sweep's per-model call; a model whose
    head dim the kernels pad to 256 (GPT-J) also runs its longest batch
    through ``forced_route_phase`` (the head-major kernels at D=256).  The
    phase table's kernel rows for these shapes come from phase 3."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.config import (
        ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.ops import quant as qops
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.runtime import loader
    from llm_interpretation_replication_tpu_torch.scoring import yes_no
    from llm_interpretation_replication_tpu_torch.scoring.prompts import (
        format_prompt)
    from llm_interpretation_replication_tpu_torch.sweeps import (
        instruct_sweep, run_model_on_prompts)

    device = "cuda"
    other = workdir is not None
    phase, models = (("instruct", INSTRUCT_DECODERS) if instruct
                     else ("other_families", OTHER_FAMILY_MODELS) if other
                     else ("families", FAMILY_MODELS))
    questions = ordinary_meaning_questions()
    tok = _question_tokenizer()
    if not instruct:
        prompts, prefix_lens = _question_prompts(tok)
    if other:   # the instruct prompts only (the second half)
        prompts, prefix_lens = (prompts[len(questions):],
                                prefix_lens[len(questions):])
    forced = {}
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
        sd = _hf_state_dict(family, cfg, seed + (60 if instruct else 80
                                                  if other else 20) + mi,
                            device, torch.bfloat16)
        tree = convert.CONVERTERS[family](sd.__getitem__, cfg)
        snapshot = None
        if other:
            tree, snapshot = _snapshot_round_trip(
                loader, os.path.join(workdir, label), config, family, cfg,
                sd, tree, fails)
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
        if other and cfg.head_dim > 128:
            # GPT-J's longest batch through the head-major kernels at D=256
            longest = max(batches, key=lambda bt: bt.bucket_len)
            ids = torch.as_tensor(longest.token_ids, device=device).long()
            mask = torch.as_tensor(longest.attention_mask, device=device)
            real = torch.as_tensor(longest.indices >= 0, device=device)
            forced[label] = forced_route_phase(
                attention, weights, dataclasses.replace(
                    cfg, attention_impl="flash"), ref_w, longest,
                decoder.forward_last_logits(weights, dense, ids, mask)[real],
                decoder.forward_last_logits(ref_w, dense, ids, mask)[real])
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
            if not other:    # warm-up, not counted (timed routes only)
                engine.score_prompts([("a b", " c")])
            engine.rows = []
            _reset_launches(attention)
            counted["prefill"] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            point = _plan_point(
                "full", rcfg, BATCH, max(b.bucket_len for b in batches),
                torch.cuda.memory_allocated(),
                quant="int8" if route.startswith("w8a8") else "none",
                kv=rcfg_e.kv_dtype,
                suffix=max([64] + [len(p) - n for p, n in zip(
                    prompts, prefix_lens or ())]))
            decoder.prefill = counting
            try:
                t0 = time.perf_counter()
                if instruct:
                    csv_rows = list(instruct_sweep._score_model(
                        engine, model, questions, False).values())
                elif other:
                    csv_rows = run_model_on_prompts(engine, model, questions,
                                                    False)
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
            prefill_ms = step_ms = None
            if not other:    # other_families: its budget takes no timing
                # one prefill of the longest base prefix+suffix batch, timed
                longest = max(batches, key=lambda bt: bt.bucket_len)
                ids = torch.as_tensor(longest.token_ids, device=device).long()
                mask = torch.as_tensor(longest.attention_mask, device=device)
                kcfg = dataclasses.replace(rcfg,
                                           kv_cache_dtype=rcfg_e.kv_dtype)
                prefill_ms = [longest.bucket_len, time_ms(
                    lambda: decoder.prefill(rweights, kcfg, ids, mask,
                                            longest.bucket_len),
                    iters=3, warmup=1)]
                # ms a look-ahead step: one scan chunk from that prefill's
                # cache
                last, cache = decoder.prefill(rweights, kcfg, ids, mask,
                                              longest.bucket_len)
                tgt = torch.as_tensor([target_ids[0]] * ids.shape[0],
                                      device=device)
                step_ms = time_ms(lambda: decoder.decode_steps(
                    rweights, kcfg, cache, last, mask.sum(-1), 0,
                    ecfg.scan_chunk, None, None, with_scores="reduced",
                    target_ids=tgt), iters=2, warmup=1) / ecfg.scan_chunk
                del last, cache
            res = dict(model=label, route=route, rows=len(csv_rows),
                       seconds=elapsed, rows_per_s=len(csv_rows) / elapsed,
                       prefills=counted["prefill"], kernel_launches=launches,
                       prefill_ms_bucket=prefill_ms,
                       decode_ms_per_step=step_ms,
                       peak_memory_bytes=torch.cuda.max_memory_allocated(),
                       plan_point=point,
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
            engine._engine.close(release_params=False)
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
        if "flash" in routes and not other:
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
                      snapshot=snapshot,
                      swapped_target_rows=swapped, target_boost=boost,
                      rounding=rounding, runs=runs, gates=gates, card=card)
        say(f"{phase} gates", json.dumps({k: v for k, v in result.items()
                                          if k != "runs"}))
        results.append(result)
        del weights
        torch.cuda.empty_cache()
    if not (instruct or other):
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
    return dict(models=results, kernel_rows=kernel_rows, forced_routes=forced,
                runs=[r for m in results for r in m["runs"]])


def _snapshot_round_trip(loader, snap, config, family, cfg, sd, tree, fails,
                         device="cuda"):
    """Write ``sd`` as a snapshot at ``snap`` (``config`` at FAMILY_LAYERS
    as its ``config.json``, the tensors in one safetensors file), read it
    back through ``loader.load_model`` onto ``device`` in bf16 and hold the
    loaded config and weights to ``cfg`` and the converter's ``tree``,
    bit for bit.  Returns (the loaded tree, sizes and seconds); the
    snapshot is deleted."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    os.makedirs(snap)
    t0 = time.perf_counter()
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(_at_depth(config, FAMILY_LAYERS), f)
    _write_safetensors(os.path.join(snap, "model.safetensors"), sd)
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(snap, "model.safetensors"))
    t0 = time.perf_counter()
    lfamily, lcfg, loaded = loader.load_model(snap, dtype="bf16",
                                              device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(snap)
    want = dict(decoder._flatten(tree))
    got = dict(decoder._flatten(loaded.tree()))
    differ = sorted("/".join(k) for k in want.keys() | got.keys()
                    if k not in want or k not in got
                    or not torch.equal(want[k], got[k]))
    if lfamily != family or lcfg != cfg or differ:
        fails.append(f"{snap}: load_model gave {lfamily}, config equal "
                     f"{lcfg == cfg}, leaves that differ {differ[:5]}")
    return loaded.tree(), dict(bytes=nbytes, write_s=write_s, load_s=load_s)


def other_families_phase(seed, attention, workdir, card):
    """Phase other_families: ``families_phase`` over OTHER_FAMILY_MODELS
    (Qwen2-7B, GPT-J-6B, MPT-7B-Instruct, GLM-4-9B, ChatGLM3-6B at their
    published widths and FAMILY_LAYERS of their depth), each read from a
    snapshot under ``workdir``, within OTHER_FAMILIES_BUDGET_S."""
    t0 = time.perf_counter()
    res = families_phase(seed, attention, card,
                         workdir=tempfile.mkdtemp(prefix="other_", dir=workdir))
    res["seconds"] = time.perf_counter() - t0
    if res["seconds"] > OTHER_FAMILIES_BUDGET_S:
        raise AssertionError(
            f"other_families: {res['seconds']:.1f} s, past its "
            f"{OTHER_FAMILIES_BUDGET_S:.0f} s budget")
    return res


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


def _cli_here(args):
    """The port's CLI on ``args`` in this process, its output captured:
    (exit code, stdout, stderr, seconds).  The sweeps' reruns over a
    finished output score nothing, so they run here rather than pay a
    child interpreter's start."""
    from llm_interpretation_replication_tpu_torch.__main__ import \
        main as cli_main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli_main(list(args)) or 0
        except SystemExit as done:
            rc = done.code or 0
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def _run_100q(snaps, out, extra=(), signal_after_first=False,
              in_process=False):
    """``python -m llm_interpretation_replication_tpu_torch run-100q`` in a
    child process (the repository on its path), or in this one with
    ``in_process`` (:func:`_cli_here`).  With ``signal_after_first`` a
    SIGTERM goes to the child as soon as its checkpoint file appears.
    Returns (exit code, stdout, stderr, seconds)."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = [sys.executable, "-m", "llm_interpretation_replication_tpu_torch",
            "run-100q", "--checkpoint-dir", snaps, "--output-dir", out,
            "--attention-impl", "flash", "--batch-size", str(BATCH), *extra]
    if in_process:
        return _cli_here(argv[3:])
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
    a run that a SIGTERM stops after its first model leaves a checkpoint of
    exactly that model's rows; resuming it (under ``--strict``) skips that
    model, scores the other eleven and writes 1200 rows in the CSV's 10
    columns, each with ``success``, the first model's the checkpoint's;
    one attention line a model it scores (dense for BLOOM and
    Mistral-7B-v0.1); a rerun over the finished output (in this process)
    skips all twelve.  (No uninterrupted run: the resume scores eleven of
    the twelve.)"""
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

    # (1) SIGTERM after the first model
    out = os.path.join(workdir, "run100q")
    rc2, _, se2, secs2 = _run_100q(snaps, out, signal_after_first=True)
    with open(os.path.join(out, "base_vs_instruct_100q_checkpoint.json")) as f:
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

    # (2) the resume: the rest of the sweep, under strict mode
    rc, so, se, secs = _run_100q(snaps, out, extra=("--strict",))
    audit = _strict_audit(se)
    runs.append(dict(run="resume", rc=rc, seconds=secs, strict=audit,
                     rows_per_s=(len(names) - 1) * len(questions) / secs))
    say("run-100q", json.dumps(dict(runs[-1], card=card)))
    if rc != 0:
        raise AssertionError(f"run-100q resume exited {rc}: {se[-3000:]}")
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
    want = {m: "xla" if m in CLI_DENSE else "flash" for m in names[1:]}
    if f"Skipping {names[0]} (already completed)" not in so or lines != want:
        fails.append(f"run-100q resume: attention lines {lines}, want {want}")
    order = [r[rows[0].index("model")] for r in rows[1:]]
    if order != [m for m in names for _ in questions]:
        fails.append("run-100q: rows not in roster order")
    # the first model's rows are the checkpoint's, field for field
    for row, ck in zip(rows[1:1 + len(questions)], state["results"]):
        for col, cell in zip(rows[0], row):
            v = ck[col]
            if (float(cell) != v if isinstance(v, float) else cell != str(v)):
                fails.append(f"run-100q resume: {col} {cell!r} vs the "
                             f"checkpoint's {v!r}")
                break

    # (3) a rerun over the finished output: nothing to score (in this
    # process: it starts no model)
    rc4, so4, se4, secs4 = _run_100q(snaps, out, in_process=True)
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


#: the T5 gates' second bf16 route: the same prompts at this batch (at 8
#: its 50-step decodes took 45 s of the instruct phase on the H100)
T5_SECOND_BATCH = 16
#: the instruct phase's T5 rows (T0_3B's instruct prompts and the
#: word-meaning pair's sweep): the first of the 100 questions
INSTRUCT_T5_QUESTIONS = 32


def _t5_gated_run(label, model, cfg, weights, tok, prompts, rows, card,
                  attention):
    """Gates of one T5 model's rows (``rows``: the sweep's, batch BATCH)
    against a second bf16 route (the same prompts at batch
    T5_SECOND_BATCH, another set of GEMM shapes) and a float32 forward of the same weights: completions
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
                             engine_config=emod.EngineConfig(
                                 batch_size=T5_SECOND_BATCH))
    t0 = time.perf_counter()
    rows2 = eng.score_prompts(prompts)
    torch.cuda.synchronize()
    secs2 = time.perf_counter() - t0
    eng.close(release_params=False)
    stats, f = _compare_family_rows(f"{label} batch {T5_SECOND_BATCH}",
                                    rows2, rows, leads,
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
                  gates={"second_batch": stats, "position0": stats32},
                  second_batch_s=secs2, ms_per_decode_step=(t50 - t10) / 40,
                  decode_ms=[t10, t50], card=card)
    return result, fails


def instruct_phase(seed, attention, workdir, card):
    """The instruct roster's new models at their published width and
    depth, random bf16 weights from ``seed`` made as HF checkpoints and
    read through the port's converters, under the phase's word tokenizer
    with the targets swapped to ids the weights rank high: T0_3B scores
    the first INSTRUCT_T5_QUESTIONS instruct prompts through the instruct
    sweep's per-model call (the word-meaning pair the same questions);
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

    questions = ordinary_meaning_questions()[:INSTRUCT_T5_QUESTIONS]
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
        engine._engine.close(release_params=False)
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
        engine._engine.close(release_params=False)
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
    ``texts``: the T5s' Unigram ``tokenizer.json`` behind a Precompiled
    charsmap, Baichuan2's SentencePiece BPE ``tokenizer.model`` alone
    (no ``tokenizer.json``), Mistral v0.3's Metaspace "first"
    byte-fallback BPE ``tokenizer.json``, Qwen's ``qwen.tiktoken``, OPT's
    ``vocab.json`` + ``merges.txt``, and a byte-level BPE
    ``tokenizer.json`` for h2oGPT.  Returns (bytes written, seconds)."""
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
        elif fmt == "sp_bpe":
            _write_tokenizer_files(snap, _format_tokenizer_files(fmt, texts))
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


def _run_instruct(snaps, out, extra=(), signal_after_first=False,
                  in_process=False):
    """``python -m llm_interpretation_replication_tpu_torch
    run-instruct-sweep --attention-impl flash --quant int8`` in a child
    process (the repository on its path), or in this one with
    ``in_process`` (:func:`_cli_here`); with ``signal_after_first`` a
    SIGTERM goes to the child as soon as its checkpoint file appears.
    Returns (exit code, stdout, stderr, seconds)."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = [sys.executable, "-m", "llm_interpretation_replication_tpu_torch",
            "run-instruct-sweep", "--checkpoint-dir", snaps, "--output-dir",
            out, "--attention-impl", "flash", "--quant", "int8",
            "--batch-size", str(BATCH), *extra]
    if in_process:
        return _cli_here(argv[3:])
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
    resuming it (under ``--strict``) writes the whole CSV, the first
    model's rows the checkpoint's, and a rerun over the finished output
    (in this process) scores nothing (no uninterrupted run: the resume
    scores nine of the ten)."""
    import csv

    from llm_interpretation_replication_tpu_torch.config import (
        instruct_sweep_models, ordinary_meaning_questions)
    from llm_interpretation_replication_tpu_torch.runtime.loader import (
        load_tokenizer)
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
    # Baichuan2's snapshot holds its SentencePiece file and no
    # tokenizer.json: the child reads it through the ModelProto reader
    spm_snap = os.path.join(snaps, "baichuan-inc--Baichuan2-7B-Chat")
    spm_files = sorted(os.listdir(spm_snap))
    spm_tok = load_tokenizer(spm_snap)
    spm_back = sum(spm_tok.decode(spm_tok.encode(t), skip_special_tokens=True)
                   != t for t in texts)
    spm_read = dict(files=spm_files, reader=type(spm_tok).__name__,
                    vocab=len(spm_tok), texts_not_decoding_back=spm_back)
    say("run-instruct-sweep baichuan tokenizer", json.dumps(spm_read))
    if "tokenizer.model" not in spm_files or "tokenizer.json" in spm_files \
            or spm_read["reader"] != "ByteLevelBPETokenizer" or spm_back:
        fails.append(f"run-instruct-sweep: Baichuan2's tokenizer {spm_read}")
    n = len(names) * len(questions)

    def csv_of(out):
        path = os.path.join(out, "instruct_model_comparison_results.csv")
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, newline="", encoding="utf-8") as f:
            return raw, list(csv.reader(f))

    def attention_lines(err):
        return dict(re.findall(r"^# (\S+): attention (\w+) ", err, re.M))

    # a run SIGTERM'd after its first model, then its resume under strict
    # mode: together the whole sweep
    out = os.path.join(workdir, "instruct")
    rc2, _, se2, secs2 = _run_instruct(snaps, out, signal_after_first=True)
    with open(os.path.join(out, "instruct_sweep_checkpoint.json")) as f:
        state = json.load(f)
    kept = list(state["outputs"])
    runs.append(dict(run="sigterm", rc=rc2, seconds=secs2, kept=kept,
                     checkpoint_rows=sum(map(len, state["outputs"].values()))))
    say("run-instruct-sweep", json.dumps(dict(runs[-1], card=card)))
    if rc2 != 143 or kept != names[:1] or \
            len(state["outputs"][names[0]]) != len(questions):
        fails.append(f"run-instruct-sweep SIGTERM: exit {rc2}, checkpoint of "
                     f"{kept}")
    rc, so, se, secs = _run_instruct(snaps, out, extra=("--strict",))
    audit = _strict_audit(se)
    runs.append(dict(run="resume", rc=rc, seconds=secs, strict=audit,
                     rows_per_s=(n - len(questions)) / secs))
    say("run-instruct-sweep", json.dumps(dict(runs[-1], card=card)))
    if rc != 0:
        raise AssertionError(f"run-instruct-sweep resume exited {rc}: "
                             f"{se[-3000:]}")
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
    # the first model's attention line and T5 warning are the SIGTERM'd
    # run's, the others the resume's
    lines = {**attention_lines(se2), **attention_lines(se)}
    want = {m: "xla" if m in INSTRUCT_DENSE else "flash" for m in names}
    if lines != want or f"Skipping {names[0]} (checkpointed)" not in so or \
            set(attention_lines(se)) != set(names[1:]):
        fails.append(f"run-instruct-sweep attention lines {lines}, want "
                     f"{want}")
    if (se2 + se).count(
            "UserWarning: int8 quantization unsupported for T5") != 2:
        fails.append("run-instruct-sweep: no int8 warning for the T5 models")
    order = [r[col["model"]] for r in rows[1:]]
    if order != [m for m in names for _ in questions]:
        fails.append("run-instruct-sweep: rows not in roster order")
    # the first model's rows are the checkpoint's, field for field
    for row in rows[1:1 + len(questions)]:
        ck = state["outputs"][names[0]][row[col["prompt"]]]
        if any(float(row[col[c]]) != ck[c] for c in
               ("yes_prob", "no_prob", "relative_prob")) or \
                row[col["model_output"]] != ck["completion"]:
            fails.append(f"run-instruct-sweep resume: {row} vs the "
                         f"checkpoint's {ck}")
            break
    rc4, so4, se4, secs4 = _run_instruct(snaps, out, in_process=True)
    runs.append(dict(run="rerun", rc=rc4, seconds=secs4))
    say("run-instruct-sweep", json.dumps(dict(runs[-1], card=card)))
    if rc4 != 0 or attention_lines(se4) or csv_of(out)[0] != raw or \
            so4.count("(checkpointed)") != len(names):
        fails.append(f"run-instruct-sweep rerun: exit {rc4}, it scored "
                     f"{sorted(attention_lines(se4))}")
    shutil.rmtree(snaps, ignore_errors=True)
    result = dict(card=card, layers=SNAPSHOT_LAYERS, snapshot_bytes=nbytes,
                  snapshot_write_s=write_s, rows=n, runs=runs,
                  attention=lines, baichuan_tokenizer=spm_read,
                  failures=fails[:50])
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
            # on a mesh, the port's row-parallel decode (the rank's rows
            # and heads; whole tokens on every rank)
            run = getattr(self, "_dev", dmod)
            toks = run.decode_steps(self.params, self.cfg, cache, prev,
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
    # at the full-study phase's depth, where its near-tie was measured
    cfg = mconfig.DecoderConfig(**{**mconfig.FALCON_7B_GEOMETRY,
                                   "num_layers": FULL_STUDY_LAYERS},
                                attention_impl="flash")
    weights = _first_layers(weights, FULL_STUDY_LAYERS)
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

    # the packed rows' bucket, and what was allocated at each reset
    pack_seq = batching.bucket_for(max(map(len, packed.encode_packs(
        tok, packed.build_packs(prompts, PACK_Q))[0])))
    before = [0]

    def reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before[0] = torch.cuda.memory_allocated()
        _reset_launches(attention)
        for k in counted:
            counted[k] = 0

    def point(rcfg=cfg):
        return _plan_point("packed", rcfg, BATCH, pack_seq, before[0],
                           packing=PACK_Q)

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
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   plan_point=point())
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
            speed.setdefault("points", []).append(dict(
                run=name, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                plan_point=point()))
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
        engine.close(release_params=False)
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
                       peak_memory_bytes=torch.cuda.max_memory_allocated(),
                       plan_point=point(rcfg))
            if route == "kernel":
                launches_per_forward(res["run"], res)
            elif _launches(attention)["causal_grouped_attention"]:
                fails.append("dense route launched the causal kernel")
            runs.append(res)
            eng.close(release_params=False)
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


def k_decode_phase(seed, attention, full_weights, card):
    """The full-study row (``score_prefixed``, binary and confidence legs)
    on the full-study phase's 96 rows with the joint K-token decode, on
    the slice's first K_DECODE_LAYERS layers (views, as the sweep phase
    runs): K=1, then K=K_DECODE with a distilled head, with oracle
    proposals (``oracle_engine``) and with a random head (every
    speculative block rejects); then K=1 and the oracle with an int8 KV
    cache.  The near-tie is measured at this depth, as the full-study
    phase measures it at full depth."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    device = "cuda"
    weights = _first_layers(full_weights, K_DECODE_LAYERS)
    cfg = dataclasses.replace(
        mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                              attention_impl="flash"),
        num_layers=K_DECODE_LAYERS)
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
        point = _plan_point(
            "full", cfg, engine.ecfg.batch_size,
            _bucket(max(len(p) for p, _ in pairs)),
            torch.cuda.memory_allocated(), kv=engine.ecfg.kv_dtype,
            depth=engine.ecfg.pipeline_depth, pooled=True,
            decode_k=engine.ecfg.decode_k)
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
                   plan_point=point,
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
        engine.close(release_params=False)
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
        warm.close(release_params=False)
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
    conf_batches = list(batching.batches_for_prompts(
        joined[1], base.batch_size, base.buckets, pad_id=0,
        length_sorted=True))
    # the rounding between two bf16 computations of the same logits at
    # this depth (the full-study phase's measure): a greedy decode of the
    # confidence prompts against one forward over them and their tokens
    btoks, _, btop1, _, _, _ = _study_prepass(
        weights, cfg, conf_batches, n, CONF_CAP, CONF_CAP, None, target_ids)
    near_tie = NEAR_TIE_FACTOR * float(np.abs(_teacher_top1(
        weights, cfg, joined[1], btoks.tolist())[0][:, :-1] - btop1).max())
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
        runs.values()), timing=timing, stats=stats, layers=K_DECODE_LAYERS,
        near_tie=near_tie, parting_tie=tie,
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
# phase's corpus (5 x 4 = 20 rows, one chunk, one batch); it and the
# tokenizers phase's sweep run on the slice's first OBS_LAYERS layers
OBS_PER_SCENARIO = 4
OBS_LAYERS = 2
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


def obs_phase(seed, attention, full_weights, workdir, card):
    """Phase 18 on Falcon-7B at full width and OBS_LAYERS of its layers
    (views of the slice's weights, the causal kernel): 20 rows of the sweep phase's corpus through
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

    weights = _first_layers(full_weights, OBS_LAYERS)
    cfg = dataclasses.replace(
        mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                              attention_impl="flash"),
        num_layers=OBS_LAYERS)
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
    engine.close(release_params=False)
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
#: package's loader compute the same on the CPU, and for the SentencePiece
#: formats ``transformers``' conversion of the same model file
#: (tests/test_torch_tokenizer.py)
TOKENIZER_DIGESTS = {
    "falcon": "0eab6160252d142550c8e11bb012e70939c4f6624c70409250d34a43360eaf60",
    "bloom": "657ea138c438af199faf905ee92e3979c81ea58f117704868efe1a09d4289d7c",
    "llama": "89fc69bc23c1f7b49158bed31fcc269c6002ec8aa0bc0cceb5ae5f6f2042e7ff",
    "mistral_v03":
        "9af18574ce5c6fe1355481d49f5a322b89c7e1ab0a1d624e51dc5faf0558b0a6",
    "t5": "754860bf3f1db2979a67bd143dbdc8b77941ae7466a7e9d257fd49e8931aa71b",
    "sp_unigram":
        "ed4112e34c0df3a9bc8fae8212ea20f326d1b388a2af2fc76bdd1a7821f2a210",
    "sp_bpe": "cc848ba3b0d57df789fe3dfae1e07dba52a43835318695864b20fd4b400a94a8",
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
    """Phase 19 on the card's host and Falcon-7B at full width:
    each published tokenizer format of ``TOKENIZER_FORMATS``, written as
    plain JSON (the SentencePiece formats as a model file the port
    serializes) and read back through ``load_tokenizer`` from a directory,
    encodes the sweep corpus (the scenarios and their rephrasings;
    tokens/s) and decodes it back, and its ids over the fixed
    ``_tokenizer_digest_texts()`` hash to ``TOKENIZER_DIGESTS``; then 20
    rows of the corpus, encoded by the Falcon-format reader, go through
    ``run_model_perturbation_sweep`` on the slice's first OBS_LAYERS layers
    (views; bf16, the causal kernel) with the span tracer on, and again
    without
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
        # a Unigram decode gives the normalized text (charsmap, folded
        # spaces; the SentencePiece conversion folds runs to "▁")
        unigram = fmt in ("t5", "sp_unigram")
        want = [tok._normalize(t).replace("▁", " ") for t in corpus] \
            if unigram else corpus
        back = [tok.decode(i, skip_special_tokens=True) for i in ids]
        bad = [t for t, b, w in zip(corpus, back, want) if b != w]
        n_tokens = sum(map(len, ids))
        spec = files[0] if isinstance(files[0], dict) else {}
        formats[fmt] = dict(
            model=model, reader=type(tok).__name__, vocab=len(tok),
            model_file=None if spec else files[0][0],
            pre_tokenizer=(spec.get("pre_tokenizer") or {}).get("type"),
            normalizer=(spec.get("normalizer") or {}).get("type"),
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
        want_reader = "UnigramTokenizer" if unigram else \
            "ByteLevelBPETokenizer"
        if formats[fmt]["reader"] != want_reader:
            fails.append(f"{fmt}: read by {formats[fmt]['reader']}")

    # 20 rows through the sweep at OBS_LAYERS layers (views), encoded by
    # the Falcon-format reader
    cfg = dataclasses.replace(
        mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                              attention_impl="flash"),
        num_layers=OBS_LAYERS)
    rows_in = [dict(s, rephrasings=s["rephrasings"][:OBS_PER_SCENARIO])
               for s in scenarios]
    n_rows = sum(len(s["rephrasings"]) for s in rows_in)
    engine = emod.ScoringEngine("falcon", cfg,
                                _first_layers(weights, OBS_LAYERS),
                                toks["falcon"],
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
        engine.close(release_params=False)
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


# ---------------------------------------------------------------------------
# The serving layer (phase 20): serve/ over the slotted engine and KV slabs
# ---------------------------------------------------------------------------

# the admission hold of the phase's schedulers
SERVE_MAX_WAIT_S = 0.02
# the replay leg's requests (the pooled prompts' first rows); prefix/suffix
# pairs of the full-study rows served through score_prefixed
SERVE_REPLAY_PROMPTS = 192
SERVE_PREFIX_PAIRS = 16
# the OOM leg: prompts of this length (bucket 448), one micro-batch of 32
SERVE_OOM_PROMPTS, SERVE_OOM_LEN = 32, 440
# the pool, roles and supervise legs' requests (the pooled prompts' first
# rows)
SERVE_POOL_PROMPTS, SERVE_ROLE_PROMPTS, SERVE_SUPERVISE_PROMPTS = 24, 32, 32
# a busy replica with no progress beat for this long is wedged; well above
# one Falcon-7B launch of 32 rows
SERVE_WEDGE_S = 3.0
# the load leg: prompts of one bucket (256), completions of 10 tokens, the
# open-loop rates as fractions of the closed loop's, seconds each
SERVE_LOAD_PROMPTS, SERVE_LOAD_LENS = 32, (241, 256)
SERVE_LOAD_FRACTIONS, SERVE_LOAD_S, SERVE_LOAD_TOKENS = (0.25, 0.5, 0.9), 1.0, 10
SERVE_LOAD_CLOSED_S = 1.5
# memory after the pool leg's hot unloads may sit this far above its
# value before the leg's copy of the weights
SERVE_MEMORY_SLACK = 64 << 20
# the CLI leg: request lines (one malformed), and the load harness's rates
SERVE_CLI_LINES, SERVE_CLI_BAD_LINE = 64, 17
SERVE_CLI_RATES, SERVE_CLI_LOAD_S = (2.0, 4.0, 8.0), 1.0


def _vs_offline(what, rows, ref, rows_equal, fails):
    """Served rows against one offline call over the same requests: the
    gate is ``rows_equal`` on every row; the stats say how far apart
    any others are."""
    same = [rows_equal(a, b) for a, b in zip(rows, ref)]
    stats = dict(bit_identical_rows=sum(same), rows=len(ref),
                 same_scan_found=sum(a["scan_found"] == b["scan_found"]
                                     for a, b in zip(rows, ref)),
                 max_abs_delta_relative_prob=max(
                     abs(a["relative_prob"] - b["relative_prob"])
                     for a, b in zip(rows, ref)))
    if len(rows) != len(ref) or not all(same):
        first = [(i, {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                      if a.get(k) != b.get(k)})
                 for i, (a, b, eq) in enumerate(zip(rows, ref, same))
                 if not eq][:3]
        fails.append(f"serve {what}: {len(ref) - sum(same)} of {len(ref)} "
                     f"rows differ from offline ({stats}; first {first})")
    return stats


def _wait_for(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def serve_phase(seed, attention, weights, pool_inputs, card):
    """The serving layer on Falcon-7B at full width and depth (bf16,
    batch 32, ``attention_impl="flash"``): replay with slot admission
    under strict mode, prefix pairs, a real OOM split, a two-replica
    shared pool with hot unloads, prefill/decode roles with an int8 KV
    cache, a supervised pool that loses a replica to a crash and one to a
    wedge, and the open-loop load harness.  Every leg holds its served rows
    exactly (``rows_equal``) against one offline call over the same
    requests: the engine's decode reads a row the same in any batch or
    ring composition (float64 products and slot-axis sums in the decode
    attention, rings at their capacity, ReducedScores scanned on the
    host)."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch import serve
    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.runtime import strict
    from llm_interpretation_replication_tpu_torch.serve import cli as scli
    from llm_interpretation_replication_tpu_torch.serve import load as sload
    from llm_interpretation_replication_tpu_torch.utils import telemetry
    from llm_interpretation_replication_tpu_torch.utils.testing import (
        BreakableEngine)

    device = "cuda"
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    tok = _id_tokenizer(cfg.vocab_size)
    prompts, pairs = pool_inputs
    # the pool target at its default, the batch: slot rings and the
    # pooled route's in-place fallback then decode at one row count
    base = emod.EngineConfig(decode_completions=False, batch_size=BATCH)
    sched_cfg = serve.SchedulerConfig(max_wait_s=SERVE_MAX_WAIT_S)
    rows_equal = serve.rows_equal
    rng = np.random.default_rng(seed + 20)

    def engine(ecfg=base, w=weights):
        return emod.ScoringEngine("falcon", cfg, w, tok, device=device,
                                  engine_config=ecfg)

    def requests(ps, ts, **kw):
        return [serve.ScoreRequest(prompt=p, targets=tuple(t), **kw)
                for p, t in zip(ps, ts)]

    prefills = [0]
    real_prefill = decoder.prefill

    def counted_prefill(*args, **kwargs):
        out = real_prefill(*args, **kwargs)
        prefills[0] += 1            # a prefill that ran out of memory
        return out                  # is not counted

    runs, fails = [], []
    offline_rows = []           # the replay leg's offline call, shared

    def leg(name, fn):
        torch.cuda.synchronize()
        _reset_launches(attention)
        prefills[0] = 0
        snap = telemetry.counters()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        res.update(run=name, seconds=time.perf_counter() - t0,
                   kernel_launches=_launches(attention)[
                       "causal_grouped_attention"],
                   prefills=prefills[0],
                   serve_counters={k: v for k, v in telemetry.counters_since(
                       snap).items() if k.startswith(("serve_", "pool_"))})
        want = cfg.num_layers * res["prefills"]
        # the OOM leg's failed prefills launch the kernel up to the layer
        # that ran out of memory
        if not res["prefills"] or res["kernel_launches"] < want or (
                name != "oom" and res["kernel_launches"] != want):
            fails.append(f"serve {name}: {res['kernel_launches']} causal "
                         f"launches for {res['prefills']} prefills")
        runs.append(res)
        say("serve", json.dumps(dict(res, card=card)))
        return res

    def replay_leg():
        eng = engine()
        eng.score_prompts(prompts[:BATCH], pairs[:BATCH])     # warm-up
        snap = telemetry.counters()
        rp, rt = prompts[:SERVE_REPLAY_PROMPTS], pairs[:SERVE_REPLAY_PROMPTS]
        t0 = time.perf_counter()
        offline = eng.score_prompts(rp, rt)
        offline_s = time.perf_counter() - t0
        offline_rows.extend(offline)
        strict.activate(sentry=False)
        try:
            report = serve.replay(eng, rp, targets=rt,
                                  config=sched_cfg, offline_rows=offline,
                                  offline_s=offline_s, require_parity=False)
        finally:
            strict.deactivate()
        served = report.pop("serve_rows")
        admitted = int(telemetry.counters_since(snap).get(
            "serve_slot_admitted", 0))
        if not admitted:
            fails.append("serve replay: no request was admitted mid-decode")
        if report["blocked_transfers"]:
            fails.append(f"serve replay: blocked_transfers "
                         f"{report['blocked_transfers']} under strict mode")
        eng.close(release_params=False)
        return dict(report=report, admitted_mid_decode=admitted,
                    vs_offline=_vs_offline("replay", served, offline,
                                           rows_equal, fails))

    # the prefix leg's rows: three in four decided at position 0 (yes =
    # the top token of one forward, outside the leg's launch count), the
    # rest decode their look-ahead
    prefixes, suffixes = _study_inputs(seed, cfg.vocab_size)
    n_pairs = SERVE_PREFIX_PAIRS
    top = _top_tokens(weights, cfg, [prefixes[i] + suffixes[i][0]
                                     for i in range(n_pairs)])
    prefix_targets = [(f"t{top[i]}", f"t{b}") if i % 4 else (f"t{a}", f"t{b}")
                      for i, (a, b) in enumerate(
                          rng.integers(3, cfg.vocab_size, (n_pairs, 2)))]

    def prefix_leg():
        n, targets = n_pairs, prefix_targets
        pairs_ = [(prefixes[i], (suffixes[i][0],)) for i in range(n)]
        eng = engine()
        sched = serve.Scheduler(eng, sched_cfg)
        futs = [sched.submit(serve.ScoreRequest(
            prefix=prefixes[i], suffix=suffixes[i][0], targets=targets[i]))
            for i in range(n)]
        with sched:
            served = [f.result(timeout=600) for f in futs]
        pool = eng.last_prefix_pool
        if not (pool.closed and pool.consistent):
            fails.append("serve prefix: the prefix cache pool leaked")
        offline = eng.score_prefixed(pairs_, targets=targets)[0]
        eng.close(release_params=False)
        return dict(pairs=n, vs_offline=_vs_offline(
            "prefix", served, offline, rows_equal, fails))

    def oom_leg():
        oom_prompts = [rng.integers(3, cfg.vocab_size,
                                    SERVE_OOM_LEN).tolist()
                       for _ in range(SERVE_OOM_PROMPTS)]
        targets = [(f"t{a}", f"t{b}") for a, b in
                   rng.integers(3, cfg.vocab_size, (SERVE_OOM_PROMPTS, 2))]
        eng = engine()
        need, points = {}, []
        for b in (BATCH // 2, BATCH):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            with eng.config_overrides(batch_size=b):
                eng.score_prompts_slotted(oom_prompts[:b], targets[:b])
            torch.cuda.synchronize()
            need[b] = torch.cuda.max_memory_allocated() - before
            points.append(dict(
                batch=b, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                plan_point=_plan_point("binary", cfg, b,
                                       _bucket(SERVE_OOM_LEN), before)))
        torch.cuda.empty_cache()
        cap = torch.cuda.memory_reserved() + (need[BATCH // 2]
                                              + need[BATCH]) / 2
        total = torch.cuda.get_device_properties(0).total_memory
        telemetry.clear_fault_events()
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            sched = serve.Scheduler(eng, sched_cfg)
            futs = [sched.submit(r) for r in requests(oom_prompts, targets)]
            with sched:
                outcome = [f.exception(timeout=600) or f.result(timeout=0)
                           for f in futs]
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        errors = [o for o in outcome if isinstance(o, BaseException)]
        splits = [{k: e[k] for k in ("rows", "batch", "new_batch")}
                  for e in telemetry.fault_events("serve_oom_split")]
        if errors or not splits:
            fails.append(f"serve oom: {len(errors)} requests failed "
                         f"({errors[:1]}), splits {splits}")
        eng.close(release_params=False)
        res = dict(prompts=SERVE_OOM_PROMPTS, bucket_tokens=SERVE_OOM_LEN,
                   cap_bytes=int(cap), splits=splits,
                   need_bytes={str(k): int(v) for k, v in need.items()},
                   points=points)
        if not errors and splits:
            # offline at the batch the split ended at
            ended = min(sp["new_batch"] for sp in splits)
            res["vs_offline"] = _vs_offline(
                "oom", outcome, engine(dataclasses.replace(
                    base, batch_size=ended)).score_prompts(
                        oom_prompts, targets), rows_equal, fails)
        return res

    def pool_leg():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        copy = decoder.DecoderWeights(cfg, _clone_tree(weights.tree()))
        pool = scli.build_shared_pool(engine(w=copy), "falcon-7b", 2,
                                      sched_cfg)
        n = SERVE_POOL_PROMPTS
        futs = [pool.submit(r) for r in requests(prompts[:n], pairs[:n])]
        served = [f.result(timeout=600) for f in futs]
        answered = {r.rid: r.completed for r in pool.replicas()}
        for rid in list(answered):
            pool.unload(rid)
        pool.close()
        del copy, pool
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        if min(answered.values()) == 0:
            fails.append(f"serve pool: answered by replica {answered}")
        if after - before > SERVE_MEMORY_SLACK:
            fails.append(f"serve pool: {after - before} bytes still "
                         f"allocated after both hot unloads")
        return dict(replicas=2, requests=n, answered=answered,
                    memory_before_bytes=before, memory_after_bytes=after,
                    vs_offline=_vs_offline("pool", served, offline_rows[:n],
                                           rows_equal, fails))

    def roles_leg():
        n = SERVE_ROLE_PROMPTS
        ecfg = dataclasses.replace(base, kv_dtype="int8")
        pool = serve.EnginePool(serve.PoolConfig(scheduler=sched_cfg))
        c0 = telemetry.counters()
        try:
            pool.load("falcon-7b", engine(ecfg), owns_engine=False,
                      role="prefill")
            pool.load("falcon-7b", engine(ecfg), owns_engine=False,
                      role="decode")
            futs = [pool.submit(r) for r in requests(prompts[:n], pairs[:n])]
            served = [f.result(timeout=600) for f in futs]
            docs = {d["role"]: d for d in (r.health(0)
                                           for r in pool.replicas())}
        finally:
            pool.close()
        c = telemetry.counters_since(c0)
        moved = {k: int(c.get(k, 0)) for k in (
            "serve_handoff_rows", "slot_slab_export_rows",
            "slot_slab_import_rows", "slab_export_bytes")}
        if not moved["serve_handoff_rows"] or len(
                {moved["serve_handoff_rows"], moved["slot_slab_export_rows"],
                 moved["slot_slab_import_rows"]}) != 1 \
                or docs["prefill"]["completed"] != n \
                or docs["decode"]["completed"]:
            fails.append(f"serve roles: handoff {moved}, docs {docs}")
        offline = engine(ecfg).score_prompts(prompts[:n], pairs[:n])
        return dict(kv_dtype="int8", requests=n, handoff=moved,
                    vs_offline=_vs_offline("roles", served, offline,
                                           rows_equal, fails))

    def supervise_leg():
        n = SERVE_SUPERVISE_PROMPTS
        made = []

        def factory():
            made.append(BreakableEngine(engine()))
            return made[-1]

        pool = serve.EnginePool(serve.PoolConfig(
            scheduler=sched_cfg, supervision=serve.SupervisorConfig(
                wedge_timeout_s=SERVE_WEDGE_S, rebuild_backoff_initial_s=0.05,
                rebuild_backoff_max_s=0.2, poll_s=0.02)))
        try:
            for _ in range(2):
                pool.load("falcon-7b", factory(), owns_engine=False)
            pool.supervisor.register_rebuild("falcon-7b", factory)
            made[0].kill()
            half = n // 2
            futs = [pool.submit(r) for r in requests(prompts[:half],
                                                     pairs[:half])]
            first = [f.result(timeout=600) for f in futs]
            rebuilt = _wait_for(
                lambda: pool.supervisor.report()["restarts"] >= 1, 60)
            wedged = made[-1]
            wedged.wedge()
            futs = [pool.submit(r) for r in requests(prompts[half:n],
                                                     pairs[half:n])]
            detected = _wait_for(
                lambda: pool.supervisor.report()["wedges"] >= 1, 60)
            wedged.heal()
            second = [f.result(timeout=600) for f in futs]
            _wait_for(lambda: pool.supervisor.report()["restarts"] >= 2, 60)
            report = pool.supervisor.report()
        finally:
            for e in made:
                e.heal()
            pool.close()
        if not (rebuilt and detected) or report["crashes"] < 1 \
                or report["wedges"] < 1 or report["requests_lost"]:
            fails.append(f"serve supervise: report {report}")
        return dict(requests=n, report=report,
                    restart_ms=report["restart_ms"],
                    vs_offline=_vs_offline("supervise", first + second,
                                           offline_rows[:n], rows_equal,
                                           fails))

    def load_leg():
        lo, hi = SERVE_LOAD_LENS
        load_prompts = [rng.integers(3, cfg.vocab_size,
                                     int(rng.integers(lo, hi + 1))).tolist()
                        for _ in range(SERVE_LOAD_PROMPTS)]
        targets = [(f"t{a}", f"t{b}") for a, b in
                   rng.integers(3, cfg.vocab_size, (SERVE_LOAD_PROMPTS, 2))]
        eng = engine(emod.EngineConfig(batch_size=BATCH,
                                       max_new_tokens=SERVE_LOAD_TOKENS))
        offline = eng.score_prompts(load_prompts, targets)
        closed = sload.run_load(eng, load_prompts, targets=targets,
                                mode="closed", concurrency=2 * BATCH,
                                duration_s=SERVE_LOAD_CLOSED_S, seed=seed,
                                config=sched_cfg, offline_rows=offline)
        saturation = closed["achieved_rows_per_s"]
        block = sload.rate_sweep(
            eng, load_prompts, targets=targets,
            rates=[f * saturation for f in SERVE_LOAD_FRACTIONS],
            duration_s=SERVE_LOAD_S, seed=seed, config=sched_cfg,
            offline_rows=offline)
        block["closed_loop"] = closed
        say(sload.format_rate_table(block))
        bad = [p["offered_rate"] for p in [closed] + block["rates"]
               if p["parity"]["mismatched_rows"] or p["errors"]]
        if bad:
            fails.append(f"serve load: parity or errors at {bad}")
        eng.close(release_params=False)
        return dict(prompts=SERVE_LOAD_PROMPTS, bucket=256,
                    max_new_tokens=SERVE_LOAD_TOKENS,
                    saturation_rows_per_s=saturation, block=block)

    decoder.prefill = counted_prefill
    try:
        legs = {}
        for name, fn in (("replay", replay_leg), ("prefix", prefix_leg),
                         ("oom", oom_leg), ("pool", pool_leg),
                         ("roles", roles_leg), ("supervise", supervise_leg),
                         ("load", load_leg)):
            legs[name] = leg(name, fn)
    finally:
        decoder.prefill = real_prefill
    rep = legs["replay"]["report"]
    say(f"serve replay: scheduler {rep['serve_rows_per_s']} rows/s against "
        f"offline {rep['offline_rows_per_s']} rows/s ({card})")
    result = dict(card=card, runs=runs, failures=fails[:50])
    say("serve gates", json.dumps(dict(card=card, failures=len(fails))))
    if fails:
        raise AssertionError(f"serve: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


def _top_tokens(weights, cfg, prompts, batch=BATCH):
    """The top token at position 0 of each prompt, one forward a batch."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    out = []
    for i in range(0, len(prompts), batch):
        ids, mask = _padded(prompts[i:i + batch], "cuda")
        out += decoder.forward_last_logits(weights, cfg, ids,
                                           mask).argmax(-1).tolist()
    torch.cuda.synchronize()
    return out


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fetch(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read().decode("utf-8")


def serve_cli_phase(attention, workdir, card):
    """``python -m llm_interpretation_replication_tpu_torch serve`` on the
    CLI phase's 2-layer snapshot with ``--attention-impl flash``: the JSONL
    driver over 64 request lines (one malformed) under ``--strict`` with
    ``--metrics-port`` (``/metrics`` and ``/healthz`` fetched while it
    serves), ``--replay`` on the CLI phase's perturbations, and
    ``--load-rate`` with three rates through ``--pool-replicas 2
    --supervise``."""
    import contextlib
    import threading

    import torch

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch.runtime import strict
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    snap = os.path.join(workdir, "falcon-7b-2l")
    pert = os.path.join(workdir, "perturbations.json")
    argv = ["serve", "--model", snap, "--attention-impl", "flash",
            "--batch-size", str(BATCH)]
    with open(pert, encoding="utf-8") as f:
        scenarios = json.load(f)
    lines = []
    for s in scenarios:
        for r in s["rephrasings"]:
            lines.append(json.dumps({"prompt": f"{r} {s['response_format']}",
                                     "targets": s["target_tokens"][:2]}))
    lines = (lines * (SERVE_CLI_LINES // len(lines) + 1))[:SERVE_CLI_LINES]
    lines[SERVE_CLI_BAD_LINE] = '{"prompt": "unterminated'
    fails, runs = [], []

    def run(name, extra, stdin_lines=None):
        out = os.path.join(workdir, f"serve_{name}.jsonl")
        codes, buf = [], io.StringIO()
        snap_c = telemetry.counters()
        fetched = {}

        def call():
            try:
                cli.main(argv + extra)
            except SystemExit as e:
                codes.append(e.code)

        torch.cuda.synchronize()
        _reset_launches(attention)
        t0 = time.perf_counter()
        if stdin_lines is None:
            with contextlib.redirect_stdout(buf):
                call()
        else:
            fifo = os.path.join(workdir, f"serve_{name}.fifo")
            os.mkfifo(fifo)
            port = _free_port()
            extra += ["--input", fifo, "--output", out,
                      "--metrics-port", str(port)]
            worker = threading.Thread(target=call, name="serve-cli")
            worker.start()
            fd = None
            # the reader opens the FIFO once its engine is up; a command
            # that dies first must not leave this writer blocked
            while fd is None and worker.is_alive():
                try:
                    fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
                except OSError:
                    time.sleep(0.05)
            if fd is not None:
                os.set_blocking(fd, True)
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    f.write("\n".join(stdin_lines) + "\n")
                    f.flush()
                    url = f"http://127.0.0.1:{port}"
                    if _wait_for(lambda: _try_fetch(url + "/healthz"), 120):
                        fetched["healthz"] = json.loads(
                            _fetch(url + "/healthz")[1])
                        fetched["metrics_lines"] = len(
                            _fetch(url + "/metrics")[1].splitlines())
            worker.join(timeout=600)
        torch.cuda.synchronize()
        delta = telemetry.counters_since(snap_c)
        res = dict(run=name, seconds=time.perf_counter() - t0,
                   exit_code=codes[0] if codes else None,
                   kernel_launches=_launches(attention)[
                       "causal_grouped_attention"],
                   blocked_transfers=int(delta.get(strict.BLOCKED_COUNTER, 0)),
                   **fetched)
        runs.append(res)
        say("serve cli", json.dumps(dict(res, card=card)))
        if res["exit_code"] != 0 or not res["kernel_launches"]:
            fails.append(f"serve cli {name}: exit {res['exit_code']}, "
                         f"{res['kernel_launches']} causal launches")
        return res, buf.getvalue(), out

    res, _, out = run("jsonl", ["--strict"], lines)
    with open(out, encoding="utf-8") as f:
        answers = [json.loads(line) for line in f]
    if [a["id"] for a in answers] != list(range(SERVE_CLI_LINES)) \
            or answers[SERVE_CLI_BAD_LINE].get("error_type") \
            != "JSONDecodeError" \
            or not all(a.get("success") for i, a in enumerate(answers)
                       if i != SERVE_CLI_BAD_LINE):
        fails.append("serve cli jsonl: answers out of order, or the "
                     "malformed line not answered with its error")
    if res["blocked_transfers"] or "healthz" not in res \
            or res["healthz"].get("scheduler") != "running" \
            or not res.get("metrics_lines"):
        fails.append(f"serve cli jsonl: blocked_transfers "
                     f"{res['blocked_transfers']}, endpoints {res}")
    _, text, _ = run("replay", ["--replay", pert])
    report = json.loads(text)
    say(f"serve cli replay: scheduler {report['serve_rows_per_s']} rows/s "
        f"against offline {report['offline_rows_per_s']} rows/s ({card})")
    if report["mismatched_rows"]:
        fails.append(f"serve cli replay: {report['mismatched_rows']} rows "
                     f"differ from offline")
    _, text, _ = run("load", [
        "--replay", pert, "--load-rate",
        ",".join(str(r) for r in SERVE_CLI_RATES),
        "--load-duration", str(SERVE_CLI_LOAD_S), "--pool-replicas", "2",
        "--supervise"])
    block = json.loads(text)
    if block.get("parity_ok") is not True or len(block["rates"]) != 3:
        fails.append(f"serve cli load: parity_ok {block.get('parity_ok')}")
    result = dict(card=card, runs=runs, replay=report,
                  load={k: v for k, v in block.items() if k != "rates"},
                  load_rates=[{k: p[k] for k in (
                      "offered_rate", "achieved_rows_per_s", "latency_ms",
                      "completed", "errors")} for p in block["rates"]],
                  failures=fails[:50])
    say("serve cli gates", json.dumps(dict(card=card, failures=len(fails))))
    if fails:
        raise AssertionError(f"serve cli: {len(fails)} failures: "
                             + "; ".join(fails[:20]))
    return result


def _try_fetch(url):
    try:
        return _fetch(url)[0] == 200
    except OSError:
        return False


def _strict_audit(stderr):
    """The ``# strict: {...}`` audit lines a ``--strict`` CLI run prints."""
    return [json.loads(line.split(": ", 1)[1]) for line in stderr.splitlines()
            if line.startswith("# strict: ")]

# ---------------------------------------------------------------------------
# The API leg: the irrelevant-insertion corpus, the vendor clients and the
# API sweeps over scripted vendors (no socket is opened)
# ---------------------------------------------------------------------------

#: the irrelevant-insertion corpus ``generate-irrelevant`` writes: its
#: JSON's sha256 (the JAX package's bytes; tests/test_torch_irrelevant.py
#: pins it on the CPU) and its perturbation count
IRRELEVANT_CORPUS_SHA256 = (
    "e10ad4e6b01698b6aa4150ae54409ba569a2b0278a1a28a4ed2d12a1e5b46edf")
IRRELEVANT_CORPUS_ROWS = 3400
API_CORPUS_ROWS = 256      # corpus rows scored on the card
API_POOL_LOCAL = 64        # of them, through the mixed pool's two replicas
API_POOL_REMOTE = 4        # binary and confidence requests a vendor
API_BUDGET_S = 40.0
API_MODELS = {"openai": "gpt-4.1-2025-04-14", "gemini": "gemini-2.5-pro",
              "anthropic": "claude-opus-4-1-20250805"}
#: USD per 1M tokens (input, output) the mixed pool's tracker prices with
API_PRICING = {API_MODELS["openai"]: {"input": 1.0, "output": 4.0},
               API_MODELS["gemini"]: {"input": 1.25, "output": 10.0},
               API_MODELS["anthropic"]: {"input": 15.0, "output": 75.0}}
API_SWEEP_SCENARIOS = 2
API_SWEEP_REPHRASINGS = 5
#: tokens the scripted vendors rank at a binary prompt's first position
API_ANSWER_TOKENS = ("Yes", "No", "Covered", "Not", "Ultimate", "First",
                     "Existing", "Future", "Monthly", "Payment", "Completion")


def _api_answer(text):
    """A scripted vendor's answer to one prompt, from a CRC of its text:
    ``(answer, [(token, logprob), ...] a position)``.  A confidence prompt
    (one that asks how confident) answers a number, its two digits'
    candidates a position; a binary prompt answers the best of
    ``API_ANSWER_TOKENS`` under CRC-drawn weights."""
    import math
    import zlib

    h = zlib.crc32(text.encode("utf-8"))
    if "confident" in text:
        a, b = h % 90 + 10, (h // 90) % 90 + 10
        return str(a), [[(x, math.log(p)) for x, p in zip(pair, (0.7, 0.2))]
                        for pair in zip(str(a), str(b))]
    w = [1 + (h >> (3 * i)) % 8 for i in range(len(API_ANSWER_TOKENS))]
    top = sorted(zip(API_ANSWER_TOKENS, (x / sum(w) for x in w)),
                 key=lambda t: -t[1])
    return top[0][0], [[(t, math.log(p)) for t, p in top]]


def _api_transport(api, vendor, calls=None):
    """A ``FakeTransport`` scripted as one vendor: chat completions, files,
    batches and downloads (OpenAI), messages and message batches
    (Anthropic), or generateContent (Gemini).  Every answer comes from
    :func:`_api_answer` on the request's text; batches end at their first
    poll.  ``calls`` (a list) collects each request's URL."""
    import json as jsonlib
    import zlib

    ft = api.FakeTransport()
    store = {}

    def counted(fn):
        def respond(call):
            if calls is not None:
                calls.append(call["url"])
            return fn(call)
        return respond

    def openai_body(req):
        text = req["messages"][0]["content"]
        answer, positions = _api_answer(text)
        choice = {"message": {"content": answer}}
        if "max_completion_tokens" not in req:
            choice["logprobs"] = {"content": [
                {"token": answer, "top_logprobs": [
                    {"token": t, "logprob": lp} for t, lp in pos]}
                for pos in positions]}
        return {"choices": [choice],
                "usage": {"prompt_tokens": len(text) // 4,
                          "completion_tokens": 2}}

    def claude_message(req):
        return {"content": [{"type": "text", "text": _api_answer(
            req["messages"][0]["content"])[0]}]}

    if vendor == "openai":
        def upload(call):
            lines = [jsonlib.loads(x) for x in call["data"].decode(
                "utf-8", "replace").splitlines() if x.startswith("{")]
            fid = f"file-{zlib.crc32(jsonlib.dumps(lines).encode()):08x}"
            store[fid] = lines
            return 200, {"id": fid}

        def download(call):
            fid = call["url"].split("/files/out-")[1].split("/content")[0]
            return 200, "\n".join(jsonlib.dumps({
                "custom_id": r["custom_id"],
                "response": {"body": openai_body(r["body"])}})
                for r in store[fid]).encode()

        ft.add("POST", "/chat/completions",
               counted(lambda c: (200, openai_body(c["json"]))))
        ft.add("POST", "/files", counted(upload))
        ft.add("POST", "/batches", counted(lambda c: (200, {
            "id": "batch-" + c["json"]["input_file_id"][5:],
            "status": "validating"})))
        ft.add("GET", "/batches/", counted(lambda c: (200, {
            "status": "completed",
            "output_file_id": "out-file-" + c["url"].rsplit("-", 1)[1]})))
        ft.add("GET", "/content", counted(download))
    elif vendor == "anthropic":
        def create(call):
            bid = f"msgbatch-{len(store)}"
            store[bid] = call["json"]["requests"]
            return 200, {"id": bid, "processing_status": "in_progress"}

        def results(call):
            bid = call["url"].split("/messages/batches/")[1].split("/")[0]
            return 200, "\n".join(jsonlib.dumps({
                "custom_id": r["custom_id"], "result": {
                    "type": "succeeded",
                    "message": claude_message(r["params"])}})
                for r in store[bid]).encode()

        ft.add("POST", "/messages/batches", counted(create))
        ft.add("GET", "/results", counted(results))
        ft.add("GET", "/messages/batches/", counted(lambda c: (200, {
            "id": c["url"].rsplit("/", 1)[1], "processing_status": "ended"})))
        ft.add("POST", "/messages",
               counted(lambda c: (200, claude_message(c["json"]))))
    else:
        def generate(call):
            answer, positions = _api_answer(
                call["json"]["contents"][0]["parts"][0]["text"])
            return 200, {"candidates": [{
                "content": {"parts": [{"text": answer}]},
                "logprobsResult": {"topCandidates": [{"candidates": [
                    {"token": t, "logProbability": lp} for t, lp in pos]}
                    for pos in positions]}}]}

        ft.add("POST", ":generateContent", counted(generate))
    return ft


def _api_client(api, vendor, calls=None):
    cls = {"openai": api.OpenAIClient, "gemini": api.GeminiClient,
           "anthropic": api.AnthropicClient}[vendor]
    return cls("scripted-key", transport=_api_transport(api, vendor, calls))


def _api_host_child(workdir):
    """The API sweeps on the card's host, in a process of their own: the
    CLI's four sweep commands over the scripted vendors on
    API_SWEEP_SCENARIOS scenarios x API_SWEEP_REPHRASINGS rephrasings,
    each run twice (the second resumes from its workbook and must ask
    nothing), then ``generate-rephrasings`` and ``repair-batch``.  Prints
    one JSON line; the process must end without a CUDA context and
    without pandas."""
    import torch

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch import api_backends as api
    from llm_interpretation_replication_tpu_torch.api_backends import (
        anthropic_client, gemini_client, openai_client)
    from llm_interpretation_replication_tpu_torch.config import legal_scenarios
    from llm_interpretation_replication_tpu_torch.sweeps.writers import (
        CLAUDE_PERTURBATION_COLUMNS, PERTURBATION_COLUMNS)
    from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx

    t0 = time.perf_counter()
    calls = []
    for mod, vendor in ((openai_client, "openai"),
                        (anthropic_client, "anthropic"),
                        (gemini_client, "gemini")):
        mod.UrllibTransport = functools.partial(
            lambda v: _api_transport(api, v, calls), vendor)
    for var in ("OPENAI_API_KEY", "ANTHROPIC_API_KEY", "GEMINI_API_KEY"):
        os.environ[var] = "scripted-key"
    records = [dict(s, rephrasings=[
        f"{s['original_main'][:80]} (rephrasing {i})"
        for i in range(API_SWEEP_REPHRASINGS)] if k < API_SWEEP_SCENARIOS
        else []) for k, s in enumerate(legal_scenarios())]
    pert = os.path.join(workdir, "api_perturbations.json")
    with open(pert, "w", encoding="utf-8") as f:
        json.dump(records, f)
    want_rows = API_SWEEP_SCENARIOS * API_SWEEP_REPHRASINGS
    runs, fails = {}, []
    sweeps = {
        "run-api-perturbation": (["--model", API_MODELS["openai"]],
                                 PERTURBATION_COLUMNS),
        "run-claude-perturbation": (["--model", API_MODELS["anthropic"]],
                                    CLAUDE_PERTURBATION_COLUMNS),
        "run-gpt-perturbation": (["--sleep", "0"], PERTURBATION_COLUMNS),
        "run-gemini-perturbation": (["--threads", "4", "--rps", "1000"],
                                    PERTURBATION_COLUMNS),
    }
    for cmd, (extra, columns) in sweeps.items():
        out = os.path.join(workdir, f"{cmd}.xlsx")
        argv = [cmd, "--perturbations", pert, "--output", out] + extra
        got = []
        for _ in range(2):
            before = len(calls)
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv)
            cols, rows = read_xlsx(out)
            got.append(dict(rows=len(rows), requests=len(calls) - before))
        runs[cmd] = dict(first=got[0], resume=got[1], columns=len(cols))
        if cols != columns or got[0]["rows"] != want_rows \
                or got[1]["rows"] != want_rows or got[1]["requests"] \
                or not got[0]["requests"]:
            fails.append(f"{cmd}: {runs[cmd]}")
    reph = os.path.join(workdir, "generated_perturbations.json")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["generate-rephrasings", "--sessions", "2", "--target", "1",
                  "--output", reph])
    with open(reph, encoding="utf-8") as f:
        generated = [len(r["rephrasings"]) for r in json.load(f)]
    if generated != [1] * len(legal_scenarios()):
        fails.append(f"generate-rephrasings: {generated} rephrasings")
    req, resp, fixed = (os.path.join(workdir, n) for n in (
        "req.jsonl", "resp.jsonl", "fixed.jsonl"))
    with open(req, "w") as f:
        f.write("\n".join(json.dumps({"custom_id": f"q{i}"})
                          for i in range(2)) + "\n")
    with open(resp, "w") as f:
        f.write(json.dumps({"response": {"candidates": [{"content": {
            "parts": [{"text": "Part(text='85')"}]}}]}}) + "\n")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["repair-batch", "--requests", req, "--responses", resp,
                  "--output", fixed])
    with open(fixed) as f:
        repaired = [json.loads(x) for x in f]
    if [r["custom_id"] for r in repaired] != ["q0"] or repaired[0][
            "response"]["candidates"][0]["content"]["parts"][0]["text"] != "85":
        fails.append(f"repair-batch: {repaired}")
    print(json.dumps(dict(
        runs=runs, generated=generated, fails=fails,
        cuda_initialized=torch.cuda.is_initialized(),
        pandas_imported="pandas" in sys.modules,
        seconds=time.perf_counter() - t0)))


def _api_host_leg(workdir):
    """:func:`_api_host_child` in a child process, in a directory of its
    own under ``workdir`` (so its first runs find no workbook); its JSON
    line, checked."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke._api_host_child(sys.argv[2])")
    own = tempfile.mkdtemp(prefix="api_host_", dir=workdir)
    proc = subprocess.run([sys.executable, "-c", code, here, own],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise AssertionError(f"api host leg exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    fails = list(res["fails"])
    if res["cuda_initialized"]:
        fails.append("the API commands created a CUDA context")
    if res["pandas_imported"]:
        fails.append("the API commands imported pandas")
    if fails:
        raise AssertionError("api host leg: " + "; ".join(fails))
    return res


def _corpus_tokenizer(corpus):
    """A ``WordTokenizer`` over the corpus's words (its texts, response
    formats and target tokens)."""
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        WordTokenizer)

    words = []
    for s in corpus:
        words += s["response_format"].split() + list(s["target_tokens"])
        for p in s["perturbations_with_irrelevant"]:
            words += p["perturbed_text"].split()
    return WordTokenizer(words)


def api_phase(seed, attention, weights, workdir, card):
    """The API leg (after serve_cli, on the slice's weights at full width
    and depth, the causal kernel): (1) ``generate-irrelevant`` through the
    port's CLI, its JSON's sha256 against IRRELEVANT_CORPUS_SHA256 with
    IRRELEVANT_CORPUS_ROWS rows; (2) API_CORPUS_ROWS of its binary prompts
    (every 13th row) scored on the card under a word tokenizer of the
    corpus (token counts, rows/s and the share decided at position 0,
    printed, not gated); (3) a mixed pool of two local replicas on the
    card beside ``RemoteBackend.openai``, ``.gemini`` and ``.anthropic``
    over scripted vendors under strict mode: local rows equal an offline
    call, remote rows equal the evaluators' on the same answers, the
    shared cost tracker's total equals its sum, ``blocked_transfers`` 0;
    (4) the four API sweeps on the card's host in a child process
    (:func:`_api_host_child`)."""
    import hashlib

    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch import api_backends as api
    from llm_interpretation_replication_tpu_torch import serve
    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.runtime import strict
    from llm_interpretation_replication_tpu_torch.scoring.prompts import (
        format_binary_prompt)
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    fails, res = [], {}
    path = os.path.join(workdir, "perturbations_irrelevant.json")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["generate-irrelevant", "--output", path,
                  "--readable-output", path + ".txt"])
    with open(path, "rb") as f:
        raw = f.read()
    corpus = json.loads(raw)
    rows_all = [(s, p) for s in corpus
                for p in s["perturbations_with_irrelevant"]]
    digest = hashlib.sha256(raw).hexdigest()
    res["corpus"] = dict(rows=len(rows_all), sha256=digest)
    if digest != IRRELEVANT_CORPUS_SHA256 \
            or len(rows_all) != IRRELEVANT_CORPUS_ROWS:
        raise AssertionError(f"api corpus: {res['corpus']}")

    # (2) the corpus scored on the card
    picked = rows_all[::13][:API_CORPUS_ROWS]
    prompts = [format_binary_prompt(p["perturbed_text"], s["response_format"])
               for s, p in picked]
    targets = [tuple(s["target_tokens"]) for s, _ in picked]
    tok = _corpus_tokenizer(corpus)
    lens = [len(tok.encode(p)) for p in prompts]
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    ecfg = emod.EngineConfig(decode_completions=False, batch_size=BATCH)

    def engine():
        return emod.ScoringEngine("falcon", cfg, weights, tok, device="cuda",
                                  engine_config=ecfg)

    prefills = [0]
    real_prefill = decoder.prefill

    def counted_prefill(*args, **kwargs):
        prefills[0] += 1
        return real_prefill(*args, **kwargs)

    eng = engine()
    decoder.prefill = counted_prefill
    try:
        torch.cuda.synchronize()
        _reset_launches(attention)
        t0 = time.perf_counter()
        scored = eng.score_prompts(prompts, targets)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches(attention)["causal_grouped_attention"]
        n_prefills = prefills[0]
    finally:
        decoder.prefill = real_prefill
    # the share decided at position 0: a target in the top_k of one
    # forward a batch (outside the run's launch count)
    decided = 0
    with torch.no_grad():
        for i in range(0, len(prompts), BATCH):
            ids, mask = _padded([tok.encode(p) for p in prompts[i:i + BATCH]],
                                "cuda")
            top = decoder.forward_last_logits(weights, cfg, ids, mask).topk(
                ecfg.top_k, dim=-1).indices.cpu()
            for row, pair in zip(top.tolist(), targets[i:i + BATCH]):
                decided += bool(set(row) & set(eng.target_ids(list(pair))))
    finite = all(np.isfinite([r["yes_prob"], r["no_prob"]]).all()
                 and r["success"] for r in scored)
    res["scored"] = dict(
        rows=len(scored), vocab=len(tok), tokens_min=min(lens),
        tokens_median=float(np.median(lens)), tokens_max=max(lens),
        seconds=seconds, rows_per_s=len(scored) / seconds,
        decided_share=decided / len(scored),
        prefills=n_prefills, kernel_launches=launches, card=card)
    say("api corpus", json.dumps(res["scored"]))
    if not finite or len(scored) != API_CORPUS_ROWS or not n_prefills \
            or launches != cfg.num_layers * n_prefills:
        fails.append(f"api scoring: finite {finite}, {res['scored']}")

    # (3) the mixed pool
    local_p, local_t = prompts[:API_POOL_LOCAL], targets[:API_POOL_LOCAL]
    remote_prompts = [p["perturbed_text"] for _, p in picked[
        API_POOL_LOCAL:API_POOL_LOCAL + API_POOL_REMOTE]]
    tracker = api.CostTracker(pricing=API_PRICING)
    offline = eng.score_prompts(local_p, local_t)   # the pool closes eng
    second = engine()
    pool = serve.EnginePool(serve.PoolConfig(
        scheduler=serve.SchedulerConfig(max_wait_s=SERVE_MAX_WAIT_S)))
    strict.activate(sentry=False)
    snap = telemetry.counters()
    _reset_launches(attention)
    t0 = time.perf_counter()
    try:
        replicas = [pool.load("falcon-7b", e, owns_engine=False)
                    for e in (eng, second)]
        for vendor, model in API_MODELS.items():
            pool.load_remote(getattr(serve.RemoteBackend, vendor)(
                _api_client(api, vendor), model, cost_tracker=tracker),
                model=model)
        local = [pool.submit(serve.ScoreRequest(prompt=p, targets=t),
                             model="falcon-7b")
                 for p, t in zip(local_p, local_t)]
        remote = [(vendor, p, conf, pool.submit(serve.ScoreRequest(
            prompt=p, with_confidence=conf), model=model))
            for vendor, model in API_MODELS.items()
            for conf in (False, True) for p in remote_prompts]
        local_rows = [f.result(timeout=600) for f in local]
        remote_rows = [(v, p, c, f.result(timeout=60))
                       for v, p, c, f in remote]
        answered = {r.rid: r.completed for r in replicas}
    finally:
        strict.deactivate()
        pool.close()
    pool_s = time.perf_counter() - t0
    blocked = int(telemetry.counters_since(snap).get(
        strict.BLOCKED_COUNTER, 0))
    pool_launches = _launches(attention)["causal_grouped_attention"]
    vs = _vs_offline("api pool", local_rows, offline, serve.rows_equal, fails)
    expected_usd, remote_same = 0.0, 0
    evaluate = {"openai": (api.evaluate_gpt_binary,
                           api.evaluate_gpt_confidence),
                "gemini": (api.evaluate_gemini_binary,
                           api.evaluate_gemini_confidence),
                "anthropic": (api.evaluate_claude, api.evaluate_claude)}
    for vendor, prompt, conf, row in remote_rows:
        out = evaluate[vendor][conf](_api_client(api, vendor),
                                     API_MODELS[vendor], prompt)
        remote_same += json.dumps(row) == json.dumps(
            serve.RemoteBackend._result_row(out))
        usage = (out.get("raw") or {}).get("usage")
        n_in, n_out = ((usage["prompt_tokens"], usage["completion_tokens"])
                       if usage else (int(len(prompt) / 4), 16))
        price = API_PRICING[API_MODELS[vendor]]
        expected_usd += (n_in / 1e6 * price["input"]
                         + n_out / 1e6 * price["output"])
    total = tracker.total_cost()
    res["pool"] = dict(local_requests=len(local_rows),
                       remote_requests=len(remote_rows),
                       remote_rows_equal=remote_same, answered=answered,
                       vs_offline=vs, cost_usd=total,
                       expected_cost_usd=expected_usd,
                       blocked_transfers=blocked, seconds=pool_s,
                       kernel_launches=pool_launches, card=card)
    say("api pool", json.dumps(res["pool"]))
    if remote_same != len(remote_rows) or blocked \
            or abs(total - expected_usd) > 1e-12 * max(1.0, expected_usd) \
            or not total or not pool_launches or min(answered.values()) == 0:
        fails.append(f"api pool: {res['pool']}")

    # (4) the sweeps on the card's host
    res["sweeps"] = _api_host_leg(workdir)
    say("api sweeps", json.dumps(dict(res["sweeps"], card=card)))
    res["seconds"] = time.perf_counter() - t_phase
    if res["seconds"] > API_BUDGET_S:
        say(f"api: {res['seconds']:.1f} s, past its {API_BUDGET_S:.0f} s "
            "budget")
    if fails:
        raise AssertionError("; ".join(fails))
    res["runs"] = [res["scored"], res["pool"]]
    return res


# ---------------------------------------------------------------------------
# The pandas-free statistics layer on the card's host (phase 22)
# ---------------------------------------------------------------------------

STATS_BUDGET_S = 40.0    # the vendor and lint legs' budgets included
#: ``power-analysis`` at its defaults (10,000 simulations): N(80%) a model
#: and the recommended N with its margin, analytic (normal quantiles), as
#: the JAX package's command prints them on the CPU
POWER_N80 = {"GPT": 122, "GEMINI": 44, "Claude": 38}
POWER_RECOMMENDED_N = 183
POWER_LIMITING_MODEL = "GPT"
#: sha256 of ``sample-statements --output``'s file (Python's ``random``
#: only): the JAX package's bytes (tests/test_torch_stats.py)
SAMPLE_STATEMENTS_SHA256 = (
    "f933ec8c959217fb2853d59073789df63e12fce3d814a581e296718d47ac53f4")
#: the texts of the similarity matrices: scenario 0's original and its 24
#: rephrasings of ``_perturbation_records(0)`` (whatever ``--seed``)
STATS_SCENARIO = 0
#: sha256 of each similarity matrix's float64 bytes over those texts: the
#: JAX package's on the CPU (tests/test_torch_stats.py)
SIMILARITY_SHA256 = {
    "bm25": "228be72ec375aa96cac4876eac62c5c9bc54486080473ae3fbcca341808204c9",
    "levenshtein":
        "2511fb2af344d6728ca4c34620a9f31b4cc725c0443b2f936128dbeddf7f4fa4",
}
#: (pairs, characters) of the native-against-plain Levenshtein check
STATS_PLAIN_PAIRS = (6, 240)


def _similarity_texts():
    rec = _perturbation_records(0)[STATS_SCENARIO]
    return [rec["original_main"]] + list(rec["rephrasings"])


def _matrix_digest(m):
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(
        m, dtype=np.float64).tobytes()).hexdigest()


#: the synthetic survey of phase 22: the study's 1,003 respondents over two
#: Qualtrics exports (the first half in survey 1), with a planted number of
#: each preregistered exclusion (disjoint sets); one respondent has no
#: duration, which drops out without counting as a speeder
SURVEY_RESPONDENTS = 1003
SURVEY_PLANTED = {"duration_excluded": 17, "identical_excluded": 9,
                  "attention_failed": 115}
SURVEY_NO_DURATION = 1
#: the demographics columns of the exports (``demographics-table``'s
#: defaults, and Age)
SURVEY_DEMOGRAPHICS = {
    "Sex": ["Female", "Male", "Prefer not to say"],
    "Ethnicity simplified": ["White", "Black", "Asian", "Mixed", "Other"],
    "Employment status": ["Full-Time", "Part-Time", "Unemployed (and job "
                          "seeking)", "Not in paid work (e.g. homemaker, "
                          "retired or disabled)", "Other"],
    "Student status": ["Yes", "No"],
}
SURVEY_STEM = ("Please answer each question with the slider.\n"
               "Left = No, Right = Yes")


def _survey_columns():
    """The substantive (Q{g}_{q}, q != 8) and attention (Q{g}_8) columns of
    one export, in file order."""
    return [f"Q{g}_{q}" for g in range(1, 6) for q in range(1, 12)]


def _survey_exports(seed, out_dir, n_respondents=SURVEY_RESPONDENTS,
                    questions=None, planted=None, no_duration=SURVEY_NO_DURATION):
    """Two Qualtrics exports written from ``seed`` (numpy only): header row
    0 the column ids, row 1 each column's text (``"<stem> - <question>"``,
    the stem quoting a line break and a comma), row 2 the ImportId row,
    then the respondents.  Export k holds questions[50k:50k+50] on its 50
    substantive columns (``config.ordinary_meaning_questions()`` by
    default, so the texts join run-100q's prompts exactly), an attention
    check in each group's ``_8`` (100 passes), a duration, and the
    demographics.  Every answer is an integer slider value: a question's
    centre plus a respondent's lean plus noise, one answer in 100 left
    blank.  Returns ``(paths, planted)``: the planted exclusion counts."""
    import csv

    import numpy as np

    from llm_interpretation_replication_tpu_torch.config import (
        ordinary_meaning_questions)

    questions = list(questions or ordinary_meaning_questions())
    planted = dict(planted or SURVEY_PLANTED)
    rng = np.random.default_rng(seed)
    n = n_respondents
    order = rng.permutation(n)
    cut = np.cumsum([planted["duration_excluded"], no_duration,
                     planted["identical_excluded"],
                     planted["attention_failed"]])
    speeders, no_dur, identical, failing = (
        np.isin(np.arange(n), order[a:b]) for a, b in zip([0, *cut[:-1]], cut))
    centres = rng.beta(2.0, 2.0, len(questions)) * 100
    lean = rng.normal(0.0, 12.0, n)
    durations = np.where(speeders, rng.integers(10, 60, n),
                         rng.integers(400, 2400, n))
    noise = rng.normal(0.0, 18.0, (n, 50))
    blank = (rng.random((n, 50)) < 0.01) & ~identical[:, None]
    flat = rng.integers(0, 101, n)
    bad_group = np.where(failing, rng.integers(1, 6, n), 0)
    bad_value = rng.integers(0, 96, n)
    ages = rng.integers(18, 80, n)
    picks = {c: rng.integers(0, len(choices), n)
             for c, choices in SURVEY_DEMOGRAPHICS.items()}
    per_file = [(n + 1) // 2, n // 2]
    sub_cols = [c for c in _survey_columns() if not c.endswith("_8")]
    cols = ["StartDate", "Duration (in seconds)", "Finished", "ResponseId",
            *_survey_columns(), "Age", *SURVEY_DEMOGRAPHICS]
    paths, start = [], 0
    os.makedirs(out_dir, exist_ok=True)
    for k, count in enumerate(per_file):
        text = dict(zip(sub_cols, questions[50 * k:50 * k + 50]))
        row1 = {"StartDate": "Start Date",
                "Duration (in seconds)": "Duration (in seconds)",
                "Finished": "Finished", "ResponseId": "Response ID",
                "Age": "What is your age?",
                **{c: f"{c}?" for c in SURVEY_DEMOGRAPHICS}}
        for c in _survey_columns():
            row1[c] = f"{SURVEY_STEM} - " + text.get(
                c, "Attention check: move the slider to 100.")
        rows = [cols, [row1[c] for c in cols],
                ['{"ImportId":"%s"}' % c for c in cols]]
        idx = np.arange(start, start + count)
        answers = np.clip(np.rint(centres[50 * k:50 * k + 50][None, :]
                                  + lean[idx, None] + noise[idx]), 0, 100)
        answers = np.where(identical[idx, None], flat[idx, None], answers)
        for r, i in enumerate(idx):
            row = {"StartDate": f"2024-03-{1 + i % 28:02d} 10:00:00",
                   "Duration (in seconds)": "" if no_dur[i]
                   else str(int(durations[i])),
                   "Finished": "True", "ResponseId": f"R_{seed}_{i:05d}",
                   "Age": "CONSENT_REVOKED" if i % 211 == 7 else str(ages[i])}
            for j, c in enumerate(sub_cols):
                row[c] = "" if blank[i, j] else str(int(answers[r, j]))
            for g in range(1, 6):
                row[f"Q{g}_8"] = str(int(bad_value[i])) if g == bad_group[i] \
                    else "100"
            for c, choices in SURVEY_DEMOGRAPHICS.items():
                row[c] = "" if i % 97 == 3 else choices[int(picks[c][i])]
            rows.append([row[c] for c in cols])
        start += count
        path = os.path.join(out_dir, f"word_meaning_survey_part_{k + 1}.csv")
        with open(path, "w", newline="", encoding="utf-8") as f:
            csv.writer(f, lineterminator="\n").writerows(rows)
        paths.append(path)
    return paths, planted


#: phase 22's bootstrap counts for ``analyze-survey``, ``model-comparison``
#: and ``cross-kappa`` (the CLI defaults are 1,000 and, for the
#: cross-prompt bootstrap, 100; at 1,003 respondents the difference CI's
#: 1,000 resamples of ~900,000 rater-pair correlations alone take ~13 s of
#: a host core, and each cross-prompt resample ~50 ms)
STATS_BOOTSTRAP = 20
STATS_CROSS_PROMPT_BOOTSTRAP = 5
#: sha256 of the survey-only numbers of phase 22 (``_survey_numbers``, floats
#: at 12 significant digits) at ``--seed 0``: the port's on the CPU, held
#: there to the JAX package's (tests/test_torch_survey.py)
SURVEY_SHA256 = (
    "f8cf5ba7a6a4f8e73fd3b745eda968159e6ea10f57448d24c1cb6b4fd967d17c")


def _survey_numbers(results, demographics_tex):
    """What phase 22 computes from the synthetic exports alone: the
    exclusion counts, the human per-item agreement and the human
    cross-prompt correlations (point estimates; their CIs depend on the
    bootstrap counts) of ``analyze-survey``'s ``results.json``, and
    ``demographics-table``'s LaTeX."""
    keep = {"human_agreement": ("overall_mean", "overall_std", "n_items"),
            "human_cross_prompt": ("mean_correlation", "std_correlation",
                                   "n_pairs")}
    out = {k: {f: results[k][f] for f in fields} for k, fields in keep.items()}
    out.update(exclusions=results["exclusions"],
               n_survey_questions=results["n_survey_questions"],
               demographics_tex=demographics_tex)
    return out


def _twelve_digits(obj):
    """Floats at 12 significant digits: the last bits of numpy's sums move
    between numpy versions (2.0 on the CPU, 2.3 on the card's host)."""
    if isinstance(obj, dict):
        return {k: _twelve_digits(v) for k, v in obj.items()}
    if isinstance(obj, float):
        return float(f"{obj:.12g}")
    return obj


def _survey_digest(numbers):
    import hashlib

    return hashlib.sha256(json.dumps(_twelve_digits(numbers),
                                     sort_keys=True).encode()).hexdigest()


def _plain_quality(rows):
    """model -> whether its relative probability, yes / (yes + no) with a
    NaN quotient at 0.5 (as the analysis commands load it, so none is
    NaN), passes the reference's gate (a spread, ddof 1, of at least 0.01
    when more than one value), computed with numpy alone."""
    import numpy as np

    out = {}
    for r in rows:
        out.setdefault(r["model"], []).append((r["yes_prob"], r["no_prob"]))
    for model, probs in out.items():
        yes, no = np.asarray(probs, dtype=float).T
        with np.errstate(divide="ignore", invalid="ignore"):
            v = yes / (yes + no)
        v[np.isnan(v)] = 0.5
        out[model] = bool(v.size < 2 or v.std(ddof=1) >= 0.01)
    return out


def _latex_rows(table):
    """The body rows of a ``tabular`` (the lines ending in ``\\\\`` but its
    header)."""
    body = table[table.index("\\begin{tabular}"):table.index("\\end{tabular}")]
    rows = [line for line in body.splitlines() if line.endswith("\\\\")]
    return rows[1:]


def _analysis_leg(workdir, run100q_csv, instruct_csv, seed):
    """The analysis commands on the card's host, through the port's CLI in
    this process: ``analyze-mae-100q --latex`` (Table 5), ``analyze-100q``,
    ``model-comparison --no-figures`` and ``cross-kappa`` on the run-100q
    CSV, ``analyze-survey`` on the run-instruct-sweep CSV, and
    ``demographics-table``, over two synthetic Qualtrics exports from
    ``seed``.  Returns (result, fails)."""
    import math

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch.survey import MODEL_FAMILIES
    from llm_interpretation_replication_tpu_torch.utils import frame

    fails, seconds = [], {}
    t = time.perf_counter()
    (s1, s2), planted = _survey_exports(seed, os.path.join(workdir, "survey"))
    seconds["survey_exports"] = time.perf_counter() - t
    out = os.path.join(workdir, "analysis")
    os.makedirs(out, exist_ok=True)

    def run(name, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        seconds[name] = time.perf_counter() - t0
        return buf.getvalue()

    def finite(*xs):
        return all(isinstance(x, (int, float)) and math.isfinite(x) for x in xs)

    models = frame.unique(frame.column(frame.read_csv(run100q_csv)[1], "model"))
    shared = [f for f, pair in MODEL_FAMILIES.items()
              if pair["base"] in models and pair["instruct"] in models]
    respondents = (SURVEY_RESPONDENTS - sum(planted.values())
                   - SURVEY_NO_DURATION)

    # Table 5
    mae_json = os.path.join(out, "mae_100q.json")
    printed = run("analyze_mae_100q", [
        "analyze-mae-100q", "--results", run100q_csv, "--survey1-csv", s1,
        "--survey2-csv", s2, "--latex", "--output-json", mae_json])
    with open(mae_json) as f:
        mae = json.load(f)
    end = "\\end{tabular}"
    table = printed[printed.index("\\begin{tabular}"):
                    printed.index(end) + len(end)]
    if mae["meta"]["respondents"] != respondents or \
            mae["meta"]["matched_prompts"] != 100 or \
            f"Respondents after exclusions: {respondents}" not in printed or \
            "Matched prompts: 100" not in printed:
        fails.append(f"analyze-mae-100q: {mae['meta']}")
    # a family is analysed unless one of its models fails the reference's
    # data-quality gate (a spread under 0.01 on random weights), checked
    # here on the CSV's probabilities with numpy alone
    plain = _plain_quality(frame.read_csv(run100q_csv)[1])
    families = {f: mae["families"].get(f, {}) for f in shared}
    expect_ok = {f: plain[MODEL_FAMILIES[f]["base"]] and
                 plain[MODEL_FAMILIES[f]["instruct"]] for f in shared}
    keys = ("base_mae", "instruct_mae", "observed_diff", "ci_lower",
            "ci_upper", "p_value")
    bad = [f for f, rec in families.items()
           if rec.get("excluded", True) == expect_ok[f]
           or (expect_ok[f] and not finite(*(rec.get(k) for k in keys)))]
    if not shared or bad or not any(expect_ok.values()):
        fails.append(f"analyze-mae-100q: families {bad} of {shared} "
                     f"(plain gate {expect_ok})")
    if len(_latex_rows(table)) != len(MODEL_FAMILIES):
        fails.append(f"analyze-mae-100q: {len(_latex_rows(table))} table rows")

    # the instruct - base bootstrap per family
    q_json = os.path.join(out, "100q.json")
    run("analyze_100q", ["analyze-100q", "--results", run100q_csv,
                         "--output-json", q_json])
    with open(q_json) as f:
        per_family = json.load(f)
    if not per_family or any(rec.get("skipped") or not finite(
            rec.get("ci_lower"), rec.get("ci_upper")) or rec.get("n") != 100
            for rec in per_family.values()):
        fails.append(f"analyze-100q: {per_family}")

    # inter-model correlations and agreement
    cmp_dir = os.path.join(out, "model_comparison")
    printed_cmp = run("model_comparison", [
        "model-comparison", "--results", run100q_csv, "--output-dir",
        cmp_dir, "--bootstrap", str(STATS_BOOTSTRAP), "--no-figures"])
    pairs = frame.read_csv(os.path.join(cmp_dir, "pairwise_correlations.csv"))[1]
    with open(os.path.join(cmp_dir, "correlation_summary.json")) as f:
        summary = json.load(f)
    n_models = len(models)
    if len(pairs) != n_models * (n_models - 1) // 2 or \
            not finite(summary["summary"]["mean"]):
        fails.append(f"model-comparison: {len(pairs)} pairs, "
                     f"{summary['summary']}")
    kappa_json = os.path.join(out, "kappa.json")
    run("cross_kappa", ["cross-kappa", "--results", run100q_csv,
                        "--bootstrap", str(STATS_BOOTSTRAP),
                        "--output-json", kappa_json])
    with open(kappa_json) as f:
        kappa = json.load(f)
    if kappa["n_frames"] != 1 or kappa["n_pairs"] != len(pairs) or \
            not finite(kappa["mean_kappa"]):
        fails.append(f"cross-kappa: {dict(kappa, pairs=len(kappa['pairs']))}")

    # the consolidated survey analysis
    survey_dir = os.path.join(out, "survey")
    run("analyze_survey", [
        "analyze-survey", "--survey1-csv", s1, "--survey2-csv", s2,
        "--llm-csv", instruct_csv, "--output-dir", survey_dir,
        "--bootstrap", str(STATS_BOOTSTRAP), "--cross-prompt-bootstrap",
        str(STATS_CROSS_PROMPT_BOOTSTRAP)])
    with open(os.path.join(survey_dir, "results.json")) as f:
        results = json.load(f)
    excl = results["exclusions"]
    if any(excl[k] != n for k, n in planted.items()) or \
            excl["final_count"] != respondents or results["n_matched"] != 100 \
            or not finite(results["human_cross_prompt"]["mean_correlation"]):
        fails.append(f"analyze-survey: exclusions {excl}, matched "
                     f"{results['n_matched']}")
    tex = os.path.join(out, "demographics.tex")
    run("demographics_table", ["demographics-table", "--csv", s1, "--csv", s2,
                               "--output", tex])
    with open(tex) as f:
        demographics = f.read()
    digest = _survey_digest(_survey_numbers(results, demographics))
    pinned = SURVEY_SHA256 if seed == 0 else None
    if pinned is not None and digest != pinned:
        fails.append(f"survey numbers: sha256 {digest}, pinned {pinned}")
    table5 = {f: {k: rec[k] for k in ("base_mae", "instruct_mae",
                                      "observed_diff", "ci_lower", "ci_upper",
                                      "p_value", "n", "excluded", "reason")
                  if k in rec}
              for f, rec in mae["families"].items()}
    res = dict(respondents=respondents, planted=planted, shared=shared,
               table5=table5, table5_tex=table, latex_rows=len(
                   _latex_rows(table)), per_family_100q=per_family,
               model_pairs=len(pairs), correlation_mean=summary["summary"][
                   "mean"], kappa=kappa["mean_kappa"], kappa_pairs=kappa[
                   "n_pairs"], survey=dict(
                   matched=results["n_matched"],
                   human_cross_prompt=results["human_cross_prompt"][
                       "mean_correlation"],
                   llm_cross_prompt=results["llm_cross_prompt"][
                       "mean_correlation"],
                   human_llm=(results["human_llm_correlation"] or {}).get(
                       "correlation")),
               survey_sha256=digest, survey_sha256_pinned=pinned,
               survey_numbers=_survey_numbers(results, demographics),
               plain_quality=plain, table5_analysed=expect_ok,
               survey_csvs=[s1, s2],
               seconds=seconds, model_comparison=printed_cmp.splitlines()[:3])
    return res, fails


VENDOR_EVAL_BUDGET_S = 10.0
VENDOR_IRRELEVANT_LIMIT = 60       # evaluations, split over the three vendors
VENDOR_REPLICATION_BOOTSTRAP = (200, 5)   # MAE, cross-prompt resamples
#: verify-replication's checks: Tables 3 and 4, the two appendix tables
#: and Table 5's row a family (an analysed family has two more)
VENDOR_CHECKS_FIXED = 5 + 6 + 3 + 3 + 3


class _FigureRecorder:
    """A stand-in for ``viz.figures`` on the card's host, which has no
    matplotlib: every figure call is recorded (its name) and returns its
    PNG path, drawing nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def figure(*args, **kwargs):
            self.calls.append(name)
            return next(a for a in [*args, *kwargs.values()]
                        if isinstance(a, str) and a.endswith(".png"))
        return figure


def _vendor_eval_leg(workdir, instruct_csv, run100q_csv, surveys, analysed,
                     corpus=None):
    """The three vendor-evaluation commands on the card's host, through the
    port's CLI in this process, over the scripted vendors (phase 21's
    ``_api_transport``; no socket), their pacing sleeps skipped:
    ``run-closed-source --yes`` over the run-instruct-sweep CSV and the
    synthetic exports ``surveys`` (the results CSV in the section 2.8
    columns, one row a question; finite MAEs; a second run asks nothing;
    ``tests/test_torch_vendor_eval.py`` holds the cache's partial and full
    re-runs); ``run-irrelevant --limit
    VENDOR_IRRELEVANT_LIMIT`` over phase 21's ``corpus`` (written by
    ``generate-irrelevant`` here when None; a finite consistency
    table; a rerun loads the saved results, and a ``--force-rerun --limit
    0`` resume from the triple checkpoint rewrites the same analysis, both
    asking nothing); ``verify-replication`` over a reference tree of these
    files under the reference's names and ``--results-100q`` (a verdict on
    every check, exit 1 exactly when its JSON counts a FAIL, the check
    count VENDOR_CHECKS_FIXED plus 2 a Table-5 family ``analysed``).  The
    card's host has no matplotlib: ``viz.figures`` is a
    :class:`_FigureRecorder` for the leg.  Returns (result, fails)."""
    import math

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch import api_backends as api
    from llm_interpretation_replication_tpu_torch.analysis.closed_source_eval \
        import RESULT_COLUMNS
    from llm_interpretation_replication_tpu_torch.analysis.replication import (
        TABLE5_FAMILIES)
    from llm_interpretation_replication_tpu_torch.api_backends import (
        anthropic_client, gemini_client, openai_client)
    from llm_interpretation_replication_tpu_torch.utils import frame

    fails, seconds, calls = [], {}, []
    s1, s2 = surveys
    figures = _FigureRecorder()
    fig_module = "llm_interpretation_replication_tpu_torch.viz.figures"
    saved = dict(sleep=time.sleep, figures=sys.modules.get(fig_module),
                 transports={m: m.UrllibTransport for m in (
                     openai_client, anthropic_client, gemini_client)})
    for mod, vendor in ((openai_client, "openai"),
                        (anthropic_client, "anthropic"),
                        (gemini_client, "gemini")):
        mod.UrllibTransport = functools.partial(
            lambda v: _api_transport(api, v, calls), vendor)
    for var in ("OPENAI_API_KEY", "ANTHROPIC_API_KEY", "GEMINI_API_KEY"):
        os.environ[var] = "scripted-key"
    sys.modules[fig_module] = figures
    time.sleep = lambda s: None

    def run(name, argv):
        asked = len(calls)
        t0 = time.perf_counter()
        code = 0
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            try:
                cli.main(argv)
            except SystemExit as exit_:
                code = exit_.code
        seconds[name] = time.perf_counter() - t0
        return code, buf.getvalue(), len(calls) - asked

    def finite(*xs):
        return all(isinstance(x, (int, float)) and math.isfinite(x) for x in xs)

    try:
        # the frontier-API evaluation (Tables 3-4's data leg)
        cs_dir = os.path.join(workdir, "closed_source")
        argv = ["run-closed-source", "--questions-csv", instruct_csv,
                "--survey2-csv", s2, "--survey1-csv", s1, "--output-dir",
                cs_dir, "--yes"]
        _, _, asked = run("run_closed_source", argv)
        results_csv = os.path.join(cs_dir, "closed_source_evaluation_results.csv")
        columns, rows = frame.read_csv(results_csv)
        with open(os.path.join(cs_dir, "human_comparisons.json")) as f:
            mae = json.load(f)["mae"]
        if columns != RESULT_COLUMNS or len(rows) != 100 or \
                len({r["question"] for r in rows}) != 100 or not asked:
            fails.append(f"run-closed-source: {len(rows)} rows, "
                         f"{len({r['question'] for r in rows})} questions, "
                         f"{asked} requests")
        if sorted(mae) != sorted(["GPT", "Gemini", "Claude", "Random",
                                  "Equanimity", "Normal"]) or not all(
                finite(m["mae"], m["ci_lower"], m["ci_upper"])
                for m in mae.values()):
            fails.append(f"run-closed-source: MAE records {mae}")
        _, _, again = run("run_closed_source_again", argv)
        if again:
            fails.append(f"run-closed-source rerun asked {again} requests")
        closed_source = dict(rows=len(rows), requests=asked,
                             mae={k: v["mae"] for k, v in mae.items()})

        # the irrelevant-insertion study
        irr_dir = os.path.join(workdir, "irrelevant")
        if corpus is None:
            corpus = os.path.join(workdir, "perturbations_irrelevant.json")
            run("generate_irrelevant", ["generate-irrelevant", "--output",
                                        corpus])
        argv = ["run-irrelevant", "--perturbations", corpus, "--output-dir",
                irr_dir, "--limit", str(VENDOR_IRRELEVANT_LIMIT)]
        _, _, asked = run("run_irrelevant", argv)
        _, summary = frame.read_csv(os.path.join(irr_dir, "summary.csv"))
        with open(os.path.join(irr_dir, "analysis.json"), "rb") as f:
            analysis = f.read()
        with open(os.path.join(irr_dir, "progress.json")) as f:
            done = json.load(f)["done"]
        if done != VENDOR_IRRELEVANT_LIMIT or \
                asked != 2 * VENDOR_IRRELEVANT_LIMIT or not summary or \
                not all(finite(r["consistency"]) for r in summary):
            fails.append(f"run-irrelevant: {done} evaluations, {asked} "
                         f"requests, consistency "
                         f"{[r['consistency'] for r in summary]}")
        _, printed, again = run("run_irrelevant_again", argv)
        _, _, resumed = run("run_irrelevant_resume", [
            *argv[:-2], "--force-rerun", "--limit", "0"])
        with open(os.path.join(irr_dir, "analysis.json"), "rb") as f:
            same = f.read() == analysis
        if again or resumed or "--force-rerun" not in printed or not same:
            fails.append(f"run-irrelevant reruns asked {again} and {resumed} "
                         f"requests; the resumed analysis equal: {same}")
        irrelevant = dict(evaluations=done, requests=asked,
                          consistency={f"{r['model']}/{r['scenario']}":
                                       r["consistency"] for r in summary})

        # the replication verifier over a reference tree of these files
        ref = os.path.join(workdir, "reference")
        links = {"data/word_meaning_survey_results.csv": s1,
                 "data/word_meaning_survey_results_part_2.csv": s2,
                 "data/instruct_model_comparison_results.csv": instruct_csv,
                 "data/instruct_model_comparison_results_combined.csv":
                     instruct_csv,
                 "results/closed_source_evaluation/"
                 "closed_source_evaluation_results.csv": results_csv}
        for rel, src in links.items():
            os.makedirs(os.path.dirname(os.path.join(ref, rel)), exist_ok=True)
            os.symlink(src, os.path.join(ref, rel))
        out_json = os.path.join(workdir, "replication.json")
        boot, cross = VENDOR_REPLICATION_BOOTSTRAP
        code, printed, _ = run("verify_replication", [
            "verify-replication", "--reference-root", ref, "--results-100q",
            run100q_csv, "--bootstrap", str(boot), "--cross-prompt-bootstrap",
            str(cross), "--output-json", out_json])
        with open(out_json) as f:
            result = json.load(f)
        want = VENDOR_CHECKS_FIXED + 2 * sum(
            bool(analysed.get(fam)) for fam in TABLE5_FAMILIES)
        verdicts = [c["verdict"] for c in result["checks"]]
        if any(v not in ("PASS", "FAIL", "SKIP") for v in verdicts) or \
                len(verdicts) != want or \
                code != (1 if result["n_fail"] else 0) or \
                f"{result['n_pass']} PASS, {result['n_fail']} FAIL" \
                not in printed:
            fails.append(f"verify-replication: exit {code}, {len(verdicts)} "
                         f"checks (want {want}), {result['n_fail']} FAIL")
        replication = dict(exit=code, checks=len(verdicts),
                           n_pass=result["n_pass"], n_fail=result["n_fail"],
                           n_skip=result["n_skip"],
                           report=[line for line in printed.splitlines()
                                   if " PASS, " in line])
    finally:
        time.sleep = saved["sleep"]
        for mod, transport in saved["transports"].items():
            mod.UrllibTransport = transport
        if saved["figures"] is None:
            sys.modules.pop(fig_module, None)
        else:
            sys.modules[fig_module] = saved["figures"]
    seconds["total"] = sum(seconds.values())
    return dict(closed_source=closed_source, irrelevant=irrelevant,
                replication=replication, figures=sorted(set(figures.calls)),
                seconds=seconds), fails


LINT_BUDGET_S = 10.0
#: the linter's two commands, each run as a user runs it
LINT_COMMANDS = {"lint": ["lint", "--format", "json"],
                 "contracts": ["lint", "contracts", "--format", "json"]}


def _lint_leg():
    """The port's linter over the smoke's own tree, from the card's host:
    ``python -m llm_interpretation_replication_tpu_torch lint`` (the
    package and this script against ``lint_baseline_torch.json``) and
    ``... lint contracts``, both at once, each in a process of its own.
    Both must exit 0 with no new finding, no stale or rotten baseline
    entry and no contract drift.  Returns (result, fails): the leg's and
    each command's seconds, the files linted, the inline suppressions in
    them (``# graftlint: disable=``) and the baselined findings."""
    import threading

    from llm_interpretation_replication_tpu_torch.lint import cli as lint_cli
    from llm_interpretation_replication_tpu_torch.lint.report import (
        parse_suppressions)

    here = os.path.dirname(os.path.abspath(__file__))
    done = {}

    def run(name):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "llm_interpretation_replication_tpu_torch",
             *LINT_COMMANDS[name]], cwd=here, capture_output=True, text=True,
            timeout=120)
        done[name] = (proc, time.perf_counter() - t)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(name,))
               for name in LINT_COMMANDS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = dict(total=time.perf_counter() - t0,
                   **{name: done[name][1] for name in LINT_COMMANDS})
    fails, docs = [], {}
    for name in LINT_COMMANDS:
        proc = done[name][0]
        try:
            docs[name] = json.loads(proc.stdout)
        except ValueError:
            docs[name] = None
        if proc.returncode or docs[name] is None:
            fails.append(f"{name}: exit {proc.returncode}: "
                         f"{(proc.stdout + proc.stderr)[-1500:]}")
    lint_doc = docs["lint"] or {}
    for key in ("findings", "stale_baseline", "rotten_baseline"):
        if lint_doc.get(key):
            fails.append(f"lint: {key} {lint_doc[key]}")
    if (docs["contracts"] or {}).get("drift"):
        fails.append(f"contracts: {docs['contracts']['drift']}")
    files = lint_cli.iter_python_files(lint_cli.default_paths())
    # every source of the package and this script: a walker that skipped
    # some would pass the gate on fewer files
    package = os.path.join(here, "llm_interpretation_replication_tpu_torch")
    sources = 1 + sum(f.endswith(".py") for _, _, names in os.walk(package)
                      for f in names)
    if len(files) != sources:
        fails.append(f"lint: {len(files)} files linted of {sources}")
    suppressions = 0
    for path in files:
        with open(path, encoding="utf-8") as f:
            suppressions += sum(map(len, parse_suppressions(
                f.read().splitlines()).values()))
    return dict(seconds=seconds, files=len(files),
                suppressions=suppressions,
                baselined=lint_doc.get("baselined")), fails


def _stats_host_child(workdir, run100q_csv=None, instruct_csv=None, seed=0,
                      launched=None, corpus=None):
    """The statistics layer on the card's host, in a process of its own:
    the native Levenshtein built and loaded (``using_native()``), held
    against the plain version on STATS_PLAIN_PAIRS pairs; the BM25 and
    Levenshtein similarity matrices over ``_similarity_texts()``;
    ``power-analysis`` at its defaults and ``sample-statements`` through
    the port's CLI; then, given the run-100q and run-instruct-sweep CSVs,
    the analysis commands over them and a synthetic survey from ``seed``
    (:func:`_analysis_leg`), then the vendor-evaluation commands over the
    same files and the irrelevant-insertion ``corpus`` (phase 21's; written
    here when None) (:func:`_vendor_eval_leg`); last, the port's linter
    over this tree (:func:`_lint_leg`).  Prints one JSON line; the process
    must end without a CUDA context and without pandas, matplotlib,
    sklearn, sentence-transformers or JAX.  ``launched`` (the parent's
    ``time.time()`` at the launch) times the process's start and
    imports."""
    entered = time.time()
    import hashlib

    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch import native
    from llm_interpretation_replication_tpu_torch.stats import (
        bm25_similarity_matrix, levenshtein_similarity_matrix)

    t0 = time.perf_counter()
    fails, seconds = [], {"imports": time.time() - entered}
    if launched is not None:
        seconds["start"] = entered - launched

    t = time.perf_counter()
    built = native.using_native()
    seconds["native_build"] = time.perf_counter() - t
    texts = _similarity_texts()
    n_pairs, width = STATS_PLAIN_PAIRS
    pairs = [(texts[i][:width], texts[-1 - i][:width]) for i in range(n_pairs)]
    plain = [native._levenshtein_py(a, b) for a, b in pairs]
    got = [native.levenshtein(a, b) for a, b in pairs]
    if got != plain:
        fails.append(f"levenshtein: native {got}, plain {plain}")
    matrices = {}
    for name, fn in (("bm25", bm25_similarity_matrix),
                     ("levenshtein", levenshtein_similarity_matrix)):
        t = time.perf_counter()
        m = fn(texts)
        seconds[name] = time.perf_counter() - t
        matrices[name] = dict(shape=list(m.shape), digest=_matrix_digest(m),
                              min=float(m.min()), mean=float(m.mean()))
        # BM25 scores go negative where a term is in most texts (rank_bm25's
        # idf floor), so only the Levenshtein matrix lies in [0, 1]
        if m.shape != (len(texts), len(texts)) or not np.isfinite(m).all() \
                or not np.array_equal(m, m.T) or (name == "levenshtein" and (
                    m.min() < 0 or not (np.diag(m) == 1).all())):
            fails.append(f"{name} matrix: {matrices[name]}")
        if matrices[name]["digest"] != SIMILARITY_SHA256[name]:
            fails.append(f"{name} matrix digest {matrices[name]['digest']}, "
                         f"pinned {SIMILARITY_SHA256[name]}")

    out_dir = tempfile.mkdtemp(prefix="power_", dir=workdir)
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["power-analysis", "--output-dir", out_dir])
    seconds["power_analysis"] = time.perf_counter() - t
    printed = buf.getvalue()
    n80 = {m: int(n) for m, n in re.findall(
        r"^(\S+): effect d=[0-9.]+, power@N=\d+ [0-9.]+, N\(80%\)=(\d+)$",
        printed, re.M)}
    rec = re.search(r"^recommendation \(80% power\): N=(\d+) \(limiting "
                    r"model: (\S+)\)$", printed, re.M)
    power = dict(n80=n80, recommended=int(rec.group(1)) if rec else None,
                 limiting=rec.group(2) if rec else None,
                 achieved=dict(re.findall(r"^(\S+): .* power@N=\d+ ([0-9.]+)",
                                          printed, re.M)))
    with open(os.path.join(out_dir, "power_analysis_report.tex")) as f:
        tex = f.read()
    if n80 != POWER_N80 or power["recommended"] != POWER_RECOMMENDED_N \
            or power["limiting"] != POWER_LIMITING_MODEL \
            or not all(f"\n{m} & " in tex for m in POWER_N80):
        fails.append(f"power-analysis: {power}")

    t = time.perf_counter()
    sample = os.path.join(workdir, "statements_sample.tex")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["sample-statements", "--output", sample])
    seconds["sample_statements"] = time.perf_counter() - t
    with open(sample, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != SAMPLE_STATEMENTS_SHA256:
        fails.append(f"sample-statements: sha256 {digest}")
    analysis = vendor = None
    if run100q_csv:
        t = time.perf_counter()
        analysis, analysis_fails = _analysis_leg(workdir, run100q_csv,
                                                 instruct_csv, seed)
        seconds["analysis"] = time.perf_counter() - t
        fails += analysis_fails
        t = time.perf_counter()
        vendor, vendor_fails = _vendor_eval_leg(
            workdir, instruct_csv, run100q_csv, analysis["survey_csvs"],
            analysis["table5_analysed"], corpus)
        seconds["vendor_eval"] = time.perf_counter() - t
        fails += vendor_fails
    lint, lint_fails = _lint_leg()
    seconds["lint"] = lint["seconds"]["total"]
    fails += lint_fails
    print(json.dumps(dict(
        using_native=built, native_plain_pairs=len(pairs), texts=len(texts),
        matrices=matrices, power=power, sample_statements_sha256=digest,
        analysis=analysis, vendor_eval=vendor, lint=lint, seconds=seconds,
        fails=fails,
        cuda_initialized=torch.cuda.is_initialized(),
        imported=sorted(m for m in sys.modules if m.split(".")[0] in (
            "pandas", "matplotlib", "sklearn", "sentence_transformers", "jax",
            "jaxlib", "llm_interpretation_replication_tpu")),
        total_s=time.perf_counter() - t0)))


def stats_phase(seed, workdir, card):
    """Phase 22: :func:`_stats_host_child` in a child process, in a
    directory of its own under ``workdir``, over the run-100q and
    run-instruct-sweep phases' CSVs there; its JSON line, checked, and
    Table 5 printed."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke._stats_host_child(sys.argv[2], sys.argv[3], "
            "sys.argv[4], int(sys.argv[5]), float(sys.argv[6]), sys.argv[7])")
    own = tempfile.mkdtemp(prefix="stats_", dir=workdir)
    sweeps = [os.path.join(workdir, "run100q",
                           "base_vs_instruct_100q_results.csv"),
              os.path.join(workdir, "instruct",
                           "instruct_model_comparison_results.csv")]
    t0 = time.perf_counter()
    corpus = os.path.join(workdir, "perturbations_irrelevant.json")
    proc = subprocess.run([sys.executable, "-c", code, here, own, *sweeps,
                           str(seed), repr(time.time()), corpus],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise AssertionError(f"stats phase exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res.update(seconds_with_start=time.perf_counter() - t0, card=card)
    table5 = res["analysis"].pop("table5_tex")
    say("stats", json.dumps(res))
    say("stats: Table 5 from run-100q's CSV and the synthetic survey "
        f"({res['analysis']['respondents']} respondents after exclusions)")
    for line in table5.splitlines():
        say(line)
    fails = list(res["fails"])
    if not res["using_native"]:
        fails.append("the native Levenshtein did not load")
    if res["cuda_initialized"]:
        fails.append("the statistics layer created a CUDA context")
    if res["imported"]:
        fails.append(f"the statistics layer imported {res['imported']}")
    if res["seconds_with_start"] > STATS_BUDGET_S:
        fails.append(f"stats: {res['seconds_with_start']:.1f} s, past its "
                     f"{STATS_BUDGET_S:.0f} s budget")
    vendor_s = res["vendor_eval"]["seconds"]["total"]
    if vendor_s > VENDOR_EVAL_BUDGET_S:
        fails.append(f"vendor leg: {vendor_s:.1f} s, past its "
                     f"{VENDOR_EVAL_BUDGET_S:.0f} s budget")
    lint = res["lint"]
    say(f"stats: lint leg {lint['seconds']['total']:.2f} s of its "
        f"{LINT_BUDGET_S:.0f} s (lint {lint['seconds']['lint']:.2f} s, "
        f"contracts {lint['seconds']['contracts']:.2f} s, at once): "
        f"{lint['files']} files linted, {lint['suppressions']} inline "
        f"suppressions, {lint['baselined']} baselined, 0 new findings, "
        f"0 drifts")
    if lint["seconds"]["total"] > LINT_BUDGET_S:
        fails.append(f"lint leg: {lint['seconds']['total']:.1f} s, past its "
                     f"{LINT_BUDGET_S:.0f} s budget")
    if fails:
        raise AssertionError("stats: " + "; ".join(fails))
    return res


def kernels_line(rows, launches, wide):
    """The ``{"kernels": [...]}`` entries: each kernel of KERNELS over all
    its rows (its times those of the Falcon-7B causal row), then each
    kernel's head-dim-WIDE_HEAD_DIM instance over its rows at that head
    dim (its times GPT-J-6B's causal row).  ``launches`` and ``wide`` map
    each kernel to its main-path launches, all and at that head dim."""
    kernels = []
    for entry in ("all", "wide"):
        for name, source, line, _, _ in KERNELS:
            mine = [r for r in rows if r["kernel"] == name
                    and (entry == "all" or r.get("D") == WIDE_HEAD_DIM)]
            main_row = next(r for r in mine if r["causal"] and r.get(
                "shape") == ("falcon-7b" if entry == "all" else "gpt-j-6b"))
            kernels.append(dict(
                name=name if entry == "all" else f"{name}[D={WIDE_HEAD_DIM}]",
                route="cuda",
                source=f"llm_interpretation_replication_tpu_torch/ops/csrc/{source}.cu",
                replaces=f"llm_interpretation_replication_tpu/ops/attention.py:{line}",
                launches=launches[name] if entry == "all" else wide[name],
                max_abs_err=max(r["max_abs_err"] for r in mine),
                ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                library_ms=main_row["library_ms"]))
    return kernels


PLAN_BUDGET_S = 55.0
#: the plan phase's searched run: Falcon-7B at full width and depth, w8a8
#: weights on the causal kernel's route, the full-study row
PLAN_QUANT, PLAN_IMPL = "int8", "flash"


def _plan_point(kind, cfg, batch, seq, before, *, quant="none", kv="bf16",
                chunk=0, depth=2, packing=1, decode_k=1, pooled=False,
                repack=True, suffix=64, weights_in_run=False):
    """What the budget model needs to price one recorded peak: the
    workload (``kind``: "binary", "full", "packed" or "prefill"), the
    geometry at the depth the run ran, batch, bucket, quant, KV dtype,
    chunk, pipeline depth, packing, decode block, the pooled confidence
    decode, the suffix length, and the bytes allocated when the peak was
    reset (``before``).  ``weights_in_run``: the weights were allocated
    inside the measured run (a CLI run loading its snapshot)."""
    return dict(kind=kind, geometry={f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(cfg)},
                batch=batch, seq=seq, quant=quant, kv_dtype=kv, chunk=chunk,
                pipeline_depth=depth, packing=packing, decode_k=decode_k,
                pooled=pooled, repack=repack, suffix=suffix,
                memory_before_bytes=before, weights_in_run=weights_in_run)


def _bucket(length):
    """The engine's bucket for a prompt of ``length`` tokens."""
    from llm_interpretation_replication_tpu_torch.runtime import batching

    return batching.bucket_for(length)


def _plan_need(point):
    """(need bytes, terms) the budget model gives a recorded point (the
    module's own coefficients)."""
    from llm_interpretation_replication_tpu_torch.models.config import (
        DecoderConfig)
    from llm_interpretation_replication_tpu_torch.runtime import plan
    from llm_interpretation_replication_tpu_torch.runtime import plan_search

    cfg = DecoderConfig(**point["geometry"])
    b, s, q = point["batch"], point["seq"], point["quant"]
    impl = "flash" if cfg.use_flash_attention(s) else "xla"
    wb = plan.weight_bytes(cfg, q)
    kind, depth = point["kind"], point["pipeline_depth"]
    if kind == "binary":
        terms = plan_search.binary_need_terms(cfg, wb, b, s, depth, impl,
                                              quant=q)
    elif kind == "full":
        terms = plan.full_study_need_terms(
            cfg, wb, impl, b, s, pipeline_depth=depth,
            kv_dtype=point["kv_dtype"], prefill_chunk=point["chunk"],
            pooled_confidence=point["pooled"], slot_repack=point["repack"],
            decode_k=point["decode_k"], quant=q, suffix_len=point["suffix"])
    elif kind == "packed":
        terms = plan.packed_need_terms(cfg, wb, impl, b, s, point["packing"],
                                       depth, quant=q)
    else:                  # one prompt forward and its cache (and a copy)
        terms = {"weights": wb,
                 "attn": plan.prefill_attention_bytes(cfg, impl, b, s,
                                                      point["chunk"]),
                 "act": plan.activation_bytes(cfg, b, s, point["chunk"], q),
                 "completions": 2 * plan.kv_cache_bytes(cfg, b, s,
                                                        point["kv_dtype"])}
    if point["weights_in_run"]:       # the run loaded its snapshot
        load = plan.load_excess_bytes(cfg, q, terms)
        if load:
            terms["load"] = load
    return sum(terms.values()), terms


def _recorded_points(results, path="", out=None):
    """Every (path, run) under ``results`` that recorded a peak, each run
    once (a phase may list a run twice)."""
    out = {} if out is None else out
    if isinstance(results, dict):
        if "peak_memory_bytes" in results and "calls" not in results:
            out.setdefault(id(results), (path, results))
        for k, v in results.items():
            if k != "plan_point":
                _recorded_points(v, f"{path}/{k}", out)
    elif isinstance(results, (list, tuple)):
        for i, v in enumerate(results):
            _recorded_points(v, f"{path}[{i}]", out)
    return list(out.values())


def plan_memory_check(results):
    """(b): at every recorded operating point, the budget model's need
    against the measured peak.  The measured need is the peak above what
    was allocated when the peak was reset; the predicted one is the
    model's live set beyond the weights (which were allocated before),
    or its whole need where the run loaded its own weights.  Returns
    (rows, failures)."""
    rows, fails = [], []
    for path, run in _recorded_points(results):
        point = run.get("plan_point")
        if point is None:       # T5: the model prices decoders only
            rows.append(dict(point=path, kind="unpriced",
                             model=run.get("model")))
            if run.get("route") != "t5":
                fails.append(f"plan {path}: a peak without its plan point")
            continue
        need, terms = _plan_need(point)
        measured = run["peak_memory_bytes"] - point["memory_before_bytes"]
        predicted = need if point["weights_in_run"] else \
            need - terms["weights"]
        row = dict(point=path, kind=point["kind"],
                   layers=point["geometry"]["num_layers"],
                   hidden=point["geometry"]["hidden_size"],
                   batch=point["batch"], seq=point["seq"],
                   quant=point["quant"], kv_dtype=point["kv_dtype"],
                   chunk=point["chunk"], predicted_bytes=predicted,
                   measured_bytes=measured,
                   ratio=predicted / max(1, measured))
        rows.append(row)
        if predicted < measured:
            fails.append(f"plan {path}: predicted {predicted} bytes < "
                         f"measured {measured}")
    return rows, fails


def _plan_searched_run(seed, attention, workdir, card, chosen):
    """(c): ``run-perturbation --plan-search`` on a Falcon-7B snapshot at
    full width and depth (random bf16 weights from ``seed``, loaded as
    w8a8) on the causal kernel's route, over one batch (the chosen batch)
    of the irrelevant-insertion corpus's rows as the legal scenarios'
    rephrasings.  Returns the run's record (peak, the need the model
    predicts for the chosen plan, OOM steps, launches and prefills)."""
    import torch

    from llm_interpretation_replication_tpu_torch import __main__ as cli
    from llm_interpretation_replication_tpu_torch.config import (
        irrelevant_scenarios, irrelevant_statements, legal_scenarios)
    from llm_interpretation_replication_tpu_torch.gen.irrelevant import (
        generate_perturbations)
    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.models import decoder

    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl=PLAN_IMPL)
    corpus = generate_perturbations(irrelevant_scenarios(),
                                    irrelevant_statements())
    per = -(-chosen["batch"] // len(corpus))
    records = [dict(s, rephrasings=[p["perturbed_text"] for p in
                                    c["perturbations_with_irrelevant"][:per]])
               for s, c in zip(legal_scenarios(), corpus)]
    extra = sum(len(r["rephrasings"]) for r in records) - chosen["batch"]
    records[-1]["rephrasings"] = records[-1]["rephrasings"][:per - extra]
    pert = os.path.join(workdir, "plan_perturbations.json")
    with open(pert, "w", encoding="utf-8") as f:
        json.dump(records, f)
    snap = os.path.join(workdir, "falcon-7b-plan")
    os.makedirs(snap)
    texts = [s[k] for s in records for k in ("original_main",
                                              "response_format",
                                              "confidence_format")]
    texts += list(irrelevant_statements())
    texts += [" " + t for s in records for t in s["target_tokens"]]
    t0 = time.perf_counter()
    _write_tokenizer_files(snap, _format_tokenizer_files("falcon", texts))
    with open(os.path.join(snap, "config.json"), "w", encoding="utf-8") as f:
        json.dump(_falcon_config_json(cfg), f)
    weights = convert.random_params(cfg, seed=seed + 5, device="cuda",
                                    dtype="bf16")
    _write_safetensors(os.path.join(snap, "model.safetensors"),
                       _falcon_state_dict(weights.tree(), cfg))
    del weights
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    snapshot_s = time.perf_counter() - t0

    # every prompt forward (the sweep's prefills, the K-head distillation's
    # greedy prefill and teacher-forced pass) runs the model's trunk once
    engines, forwards = [], [0]
    real_factory, real_trunk = cli._engine_factory, decoder._trunk

    def factory(rc):
        make = real_factory(rc)

        def build(name):
            engines.append(make(name))
            return engines[-1]
        return build

    def counted_trunk(*args, **kwargs):
        forwards[0] += 1
        return real_trunk(*args, **kwargs)

    out = os.path.join(workdir, "plan_run")
    stdout, stderr = io.StringIO(), io.StringIO()
    cli._engine_factory, decoder._trunk = factory, counted_trunk
    try:
        _reset_launches(attention)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            cli.main(["run-perturbation", "--model", snap, "--perturbations",
                      pert, "--quant", PLAN_QUANT, "--attention-impl",
                      PLAN_IMPL, "--plan-search", "--output-dir", out])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        cli._engine_factory, decoder._trunk = real_factory, real_trunk
    eng = engines[0]
    err = stderr.getvalue()
    launches = _launches(attention)["causal_grouped_attention"]
    log_plan = [x for x in err.splitlines() + stdout.getvalue().splitlines()
                if "plan search chose" in x]
    return dict(snapshot_seconds=snapshot_s, run_seconds=run_s,
                rows=chosen["batch"], peak_memory_bytes=peak,
                memory_before_bytes=before,
                fault_events=[str(e) for e in eng.fault_events],
                oom_steps=sum("oom" in str(e).lower()
                              for e in eng.fault_events),
                plan_decision=eng.plan_decision, plan_lines=log_plan,
                batch_size=eng.ecfg.batch_size, kv_dtype=eng.ecfg.kv_dtype,
                prefill_chunk=eng.ecfg.prefill_chunk,
                decode_k=eng.ecfg.decode_k, kernel_launches=launches,
                forwards=forwards[0], layers=cfg.num_layers, card=card)


def plan_run_fails(run, chosen):
    """The searched run's gates: no OOM step, the measured peak within the
    predicted need and the need within the card's memory, the engine on
    the chosen plan with its ``[plan]`` decision logged, and the causal
    kernel launched once a layer a prompt forward."""
    fails = []
    if run["oom_steps"]:
        fails.append(f"plan searched run: {run['oom_steps']} OOM steps")
    if not run["measured_bytes"] <= run["predicted_need_bytes"] \
            <= run["hbm_bytes"]:
        fails.append(f"plan searched run: measured {run['measured_bytes']}, "
                     f"predicted {run['predicted_need_bytes']}, card "
                     f"{run['hbm_bytes']}")
    if (run["batch_size"], run["kv_dtype"], run["prefill_chunk"],
            run["decode_k"]) != (chosen["batch"], chosen["kv_dtype"],
                                 chosen["prefill_chunk"], chosen["decode_k"]) \
            or not run["plan_lines"]:
        fails.append(f"plan searched run: ran batch {run['batch_size']} kv "
                     f"{run['kv_dtype']} chunk {run['prefill_chunk']} "
                     f"decode-k {run['decode_k']}, chosen {chosen}")
    if not run["forwards"] or \
            run["kernel_launches"] != run["layers"] * run["forwards"]:
        fails.append(f"plan searched run: {run['kernel_launches']} causal "
                     f"launches for {run['forwards']} prompt forwards")
    return fails


def plan_phase(seed, attention, workdir, card, results):
    """The plan model on the card (after every other phase, nothing of
    theirs resident; budget PLAN_BUDGET_S): (a) ``plan search`` prints the
    ranked table for Falcon-7B, w8a8, the full-study row, on the kernel
    route, at the card's own memory; (b) at every operating point the
    other phases recorded a peak (``plan_point``; T5 has none: the model
    prices decoders), the model's need is at least the measured peak; (c)
    ``run-perturbation --plan-search`` runs the chosen plan on Falcon-7B at
    full width and depth over one batch of corpus rows: no OOM step, the
    measured peak within the predicted need, the need within the card's
    memory, the causal kernel launched once a layer a prompt forward."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.runtime import plan
    from llm_interpretation_replication_tpu_torch.runtime import plan_search

    t_phase = time.perf_counter()
    fails, res = [], {}
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        code = plan_search.main(["search", "--model", "falcon-7b", "--quant",
                                 PLAN_QUANT, "--workload", "full",
                                 "--attention-impl", PLAN_IMPL])
    say(table.getvalue().rstrip())
    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY)
    ranked = plan_search.search_plans(cfg, PLAN_QUANT, 1, workload="full",
                                      attention_impl=PLAN_IMPL,
                                      slot_repack=True)
    best = plan_search.chosen_plan(ranked)
    memory = plan.device_memory_bytes()
    res["search"] = dict(exit=code, hbm_bytes=memory, card=card,
                         chosen=best and best.as_record())
    if code != 0 or best is None or "chosen" not in table.getvalue():
        raise AssertionError(f"plan search: exit {code}, chosen {best}")

    res["points"], point_fails = plan_memory_check(results)
    fails += point_fails
    for row in res["points"]:
        say("plan point", json.dumps(row))
    ratios = [r["ratio"] for r in res["points"] if "ratio" in r]
    say("plan points", json.dumps(dict(
        n=len(ratios), min_ratio=min(ratios, default=None),
        max_ratio=max(ratios, default=None), card=card)))

    run = _plan_searched_run(seed, attention, workdir, card,
                             best.as_record())
    need = best.need_bytes      # the chosen plan's, its load included
    measured = run["peak_memory_bytes"] - run["memory_before_bytes"]
    run.update(predicted_need_bytes=need, measured_bytes=measured,
               ratio=need / max(1, measured), hbm_bytes=memory,
               predicted_rows_per_s=best.predicted_rows_per_s,
               measured_rows_per_s=run["rows"] / run["run_seconds"])
    res["searched_run"] = run
    say("plan searched run", json.dumps(run))
    fails += plan_run_fails(run, best.as_record())
    res["seconds"] = time.perf_counter() - t_phase
    if res["seconds"] > PLAN_BUDGET_S:
        fails.append(f"plan: {res['seconds']:.1f} s, past its "
                     f"{PLAN_BUDGET_S:.0f} s budget")
    if fails:
        raise AssertionError("plan: " + "; ".join(fails[:10]))
    return res


TRAIN_BUDGET_S = 45.0
#: phase 26's budget: (a) and (b) took 12-24 s of 45; (c)-(g) take their
#: predicted share of at most 35 s more
MESH_BUDGET_S = 80.0
#: phase 26: one batch of the slice's prompts; (b)'s w8a8 class is the CPU
#: tests' (tests/test_torch_engine.W8A8_RTOL)
MESH_PROMPTS, MESH_W8A8_RTOL = 32, 2e-2
#: (c): the prompts of the MESH_SERVE_BUCKETS buckets that hold the most of
#: them, through a leader's scheduler that launches micro-batches of
#: MESH_SERVE_BATCH rows, so that the rest of a bucket meets the ring's
#: free lanes mid-decode (requests of two buckets never share a launch)
MESH_SERVE_BUCKETS, MESH_SERVE_BATCH = 3, 2
#: (c) and (f): the slot ring's lanes and the engine's batch, a
#: micro-batch and one admission's worth (a ring decodes every lane at
#: each step, and a prefill pads its rows to the batch)
MESH_SERVE_RING = 2 * MESH_SERVE_BATCH
#: (e): the prompts (the first of the slice's; the engine's batch) and the
#: completion tokens the K path decodes (one chunk)
MESH_K_PROMPTS, MESH_K_TOKENS = 8, 10
#: (g): one MoE layer at Mixtral-8x7B's published widths
#: (mistralai/Mixtral-8x7B-v0.1 config.json: hidden_size 4096,
#: intermediate_size 14336, num_local_experts 8, num_experts_per_tok 2)
MOE_HIDDEN, MOE_FFN, MOE_EXPERTS, MOE_TOP_K, MOE_TOKENS = (4096, 14336, 8, 2,
                                                           1024)
#: (g)'s tolerance: the dense path runs its experts in bf16, the sharded
#: one in float32 (the reference's), so they part by bf16 rounding: the
#: largest difference over the largest dense value; the aux losses part by
#: float32 reduction order only
MOE_RTOL, MOE_AUX_RTOL = 2e-2, 1e-5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 4
#: (c): the card against the CPU, float32, at FAMILY_LAYERS of Falcon-7B
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_STEPS = 2, 64, 2
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL_L2 = 1e-4
TRAIN_MICROBATCHES = 2
#: (f): ring and Ulysses at seq 1 on Falcon-7B's q/k/v, against dense
SEQ_PARALLEL_SHAPE = (2, 448, 71, 64)      # B, S, N, D
SEQ_PARALLEL_ATOL = 1e-5


@functools.lru_cache(maxsize=1)
def _train_corpus():
    """The irrelevant-insertion corpus and a ``WordTokenizer`` of its
    words."""
    from llm_interpretation_replication_tpu_torch.config import (
        irrelevant_scenarios, irrelevant_statements)
    from llm_interpretation_replication_tpu_torch.gen.irrelevant import (
        generate_perturbations)

    corpus = generate_perturbations(irrelevant_scenarios(),
                                    irrelevant_statements())
    return corpus, _corpus_tokenizer(corpus)


def _train_batch(rows, seq, device):
    """``rows`` texts of the irrelevant-insertion corpus (round robin over
    its scenarios) under a ``WordTokenizer`` of its words, each cut to
    ``seq`` tokens and right-padded to ``seq``: (ids, mask, vocab)."""
    import torch

    corpus, tok = _train_corpus()
    texts = [p["perturbed_text"] for i in range(rows) for p in
             [corpus[i % len(corpus)]["perturbations_with_irrelevant"]
              [i // len(corpus)]]]
    ids = torch.zeros((rows, seq), dtype=torch.long)
    mask = torch.zeros((rows, seq), dtype=torch.int32)
    for i, text in enumerate(texts):
        row = tok.encode(text)[:seq]
        ids[i, :len(row)] = torch.as_tensor(row)
        mask[i, :len(row)] = 1
    return ids.to(device), mask.to(device), len(tok)


def _grad_check(grads, params):
    """What (b)'s gate reads of step 2's gradient: leaves without one
    (missing, or zero everywhere) and leaves with a non-finite entry."""
    from llm_interpretation_replication_tpu_torch.runtime import train

    got = dict(train._flatten(grads))
    missing, nonfinite = [], []
    for path, _ in train._flatten(params):
        g = got.get(path)
        name = "/".join(path)
        if g is None or not bool(g.any()):
            missing.append(name)
        elif not bool(g.isfinite().all()):
            nonfinite.append(name)
    return missing, nonfinite


def train_run_fails(res):
    """The train phase's gates: (b) step 1 leaves every parameter
    bit-equal, every loss is finite, loss 4 is below loss 2, step 2's
    gradient reaches every leaf, finite, with a global norm above 0; (c)
    the card's losses and step-1 gradient agree with the CPU's; (d) the
    kernel under grad raises; (e) the pipelined forward launches the
    causal kernel a layer a microbatch and stays within the forced-route
    tolerance; (f) ring and Ulysses agree with dense attention; the
    budget."""
    fails = []
    b = res["falcon_7b"]
    if b["step1_changed"]:
        fails.append(f"train: step 1 (lr 0) changed {b['step1_changed']}")
    if not all(math.isfinite(x) for x in b["losses"]):
        fails.append(f"train: losses {b['losses']}")
    elif not b["losses"][3] < b["losses"][1]:
        fails.append(f"train: loss 4 {b['losses'][3]} not below loss 2 "
                     f"{b['losses'][1]}")
    if b["step2_missing"] or b["step2_nonfinite"] or \
            not b["step2_norm"] > 0:
        fails.append(f"train: step 2 gradient: no gradient "
                     f"{b['step2_missing'][:3]}, non-finite "
                     f"{b['step2_nonfinite'][:3]}, norm {b['step2_norm']}")
    c = res["card_vs_cpu"]
    if not all(abs(x - y) <= TRAIN_LOSS_RTOL * abs(y)
               for x, y in zip(c["card_losses"], c["cpu_losses"])):
        fails.append(f"train: card losses {c['card_losses']}, CPU "
                     f"{c['cpu_losses']}")
    if not c["grad_rel_l2"] <= TRAIN_GRAD_REL_L2:
        fails.append(f"train: step-1 gradient {c['grad_rel_l2']} from the "
                     f"CPU's")
    if not res["guard"]["raised"]:
        fails.append("train: a loss through the kernel did not raise")
    e = res["pipelined"]
    if e["kernel_launches"] != e["layers"] * e["microbatches"]:
        fails.append(f"train: pipelined forward {e['kernel_launches']} "
                     f"causal launches, want {e['layers']} x "
                     f"{e['microbatches']}")
    if not e["logits_rel_l2_vs_fp32"] <= \
            KERNEL_VS_DENSE_ERR_RATIO * e["dense_rel_l2_vs_fp32"]:
        fails.append(f"train: pipelined logits {e['logits_rel_l2_vs_fp32']} "
                     f"from float32, dense bf16 {e['dense_rel_l2_vs_fp32']}")
    for name, err in res["seq_parallel"].items():
        if not err <= SEQ_PARALLEL_ATOL:
            fails.append(f"train: {name} {err} from dense")
    if res["seconds"] > TRAIN_BUDGET_S:
        fails.append(f"train: {res['seconds']:.1f} s, past its "
                     f"{TRAIN_BUDGET_S:.0f} s budget")
    return fails


def _bit_fingerprints(params, run=1 << 26):
    """path -> two int64 sums of each leaf's 16-bit patterns, plain and
    weighted by 2i + 1 at element i, modulo 2^64 (so in any order): a
    leaf with one element changed always moves the weighted sum, one with
    more moves it but for a 2^-64 chance."""
    import torch

    from llm_interpretation_replication_tpu_torch.runtime import train

    out = {}
    for path, t in train._flatten(params):
        bits = t.detach().view(torch.int16).view(-1)
        plain = weighted = 0
        for i in range(0, bits.numel(), run):
            b = bits[i:i + run].to(torch.int64)
            odd = torch.arange(2 * i + 1, 2 * (i + b.numel()) + 1, 2,
                               device=b.device)
            plain = plain + b.sum()
            weighted = weighted + (b * odd).sum()
        out[path] = (int(plain), int(weighted))
    return out


def _falcon_train_steps(cfg, mesh, ids, mask, seed):
    """(b) and (d): Falcon-7B's full-width, full-depth training steps on the
    card; returns the record and the trained weights."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.runtime import train

    t0 = time.perf_counter()
    weights = convert.random_params(cfg, seed=seed + 7, device="cuda",
                                    dtype="bf16")
    opt = train.make_optimizer(1e-4, warmup_steps=1, total_steps=10)
    state = train.init_train_state(weights, opt)
    step = train.make_train_step(cfg, opt, mesh)
    torch.cuda.synchronize()
    seconds = dict(init=time.perf_counter() - t0)
    t0 = time.perf_counter()
    before = _bit_fingerprints(state.params)
    seconds["fingerprint"] = time.perf_counter() - t0
    seen = {}

    def on_grads(grads, norm):
        seen["missing"], seen["nonfinite"] = _grad_check(grads, state.params)
        seen["norm"] = float(norm)

    losses, step_ms, changed = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, ids, mask,
                           on_grads=on_grads if i == 1 else None)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            after = _bit_fingerprints(state.params)
            changed = ["/".join(p) for p in before if after[p] != before[p]]
    peak = torch.cuda.max_memory_allocated()
    # (d): a loss through the causal kernel under grad
    flash = dataclasses.replace(cfg, attention_impl="flash")
    attention = importlib.import_module(
        "llm_interpretation_replication_tpu_torch.ops.attention")
    launches = attention.causal_grouped_attention.launches
    try:
        train.causal_lm_loss(state.params, flash, ids[:1, :16], mask[:1, :16])
        raised = None
    except NotImplementedError as e:
        raised = str(e)
    guard = dict(raised=raised is not None and
                 attention.causal_grouped_attention.launches == launches,
                 message=raised)
    real = int(mask.sum())
    steady = sum(step_ms[1:]) / (len(step_ms) - 1)
    rec = dict(layers=cfg.num_layers, params=sum(
                   t.numel() for _, t in train._flatten(state.params)),
               batch=list(ids.shape), real_tokens=real, losses=losses,
               step_ms=step_ms, steady_step_ms=steady,
               tokens_per_s=ids.numel() / (steady / 1e3),
               real_tokens_per_s=real / (steady / 1e3),
               peak_memory_bytes=peak, step1_changed=changed,
               step2_missing=seen["missing"],
               step2_nonfinite=seen["nonfinite"], step2_norm=seen["norm"],
               seconds=seconds)
    del state, step, opt
    for _, t in train._flatten(weights.tree()):
        t.requires_grad_(False)
    return rec, guard, weights


def _float32_steps(cfg, host, ids, mask, where):
    """TRAIN_CPU_STEPS float32 steps of ``cfg`` from the weights ``host``
    (path -> CPU tensor) on ``where``: the losses and step 1's gradient
    (on ``where``)."""
    from llm_interpretation_replication_tpu_torch.runtime import train

    t0 = time.perf_counter()
    params = train._unflatten((p, t.to(where, copy=True))
                              for p, t in host.items())
    opt = train.make_optimizer(1e-4, warmup_steps=1, total_steps=10)
    state = train.init_train_state(params, opt)
    step = train.make_train_step(cfg, opt)
    grads, losses = {}, []

    def keep(g, _norm):     # the optimizer does not write the gradients
        grads.update((p, t.detach()) for p, t in train._flatten(g))

    for i in range(TRAIN_CPU_STEPS):
        state, loss = step(state, ids.to(where), mask.to(where),
                           on_grads=keep if i == 0 else None)
        losses.append(float(loss))
    return dict(losses=losses, grads=grads, seconds=time.perf_counter() - t0)


def _card_vs_cpu(card, cpu, layers, batch):
    """(c)'s record: the two runs' losses and how far step 1's gradient on
    the card is from the CPU's (relative L2 in float64 on the card, over
    all leaves and the worst leaf)."""
    num = den = worst = 0.0
    for path, g in cpu["grads"].items():
        ref = g.to("cuda").double()
        d2 = float((card["grads"][path].double() - ref).square().sum())
        r2 = float(ref.square().sum())
        num, den = num + d2, den + r2
        worst = max(worst, math.sqrt(d2 / r2))
    return dict(layers=layers, batch=batch, card_losses=card["losses"],
                cpu_losses=cpu["losses"], grad_rel_l2=math.sqrt(num / den),
                worst_leaf_rel_l2=worst, card_s=card["seconds"],
                cpu_s=cpu["seconds"])


def _pipelined_forward(cfg, weights, mesh, ids, mask, attention):
    """(e): ``pipeline_decoder_forward`` (pipe 1, TRAIN_MICROBATCHES) on the
    causal kernel's route against ``decoder.forward`` on the same route,
    both held to a float32 forward as the forced-route phase holds them."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.parallel import (
        pipeline_decoder_forward)

    t0 = time.perf_counter()
    flash = dataclasses.replace(cfg, attention_impl="flash")
    real = mask.bool()
    with torch.no_grad():
        _reset_launches(attention)
        piped = pipeline_decoder_forward(weights, flash, ids, mask, mesh,
                                         n_microbatches=TRAIN_MICROBATCHES)
        torch.cuda.synchronize()
        launches = _launches(attention)
        if launches["grouped_attention"] or launches["flash_attention"]:
            raise AssertionError(f"train: pipelined forward launched "
                                 f"{launches}")
        piped = piped[real]
        routed = decoder.forward(weights, flash, ids, mask)[real]
        dense = decoder.forward(weights, cfg, ids, mask)[real]
        ref = decoder.forward(_to_float32(weights.tree()), cfg, ids,
                              mask)[real]
    return dict(layers=cfg.num_layers, microbatches=TRAIN_MICROBATCHES,
                seconds=time.perf_counter() - t0,
                kernel_launches=launches["causal_grouped_attention"],
                finite=bool(torch.isfinite(piped).all()),
                logits_rel_l2_vs_fp32=_rel_l2(piped, ref),
                dense_rel_l2_vs_fp32=_rel_l2(dense, ref),
                vs_forward_rel_l2=_rel_l2(piped, routed))


def _seq_parallel(mesh, seed):
    """(f): ring and Ulysses attention over the seq axis (one rank) on
    Falcon-7B's q/k/v shape, bf16 draws compared in float32 against dense
    attention, causal, with a padded row."""
    import torch

    from llm_interpretation_replication_tpu_torch.parallel import (
        ring_attention_sharded, ulysses_attention_sharded)

    b, s, n, d = SEQ_PARALLEL_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 9)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16).float() for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.int32, device="cuda")
    mask[1, s // 3:] = 0
    with torch.no_grad():
        scores = torch.einsum("bsnd,btnd->bnst", q, k) / math.sqrt(d)
        pos = torch.arange(s, device="cuda")
        ok = (pos[None, :] <= pos[:, None])[None, None] \
            & mask.bool()[:, None, None, :]
        probs = torch.softmax(torch.where(ok, scores, -1e9), -1)
        dense = torch.einsum("bnst,btnd->bsnd", probs, v)
        real = mask.bool()[:, :, None, None]
        return {name: float(((fn(mesh, q, k, v, mask) - dense) * real)
                            .abs().max())
                for name, fn in (("ring", ring_attention_sharded),
                                 ("ulysses", ulysses_attention_sharded))}


def train_phase(seed, attention, workdir, card):
    """The training step and the parallel package on the card (last,
    nothing of the other phases resident; budget TRAIN_BUDGET_S): (a) an
    NCCL group of one rank through ``initialize_distributed`` with a
    ``file://`` rendezvous under ``workdir``, and ``make_mesh()`` on it;
    (b) Falcon-7B at its published width and full depth, random bf16
    weights and moments, TRAIN_STEPS steps of ``make_train_step`` on
    TRAIN_BATCH x TRAIN_SEQ corpus tokens on the dense route; (c) the same
    float32 steps at FAMILY_LAYERS on the card (TF32 off) and on the CPU;
    (d) a loss through the causal kernel under grad raises; (e)
    ``pipeline_decoder_forward`` on (b)'s weights through the causal
    kernel; (f) ring and Ulysses attention at seq 1.  The process group
    stays up for :func:`mesh_phase`, which ends it; a failure here ends
    it at once."""
    import torch
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.parallel import (
        initialize_distributed, make_mesh)
    from llm_interpretation_replication_tpu_torch.runtime import train

    t_phase = time.perf_counter()
    res, parts = {}, {}
    os.environ.pop("MASTER_ADDR", None)
    up = initialize_distributed(num_processes=1, process_id=0, device="cuda",
                                init_method="file://" + os.path.join(
                                    workdir, "train_rendezvous"))
    try:
        mesh = make_mesh()
        probe = torch.ones(1, device="cuda")
        dist.all_reduce(probe)
        res["group"] = dict(initialized=up, backend=dist.get_backend(),
                            world=dist.get_world_size(),
                            mesh=list(mesh.mesh.shape),
                            device_type=mesh.device_type,
                            all_reduce=float(probe))
        if not (up and res["group"]["backend"] == "nccl"
                and res["group"]["all_reduce"] == 1.0):
            raise AssertionError(f"train: process group {res['group']}")
        cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                    attention_impl="xla")
        ids, mask, vocab = _train_batch(TRAIN_BATCH, TRAIN_SEQ, "cuda")
        parts["group_and_batch"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res["falcon_7b"], res["guard"], weights = _falcon_train_steps(
            cfg, mesh, ids, mask, seed)
        res["falcon_7b"].update(vocab_words=vocab, memory_before_bytes=before)
        torch.cuda.empty_cache()
        parts["falcon_7b"] = time.perf_counter() - t0
        res["pipelined"] = _pipelined_forward(cfg, weights, mesh, ids, mask,
                                              attention)
        del weights
        torch.cuda.empty_cache()
        # (f) and (c) compare float32 results: TF32 off
        t0 = time.perf_counter()
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            res["seq_parallel"] = _seq_parallel(mesh, seed)
            # (c)'s weights are drawn on the card, then run on both
            small = dataclasses.replace(cfg, num_layers=FAMILY_LAYERS)
            host = {p: t.cpu() for p, t in train._flatten(
                convert.random_params(small, seed=seed + 8, device="cuda",
                                      dtype="fp32").tree())}
            cids, cmask, _ = _train_batch(TRAIN_CPU_BATCH, TRAIN_CPU_SEQ,
                                          "cpu")
            card_run = _float32_steps(small, host, cids, cmask, "cuda")
            parts["card_float32"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu_run = _float32_steps(small, host, cids, cmask, "cpu")
            parts["cpu_float32"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["card_vs_cpu"] = _card_vs_cpu(card_run, cpu_run,
                                              small.num_layers,
                                              list(cids.shape))
            parts["compare"] = time.perf_counter() - t0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    except BaseException:
        # the group stays up for the mesh phase only when this one passes
        dist.destroy_process_group()
        raise
    res["seconds"] = time.perf_counter() - t_phase
    res.update(card=card, part_seconds=parts)
    for key in ("group", "falcon_7b", "guard", "card_vs_cpu", "pipelined",
                "seq_parallel", "part_seconds"):
        say(f"train {key}", json.dumps(res[key]))
    fails = train_run_fails(res)
    if fails:
        raise AssertionError("train: " + "; ".join(fails[:10]))
    return res


# ---------------------------------------------------------------------------
# The scoring engine on a mesh (phase 26)
# ---------------------------------------------------------------------------

def _mesh_inputs(seed):
    """The slice's tokenizer and the first MESH_PROMPTS of its prompts."""
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        default_tokenizer)

    tok = default_tokenizer()
    return tok, _prompts(seed, tok)[:MESH_PROMPTS]


def _mesh_engine(cfg, weights, tok, mesh=None, **ecfg):
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    engine = emod.ScoringEngine(
        "falcon", cfg, weights, tok, device="cuda",
        engine_config=emod.EngineConfig(**{
            "decode_completions": False, "phase2_pool": False,
            "batch_size": BATCH, **ecfg}))
    return engine.bind_mesh(mesh) if mesh is not None else engine


def _mesh_small(seed):
    """(b)'s model: Falcon-7B at full width and FAMILY_LAYERS layers, w8a8
    weights from ``seed + 26`` (the same on every process of the card)."""
    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import convert

    cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                attention_impl="flash")
    cfg = dataclasses.replace(cfg, num_layers=FAMILY_LAYERS)
    return cfg, convert.random_params(cfg, seed=seed + 26, device="cuda",
                                      dtype="bf16", quant="int8")


def _mesh_rank_runs(rank, seed):
    """One gloo rank of (b): dp2 then tp2 on the card, each rank's causal
    launches (the heads of each), peak memory, collective bytes and ms."""
    import torch
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.parallel import make_mesh

    # the ops package re-exports a function named ``attention``
    attention = importlib.import_module(
        "llm_interpretation_replication_tpu_torch.ops.attention")
    cfg, weights = _mesh_small(seed)
    tok, prompts = _mesh_inputs(seed)
    heads, moved = [], [0]
    kernel = attention.causal_grouped_attention

    def counted(q, *args, **kwargs):
        heads.append(int(q.shape[2]))
        return kernel(q, *args, **kwargs)

    # the kernel's wrapper counts its launches on the module's name
    counted.launches = kernel.launches

    def nbytes(t):
        return t.numel() * t.element_size()

    real = dist.all_reduce, dist.all_gather

    def all_reduce(t, *args, **kwargs):
        moved[0] += nbytes(t)
        return real[0](t, *args, **kwargs)

    def all_gather(parts, t, *args, **kwargs):
        moved[0] += sum(nbytes(p) for p in parts)
        return real[1](parts, t, *args, **kwargs)

    runs = {}
    attention.causal_grouped_attention = counted
    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    try:
        for name, shape in (("dp2", dict(data=2)), ("tp2", dict(model=2))):
            engine = _mesh_engine(cfg, weights, tok, make_mesh(**shape),
                                  kv_dtype="int8")
            heads.clear()
            moved[0] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rows = engine.score_prompts(prompts)
            torch.cuda.synchronize()
            runs[name] = dict(
                ms=(time.perf_counter() - t0) * 1e3, heads=list(heads),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                collective_bytes=moved[0],
                rows=[[r["scan_found"], r["relative_prob"], r["yes_prob"],
                       r["no_prob"]] for r in rows])
            engine.close(release_params=False)
    finally:
        attention.causal_grouped_attention = kernel
        dist.all_reduce, dist.all_gather = real
    legs = {}
    for key, leg in (("c", _mesh_serve_leg), ("d", _mesh_slab_leg),
                     ("e", _mesh_k_leg), ("f", _mesh_pool_leg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        legs[key] = leg(rank, cfg, weights, tok, prompts)
        torch.cuda.synchronize()
        legs[key]["seconds"] = time.perf_counter() - t0
    del weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    legs["g"] = _mesh_moe_leg(rank, seed)
    legs["g"]["seconds"] = time.perf_counter() - t0
    return runs, legs


def _row_fields(rows):
    return [[r["scan_found"], r["relative_prob"], r["yes_prob"],
             r["no_prob"]] for r in rows]


def mesh_serve_rows(prompts):
    """(c)'s prompts: the indices of those in the MESH_SERVE_BUCKETS
    buckets (the engine's default menu) that hold the most of them."""
    import collections

    from llm_interpretation_replication_tpu_torch.config import \
        DEFAULT_BUCKETS
    from llm_interpretation_replication_tpu_torch.runtime import batching

    bucket = [batching.bucket_for(len(p), DEFAULT_BUCKETS) for p in prompts]
    top = [b for b, _ in sorted(collections.Counter(bucket).items(),
                                key=lambda kv: (-kv[1], kv[0]))]
    keep = set(top[:MESH_SERVE_BUCKETS])
    return [i for i, b in enumerate(bucket) if b in keep]


def _mesh_serve_leg(rank, cfg, weights, tok, prompts):
    """(c): the prompts of :func:`mesh_serve_rows` through the leader's
    scheduler on dp2 and on tp2, slot admission on: rank 0 submits them
    all before the loop starts and reads the rows, rank 1 follows.  Each
    rank's engine calls and ring admissions (the engine's
    ``slot_admitted``)."""
    import torch

    from llm_interpretation_replication_tpu_torch.parallel import make_mesh
    from llm_interpretation_replication_tpu_torch.serve import (
        Scheduler, SchedulerConfig, ScoreRequest)
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    out = {}
    prompts = [prompts[i] for i in mesh_serve_rows(prompts)]
    for name, shape in (("dp2", dict(data=2)), ("tp2", dict(model=2))):
        engine = _mesh_engine(cfg, weights, tok, make_mesh(**shape),
                              kv_dtype="int8", batch_size=MESH_SERVE_RING,
                              phase2_pool_target=MESH_SERVE_RING)
        before = telemetry.counters()
        sched = Scheduler(engine, SchedulerConfig(
            max_batch=MESH_SERVE_BATCH, max_wait_s=0.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = None
        if sched.follower:
            sched.start()
        else:
            futures = [sched.submit(ScoreRequest(prompt=p)) for p in prompts]
            sched.start()
            rows = _row_fields(f.result(timeout=600) for f in futures)
        sched.close()
        torch.cuda.synchronize()
        delta = telemetry.counters_since(before)
        out[name] = dict(rows=rows, follower=sched.follower,
                         engine_calls=sched.engine_calls,
                         admitted=int(delta.get("slot_admitted", 0)),
                         serve_slot_admitted=int(delta.get(
                             "serve_slot_admitted", 0)),
                         ms=(time.perf_counter() - t0) * 1e3)
        engine.close(release_params=False)
    return out


def _mesh_slab_leg(rank, cfg, weights, tok, prompts):
    """(d): the KV-slab handoff on dp2: the prompts' undecided rows leave
    one engine as host slabs and decode on another; the rows in prompt
    order."""
    import torch

    from llm_interpretation_replication_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=2)
    exporter = _mesh_engine(cfg, weights, tok, mesh, kv_dtype="int8")
    importer = _mesh_engine(cfg, weights, tok, mesh, kv_dtype="int8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, slabs = exporter.export_kv_slab(prompts)
    decoded = importer.decode_kv_slabs(slabs)
    torch.cuda.synchronize()
    origs = [m["orig"] for slab in slabs for m in slab.metas]
    for i, row in zip(origs, decoded):
        rows[i] = row
    for engine in (exporter, importer):
        engine.close(release_params=False)
    return dict(rows=_row_fields(rows), slab_rows=len(origs),
                slab_bytes=sum(slab.nbytes() for slab in slabs),
                ms=(time.perf_counter() - t0) * 1e3)


def _mesh_k_leg(rank, cfg, weights, tok, prompts):
    """(e): ``decode_k=K_DECODE`` on tp2 with a K-head distilled on the
    mesh, against ``decode_k=1`` on tp2, both decoding MESH_K_TOKENS
    completion tokens (the K path's completion chunks): the rows, the
    head's digest on this rank, the accept rate and the ms of a K
    chunk."""
    import hashlib

    import torch

    from llm_interpretation_replication_tpu_torch.parallel import make_mesh
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    mesh = make_mesh(model=2)
    prompts = prompts[:MESH_K_PROMPTS]
    k = dict(kv_dtype="int8", decode_completions=True,
             max_new_tokens=MESH_K_TOKENS, batch_size=MESH_K_PROMPTS)
    k1 = _mesh_engine(cfg, weights, tok, mesh, **k)
    ref = _row_fields(k1.score_prompts(prompts))
    k1.close(release_params=False)
    k4 = _mesh_engine(cfg, weights, tok, mesh, decode_k=K_DECODE, **k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head = k4.distill_k_head_on(prompts)["w"]
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    digest = hashlib.sha256(
        head.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    ).hexdigest()
    chunks, chunk = [], k4._k_decode_chunk

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            return chunk(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            chunks.append((time.perf_counter() - start) * 1e3)

    k4._k_decode_chunk = timed
    before = telemetry.counters()
    rows = _row_fields(k4.score_prompts(prompts))
    delta = telemetry.counters_since(before)
    k4.close(release_params=False)
    proposed = int(delta.get("k_blocks_proposed", 0))
    rejected = int(delta.get("k_blocks_rejected", 0))
    return dict(rows=rows, k1_rows=ref, head_digest=digest,
                head_shape=list(head.shape), distill_s=distill_s,
                k_chunks=len(chunks),
                chunk_ms=sum(chunks) / len(chunks) if chunks else None,
                k_blocks_proposed=proposed, k_blocks_rejected=rejected,
                accept_rate=(1 - rejected / proposed) if proposed else None)


def _mesh_pool_leg(rank, cfg, weights, tok, prompts):
    """(f): an ``EnginePool`` of two replicas on ``carve_slices(2)``, one
    rank each: rank 0 submits and reads the rows and the health document;
    each rank reports the replicas it hosts."""
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.parallel import mesh
    from llm_interpretation_replication_tpu_torch.serve import (
        EnginePool, SchedulerConfig, ScoreRequest)
    from llm_interpretation_replication_tpu_torch.serve.pool import PoolConfig

    pool = EnginePool(PoolConfig(scheduler=SchedulerConfig(
        max_batch=MESH_SERVE_BATCH, max_wait_s=0.0)))
    slices = mesh.carve_slices(2)
    for sl in slices:
        pool.load("falcon-7b", _mesh_engine(
            cfg, weights, tok, kv_dtype="int8", batch_size=MESH_SERVE_RING,
            phase2_pool_target=MESH_SERVE_RING)
            if rank in sl else None, devices=sl, owns_engine=False)
    t0 = time.perf_counter()
    rows = health = None
    if pool.leads:
        futures = [pool.submit(ScoreRequest(prompt=p)) for p in prompts]
        rows = _row_fields(f.result(timeout=600) for f in futures)
        health = pool.health()["replicas"]
    hosted = sorted(r.rid for r in pool.replicas()
                    if getattr(r, "hosted", False))
    pool.close()
    everyone = [None, None]
    dist.all_gather_object(everyone, hosted)
    return dict(rows=rows, health=health, hosted=everyone,
                slices=[list(sl) for sl in slices],
                ms=(time.perf_counter() - t0) * 1e3)


def _mesh_moe_leg(rank, seed):
    """(g): one MoE layer at Mixtral-8x7B's widths, bf16 weights and
    MOE_TOKENS tokens from ``seed + 27`` (the same on both processes):
    ``moe_mlp_sharded`` over the two ranks (MOE_EXPERTS / 2 experts each),
    then, on rank 0, ``moe_mlp_dense`` on one process.  Each path's ms (a
    warm call, then a timed one), the all_to_all bytes a rank, and the
    tokens whose choices overflowed a capacity."""
    import torch
    import torch.distributed as dist

    from llm_interpretation_replication_tpu_torch.ops import moe
    from llm_interpretation_replication_tpu_torch.parallel import make_mesh

    gen = torch.Generator(device="cuda").manual_seed(seed + 27)
    params = moe.init_moe_params(gen, MOE_HIDDEN, MOE_FFN, MOE_EXPERTS,
                                 dtype=torch.bfloat16, device="cuda")
    x = torch.randn((MOE_TOKENS, MOE_HIDDEN), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    mesh = make_mesh(data=2)
    moved = [0]
    real = dist.all_to_all_single

    def all_to_all_single(out, inp, *args, **kwargs):
        moved[0] += inp.numel() * inp.element_size()
        return real(out, inp, *args, **kwargs)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t0) * 1e3

    dist.all_to_all_single = all_to_all_single
    try:
        (y, aux), sharded_ms = timed(lambda: moe.moe_mlp_sharded(
            params, x, mesh, top_k=MOE_TOP_K))
    finally:
        dist.all_to_all_single = real
    # this rank's tokens whose choices found a capacity full
    t = MOE_TOKENS // 2
    gates, idx, _ = moe.route(params, x[rank * t:(rank + 1) * t], MOE_TOP_K)
    cap = max(1, int(2.0 * MOE_TOP_K * t / MOE_EXPERTS))
    dispatch, _ = moe._dispatch_tensors(gates, idx, MOE_EXPERTS, cap)
    kept = dispatch.sum(dim=(1, 2)) == MOE_TOP_K
    kept_all = [None, None]
    dist.all_gather_object(kept_all, kept.cpu().tolist())
    out = dict(sharded_ms=sharded_ms, all_to_all_bytes=moved[0] // 2,
               capacity=cap, aux_sharded=float(aux),
               overflowed_tokens=sum(k.count(False) for k in kept_all))
    if rank == 0:
        (yd, auxd), dense_ms = timed(lambda: moe.moe_mlp_dense(
            params, x, top_k=MOE_TOP_K))
        keep = torch.tensor(sum(kept_all, []), device="cuda")
        err = float((y[keep].float() - yd[keep].float()).abs().max())
        out.update(dense_ms=dense_ms, aux_dense=float(auxd),
                   max_abs_err=err,
                   dense_max_abs=float(yd.float().abs().max()),
                   compared_tokens=int(keep.sum()))
    del params, x
    torch.cuda.empty_cache()
    return out


def _mesh_rank(rank, world, workdir, seed):
    """A spawned process of (b): rank ``rank`` of a gloo group on the one
    card.  Probes gloo with CUDA tensors, then runs :func:`_mesh_rank_runs`;
    writes its results under ``workdir``.  An error ends the process with
    it, and so the phase."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llm_interpretation_replication_tpu_torch.parallel import (
        initialize_distributed)

    torch.cuda.set_device(0)
    os.environ.pop("MASTER_ADDR", None)
    initialize_distributed(num_processes=world, process_id=rank, device="cpu",
                           init_method="file://" + os.path.join(
                               workdir, "mesh_rendezvous"), timeout=120)
    res = {}
    try:
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        parts = [torch.empty(2, device="cuda") for _ in range(world)]
        dist.all_gather(parts, torch.full((2,), float(rank), device="cuda"))
        res["probe"] = dict(all_reduce=x.tolist(),
                            all_gather=[p.tolist() for p in parts])
        res["runs"], res["legs"] = _mesh_rank_runs(rank, seed)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def mesh_run_fails(res, ref_rows, num_heads):
    """(b)'s gates on both ranks' results against the world of one's rows
    (``[scan_found, relative, yes, no]`` a row); ``num_heads`` the model's
    query heads (each dp2 rank launches at all of them, the tp2 ranks at
    their head-boundary shares)."""
    from llm_interpretation_replication_tpu_torch.parallel.tensor_parallel \
        import split_sizes

    fails = [f"mesh: rank {rank} has no {key}" for rank, r in enumerate(res)
             for key in ("probe", "runs") if key not in r]
    if fails:
        return fails
    for p in (r["probe"] for r in res):
        if p != dict(all_reduce=[3.0] * 4, all_gather=[[0.0, 0.0],
                                                       [1.0, 1.0]]):
            fails.append(f"mesh: gloo probe read {p}")
    want_heads = {"dp2": (num_heads, num_heads),
                  "tp2": tuple(split_sizes(num_heads, 2))}
    for name, heads in want_heads.items():
        for rank, r in enumerate(res):
            run = r["runs"][name]
            if set(run["heads"]) != {heads[rank]} or \
                    len(run["heads"]) != FAMILY_LAYERS:
                fails.append(f"mesh {name} rank {rank}: causal launches at "
                             f"heads {run['heads']}")
            for i, (got, want) in enumerate(zip(run["rows"], ref_rows)):
                if got[0] != want[0]:
                    fails.append(f"mesh {name} rank {rank} row {i}: "
                                 f"scan_found {got[0]} vs {want[0]}")
                for g, w in zip(got[1:], want[1:]):
                    if abs(g - w) > MESH_W8A8_RTOL * abs(w) + 1e-9:
                        fails.append(f"mesh {name} rank {rank} row {i}: "
                                     f"{g} vs {w}")
                        break
            if len(run["rows"]) != len(ref_rows):
                fails.append(f"mesh {name} rank {rank}: {len(run['rows'])} "
                             f"rows")
        if res[0]["runs"][name]["rows"] != res[1]["runs"][name]["rows"]:
            fails.append(f"mesh {name}: the ranks' rows differ")
    return fails


def _class_fails(label, got, want):
    """Rows ``[scan_found, relative, yes, no]`` against ``want`` in the
    w8a8 class: verdicts identical, probabilities within MESH_W8A8_RTOL."""
    if got is None or len(got) != len(want):
        return [f"{label}: {None if got is None else len(got)} rows of "
                f"{len(want)}"]
    fails = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g[0] != w[0]:
            fails.append(f"{label} row {i}: scan_found {g[0]} vs {w[0]}")
        elif any(abs(a - b) > MESH_W8A8_RTOL * abs(b) + 1e-9
                 for a, b in zip(g[1:], w[1:])):
            fails.append(f"{label} row {i}: {g[1:]} vs {w[1:]}")
    return fails


def mesh_leg_fails(res, ref_rows, prompts):
    """The gates of (c)-(g) on both ranks' results (``ref_rows`` the world
    of one's rows of the same weights, on ``prompts``)."""
    if any("legs" not in r for r in res):
        return ["mesh: a rank returned no legs"]
    legs = [r["legs"] for r in res]
    fails = []
    served = [ref_rows[i] for i in mesh_serve_rows(prompts)]
    for name in ("dp2", "tp2"):
        c = [leg["c"][name] for leg in legs]
        fails += _class_fails(f"mesh (c) {name}", c[0]["rows"], served)
        if [x["follower"] for x in c] != [False, True]:
            fails.append(f"mesh (c) {name}: followers {[x['follower'] for x in c]}")
        if c[0]["admitted"] < 1 or c[0]["serve_slot_admitted"] < 1:
            fails.append(f"mesh (c) {name}: no mid-decode admission")
        for key in ("admitted", "engine_calls"):
            if c[0][key] != c[1][key]:
                fails.append(f"mesh (c) {name}: {key} {c[0][key]} vs "
                             f"{c[1][key]} on the ranks")
    for rank, leg in enumerate(legs):
        fails += _class_fails(f"mesh (d) rank {rank}", leg["d"]["rows"],
                              ref_rows)
        e = leg["e"]
        fails += _class_fails(f"mesh (e) rank {rank}", e["rows"],
                              e["k1_rows"])
        if not e["k_chunks"] or not e["k_blocks_proposed"]:
            fails.append(f"mesh (e) rank {rank}: the K path never ran")
    if not legs[0]["d"]["slab_rows"]:
        fails.append("mesh (d): no row left in a slab")
    if legs[0]["e"]["head_digest"] != legs[1]["e"]["head_digest"]:
        fails.append("mesh (e): the ranks' K-heads differ")
    f = legs[0]["f"]
    fails += _class_fails("mesh (f)", f["rows"], ref_rows)
    if f["hosted"] != [["r0"], ["r1"]]:
        fails.append(f"mesh (f): hosted {f['hosted']}")
    docs = f["health"] or []
    if len(docs) != 2 or not all(d.get("placement") == "sliced"
                                 and d.get("devices") == 1
                                 and d.get("completed", 0) > 0
                                 for d in docs):
        fails.append(f"mesh (f): health {docs}")
    g = legs[0]["g"]
    if not g.get("compared_tokens"):
        fails.append("mesh (g): every token overflowed")
    elif g["max_abs_err"] > MOE_RTOL * g["dense_max_abs"]:
        fails.append(f"mesh (g): sharded against dense {g['max_abs_err']} "
                     f"(largest dense {g['dense_max_abs']})")
    if abs(g["aux_sharded"] - g.get("aux_dense", float("nan"))) > \
            MOE_AUX_RTOL * abs(g.get("aux_dense", 0.0)) \
            or g["aux_sharded"] != legs[1]["g"]["aux_sharded"]:
        fails.append(f"mesh (g): aux {g['aux_sharded']} / "
                     f"{legs[1]['g']['aux_sharded']} vs dense "
                     f"{g.get('aux_dense')}")
    return fails


def mesh_phase(seed, attention, workdir, card):
    """Phase 26 (after train, on its NCCL world of one, which it ends;
    budget MESH_BUDGET_S): (a) Falcon-7B at full width and depth through
    ``bind_mesh(make_mesh())`` and without a mesh, rows equal bit for bit,
    one causal launch a layer; (b) dp2 and tp2 on two gloo processes of the
    card against the world of one (see the module docstring)."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from llm_interpretation_replication_tpu_torch.models import config as mconfig
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.parallel import make_mesh
    from llm_interpretation_replication_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    res, parts = {}, {}
    try:
        world_of_one = make_mesh()
        cfg = mconfig.DecoderConfig(**mconfig.FALCON_7B_GEOMETRY,
                                    attention_impl="flash")
        tok, prompts = _mesh_inputs(seed)
        weights = convert.random_params(cfg, seed=seed, device="cuda",
                                        dtype="bf16")
        bound = telemetry.counter("replica_mesh_bound")
        meshed = _mesh_engine(cfg, weights, tok, world_of_one)
        bound = telemetry.counter("replica_mesh_bound") - bound
        _reset_launches(attention)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = meshed.score_prompts(prompts)
        torch.cuda.synchronize()
        mesh_ms = (time.perf_counter() - t0) * 1e3
        launches = _launches(attention)["causal_grouped_attention"]
        plain = _mesh_engine(cfg, weights, tok).score_prompts(prompts)
        equal = sum(a == b for a, b in zip(rows, plain))
        res["a"] = dict(rows=len(rows), bit_equal_rows=equal,
                        kernel_launches=launches, layers=cfg.num_layers,
                        mesh=list(world_of_one.mesh.shape),
                        backend=dist.get_backend(), ms=mesh_ms,
                        replica_mesh_bound=bound)
        meshed.close(release_params=False)
        del weights, meshed
        torch.cuda.empty_cache()
        parts["a"] = time.perf_counter() - t_phase
    finally:
        dist.destroy_process_group()
    fails = [] if bound == 1 else [
        f"mesh (a): replica_mesh_bound counted {bound} binds of one"]
    if equal != len(prompts) or launches != cfg.num_layers:
        fails.append(f"mesh (a): {equal} of {len(prompts)} rows bit-equal, "
                     f"{launches} causal launches for {cfg.num_layers} "
                     f"layers")

    # (b): the world of one's rows of (b)'s weights, then two gloo ranks
    t0 = time.perf_counter()
    small, qweights = _mesh_small(seed)
    ref = _mesh_engine(small, qweights, tok, kv_dtype="int8").score_prompts(
        prompts)
    ref_rows = [[r["scan_found"], r["relative_prob"], r["yes_prob"],
                 r["no_prob"]] for r in ref]
    del qweights
    torch.cuda.empty_cache()
    parts["b_reference"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp.start_processes(_mesh_rank, args=(2, workdir, seed), nprocs=2,
                       start_method="spawn")
    ranks = []
    for rank in range(2):
        with open(os.path.join(workdir, f"mesh_rank{rank}.json")) as f:
            ranks.append(json.load(f))
    parts["b_ranks"] = time.perf_counter() - t0
    res["b"] = dict(
        probe=[r.get("probe") for r in ranks],
        runs=[{name: {k: v for k, v in run.items() if k != "rows"}
               for name, run in r.get("runs", {}).items()} for r in ranks])
    fails += mesh_run_fails(ranks, ref_rows, small.num_heads)
    fails += mesh_leg_fails(ranks, ref_rows, prompts)

    def numbers(obj):
        # a leg's printout: everything but its rows
        if isinstance(obj, dict):
            return {k: numbers(v) for k, v in obj.items()
                    if k not in ("rows", "k1_rows")}
        return obj

    for key in "cdefg":
        res[key] = [numbers(r.get("legs", {}).get(key)) for r in ranks]
        res["legs_seconds"] = [
            {k: v.get("seconds") for k, v in r.get("legs", {}).items()}
            for r in ranks]
    res.update(card=card, seconds=time.perf_counter() - t_phase,
               budget_s=MESH_BUDGET_S, part_seconds=parts, failures=fails)
    for key in ("a", "b", "c", "d", "e", "f", "g", "legs_seconds",
                "part_seconds"):
        say(f"mesh {key}", json.dumps(res[key]))
    if fails:
        raise AssertionError("mesh: " + "; ".join(fails[:10]))
    return res


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
    pool_inputs = pres.pop("inputs")
    fres = timed("full_study", full_study_phase, args.seed, attention, weights)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        wres = timed("sweep", sweep_phase, args.seed, attention, weights,
                     workdir, card)
        pkres = timed("packed", packed_phase, args.seed, attention, weights,
                      fres["near_tie"], workdir, card)
        kres = timed("k_decode", k_decode_phase, args.seed, attention,
                     weights, card)
        ores = timed("obs", obs_phase, args.seed, attention, weights,
                     workdir, card)
        tres = timed("tokenizers", tokenizers_phase, args.seed, attention,
                     weights, workdir, card)
        svres = timed("serve", serve_phase, args.seed, attention, weights,
                      pool_inputs, card)
        ires = timed("int8", int8_phase, args.seed, attention, bf16_rows)
        cres = timed("cli", cli_phase, args.seed, attention, workdir, card)
        ocres = timed("obs_cli", obs_cli_phase, workdir, card)
        svcli = timed("serve_cli", serve_cli_phase, attention, workdir, card)
        apres = timed("api", api_phase, args.seed, attention, weights,
                      workdir, card)
        del weights
        torch.cuda.empty_cache()
        fam = timed("families", families_phase, args.seed, attention, card)
        torch.cuda.empty_cache()
        oth = timed("other_families", other_families_phase, args.seed,
                    attention, workdir, card)
        qres = timed("run_100q", run100q_cli_phase, args.seed, workdir, card)
        torch.cuda.empty_cache()
        inst = timed("instruct", instruct_phase, args.seed, attention,
                     workdir, card)
        ires_cli = timed("run_instruct_sweep", instruct_cli_phase, args.seed,
                         workdir, card)
        # the analysis commands over the two sweeps' CSVs (host only)
        stres = timed("stats", stats_phase, args.seed, workdir, card)
        # the plan model against every peak recorded above, then its
        # searched run (nothing of the other phases resident)
        torch.cuda.empty_cache()
        plres = timed("plan", plan_phase, args.seed, attention, workdir,
                      card, dict(slice=sres, pooled=pres, full_study=fres,
                                 sweep=wres, packed=pkres, k_decode=kres,
                                 int8=ires, cli=cres, families=fam,
                                 other_families=oth, instruct=inst,
                                 serve=svres))
        # training and the parallel package (nothing else resident)
        torch.cuda.empty_cache()
        trres = timed("train", train_phase, args.seed, attention, workdir,
                      card)
        # the scoring engine on a mesh, on the train phase's world of one
        mres = timed("mesh", mesh_phase, args.seed, attention, workdir, card)
        say(f"phase mesh: {seconds['mesh']:.1f} s of its {MESH_BUDGET_S:.0f} "
            f"s budget")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # the causal kernel's launches over every main-path run (each counted
    # from 0 just before it); the head-major kernels run on forced routes
    causal = causal_launches(sres, pres, fres, ires, wres, pkres, kres, ores,
                             tres, cres, fam, inst, svres, svcli, apres) \
        + causal_launches(oth) + plres["searched_run"]["kernel_launches"] \
        + trres["pipelined"]["kernel_launches"] \
        + mres["a"]["kernel_launches"]
    forced = [*oth["forced_routes"].values()]
    launches = {"causal_grouped_attention": causal,
                "grouped_attention": sum(f["grouped"]["launches"] for f in
                                         [sres["forced_routes"], *forced]),
                "flash_attention": sum(f["pallas"]["launches"] for f in
                                       [sres["forced_routes"], *forced])}
    # each kernel, then its head-dim-256 instance (GPT-J's) as an entry of
    # its own: its launches are the other_families phase's GPT-J runs
    wide = {"causal_grouped_attention": sum(
                r["kernel_launches"] for m in oth["models"]
                if m["heads"][2] == WIDE_HEAD_DIM for r in m["runs"]),
            "grouped_attention": sum(f["grouped"]["launches"] for f in forced),
            "flash_attention": sum(f["pallas"]["launches"] for f in forced)}
    kernels = kernels_line(krows + erows + fam["kernel_rows"]
                           + inst["kernel_rows"] + pkres["kernel_rows"],
                           launches, wide)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, build=build,
                       edge_rows=erows, kernel_rows=krows, slice=sres,
                       pooled=pres, full_study=fres, sweep=wres,
                       packed=pkres, k_decode=kres, obs=ores, obs_cli=ocres,
                       tokenizers=tres, serve=svres, serve_cli=svcli,
                       api=apres, stats=stres, plan=plres, train=trres,
                       mesh=mres,
                       int8=ires, cli=cres, families=fam,
                       other_families=oth, run_100q=qres,
                       instruct=inst,
                       run_instruct_sweep=ires_cli, phase_seconds=seconds,
                       kernels=kernels), f, indent=1)
    say("phase seconds", json.dumps({k: round(v, 1) for k, v in
                                     seconds.items()}),
        f"sum {sum(seconds.values()):.1f} s ({card})")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
