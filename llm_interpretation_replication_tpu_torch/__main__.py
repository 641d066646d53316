"""Command-line entry point of the port::

    python -m llm_interpretation_replication_tpu_torch run-perturbation \\
        --model SNAPSHOT --perturbations perturbations.json [--device cuda]
    python -m llm_interpretation_replication_tpu_torch run-100q \\
        --checkpoint-dir DIR [--device cuda]
    python -m llm_interpretation_replication_tpu_torch run-instruct-sweep \\
        --checkpoint-dir DIR [--device cuda]
    python -m llm_interpretation_replication_tpu_torch serve \\
        --model SNAPSHOT [--input requests.jsonl | --replay FILE] [--device cuda]
    python -m llm_interpretation_replication_tpu_torch obs report --trace PATH
    python -m llm_interpretation_replication_tpu_torch obs bench-diff RECORD...
    python -m llm_interpretation_replication_tpu_torch generate-irrelevant
    python -m llm_interpretation_replication_tpu_torch run-api-perturbation \\
        --perturbations perturbations.json --model gpt-4.1
    python -m llm_interpretation_replication_tpu_torch power-analysis
    python -m llm_interpretation_replication_tpu_torch sample-statements
    python -m llm_interpretation_replication_tpu_torch analyze-mae-100q \
        --results results/base_vs_instruct_100q_results.csv \
        --survey1-csv S1.csv --survey2-csv S2.csv --latex

``run-perturbation`` loads a local HF snapshot (``config.json``, weights as
safetensors or ``pytorch_model.bin``, a byte-level BPE ``tokenizer.json``)
onto the card, or onto the CPU with ``--device cpu``, and writes the
perturbation study's 15-column workbook to
``<output-dir>/perturbation_results.xlsx`` (with ``--packed Q``, Q
rephrasings a prefill scored at their answer anchors, to
``perturbation_results_packed.xlsx``, and the drift block against isolated
scoring printed as ``{"packed_drift": ...}``).  With ``--decode-k K`` the
decode legs run in joint K-token verify passes: the engine loads the
snapshot's ``k_head.npz`` when it matches, and otherwise
``run-perturbation`` distills a K-head on the sweep's own texts and writes
it there.  ``run-100q`` scores the 100
ordinary-meaning questions with each base and instruct model of
``data_assets/model_pairs_100q.json``, each loaded from its snapshot under
``--checkpoint-dir`` (``org/name``, ``org--name`` or a hub cache's
``models--org--name/snapshots/*``), and writes
``<output-dir>/base_vs_instruct_100q_results.csv``.  ``run-instruct-sweep``
scores the 100 questions (or ``--questions-file``'s) with each model of
``data_assets/instruct_sweep_models.json`` (T5 among them) and writes
``<output-dir>/instruct_model_comparison_results.csv`` (or
``--results-csv``).  ``serve`` is the continuous-batching scoring service
(``serve/``): JSONL requests in, one JSONL answer a line out, in input
order; ``--replay`` pushes the perturbation workload through the scheduler
and asserts row parity with offline scoring, ``--load-rate`` runs the
open-loop load harness, ``--pool-replicas N`` serves through an engine
pool of N replicas sharing the snapshot's weights (``--supervise`` arms
its self-healing) and ``--metrics-port`` serves ``/metrics`` and
``/healthz``.  The API leg runs on the host alone and creates no CUDA
context: ``generate-irrelevant`` writes the 3,400-row
irrelevant-insertion corpus; ``run-api-perturbation`` (OpenAI batches),
``run-claude-perturbation`` (Claude message batches, confidence only),
``run-gpt-perturbation`` (serial) and ``run-gemini-perturbation``
(threaded) score a ``perturbations.json`` on a vendor's API into the
study's workbooks, resuming from them; ``generate-rephrasings`` builds a
``perturbations.json`` from Claude sessions, and ``repair-batch``
rewrites a corrupted batch-response JSONL.  The vendor keys come from
``OPENAI_API_KEY``, ``ANTHROPIC_API_KEY`` and ``GEMINI_API_KEY``.
``power-analysis`` writes the sample-size report
(``<output-dir>/power_analysis_report.tex``) from the pilot MAEs, and
``sample-statements`` a seeded LaTeX sample of the irrelevant statements;
both run on the host alone.  So do the fourteen analysis commands, on row
dicts (``utils/frame.py``) in place of pandas: ``analyze-survey``,
``analyze-combined``, ``demographics-table``, ``analyze-perturbations``,
``similarity``, ``analyze-100q``, ``analyze-mae-100q`` (paper Table 5),
``extract-survey2-questions``, ``analyze-3way``, ``analyze-agreement``,
``analyze-family-differences``, ``ground-truth-figure``,
``model-comparison`` and ``cross-kappa``; their figures need matplotlib.
The three vendor-evaluation commands run on the host too:
``run-closed-source`` (the frontier-API 100-question evaluation and its
MAE tables against the survey), ``run-irrelevant`` (the
irrelevant-insertion study over three vendors, with resume) and
``verify-replication`` (every headline table recomputed and judged
PASS/FAIL against the published values; with ``--snapshots`` its Table-5
sweep runs on the card first).  These are copies of the reference CLI's
commands; all 33 of its commands are ported.  ``lint`` runs the port's
static-analysis gate (``lint/``: G01/G02 read for PyTorch, G05-G11 as
the reference has them, gated by ``lint_baseline_torch.json``) and ``lint
contracts`` its cross-artifact checks; both read sources only.  ``plan search``
prints the plan search's ranked table (host arithmetic; ``--hbm-gib``
without a card), and ``--plan-search`` on a sweep runs its choice.
Each takes ``--strict`` (the sync guard of ``runtime/strict.py``),
``--trace [PATH]`` (span tracing: a JSONL span log streamed to
``PATH.spans.jsonl`` and a Chrome trace written to PATH at exit),
``--profile DIR`` (a ``torch.profiler`` capture of the command) and
``--metrics [PATH]`` (the streaming JSONL metrics log); ``obs report``
aggregates a saved trace per phase and leg, ``obs bench-diff`` aligns bench
records into a regression table.  Flags of paths the port does not cover
yet raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .utils.checkpoint import writing_rank


def _add_run_config_args(p: argparse.ArgumentParser):
    p.add_argument("--strict", action="store_true",
                   help="arm strict mode (runtime/strict.py): raise on any "
                        "synchronizing CUDA operation outside the engine's "
                        "sanctioned fetch points and count nvcc builds "
                        "into telemetry (recompile_events / "
                        "blocked_transfers) — same as LLM_INTERP_STRICT=1")
    p.add_argument("--trace", nargs="?", const="obs_trace.json",
                   default=None, metavar="PATH",
                   help="span tracing (obs/): record hot-path phase spans "
                        "(tokenize/prefill/extend/decode/fetch), stream a "
                        "JSONL span log to PATH.spans.jsonl, and export a "
                        "Perfetto-loadable Chrome trace to PATH at exit; "
                        "analyze saved traces with the 'obs report' "
                        "subcommand")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="windowed torch.profiler capture into DIR for the "
                        "command's run (obs/profiler.py; headless "
                        "analysis: utils/profiling.top_device_ops)")
    p.add_argument("--metrics", nargs="?", const="metrics.jsonl",
                   default=None, metavar="PATH",
                   help="streaming JSONL metrics log (obs/metrics.py): "
                        "one sample per sweep heartbeat — telemetry "
                        "counters (raw + since-start delta), sample-ring "
                        "percentiles with truncation visibility, and "
                        "progress gauges — to PATH (default "
                        "metrics.jsonl).  Off by default")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="w8a8 int8 projections")
    p.add_argument("--attention-impl", choices=["xla", "flash", "auto"],
                   default="xla",
                   help="'flash': the causal kernel carries every prompt "
                        "forward; 'auto': dense up to 1024 tokens, the "
                        "kernel beyond")
    p.add_argument("--kv-dtype", choices=["bf16", "int8"], default="bf16",
                   help="KV cache storage: int8 codes with per-head scales")
    p.add_argument("--prefill-chunk", type=int, default=0, metavar="N",
                   help="> 0: prompt buckets above N tokens prefill in "
                        "N-token chunks through the suffix-extension path")
    p.add_argument("--pooled-confidence",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="confidence-leg decodes through the cross-batch pool")
    p.add_argument("--phase2-pool-target", type=int, default=0, metavar="N",
                   help="rows per pooled decode; 0 = batch size")
    p.add_argument("--slot-repack",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="slot ring (retired lanes refill mid-decode); "
                        "--no-slot-repack decodes whole flushes")
    p.add_argument("--decode-k", type=int, default=1, metavar="K",
                   help="joint next-K-token decode with verify and accept: "
                        "a K-head proposes K tokens a pass and one joint "
                        "pass verifies them against the single-step "
                        "argmax; a rejected pass re-runs its chunk "
                        "sequentially; 1 = sequential (default)")
    p.add_argument("--plan-search", action="store_true",
                   help="plan search (runtime/plan_search.py): enumerate "
                        "mesh x batch x kv-dtype x prefill-chunk x pool "
                        "target candidates against the device-memory "
                        "budget model and run the predicted-rows/s winner "
                        "instead of the batch/kv/chunk/pool flags; the "
                        "engine's OOM back-off ladder stays armed as the "
                        "safety net ('plan search' prints the same table "
                        "standalone)")
    p.add_argument("--hbm-gib", type=float, default=None, metavar="GIB",
                   help="device memory --plan-search budgets, in GiB "
                        "(default: the card's; needed without a card)")
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--mesh-seq", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--output-dir", default="results")


def _run_config(args):
    from .config import RunConfig

    return RunConfig(
        device=args.device, dtype=args.dtype, quant=args.quant,
        kv_dtype=args.kv_dtype, prefill_chunk=args.prefill_chunk,
        pooled_confidence=args.pooled_confidence,
        phase2_pool_target=args.phase2_pool_target,
        slot_repack=args.slot_repack, decode_k=args.decode_k,
        plan_search=args.plan_search,
        hbm_bytes=(None if args.hbm_gib is None
                   else int(args.hbm_gib * 2**30)),
        attention_impl=args.attention_impl, mesh_model=args.mesh_model,
        mesh_seq=args.mesh_seq, batch_size=args.batch_size,
        checkpoint_dir=args.checkpoint_dir, output_dir=args.output_dir,
    )


def _world(rc) -> int:
    """Ranks of the world this process is one of: the process group
    ``torchrun`` launches (``parallel.initialize_distributed`` reads its
    variables; NCCL on ``--device cuda``, gloo on ``cpu``), or 1."""
    import torch.distributed as dist

    from .parallel import initialize_distributed

    initialize_distributed(device=rc.device)
    return dist.get_world_size() if dist.is_initialized() else 1


def _run_mesh(rc):
    """The mesh ``--mesh-model``/``--mesh-seq`` ask for, built exactly when
    the reference's CLI builds one (either above 1), over the world's ranks
    with ``mesh_data`` taking the ranks left; None otherwise.  A world the
    mesh does not fit raises."""
    world = _world(rc)
    if rc.mesh_model <= 1 and rc.mesh_seq <= 1:
        return None
    need = rc.mesh_model * rc.mesh_seq
    if world % need:
        raise ValueError(
            f"--mesh-model {rc.mesh_model} --mesh-seq {rc.mesh_seq} needs a "
            f"world of a multiple of {need} ranks; it has {world} (launch "
            f"one process a rank: torchrun --nproc-per-node N -m "
            f"llm_interpretation_replication_tpu_torch ...)")
    return rc.make_mesh()


def _engine_factory(run_config):
    """model name -> ScoringEngine over its local snapshot.  Under the
    roster-wide ``--attention-impl flash``, a model whose config refuses
    the causal kernel (``flash_refusal``: ALiBi, a sliding window, T5's
    position bias) runs dense, as the reference's loader runs it; each
    model's impl is named on stderr (``# <model>: attention <impl>
    (<why>)``) before it loads.  With ``--decode-k`` > 1 the engine takes
    the snapshot's persisted K-head when one matches.  On a mesh
    (``--mesh-model``/``--mesh-seq``, or one the plan search chose) every
    rank loads its blocks of the weights and binds the engine to it."""
    from .models.config import from_hf_config
    from .runtime.engine import EngineConfig, ScoringEngine
    from .runtime.loader import (K_HEAD_FILENAME, attach_k_head,
                                 load_hf_config, load_model, load_tokenizer)

    mesh = _run_mesh(run_config)

    def factory(model_name: str) -> ScoringEngine:
        rc, factory_mesh = run_config, mesh
        path = rc.snapshot_path(model_name)
        plan_note = None
        if rc.plan_search:
            rc, factory_mesh, plan_note = _searched_run_config(rc, path,
                                                              mesh)
        impl, why = rc.attention_impl, f"--attention-impl {rc.attention_impl}"
        if impl == "flash":
            refusal = from_hf_config(load_hf_config(path))[1].flash_refusal()
            if refusal:
                impl, why = "xla", refusal
        print(f"# {model_name}: attention {impl} ({why})", file=sys.stderr,
              flush=True)
        family, cfg, params = load_model(
            path, dtype=rc.dtype, quant=rc.quant, attention_impl=impl,
            device=rc.device, mesh=factory_mesh)
        engine = ScoringEngine(
            family, cfg, params, load_tokenizer(path), device=rc.device,
            mesh=factory_mesh,
            engine_config=EngineConfig(
                batch_size=rc.batch_size,
                kv_dtype=rc.kv_dtype,
                prefill_chunk=rc.prefill_chunk,
                pooled_confidence=rc.pooled_confidence,
                phase2_pool_target=rc.phase2_pool_target,
                slot_repack=rc.slot_repack,
                decode_k=rc.decode_k,
            ))
        # with --plan-search the engine's OOM ladder (armed by default) is
        # the safety net for a prediction the card does not keep
        engine.plan_decision = plan_note
        if rc.decode_k > 1 and attach_k_head(engine, path):
            print(f"# K-head loaded from snapshot ({K_HEAD_FILENAME}, "
                  f"decode_k={rc.decode_k})", file=sys.stderr, flush=True)
        return engine

    return factory


def _searched_run_config(rc, path, mesh):
    """Apply the plan search to one model's engine construction: read the
    snapshot's geometry (``config.json`` only, no weights), search mesh x
    batch x kv-dtype x prefill-chunk x pool target x decode-k over the
    visible devices at the device's memory (``rc.hbm_bytes``, else the
    card's: without either it raises), on the route ``--attention-impl``
    takes, and rewrite the RunConfig fields to the chosen plan.  Returns
    (run_config, mesh, decision note): the meshes searched are those of
    the world's ranks (one process a rank), and a chosen mesh of more than
    one rank is built over them.  T5 geometries, which the budget model
    cannot price, keep the flags and ``mesh`` with a note on stderr; so
    does a search where nothing fits."""
    import dataclasses

    from .models.config import DecoderConfig, from_hf_config
    from .runtime.loader import load_hf_config
    from .parallel import make_mesh
    from .runtime.plan_search import (chosen_plan, format_candidate_table,
                                      require_ranks, search_plans)

    _family, dcfg = from_hf_config(load_hf_config(path))
    if not isinstance(dcfg, DecoderConfig):
        print(f"# plan search skipped for {path}: the budget model prices "
              f"decoder geometries only; running the configured flags",
              file=sys.stderr)
        return rc, mesh, None
    impl = "flash" if rc.attention_impl == "flash" else "xla"
    world = _world(rc)
    # the engine does not run the joint K-token decode on a mesh of more
    # than one rank yet: a world of ranks searches decode-k 1 only
    extra = {} if world == 1 else {"decode_ks": (1,)}
    ranked = search_plans(dcfg, rc.quant, world, workload="full", **extra,
                          hbm_bytes=rc.hbm_bytes, attention_impl=impl,
                          slot_repack=rc.slot_repack)
    best = chosen_plan(ranked)
    if best is None:
        print("# plan search: no candidate fits; running the configured "
              "flags", file=sys.stderr)
        return rc, mesh, None
    print(format_candidate_table(ranked, top=4), file=sys.stderr)
    require_ranks(best, world)
    rc = dataclasses.replace(
        rc, batch_size=best.batch, kv_dtype=best.kv_dtype,
        prefill_chunk=best.prefill_chunk,
        # unconditional: pool_target 0 is the chosen plan's pool-at-batch
        # configuration, not "keep the flag"
        phase2_pool_target=best.pool_target, decode_k=best.decode_k,
        mesh_model=best.model)
    if best.data * best.model > 1:
        mesh = make_mesh(data=best.data, model=best.model)
    note = (f"plan search chose mesh dp{best.data}xtp{best.model} batch "
            f"{best.batch} kv {best.kv_dtype} chunk {best.prefill_chunk}"
            + (f" decode-k {best.decode_k}" if best.decode_k > 1 else "")
            + f" ({best.reason})")
    print(f"# {note}", file=sys.stderr)
    return rc, mesh, note


def cmd_run_100q(args):
    from .sweeps import run_sweep

    rc = _run_config(args)
    rows = run_sweep(
        _engine_factory(rc),
        checkpoint_path=os.path.join(rc.output_dir, "base_vs_instruct_100q_checkpoint.json"),
        results_csv=os.path.join(rc.output_dir, "base_vs_instruct_100q_results.csv"),
    )
    if writing_rank():
        print(f"{len(rows)} rows")


def cmd_run_instruct_sweep(args):
    from .config import ordinary_meaning_questions
    from .sweeps import run_instruct_sweep

    rc = _run_config(args)
    if args.questions_file:
        if not args.results_csv:
            raise SystemExit(
                "--questions-file requires --results-csv: without it the "
                "custom-question run would overwrite the default sweep's "
                "instruct_model_comparison_results.csv"
            )
        with open(args.questions_file, encoding="utf-8") as f:
            prompts = [line.strip() for line in f if line.strip()]
    else:
        prompts = ordinary_meaning_questions()
    results_csv = args.results_csv or os.path.join(
        rc.output_dir, "instruct_model_comparison_results.csv")
    if args.results_csv:
        stem = os.path.splitext(os.path.basename(results_csv))[0]
        checkpoint = os.path.join(rc.output_dir, f"{stem}_checkpoint.json")
    else:
        checkpoint = os.path.join(rc.output_dir, "instruct_sweep_checkpoint.json")
    rows = run_instruct_sweep(
        _engine_factory(rc),
        prompts=prompts,
        checkpoint_path=checkpoint,
        results_csv=results_csv,
    )
    if writing_rank():
        print(f"{len(rows)} rows over {len(prompts)} questions")


def _distill_k_head(engine, rc, model, scenarios):
    """Distill the engine's K-head on the sweep's own texts (24 binary and
    12 confidence prompts: the continuations the decode legs replay) and
    write it beside the snapshot; a snapshot directory that cannot be
    written keeps the run going without it."""
    from .runtime.loader import save_k_head

    sample = [f"{r} {s['response_format']}" for s in scenarios
              for r in s["rephrasings"][:3]][:24]
    sample += [f"{r} {s['confidence_format']}" for s in scenarios
               for r in s["rephrasings"][:2]][:12]
    engine.distill_k_head_on(sample)
    print(f"# K-head distilled for decode_k={engine.ecfg.decode_k} on "
          f"{min(len(sample), 32)} sample prompts", file=sys.stderr,
          flush=True)
    try:
        saved = save_k_head(rc.snapshot_path(model), engine.k_head,
                            engine.ecfg.decode_k)
        print(f"# K-head persisted to {saved}", file=sys.stderr, flush=True)
    except OSError as err:
        print(f"# K-head not persisted ({err})", file=sys.stderr, flush=True)


def cmd_run_perturbation(args):
    from .config import legal_scenarios
    from .gen.rephrase import load_perturbations
    from .sweeps import (run_model_perturbation_sweep,
                         run_packed_perturbation_sweep)

    rc = _run_config(args)
    scenarios = load_perturbations(args.perturbations,
                                   expected_scenarios=legal_scenarios())
    engine = _engine_factory(rc)(args.model)
    # the engine's decode_k: --plan-search may have chosen one
    if engine.ecfg.decode_k > 1 and engine.k_head is None \
            and not engine.is_encoder_decoder:
        _distill_k_head(engine, rc, args.model, scenarios)
    if args.packed:
        rows, drift = run_packed_perturbation_sweep(
            engine, args.model, scenarios,
            output_xlsx=os.path.join(rc.output_dir,
                                     "perturbation_results_packed.xlsx"),
            packing=args.packed, drift_parity=args.packed_parity,
            max_rephrasings=args.max_rephrasings,
            score_chunk=args.score_chunk,
        )
        engine.close()
        if writing_rank():
            print(f"{len(rows)} rows (packed Q={args.packed})")
            if drift is not None:
                print(json.dumps({"packed_drift": drift}))
        return
    rows = run_model_perturbation_sweep(
        engine, args.model, scenarios,
        output_xlsx=os.path.join(rc.output_dir, "perturbation_results.xlsx"),
        max_rephrasings=args.max_rephrasings,
        score_chunk=args.score_chunk,
        confidence_max_new_tokens=args.confidence_max_new_tokens,
    )
    engine.close()
    if writing_rank():
        print(f"{len(rows)} rows")


def cmd_serve(args):
    """Continuous-batching scoring service (serve/): one resident model,
    independent requests coalescing onto its batch shapes.  The stdlib
    JSONL driver reads requests from --input (file or stdin) and answers
    every line in input order; --replay routes the perturbation sweep
    workload through the scheduler and asserts row-level parity with the
    offline score_prompts path; --load-rate drives the open-loop load
    harness; --pool-replicas N serves through an EnginePool of N
    shared-snapshot replicas (serve/pool.py: per-replica /healthz and
    labeled serve_* metrics, hot load/unload over the engine's
    teardown).  Under ``torchrun`` with ``--mesh-model``/``--mesh-seq``
    every rank loads its blocks and runs the scheduler; the mesh's first
    rank reads the requests, decides every launch and answers, and the
    other ranks follow its decisions (serve/scheduler.py)."""
    from .serve.cli import main as serve_main

    rc = _run_config(args)
    engine = _engine_factory(rc)(args.model)
    raise SystemExit(serve_main(engine, args))


def _add_serve_args(p: argparse.ArgumentParser):
    p.add_argument("--model", required=True,
                   help="model snapshot name under --checkpoint-dir")
    p.add_argument("--input", default="-",
                   help="JSONL request stream: one "
                        '{"prompt": ...}/{"prefix": ..., "suffix": ...} '
                        "object per line ('-' = stdin)")
    p.add_argument("--output", default="-",
                   help="JSONL results, input order ('-' = stdout)")
    p.add_argument("--max-batch", type=int, default=0, metavar="N",
                   help="rows per coalesced micro-batch (0 = the "
                        "engine's batch size)")
    p.add_argument("--max-wait-ms", type=float, default=20.0, metavar="MS",
                   help="admission policy: hold the head request at most "
                        "this long for co-batchable traffic before "
                        "launching a partial micro-batch")
    p.add_argument("--queue-capacity", type=int, default=2048, metavar="N",
                   help="admission bound; a submit past it is a typed "
                        "QueueFull backpressure rejection")
    p.add_argument("--timeout-s", type=float, default=None, metavar="S",
                   help="default per-request deadline (expired requests "
                        "are rejected with a typed DeadlineExceeded, "
                        "never silently dropped)")
    p.add_argument("--no-slot-admission", action="store_true",
                   help="disable slot-level mid-decode admission "
                        "(SchedulerConfig.slot_admission, default on): "
                        "eligible requests launch only at coalescer "
                        "boundaries instead of refilling vacated decode "
                        "slots")
    p.add_argument("--metrics-port", type=int, default=0, metavar="PORT",
                   help="serve /metrics (Prometheus text over the "
                        "telemetry counters, serve sample rings and "
                        "latency histograms) and /healthz (scheduler or "
                        "pool liveness and queue age) on this loopback "
                        "port while the command runs (0 = off)")
    p.add_argument("--replay", metavar="PERTURBATIONS", default=None,
                   help="replay mode: push the perturbation sweep "
                        "workload through the scheduler, assert "
                        "row-level parity vs the offline path, and "
                        "report scheduler-vs-offline throughput")
    p.add_argument("--max-rephrasings", type=int, default=None,
                   help="replay mode: cap rephrasings per scenario")
    p.add_argument("--load-rate", metavar="R[,R2,...]", default=None,
                   help="open-loop load harness (serve/load.py): drive "
                        "the scheduler at a seeded-Poisson offered rate "
                        "(requests/s) drawn from the --replay corpus (or "
                        "the --input lines) and report per-request "
                        "latency anatomy (queue_wait/coalesce/"
                        "serve_engine/respond); a comma list of >= 3 "
                        "rates walks the rate sweep and reports the knee")
    p.add_argument("--load-duration", type=float, default=10.0,
                   metavar="S",
                   help="load mode: seconds of offered traffic per rate "
                        "point")
    p.add_argument("--load-seed", type=int, default=0, metavar="N",
                   help="load mode: seed for the Poisson schedule and "
                        "the prompt mix (same seed = identical traffic)")
    p.add_argument("--load-jsonl", metavar="PATH", default=None,
                   help="load mode: stream one per-request anatomy "
                        "record (scheduled time, generator lag, e2e + "
                        "per-phase ms) per line to PATH")
    p.add_argument("--pool-replicas", type=int, default=0, metavar="N",
                   help="serve through an EnginePool (serve/pool.py) of "
                        "N local replicas of the loaded snapshot, sharing "
                        "its weight tensors, each behind its own "
                        "scheduler with {replica, model} labeled serve_* "
                        "metrics (0/1 = one scheduler)")
    p.add_argument("--supervise", action="store_true",
                   help="arm self-healing on the --pool-replicas fleet "
                        "(serve/supervisor.py): crashed or wedged "
                        "replicas are quarantined and rebuilt from the "
                        "shared snapshot with backoff, their requests "
                        "fail over to a sibling at most once, and a "
                        "request that kills replicas repeatedly is "
                        "rejected as poisonous")


def cmd_run_api_perturbation(args):
    from .api_backends.cost import CostTracker
    from .api_backends.openai_client import OpenAIClient
    from .config import legal_scenarios
    from .gen.rephrase import load_perturbations
    from .sweeps.api_perturbation import run_api_perturbation_sweep

    key = os.environ.get("OPENAI_API_KEY")
    if not key:
        raise SystemExit("OPENAI_API_KEY not set")
    scenarios = load_perturbations(args.perturbations,
                                   expected_scenarios=legal_scenarios())
    cost = CostTracker()
    run_api_perturbation_sweep(
        OpenAIClient(key), args.model, scenarios, args.output,
        max_rephrasings=args.max_rephrasings,
        skip_reasoning_logprobs=not args.reasoning_logprob_runs,
        cost_tracker=cost,
    )
    print(cost.summary())


def cmd_run_claude_perturbation(args):
    from .api_backends.anthropic_client import AnthropicClient
    from .config import legal_scenarios
    from .gen.rephrase import load_perturbations
    from .sweeps.api_perturbation import run_claude_perturbation_sweep

    key = os.environ.get("ANTHROPIC_API_KEY")
    if not key:
        raise SystemExit("ANTHROPIC_API_KEY not set")
    scenarios = load_perturbations(args.perturbations,
                                   expected_scenarios=legal_scenarios())
    run_claude_perturbation_sweep(
        AnthropicClient(key), args.model, scenarios, args.output,
        max_rephrasings=args.max_rephrasings,
    )


def cmd_generate_rephrasings(args):
    from .api_backends.anthropic_client import AnthropicClient
    from .config import legal_scenarios
    from .gen.rephrase import generate_rephrasings, save_perturbations

    key = os.environ.get("ANTHROPIC_API_KEY")
    if not key:
        raise SystemExit("ANTHROPIC_API_KEY not set")
    client = AnthropicClient(key)

    def complete(prompt):
        # one rephrasing session: temperature 0.9, up to 4000 tokens
        msg = client.create_message(
            args.model, [{"role": "user", "content": prompt}],
            temperature=0.9, max_tokens=4000,
        )
        return client.text_of(msg)

    records = generate_rephrasings(
        legal_scenarios(), complete,
        sessions_per_scenario=args.sessions,
        target_per_scenario=args.target,
        on_error=lambda s, e: print(f"session {s} failed: {e}"),
    )
    save_perturbations(records, args.output)
    print(f"wrote {args.output}: "
          + ", ".join(str(len(r["rephrasings"])) for r in records)
          + " rephrasings per scenario")


def cmd_run_gpt_perturbation(args):
    from .api_backends.openai_client import OpenAIClient
    from .config import legal_scenarios
    from .gen.rephrase import load_perturbations
    from .sweeps.api_perturbation import run_gpt_perturbation_sweep

    key = os.environ.get("OPENAI_API_KEY")
    if not key:
        raise SystemExit("OPENAI_API_KEY not set")
    scenarios = load_perturbations(args.perturbations,
                                   expected_scenarios=legal_scenarios())
    run_gpt_perturbation_sweep(
        OpenAIClient(key), args.model, scenarios, args.output,
        rate_limit_sleep=args.sleep,
        max_rephrasings=args.max_rephrasings,
    )


def cmd_run_gemini_perturbation(args):
    from .api_backends.gemini_client import GeminiClient
    from .config import legal_scenarios
    from .gen.rephrase import load_perturbations
    from .sweeps.api_perturbation import run_gemini_perturbation_sweep

    key = os.environ.get("GEMINI_API_KEY")
    if not key:
        raise SystemExit("GEMINI_API_KEY not set")
    scenarios = load_perturbations(args.perturbations,
                                   expected_scenarios=legal_scenarios())
    run_gemini_perturbation_sweep(
        GeminiClient(key, requests_per_second=args.rps), args.model, scenarios,
        args.output, max_workers=args.threads,
        max_rephrasings=args.max_rephrasings,
    )


def cmd_generate_irrelevant(args):
    from .config import irrelevant_scenarios, irrelevant_statements
    from .gen.irrelevant import (
        generate_perturbations,
        save_perturbations,
        save_readable,
    )

    perturbed = generate_perturbations(irrelevant_scenarios(), irrelevant_statements())
    save_perturbations(perturbed, args.output)
    total = sum(len(s["perturbations_with_irrelevant"]) for s in perturbed)
    print(f"{total} perturbations -> {args.output}")
    if args.readable_output:
        import datetime

        save_readable(
            perturbed, args.readable_output,
            generated_at=datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        )
        print(f"readable dump -> {args.readable_output}")


def cmd_repair_batch(args):
    """Rewrite a corrupted batch-response JSONL: re-pair each row with its
    request's custom_id and recover the reply text."""
    from .api_backends.gemini_client import repair_batch_responses

    n = repair_batch_responses(args.requests, args.responses, args.output)
    print(f"repaired {n} rows -> {args.output}")


def cmd_sample_statements(args):
    """Seeded LaTeX sample of the irrelevant statements for the appendix
    (data/generate_latex_statements.py)."""
    from .config import irrelevant_statements
    from .viz.latex import irrelevant_statements_sample

    tex = irrelevant_statements_sample(
        irrelevant_statements(), k=args.k, seed=args.seed
    )
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(tex + "\n")
        print(f"wrote {args.output}")
    else:
        print(tex)


def cmd_power_analysis(args):
    """Sample-size / power report (power_analysis.py:10-278) from pilot MAEs;
    writes power_analysis_report.tex."""
    from .config import power_pilot_results
    from .stats import power_report

    if args.pilot_json:
        with open(args.pilot_json) as f:
            pilot = json.load(f)
    else:
        pilot = power_pilot_results()
    os.makedirs(args.output_dir, exist_ok=True)
    tex = os.path.join(args.output_dir, "power_analysis_report.tex")
    report = power_report(
        pilot["models"], baseline_mae=pilot["baseline_mae"],
        sample_size=pilot["sample_size"], alpha=args.alpha,
        n_simulations=args.simulations, output_tex=tex,
    )
    for name, analysis in report["models"].items():
        n80 = analysis["sample_sizes"]["power_80"]["raw"]
        print(f"{name}: effect d={analysis['effect_size']:.3f}, "
              f"power@N={pilot['sample_size']} "
              f"{analysis['achieved_power']:.2f}, N(80%)={n80}")
    rec = report["recommendation"]["power_80"]
    print(f"recommendation (80% power): N={rec['with_margin']} "
          f"(limiting model: {rec['limiting_model']})")
    print(f"wrote {tex}")


def _write_json(obj, path):
    """Shared artifact writer: parent dir, utf-8, indent-2, strict JSON
    (non-finite floats become null — utils/strict_json)."""
    from .utils.strict_json import dump_strict

    dump_strict(obj, path)
    print(f"wrote {path}")


def _read_workbook(path):
    """A workbook's rows typed as the JAX package's ``read_xlsx`` frame."""
    from .utils import frame
    from .utils.xlsx import read_xlsx

    columns, rows = read_xlsx(path)
    return frame.records(rows, columns)[1]


def cmd_analyze_survey(args):
    from .survey.pipeline import run_consolidated_analysis

    run_consolidated_analysis(
        [args.survey1_csv, args.survey2_csv], args.llm_csv, args.output_dir,
        n_bootstrap=args.bootstrap, cross_prompt_bootstrap=args.cross_prompt_bootstrap,
    )


def cmd_analyze_combined(args):
    from .analysis.combined_confidence import run_combined_analysis
    from .utils import frame

    frames = {}
    for spec in args.workbook:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise SystemExit(f"--workbook expects NAME=PATH, got {spec!r}")
        if name in frames:
            raise SystemExit(f"duplicate workbook name {name!r}")
        frames[name] = _read_workbook(path)
    out = run_combined_analysis(frames, args.output_dir)
    print(frame.to_string(*frame.records(out["stats"]), index=False))


def cmd_demographics(args):
    from .survey.demographics import (
        demographics_latex_table,
        load_demographics,
        summarize_age,
    )

    df = load_demographics(list(args.csv))
    columns = args.column or ["Sex", "Ethnicity simplified", "Employment status",
                              "Student status"]
    tex = demographics_latex_table(df, columns)
    age = summarize_age(df)
    age_block = (
        "\n% Age summary (reference generate_demographics_table.py:115-120)\n"
        f"% n={age['n']} mean={age['mean']:.1f} median={age['median']:.0f} "
        f"range {age['min']:.0f}-{age['max']:.0f}\n"
    )
    tex = tex + age_block
    if args.output:
        with open(args.output, "w") as f:
            f.write(tex)
        print(f"wrote {args.output}")
    else:
        print(tex)


def cmd_analyze_perturbations(args):
    from .analysis import analyze_workbook
    from .config import legal_scenarios

    df = _read_workbook(args.workbook)
    out = analyze_workbook(df, legal_scenarios(), args.output_dir,
                           n_simulations=args.simulations)
    print(json.dumps({m: len(r["scenarios"]) for m, r in out.items()}, indent=2))


def cmd_similarity(args):
    from .analysis import similarity_report
    from .analysis.similarity_report import load_embedding_model
    from .config import legal_scenarios
    from .gen.rephrase import load_perturbations
    from .utils import frame

    embedding_model = None
    if args.embeddings:
        # gated exactly like the reference: absent package / unloadable
        # model degrades to the lexical metrics with a warning
        embedding_model = load_embedding_model(args.embedding_model)
    records = load_perturbations(args.perturbations, expected_scenarios=legal_scenarios())
    summary = similarity_report(records, args.output_dir,
                                max_rephrasings=args.max_rephrasings,
                                embedding_model=embedding_model)
    print(frame.to_string(*frame.records(summary), index=False))


def _mae_100q_families(results_csv, survey_csvs):
    """Shared Table-5 machinery: survey loading + exclusions + human means
    (0-1) + question matching + per-family paired bootstrap
    (analyze_base_vs_instruct_mae_100q.py:421-560)."""
    from .survey import (
        analyze_families,
        apply_exclusion_criteria,
        human_responses_by_question,
        load_and_clean_survey_data,
        match_survey_to_llm_questions,
    )

    df, cols = load_and_clean_survey_data(survey_csvs)
    df, excl = apply_exclusion_criteria(df, cols)
    model_df = _load_llm_csv(results_csv)
    matches, _ = match_survey_to_llm_questions(model_df, survey_csvs)
    human = human_responses_by_question(df, cols)
    human_avgs = {q: s["mean"] / 100.0 for q, s in human.items()}  # 0-100 → 0-1
    families = analyze_families(model_df, human_avgs, matches)
    meta = {
        "respondents": int(excl["final_count"]),
        "questions_with_humans": len(human_avgs),
        "matched_prompts": len(matches),
        "model_rows": len(model_df),
    }
    return families, meta


def cmd_analyze_100q(args):
    from .stats.bootstrap import base_vs_instruct_analysis
    from .utils import frame

    _, df = frame.read_csv(args.results)
    out = base_vs_instruct_analysis(df)
    print(json.dumps(out, indent=2, default=float))
    if args.output_json:
        _write_json(out, args.output_json)
    if args.latex:
        # Table 5 needs human survey means — delegate to the real machinery
        # (the old mapping printed NaN MAE columns from bootstrap-only keys)
        if not args.survey1_csv:
            raise SystemExit(
                "--latex emits paper Table 5 (MAE vs human means): pass "
                "--survey1-csv/--survey2-csv, or use the analyze-mae-100q "
                "subcommand"
            )
        from .viz.latex import base_vs_instruct_table

        surveys = [args.survey1_csv] + (
            [args.survey2_csv] if args.survey2_csv else []
        )
        families, _ = _mae_100q_families(args.results, surveys)
        print(base_vs_instruct_table(families))


def cmd_run_closed_source(args):
    """The frontier-API 100-question evaluation (Tables 3-4's data leg):
    the vendors' binary and confidence replies a question, cached with
    partial re-runs, then the results CSV, correlations, MAE against the
    human means, the LaTeX tables and the figures."""
    import time

    from .analysis.closed_source_eval import run_closed_source_evaluation
    from .analysis.questions import (
        load_human_survey_means,
        load_ordinary_meaning_questions,
    )
    from .api_backends.anthropic_client import AnthropicClient
    from .api_backends.gemini_client import GeminiClient
    from .api_backends.openai_client import OpenAIClient

    questions = load_ordinary_meaning_questions(
        instruct_csv=args.questions_csv, survey2_csv=args.survey2_csv,
    )
    human_means = load_human_survey_means(args.survey1_csv, args.survey2_csv)

    def client(env, cls):
        key = os.environ.get(env)
        return cls(key) if key else None

    run_closed_source_evaluation(
        questions,
        output_dir=args.output_dir,
        human_means=human_means,
        cache_file=os.path.join(args.output_dir, "api_cache.json"),
        confirm_fn=None if args.yes else (
            lambda prompt: input(prompt).strip().lower() == "yes"
        ),
        gpt_client=client("OPENAI_API_KEY", OpenAIClient),
        gemini_client=client("GEMINI_API_KEY", GeminiClient),
        claude_client=client("ANTHROPIC_API_KEY", AnthropicClient),
        sleep=time.sleep,           # real per-vendor pacing outside tests
    )


def cmd_run_irrelevant(args):
    """The irrelevant-insertion study end to end (Appendix C's data leg):
    3,400 perturbations x {response, confidence} legs over GPT-4.1 /
    Claude Opus 4.1 / Gemini 2.5 Pro at temperature 0.7, triple-set resume,
    and the full artifact set (raw/summary CSVs, three-sheet workbook,
    analysis.json, reports, stacked violins)."""
    from .analysis.irrelevant_eval import (
        build_vendor_evaluators,
        create_stacked_visualization,
        run_irrelevant_evaluation,
    )
    from .gen.irrelevant import load_perturbations

    out = args.output_dir
    analysis_json = os.path.join(out, "analysis.json")
    raw_csv = os.path.join(out, "raw_results.csv")

    if args.regenerate_plots:
        # plots only, from the saved analysis
        if not os.path.exists(analysis_json):
            raise SystemExit(f"no analysis at {analysis_json}; run the evaluation first")
        with open(analysis_json) as f:
            analysis = json.load(f)
        fig = create_stacked_visualization(analysis, out)
        print(f"regenerated {fig}")
        return

    fresh_start = args.no_resume or args.clear_checkpoint
    if args.load_existing and not args.force_rerun and not fresh_start:
        # loading saved results is the default; a new evaluation only
        # starts when nothing is saved, --force-rerun asks, or a fresh
        # start (--no-resume/--clear-checkpoint) signals intent to
        # re-evaluate
        if os.path.exists(raw_csv) and os.path.exists(analysis_json):
            from .utils import frame

            _, rows = frame.read_csv(raw_csv)
            with open(analysis_json) as f:
                analysis = json.load(f)
            for model in args.models:
                sub = [r for r in rows if r["model"] == model]
                if len(sub):
                    scenarios = frame.unique(frame.dropna(
                        [r["scenario_name"] for r in sub]))
                    print(f"{model.upper()}: {len(sub)} evaluations across "
                          f"{len(scenarios)} scenarios")
            fig = create_stacked_visualization(analysis, out)
            print(f"loaded {len(rows)} results from {raw_csv}; figure: {fig}")
            print("to force re-running evaluations, use: --force-rerun")
            return

    scenarios = load_perturbations(args.perturbations)

    def key_for(env):
        key = os.environ.get(env)
        if key is None:
            raise SystemExit(f"{env} not set")
        return key

    clients = {}
    if "gpt" in args.models:
        from .api_backends.openai_client import OpenAIClient

        clients["gpt_client"] = OpenAIClient(key_for("OPENAI_API_KEY"))
    if "claude" in args.models:
        from .api_backends.anthropic_client import AnthropicClient

        clients["claude_client"] = AnthropicClient(key_for("ANTHROPIC_API_KEY"))
    if "gemini" in args.models:
        from .api_backends.gemini_client import GeminiClient

        clients["gemini_client"] = GeminiClient(key_for("GEMINI_API_KEY"))

    # Destroy saved state only after inputs/keys validated above — a typo'd
    # path or missing key must fail fast WITHOUT erasing paid-for results.
    if fresh_start:
        for name in ("processed_triples.json", "progress.json",
                     "raw_results.csv", "analysis.json"):
            path = os.path.join(out, name)
            if os.path.exists(path):
                os.remove(path)
        print("cleared resume state")
    import time

    evaluators = build_vendor_evaluators(sleep=time.sleep, **clients)
    test_mode = args.test_mode and not args.full_mode
    if args.limit is not None and not args.full_mode:
        # an explicit cap implies a limited run — it must never silently
        # escalate into the full 3,400x3x2 paid sweep; only an explicit
        # --full-mode overrides it
        test_mode = True
    paths = run_irrelevant_evaluation(
        evaluators, scenarios, out,
        limit_total=(args.limit if args.limit is not None else 100)
        if test_mode else None,
    )
    print(json.dumps(paths, indent=2))


def cmd_verify_replication(args):
    """One-command replication verifier: recompute every headline table
    through the port's pipeline and diff against the published numbers
    with CI-overlap PASS/FAIL verdicts.  With --snapshots, the Table-5
    sweep first runs for real through the port's engine (on the card by
    default); otherwise the Table-5 rows report SKIP unless --results-100q
    names a finished sweep's CSV."""
    from .analysis.replication import (
        format_report,
        run_snapshot_sweep,
        verify_replication,
    )

    results_100q = args.results_100q
    if args.snapshots:
        args.checkpoint_dir = args.snapshots
        rc = _run_config(args)
        results_100q = run_snapshot_sweep(rc, args.output_dir)
    result = verify_replication(
        reference_root=args.reference_root,
        results_100q_csv=results_100q,
        n_bootstrap=args.bootstrap,
        cross_prompt_bootstrap=args.cross_prompt_bootstrap,
    )
    print(format_report(result))
    if args.output_json:
        _write_json(result, args.output_json)
    if not result["ok"]:
        raise SystemExit(1)


def cmd_analyze_mae_100q(args):
    """Paper Table 5 end-to-end: per-family base→instruct MAE vs human means
    with paired bootstrap — analyze_base_vs_instruct_mae_100q.py's main."""
    from .viz.latex import base_vs_instruct_table

    surveys = [args.survey1_csv] + ([args.survey2_csv] if args.survey2_csv else [])
    families, meta = _mae_100q_families(args.results, surveys)
    print(f"Respondents after exclusions: {meta['respondents']}")
    print(f"Questions with human responses: {meta['questions_with_humans']}")
    print(f"Matched prompts: {meta['matched_prompts']}")
    for fam, rec in families.items():
        if fam.startswith("_"):
            continue
        if rec.get("excluded"):
            print(f"{fam}: excluded ({rec.get('reason', '')})")
            continue
        print(
            f"{fam}: base {rec['base_mae']:.3f} -> instruct "
            f"{rec['instruct_mae']:.3f}  diff {rec['observed_diff']:+.3f} "
            f"[{rec['ci_lower']:+.3f}, {rec['ci_upper']:+.3f}] "
            f"p={rec['p_value']:.4f} (n={rec['n']})"
        )
    overall = families.get("_overall")
    if overall:
        print(
            f"Overall: base {overall['base_mae']:.3f} -> instruct "
            f"{overall['instruct_mae']:.3f}  diff {overall['observed_diff']:+.3f} "
            f"[{overall['ci_lower']:+.3f}, {overall['ci_upper']:+.3f}] "
            f"p={overall['p_value']:.4f}"
        )
    if args.latex or args.output_tex:
        table = base_vs_instruct_table(families)
        if args.output_tex:
            with open(args.output_tex, "w", encoding="utf-8") as f:
                f.write(table + "\n")
            print(f"wrote {args.output_tex}")
        if args.latex:
            print(table)
    if args.output_json:
        _write_json({"families": families, "meta": meta}, args.output_json)


def cmd_extract_survey2(args):
    """Pull the part-2 questions out of the Qualtrics headers
    (analysis/extract_survey2_questions.py:9-82)."""
    from .analysis.questions import extract_survey2_questions

    questions, _ = extract_survey2_questions(args.survey_csv)
    if getattr(args, "ascii_quotes", False):
        table = str.maketrans({"“": '"', "”": '"',
                               "‘": "'", "’": "'"})
        questions = [q.translate(table) for q in questions]
    parent = os.path.dirname(os.path.abspath(args.output))
    os.makedirs(parent, exist_ok=True)
    with open(args.output, "w", encoding="utf-8") as f:
        f.write("\n".join(questions) + "\n")
    print(f"wrote {len(questions)} questions -> {args.output}")


def _load_llm_csv(path):
    """Model-results rows with relative_prob guaranteed: recomputed from the
    raw probs when yes/no columns exist, a NaN quotient (both zero, or a
    missing probability) at 0.5 (analyze_base_vs_instruct_mae_100q.py:212-222)."""
    import numpy as np

    from .utils import frame

    columns, rows = frame.read_csv(path)
    if {"yes_prob", "no_prob"}.issubset(columns):
        yes = np.asarray(frame.column(rows, "yes_prob"), dtype=float)
        no = np.asarray(frame.column(rows, "no_prob"), dtype=float)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = yes / (yes + no)
        for r, v in zip(rows, np.where(np.isnan(rel), 0.5, rel)):
            r["relative_prob"] = float(v)
    return rows


def _load_clean_survey(survey_csvs):
    from .survey import apply_exclusion_criteria, load_and_clean_survey_data
    from .survey.pipeline import extract_question_text

    df, cols = load_and_clean_survey_data(survey_csvs)
    df, excl = apply_exclusion_criteria(df, cols)
    mapping = extract_question_text(survey_csvs)
    return df, cols, mapping, excl


def cmd_analyze_3way(args):
    """Base-vs-instruct-vs-human 3-way comparison
    (analyze_base_vs_instruct_vs_human.py as a subcommand)."""
    from .survey import three_way_report
    from .utils import frame

    surveys = [args.survey1_csv] + ([args.survey2_csv] if args.survey2_csv else [])
    survey_df, cols, mapping, _ = _load_clean_survey(surveys)
    llm_df = _load_llm_csv(args.llm_csv)
    out = three_way_report(llm_df, survey_df, cols, mapping, args.output_dir,
                           make_figures=not args.no_figures)
    print(f"Loaded human data for {out['human_questions']} questions")
    print("Model correlations with human responses:")
    print(frame.to_string(*frame.records(out["correlations"])))
    print(f"Found {len(out['invalid_responses'])} invalid responses "
          f"(not containing Yes/No)")
    for row in out["distribution_stats"]:
        line = (f"{row['model']}: mean {row['mean']:.3f}, std {row['std']:.3f}, "
                f"range [{row['min']:.3f}, {row['max']:.3f}]")
        if row["warning"]:
            line += f"  WARNING: {row['warning']}"
        print(line)
    print(f"wrote {out['correlations_csv']}")
    if out.get("figure"):
        print(f"figure: {out['figure']}")


def cmd_analyze_agreement(args):
    """Point-estimate + question-bootstrap LLM/human agreement reports
    (analyze_llm_human_agreement.py + analyze_llm_agreement_simple_bootstrap.py
    as one subcommand; both reference JSON shapes)."""
    from .survey.variants import (
        agreement_question_bootstrap,
        human_agreement_means,
        human_agreement_report,
        save_agreement_json,
    )
    from .utils import frame

    os.makedirs(args.output_dir, exist_ok=True)
    instruct_df = _load_llm_csv(args.llm_csv)
    base_df = frame.read_csv(args.base_csv)[1] if args.base_csv else None
    means = human_agreement_means([args.survey_csv], instruct_df)
    print(f"Loaded human average ratings for {len(means)} questions")

    point = human_agreement_report(instruct_df, base_df, means)
    point_path = os.path.join(args.output_dir, "llm_human_agreement_analysis.json")
    save_agreement_json({k: v for k, v in point.items() if k != "detailed"},
                        point_path)
    print(f"{'Model':<45} {'Type':<9} {'MAE':<8} {'RMSE':<8} {'Pearson r':<10}")
    for r in point["model_results"]:
        print(f"{r['model']:<45} {r['model_type']:<9} {r['mae']:<8.4f} "
              f"{r['rmse']:<8.4f} {r['pearson_r']:<10.4f}")

    boot = agreement_question_bootstrap(
        instruct_df, base_df, means,
        n_bootstrap=args.bootstrap, seed=args.seed,
    )
    boot_path = os.path.join(args.output_dir, "llm_human_agreement_bootstrap.json")
    save_agreement_json(boot, boot_path)
    for metric, rec in boot["overall_comparison"]["metrics"].items():
        print(f"{metric.upper()}: base {rec['base_mean']:.4f} vs instruct "
              f"{rec['instruct_mean']:.4f}, diff {rec['difference']:+.4f} "
              f"[{rec['difference_ci'][0]:+.4f}, {rec['difference_ci'][1]:+.4f}], "
              f"p = {rec['p_value']:.4f}")
    print(f"wrote {point_path}")
    print(f"wrote {boot_path}")


def cmd_analyze_family_differences(args):
    """Respondent-level agreement bootstrap + per-family MAE/MSE/MAPE
    differences (analyze_llm_human_agreement_bootstrap.py +
    analyze_model_family_differences.py)."""
    from .survey import (
        agreement_bootstrap,
        family_differences,
        family_differences_text,
    )
    from .survey.variants import save_agreement_json

    os.makedirs(args.output_dir, exist_ok=True)
    agreement_path = os.path.join(args.output_dir,
                                  "llm_human_agreement_bootstrap.json")
    if args.agreement_json:
        with open(args.agreement_json) as f:
            agreement = json.load(f)
    else:
        if not (args.llm_csv and args.survey1_csv):
            raise SystemExit(
                "pass --llm-csv and --survey1-csv, or --agreement-json"
            )
        surveys = [args.survey1_csv] + (
            [args.survey2_csv] if args.survey2_csv else []
        )
        survey_df, cols, mapping, _ = _load_clean_survey(surveys)
        llm_df = _load_llm_csv(args.llm_csv)
        agreement = agreement_bootstrap(
            llm_df, survey_df, cols, mapping,
            n_bootstrap=args.bootstrap,
        )
        save_agreement_json(agreement, agreement_path)
        print(f"wrote {agreement_path}")
    records = family_differences(agreement)
    text = family_differences_text(records)
    print(text)
    report_path = os.path.join(args.output_dir, "family_differences.txt")
    with open(report_path, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"wrote {report_path}")


def cmd_ground_truth_figure(args):
    """Ground-truth distribution figures
    (visualize_ground_truth_distribution.py)."""
    from .survey import ground_truth_figures, ground_truth_values

    surveys = [args.survey1_csv] + ([args.survey2_csv] if args.survey2_csv else [])
    survey_df, cols, _, _ = _load_clean_survey(surveys)
    values = ground_truth_values(survey_df, cols)
    if not values.size:
        raise SystemExit("no human ground-truth values found")
    out = ground_truth_figures(values, args.output_dir)
    print(f"Loaded {out['n']} human ground truth values")
    print(f"Mean: {out['mean']:.3f} ({out['mean'] * 100:.1f}%)")
    print(f"Std:  {out['std']:.3f} ({out['std'] * 100:.1f}%)")
    print(f"figures: {out['two_panel']}, {out['simple']}")


def cmd_model_comparison(args):
    """Inter-model correlation engine as a runnable leg
    (model_comparison_graph.py:389-494): pairwise Pearson/Spearman, bootstrap
    summary, pairwise+aggregate kappa, heatmap/distribution/strip figures."""
    from .analysis import model_comparison_report
    from .utils import frame

    _, df = frame.read_csv(args.results)
    reference_model = args.reference_model
    if reference_model is None:
        # reference default: a Baichuan model anchors the strip plot when
        # present (model_comparison_graph.py:59-79)
        baichuan = [m for m in frame.unique(frame.column(df, "model"))
                    if "baichuan" in m.lower()]
        reference_model = baichuan[0] if baichuan else None
    report = model_comparison_report(
        df, args.output_dir, n_bootstrap=args.bootstrap,
        reference_model=reference_model, make_figures=not args.no_figures,
    )
    s = report["summary"]
    print(f"{len(report['pairwise'])} model pairs")
    print(f"mean correlation {s['mean']:.3f} "
          f"[{s['mean_ci'][0]:.3f}, {s['mean_ci'][1]:.3f}], "
          f"median {s['median']:.3f}, std {s['std']:.3f}")
    print(f"mean kappa {report['kappa']['mean_kappa']:.3f}")
    for key in ("heatmap", "distribution", "difference_strip"):
        if report.get(key):
            print(f"figure: {report[key]}")
    print(f"wrote {args.output_dir}/pairwise_correlations.csv, "
          f"correlation_summary.json")


def cmd_cross_kappa(args):
    """Cross-experiment Cohen's kappa (calculate_cohens_kappa.py): merge
    result frames from multiple experiments, binarize at the threshold, and
    bootstrap the aggregate agreement."""
    from .analysis import cross_experiment_kappa
    from .utils import frame

    frames = [frame.read_csv(path)[1] for path in args.results]
    kappa = cross_experiment_kappa(
        frames, threshold=args.threshold, n_bootstrap=args.bootstrap,
    )
    out = {
        "n_frames": len(frames),
        "mean_kappa": kappa["mean_kappa"],
        "mean_kappa_ci": kappa["mean_kappa_ci"],
        "n_pairs": len(kappa["pairs"]),
    }
    print(json.dumps(out, indent=2, default=float))
    if args.output_json:
        _write_json({**out, "pairs": kappa["pairs"]}, args.output_json)


def cmd_lint(args):
    """The port's static-analysis gate (lint/).  In practice unreachable:
    ``main()`` routes ``lint`` to :mod:`.lint.cli` before argparse runs,
    because REMAINDER cannot take leading optionals like ``--explain``;
    the subparser exists so the subcommand shows in ``--help``."""
    from .lint.cli import main as lint_main

    raise SystemExit(lint_main(args.lint_args))


def cmd_plan(args):
    """``plan search``: the plan search (runtime/plan_search.py).  In
    practice unreachable: ``main()`` routes ``plan`` before argparse runs;
    the subparser exists so the subcommand shows in ``--help``."""
    from .runtime.plan_search import main as plan_main

    raise SystemExit(plan_main(args.plan_args))


def cmd_obs(args):
    """``obs report`` / ``obs bench-diff``: the phase-attribution table
    over a saved span trace, and the bench-trajectory regression analyzer
    over BENCH_r*.json records.  In practice unreachable — ``main()``
    routes ``obs`` to :mod:`.obs.report` before argparse runs (REMAINDER
    cannot take leading optionals like ``--trace``); the subparser exists
    so the subcommand shows in ``--help``."""
    from .obs.report import main as obs_main

    raise SystemExit(obs_main(args.obs_args))


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "lint":
        # routed before argparse: REMAINDER cannot swallow leading
        # optionals (`lint --explain all` would error against the parent
        # parser), and the linter needs none of the run-config machinery
        from .lint.cli import main as lint_main

        raise SystemExit(lint_main(argv[1:]))
    if argv and argv[0] == "obs":
        # same pre-argparse routing as lint: `obs report --trace PATH`
        # leads with an optional the parent parser would reject
        from .obs.report import main as obs_main

        raise SystemExit(obs_main(argv[1:]))
    if argv and argv[0] == "plan":
        # same pre-argparse routing: the plan search is host arithmetic
        # and needs none of the run-config machinery
        from .runtime.plan_search import main as plan_main

        raise SystemExit(plan_main(argv[1:]))
    parser = argparse.ArgumentParser(prog="llm_interpretation_replication_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run-100q", help="base-vs-instruct 100-question sweep")
    _add_run_config_args(p)
    p.set_defaults(fn=cmd_run_100q)

    p = sub.add_parser(
        "verify-replication",
        help="recompute Tables 3-5 + appendix numbers and PASS/FAIL each "
             "against the published values by CI overlap")
    _add_run_config_args(p)
    from .analysis.replication import DEFAULT_REFERENCE_ROOT

    p.add_argument("--reference-root", default=DEFAULT_REFERENCE_ROOT,
                   help="mounted reference repo with the recorded artifacts")
    p.add_argument("--snapshots", default=None, metavar="DIR",
                   help="local HF checkpoint dir: run the real Table-5 sweep "
                        "(run-100q) through the engine first")
    p.add_argument("--results-100q", default=None,
                   help="existing base_vs_instruct_100q_results.csv from a "
                        "finished run-100q sweep (alternative to --snapshots)")
    p.add_argument("--bootstrap", type=int, default=10_000,
                   help="MAE bootstrap resamples (paper value)")
    p.add_argument("--cross-prompt-bootstrap", type=int, default=200,
                   help="cross-prompt bootstrap resamples (the full "
                        "pipeline's 1000 takes minutes; point estimates are "
                        "deterministic either way)")
    p.add_argument("--output-json", default=None)
    p.set_defaults(fn=cmd_verify_replication)

    p = sub.add_parser("run-instruct-sweep", help="instruct-model roster sweep")
    _add_run_config_args(p)
    p.add_argument("--questions-file", default=None,
                   help="newline-delimited question list (e.g. the survey-2 "
                        "questions); default: the 100 ordinary-meaning "
                        "questions")
    p.add_argument("--results-csv", default=None,
                   help="output CSV path; the checkpoint file is named after "
                        "its basename, so two question sets can share an "
                        "output dir")
    p.set_defaults(fn=cmd_run_instruct_sweep)

    p = sub.add_parser("run-closed-source",
                       help="frontier-API 100-question evaluation (keys via env)")
    p.add_argument("--questions-csv", required=True,
                   help="instruct_model_comparison_results.csv (first 50 questions)")
    p.add_argument("--survey2-csv", required=True,
                   help="survey part-2 export (remaining questions)")
    p.add_argument("--survey1-csv", required=True,
                   help="survey part-1 export (human means for the MAE tables)")
    p.add_argument("--output-dir", default="results/closed_source_evaluation")
    p.add_argument("--yes", action="store_true", help="skip the cost confirmation")
    p.set_defaults(fn=cmd_run_closed_source)

    p = sub.add_parser("run-perturbation", help="10k-perturbation local-model sweep")
    _add_run_config_args(p)
    p.add_argument("--model", required=True)
    p.add_argument("--perturbations", required=True)
    p.add_argument("--max-rephrasings", type=int, default=None)
    p.add_argument("--score-chunk", type=int, default=2000,
                   help="rows per cross-scenario scoring call: bounds crash "
                        "loss (a crash loses the chunk in flight)")
    p.add_argument("--confidence-max-new-tokens", type=int, default=10,
                   metavar="N",
                   help="generation cap of the confidence leg; 0 = the "
                        "engine's max_new_tokens")
    p.add_argument("--packed", type=int, default=0, metavar="Q",
                   help="> 0: packed multi-question scoring: Q rephrasings "
                        "and their demonstration answers join into one "
                        "row, prefill once, and the binary leg reads the "
                        "logits at each answer anchor (no decode, no "
                        "confidence leg); writes "
                        "perturbation_results_packed.xlsx")
    p.add_argument("--packed-parity",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="with --packed: score the same rows isolated first "
                        "and print the drift block (per-question |d "
                        "relative_prob| distribution and flip rate); the "
                        "isolated answers are the demonstrations")
    p.set_defaults(fn=cmd_run_perturbation)

    p = sub.add_parser("run-api-perturbation",
                       help="frontier-model 10k-perturbation sweep via the "
                            "OpenAI Batch API (key via env)")
    p.add_argument("--perturbations", required=True, help="perturbations.json")
    p.add_argument("--model", action="append", required=True,
                   help="repeat per model (<=3 run concurrently)")
    p.add_argument("--output", default="results/perturbation_results_api.xlsx")
    p.add_argument("--max-rephrasings", type=int, default=None)
    p.add_argument("--reasoning-logprob-runs", action="store_true",
                   help="approximate reasoning-model logprobs with 10 repeats "
                        "instead of skipping the binary leg")
    p.set_defaults(fn=cmd_run_api_perturbation)

    p = sub.add_parser("run-claude-perturbation",
                       help="confidence-only Claude Message-Batches sweep "
                            "(key via env)")
    p.add_argument("--perturbations", required=True, help="perturbations.json")
    p.add_argument("--model", default="claude-opus-4-1-20250805")
    p.add_argument("--output", default="results/claude_batch_perturbation_results.xlsx")
    p.add_argument("--max-rephrasings", type=int, default=None)
    p.set_defaults(fn=cmd_run_claude_perturbation)

    p = sub.add_parser("generate-rephrasings",
                       help="build perturbations.json via Claude rephrasing "
                            "sessions (key via env)")
    p.add_argument("--model", default="claude-sonnet-4-20250514")
    p.add_argument("--sessions", type=int, default=100)
    p.add_argument("--target", type=int, default=2000)
    p.add_argument("--output", default="data/perturbations.json")
    p.set_defaults(fn=cmd_generate_rephrasings)

    p = sub.add_parser("run-gpt-perturbation",
                       help="serial GPT sync perturbation sweep, no batch "
                            "service (key via env)")
    p.add_argument("--perturbations", required=True, help="perturbations.json")
    p.add_argument("--model", default="gpt-4-0125-preview")
    p.add_argument("--output", default="results/gpt4_perturbation_results.xlsx")
    p.add_argument("--sleep", type=float, default=0.5,
                   help="rate-limit sleep between rephrasings (0.5 s)")
    p.add_argument("--max-rephrasings", type=int, default=None)
    p.set_defaults(fn=cmd_run_gpt_perturbation)

    p = sub.add_parser("run-gemini-perturbation",
                       help="threaded Gemini sync perturbation sweep (key via env)")
    p.add_argument("--perturbations", required=True, help="perturbations.json")
    p.add_argument("--model", default="gemini-2.5-pro")
    p.add_argument("--output", default="results/gemini_perturbation_results.xlsx")
    p.add_argument("--threads", type=int, default=20)
    p.add_argument("--rps", type=float, default=2.3,
                   help="token-bucket rate limit (~2.3 req/s)")
    p.add_argument("--max-rephrasings", type=int, default=None)
    p.set_defaults(fn=cmd_run_gemini_perturbation)

    p = sub.add_parser("generate-irrelevant", help="build perturbations_irrelevant.json")
    p.add_argument("--output", default="data/perturbations_irrelevant.json")
    p.add_argument("--readable-output", default=None,
                   help="also write the human-readable dump "
                        "(perturbations_irrelevant_readable.txt)")
    p.set_defaults(fn=cmd_generate_irrelevant)

    p = sub.add_parser("run-irrelevant",
                       help="irrelevant-insertion study: 3,400 perturbations "
                            "over GPT/Claude/Gemini at temperature 0.7 "
                            "(keys via env)")
    p.add_argument("--perturbations", default="data/perturbations_irrelevant.json")
    p.add_argument("--output-dir", default="results/irrelevant_perturbations")
    p.add_argument("--test-mode", action="store_true", default=False,
                   help="limited run (see --limit)")
    p.add_argument("--full-mode", action="store_true",
                   help="run on all data (overrides test mode)")
    p.add_argument("--limit", type=int, default=None,
                   help="cap on total evaluations, split across models "
                        "(implies a limited run unless --full-mode; "
                        "test-mode default: 100)")
    p.add_argument("--models", nargs="+", choices=["gpt", "claude", "gemini"],
                   default=["gpt", "claude", "gemini"])
    p.add_argument("--resume", action="store_true",
                   help="resume from checkpoint (the default behavior; "
                        "accepted for reference-CLI parity)")
    p.add_argument("--no-resume", action="store_true",
                   help="start from scratch, discarding any checkpoint")
    p.add_argument("--clear-checkpoint", action="store_true",
                   help="clear existing checkpoint before starting")
    p.add_argument("--load-existing", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="load saved results/analysis instead of evaluating")
    p.add_argument("--force-rerun", action="store_true",
                   help="run new evaluations even if results exist")
    p.add_argument("--regenerate-plots", action="store_true",
                   help="only rebuild plots from the saved analysis.json")
    p.set_defaults(fn=cmd_run_irrelevant)

    p = sub.add_parser(
        "serve",
        help="continuous-batching scoring service (serve/): JSONL "
             "stdin/file driver over one resident model, or an "
             "EnginePool of replicas with --pool-replicas, plus --replay "
             "for offline-parity verification and --load-rate for the "
             "open-loop load harness")
    _add_run_config_args(p)
    _add_serve_args(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("lint",
                       help="PyTorch-aware static analysis (rules G01, "
                            "G02, G05-G11, interprocedural device regions "
                            "and the whole-tree concurrency layer) gated "
                            "by lint_baseline_torch.json; `lint "
                            "contracts` runs the cross-artifact drift "
                            "checker")
    p.add_argument("lint_args", nargs=argparse.REMAINDER,
                   help="forwarded to the linter: paths, --diff, "
                        "--format text|json, --baseline PATH, "
                        "--no-baseline, --write-baseline, --explain "
                        "RULE|all, or the `contracts` subcommand "
                        "(--root, --format, --only KIND, --diff, "
                        "--explain KIND|all)")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("plan",
                       help="plan search: 'plan search' enumerates mesh x "
                            "batch x kv-dtype x prefill-chunk candidates "
                            "against the device-memory budget model and "
                            "ranks them by predicted rows/s ('plan search "
                            "--dryrun' compares the choice for 8 devices "
                            "with the hand-picked dp4xtp2 point)")
    p.add_argument("plan_args", nargs=argparse.REMAINDER,
                   help="forwarded: search [--model ...] [--devices N] "
                        "[--workload full|binary|packed] [--hbm-gib GIB] "
                        "[--dryrun] [--format table|json]")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("obs",
                       help="observability reports: 'obs report --trace "
                            "PATH' aggregates a saved span trace (JSONL "
                            "log or Chrome-trace JSON) per phase/leg; "
                            "'obs bench-diff BENCH_r04.json "
                            "BENCH_r05.json' aligns bench records into a "
                            "regression table (exit 1 past --threshold)")
    p.add_argument("obs_args", nargs=argparse.REMAINDER,
                   help="forwarded: report --trace PATH [--wall-s S] "
                        "[--rows N] [--format table|json], or bench-diff "
                        "RECORD... [--threshold PCT] [--format "
                        "table|json] [--no-fail]")
    p.set_defaults(fn=cmd_obs)

    p = sub.add_parser("sample-statements",
                       help="seeded LaTeX sample of the irrelevant statements")
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_sample_statements)

    p = sub.add_parser("power-analysis",
                       help="sample-size / power report from pilot MAEs")
    p.add_argument("--pilot-json", default=None,
                   help="override the built-in pilot results asset")
    p.add_argument("--output-dir", default="results/power_analysis")
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--simulations", type=int, default=10_000)
    p.set_defaults(fn=cmd_power_analysis)

    p = sub.add_parser("repair-batch",
                       help="re-pair a corrupted batch-response JSONL")
    p.add_argument("--requests", required=True, help="request JSONL")
    p.add_argument("--responses", required=True, help="corrupted response JSONL")
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_repair_batch)

    p = sub.add_parser("analyze-survey",
                       help="consolidated human-vs-LLM survey analysis")
    p.add_argument("--survey1-csv", required=True)
    p.add_argument("--survey2-csv", required=True)
    p.add_argument("--llm-csv", required=True,
                   help="instruct_model_comparison_results_combined.csv")
    p.add_argument("--output-dir", default="results/survey_analysis")
    p.add_argument("--bootstrap", type=int, default=1000)
    p.add_argument("--cross-prompt-bootstrap", type=int, default=100)
    p.set_defaults(fn=cmd_analyze_survey)

    p = sub.add_parser("analyze-combined",
                       help="three-model confidence combiner over sweep workbooks")
    p.add_argument("--workbook", action="append", required=True,
                   metavar="NAME=PATH", help="repeat per model")
    p.add_argument("--output-dir", default="results/combined_analysis")
    p.set_defaults(fn=cmd_analyze_combined)

    p = sub.add_parser("demographics-table",
                       help="Prolific demographics LaTeX table")
    p.add_argument("--csv", action="append", required=True)
    p.add_argument("--column", action="append", default=None,
                   help="repeat per categorical column (default: Sex, "
                        "Ethnicity simplified, Employment status, Student "
                        "status; an Age summary comment is always appended)")
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_demographics)

    p = sub.add_parser("analyze-perturbations", help="statistics over a sweep workbook")
    p.add_argument("--workbook", required=True)
    p.add_argument("--output-dir", default="results/perturbation_analysis")
    p.add_argument("--simulations", type=int, default=100_000)
    p.set_defaults(fn=cmd_analyze_perturbations)

    p = sub.add_parser("similarity", help="rephrasing similarity validation")
    p.add_argument("--perturbations", required=True)
    p.add_argument("--output-dir", default="results/prompt_similarity")
    p.add_argument("--max-rephrasings", type=int, default=None)
    p.add_argument("--embeddings", action="store_true",
                   help="add the sentence-transformer embedding-cosine "
                        "column (calculate_prompt_similarity.py:98-207); "
                        "degrades with a warning when the package or model "
                        "is unavailable")
    p.add_argument("--embedding-model", default="all-MiniLM-L6-v2",
                   help="sentence-transformers model name (reference default)")
    p.set_defaults(fn=cmd_similarity)

    p = sub.add_parser("analyze-100q", help="instruct-base bootstrap over 100q results")
    p.add_argument("--results", required=True)
    p.add_argument("--latex", action="store_true",
                   help="also emit paper Table 5 (needs --survey1-csv)")
    p.add_argument("--survey1-csv", default=None)
    p.add_argument("--survey2-csv", default=None)
    p.add_argument("--output-json", default=None,
                   help="also write the analysis records here")
    p.set_defaults(fn=cmd_analyze_100q)

    p = sub.add_parser("extract-survey2-questions",
                       help="extract part-2 questions from Qualtrics headers")
    p.add_argument("--survey-csv", required=True)
    p.add_argument("--output", default="data/question_list_part_2_actual.txt")
    p.add_argument("--ascii-quotes", action="store_true",
                   help="normalize the 7 curly-quoted Qualtrics headers to "
                        "straight quotes — the form the reference sweep "
                        "actually ran (its hardcoded prompts list, "
                        "compare_instruct_models_survey2.py:298-355, is a "
                        "straight-quote transcription of this extractor's "
                        "output)")
    p.set_defaults(fn=cmd_extract_survey2)

    p = sub.add_parser("analyze-3way",
                       help="base-vs-instruct-vs-human comparison "
                            "(correlations, validity audit, scatter)")
    p.add_argument("--llm-csv", required=True)
    p.add_argument("--survey1-csv", required=True)
    p.add_argument("--survey2-csv", default=None)
    p.add_argument("--output-dir", default="results/three_way")
    p.add_argument("--no-figures", action="store_true")
    p.set_defaults(fn=cmd_analyze_3way)

    p = sub.add_parser("analyze-agreement",
                       help="point-estimate + question-bootstrap LLM/human "
                            "agreement (both reference JSON report shapes)")
    p.add_argument("--llm-csv", required=True,
                   help="instruct_model_comparison_results.csv")
    p.add_argument("--base-csv", default=None,
                   help="model_comparison_results.csv (base models)")
    p.add_argument("--survey-csv", required=True,
                   help="survey-1 Qualtrics export (the 50 mapped questions)")
    p.add_argument("--output-dir", default="results/agreement")
    p.add_argument("--bootstrap", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_analyze_agreement)

    p = sub.add_parser("analyze-family-differences",
                       help="respondent-bootstrap agreement + per-family "
                            "MAE/MSE/MAPE differences")
    p.add_argument("--llm-csv", default=None)
    p.add_argument("--survey1-csv", default=None)
    p.add_argument("--survey2-csv", default=None)
    p.add_argument("--agreement-json", default=None,
                   help="reuse a saved llm_human_agreement_bootstrap.json")
    p.add_argument("--output-dir", default="results/family_differences")
    p.add_argument("--bootstrap", type=int, default=100)
    p.set_defaults(fn=cmd_analyze_family_differences)

    p = sub.add_parser("ground-truth-figure",
                       help="human ground-truth distribution figures")
    p.add_argument("--survey1-csv", required=True)
    p.add_argument("--survey2-csv", default=None)
    p.add_argument("--output-dir", default="results/ground_truth")
    p.set_defaults(fn=cmd_ground_truth_figure)

    p = sub.add_parser("model-comparison",
                       help="inter-model correlation report + heatmap + kappa "
                            "over a results CSV (prompt/model/relative_prob)")
    p.add_argument("--results", required=True,
                   help="instruct_model_comparison_results*.csv-style CSV")
    p.add_argument("--output-dir", default="results/model_comparison")
    p.add_argument("--reference-model", default=None,
                   help="strip-plot anchor (default: auto-detect Baichuan)")
    p.add_argument("--bootstrap", type=int, default=1000)
    p.add_argument("--no-figures", action="store_true")
    p.set_defaults(fn=cmd_model_comparison)

    p = sub.add_parser("cross-kappa",
                       help="aggregate Cohen's kappa across experiment CSVs")
    p.add_argument("--results", nargs="+", required=True,
                   help="one or more results CSVs (same schema)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--bootstrap", type=int, default=1000)
    p.add_argument("--output-json", default=None)
    p.set_defaults(fn=cmd_cross_kappa)

    p = sub.add_parser("analyze-mae-100q",
                       help="paper Table 5: per-family base-vs-instruct MAE "
                            "vs human survey means (paired bootstrap)")
    p.add_argument("--results", required=True,
                   help="base_vs_instruct_100q_results.csv")
    p.add_argument("--survey1-csv", required=True)
    p.add_argument("--survey2-csv", default=None)
    p.add_argument("--latex", action="store_true", help="print the LaTeX table")
    p.add_argument("--output-tex", default=None, help="write the LaTeX table here")
    p.add_argument("--output-json", default=None, help="write family records here")
    p.set_defaults(fn=cmd_analyze_mae_100q)

    args = parser.parse_args(argv)
    # Strict mode (runtime/strict.py): --strict or LLM_INTERP_STRICT=1 arms
    # the sync guard and the build sentry, so the run's operating point is
    # auditable (recompile_events / blocked_transfers counters)
    from .runtime import strict as strict_mod
    from .utils import telemetry

    was_strict = strict_mod.strict_enabled()
    counters_at_start = telemetry.counters()
    if getattr(args, "strict", False):
        strict_mod.activate()
    else:
        strict_mod.activate_from_env()
    # Observability (obs/): --trace arms the span tracer for the whole
    # command (the JSONL streams as spans close; the Chrome trace exports
    # on the way out, success or failure), --profile wraps the command in
    # a torch.profiler capture window, --metrics streams the JSONL metrics
    # log (one sample a sweep heartbeat).  All measurement-only; each is
    # disarmed again on the way out, so a caller that runs several
    # commands in one process gets one artifact set a command.
    from . import obs
    from .obs import metrics as obs_metrics
    from .obs.profiler import profile_window

    metrics_path = getattr(args, "metrics", None)
    trace_path = getattr(args, "trace", None)
    profile_dir = getattr(args, "profile", None)
    if metrics_path:
        obs_metrics.enable_jsonl(metrics_path)
        print(f"# obs: metrics log streaming to {metrics_path}",
              file=sys.stderr)
    if trace_path:
        obs.get_tracer().reset()
        obs.enable(jsonl_path=trace_path + ".spans.jsonl", memory=True)
    try:
        with profile_window(profile_dir, enabled=bool(profile_dir)):
            return args.fn(args)
    finally:
        if trace_path:
            path = obs.export_chrome(trace_path)
            obs.disable()
            print(f"# obs: trace written to {path} (span log "
                  f"{trace_path}.spans.jsonl)", file=sys.stderr)
        if metrics_path:
            obs_metrics.get_registry().disable_jsonl()
        if strict_mod.strict_enabled():
            # the audit line, with this command's counts: a clean run
            # reads blocked_transfers 0
            audit = strict_mod.strict_report()
            delta = telemetry.counters_since(counters_at_start)
            for key in (strict_mod.RECOMPILE_COUNTER,
                        strict_mod.BLOCKED_COUNTER):
                audit[key] = int(delta.get(key, 0))
            print(f"# strict: {json.dumps(audit)}", file=sys.stderr,
                  flush=True)
        if not was_strict:
            strict_mod.deactivate()


if __name__ == "__main__":
    sys.exit(main())
