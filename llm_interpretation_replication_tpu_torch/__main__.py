"""Command-line entry point of the port::

    python -m llm_interpretation_replication_tpu_torch run-perturbation \\
        --model SNAPSHOT --perturbations perturbations.json [--device cuda]
    python -m llm_interpretation_replication_tpu_torch run-100q \\
        --checkpoint-dir DIR [--device cuda]
    python -m llm_interpretation_replication_tpu_torch run-instruct-sweep \\
        --checkpoint-dir DIR [--device cuda]

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
``--results-csv``).  These are copies of the reference CLI's commands.  Flags of paths the port does not cover yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import os
import sys

_ITEM_GUARDS = "ROADMAP.md queue 1, 'Guards and device observability'"
_ITEM_PLAN = "ROADMAP.md queue 1, 'Planning for the H100'"
_ITEM_PAR = "ROADMAP.md queue 1, 'Parallel and training'"


def _add_run_config_args(p: argparse.ArgumentParser):
    p.add_argument("--strict", action="store_true",
                   help="strict transfer guard (not ported)")
    p.add_argument("--trace", nargs="?", const="obs_trace.json",
                   default=None, metavar="PATH",
                   help="span tracing (not ported)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="profiler capture (not ported)")
    p.add_argument("--metrics", nargs="?", const="metrics.jsonl",
                   default=None, metavar="PATH",
                   help="streaming metrics log (not ported)")
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
                   help="plan search (not ported)")
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--mesh-seq", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--output-dir", default="results")


def _refuse_unported(args) -> None:
    """Raise for each flag whose path the port does not cover yet."""
    for flag, on, item in (
        ("--strict", args.strict, _ITEM_GUARDS),
        ("--trace", args.trace, _ITEM_GUARDS),
        ("--profile", args.profile, _ITEM_GUARDS),
        ("--metrics", args.metrics, _ITEM_GUARDS),
        ("--plan-search", args.plan_search, _ITEM_PLAN),
        ("--mesh-model > 1", args.mesh_model > 1, _ITEM_PAR),
        ("--mesh-seq > 1", args.mesh_seq > 1, _ITEM_PAR),
    ):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet ({item})")


def _run_config(args):
    from .config import RunConfig

    _refuse_unported(args)
    return RunConfig(
        device=args.device, dtype=args.dtype, quant=args.quant,
        kv_dtype=args.kv_dtype, prefill_chunk=args.prefill_chunk,
        pooled_confidence=args.pooled_confidence,
        phase2_pool_target=args.phase2_pool_target,
        slot_repack=args.slot_repack, decode_k=args.decode_k,
        attention_impl=args.attention_impl, batch_size=args.batch_size,
        checkpoint_dir=args.checkpoint_dir, output_dir=args.output_dir,
    )


def _engine_factory(run_config):
    """model name -> ScoringEngine over its local snapshot.  Under the
    roster-wide ``--attention-impl flash``, a model whose config refuses
    the causal kernel (``flash_refusal``: ALiBi, a sliding window, T5's
    position bias) runs dense, as the reference's loader runs it; each
    model's impl is named on stderr (``# <model>: attention <impl>
    (<why>)``) before it loads.  With ``--decode-k`` > 1 the engine takes
    the snapshot's persisted K-head when one matches."""
    from .models.config import from_hf_config
    from .runtime.engine import EngineConfig, ScoringEngine
    from .runtime.loader import (K_HEAD_FILENAME, attach_k_head,
                                 load_hf_config, load_model, load_tokenizer)

    def factory(model_name: str) -> ScoringEngine:
        rc = run_config
        path = rc.snapshot_path(model_name)
        impl, why = rc.attention_impl, f"--attention-impl {rc.attention_impl}"
        if impl == "flash":
            refusal = from_hf_config(load_hf_config(path))[1].flash_refusal()
            if refusal:
                impl, why = "xla", refusal
        print(f"# {model_name}: attention {impl} ({why})", file=sys.stderr,
              flush=True)
        family, cfg, params = load_model(
            path, dtype=rc.dtype, quant=rc.quant, attention_impl=impl,
            device=rc.device)
        engine = ScoringEngine(
            family, cfg, params, load_tokenizer(path), device=rc.device,
            engine_config=EngineConfig(
                batch_size=rc.batch_size,
                kv_dtype=rc.kv_dtype,
                prefill_chunk=rc.prefill_chunk,
                pooled_confidence=rc.pooled_confidence,
                phase2_pool_target=rc.phase2_pool_target,
                slot_repack=rc.slot_repack,
                decode_k=rc.decode_k,
            ))
        if rc.decode_k > 1 and attach_k_head(engine, path):
            print(f"# K-head loaded from snapshot ({K_HEAD_FILENAME}, "
                  f"decode_k={rc.decode_k})", file=sys.stderr, flush=True)
        return engine

    return factory


def cmd_run_100q(args):
    from .sweeps import run_sweep

    rc = _run_config(args)
    rows = run_sweep(
        _engine_factory(rc),
        checkpoint_path=os.path.join(rc.output_dir, "base_vs_instruct_100q_checkpoint.json"),
        results_csv=os.path.join(rc.output_dir, "base_vs_instruct_100q_results.csv"),
    )
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
    import json

    from .config import legal_scenarios
    from .gen.rephrase import load_perturbations
    from .sweeps import (run_model_perturbation_sweep,
                         run_packed_perturbation_sweep)

    rc = _run_config(args)
    scenarios = load_perturbations(args.perturbations,
                                   expected_scenarios=legal_scenarios())
    engine = _engine_factory(rc)(args.model)
    if rc.decode_k > 1 and engine.k_head is None \
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
    print(f"{len(rows)} rows")


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    parser = argparse.ArgumentParser(prog="llm_interpretation_replication_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run-100q", help="base-vs-instruct 100-question sweep")
    _add_run_config_args(p)
    p.set_defaults(fn=cmd_run_100q)

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

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
