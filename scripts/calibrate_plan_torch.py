#!/usr/bin/env python3
"""Measure the port's plan model (``runtime/plan.py``, ``runtime/plan_search.py``)
on one GPU, and fit its coefficients from the measurement.

    python3 scripts/calibrate_plan_torch.py [--seed N] [--sections S,...] [--out FILE]
    python3 scripts/calibrate_plan_torch.py --fit FILE [FILE ...]

On the card (Falcon-7B at its published width and depth, random weights from
``--seed``, bf16 and w8a8 int8) the sections are:

- ``reserve``: the memory the CUDA context, cuBLAS (bf16 and int8 products)
  and the attention kernels' libraries hold, read with
  ``torch.cuda.mem_get_info`` once they are loaded and the caching allocator
  is empty;
- ``weights``: ``torch.cuda.memory_allocated`` of each quant's weights;
- ``load``: the peak of ``runtime/loader.load_model`` reading a snapshot
  the script writes (2 layers and full depth; bf16 and w8a8) above what
  was allocated before it;
- ``blocks``: the peak transient of one layer's sub-blocks at several
  (batch, sequence): the MLP, dense attention, kernel attention (the causal
  kernel), the suffix-extension attention of chunked prefill and of the
  fused legs, and a whole block on each route;
- ``distill``: the peak of the K-head's distillation (K = 4, 32 corpus
  prompts) above what was allocated before it;
- ``engine``: ``torch.cuda.max_memory_allocated`` and
  ``max_memory_reserved`` of whole engine calls at a ladder of operating
  points (binary, full-study and packed; dense and kernel routes; bf16 and
  w8a8; bf16 and int8 KV; chunk 0 and 128; three batches each, up to the
  largest that runs), on prompts whose prefixes fill the 256-token bucket
  (the packed rows: the corpus's);
- ``rates``: rows/s of the binary leg and of the full-study row (both legs
  over one prefix cache) at three batches, three repeats each, on the
  3,400-row irrelevant-insertion corpus under a ``WordTokenizer`` of its
  words, w8a8 weights on the kernel route; the int8 KV cache and chunked
  prefill at one batch; packed questions/s at Q = 1, 2 and 4 beside the
  isolated binary leg; the corpus's token counts and its pack encoding;
  and the self seconds by span phase of a binary and a full-study call
  under the span tracer in sync mode.

It prints one JSON object and writes it to ``--out`` (default
``chiprun_out/calibrate_plan_torch.json``).  ``--fit FILE ...`` reads such
files on the host (no card needed; a later file's sections replace an
earlier one's), prints the coefficients it solves and each
engine point's predicted need against its measured peak under the module's
current coefficients.  Random weights decide no row at position 0, so the
rates describe that regime (every binary row decodes its look-ahead)."""

import argparse
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join("chiprun_out", "calibrate_plan_torch.json")
SECTIONS = ("reserve", "weights", "load", "blocks", "distill", "engine",
            "rates")
DEVICE = "cuda"

#: (batch, sequence) of the sub-block measurements; the extension's chunk
BLOCK_SHAPES = ((8, 128), (16, 256), (32, 256))
BLOCK_CHUNK = 128
#: the engine ladder: the prefixes' bucket, the format suffixes' tokens,
#: the packed ladder's questions a row, and the batches of each workload
LADDER_SEQ = 256
LADDER_BATCHES = (64, 256, 512)
PACKED_LADDER_Q = 4
PACKED_LADDER_BATCHES = (16, 64, 128)
#: (workload, attention impl, quant, kv dtype, prefill chunk)
LADDER_POINTS = (
    ("binary", "xla", "none", "bf16", 0),
    ("binary", "flash", "none", "bf16", 0),
    ("binary", "xla", "int8", "bf16", 0),
    ("binary", "flash", "int8", "bf16", 0),
    ("binary", "flash", "int8", "int8", 0),
    ("full", "xla", "none", "bf16", 0),
    ("full", "flash", "none", "bf16", 0),
    ("full", "xla", "int8", "bf16", 0),
    ("full", "flash", "int8", "bf16", 0),
    ("full", "flash", "int8", "int8", 0),
    ("full", "flash", "int8", "bf16", 128),
    ("full", "xla", "none", "int8", 128),
    ("packed", "xla", "none", "bf16", 0),
    ("packed", "flash", "none", "bf16", 0),
    ("packed", "xla", "int8", "bf16", 0),
    ("packed", "flash", "int8", "bf16", 0),
)
#: the rate runs: batches, repeats, the penalties' batch and chunk, the
#: packed runs' question batch and packings
RATE_BATCHES = (32, 128, 384)
RATE_REPEATS = 3
PENALTY_BATCH = 128
RATE_CHUNK = 64
PACKED_QUESTIONS = 128
PACKINGS = (1, 2, 4)
CONF_CAP = 10


def say(*parts):
    print(*parts, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def peak_of(fn):
    """(result, peak bytes allocated while ``fn`` ran above what was
    allocated before it)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def falcon(attention_impl="xla", kv="bf16"):
    from llm_interpretation_replication_tpu_torch.models import config

    return config.DecoderConfig(**config.FALCON_7B_GEOMETRY,
                                attention_impl=attention_impl,
                                kv_cache_dtype=kv)


def corpus():
    """The 3,400-row corpus as (scenario, row) pairs and its tokenizer."""
    from llm_interpretation_replication_tpu_torch.config import (
        irrelevant_scenarios, irrelevant_statements)
    from llm_interpretation_replication_tpu_torch.gen.irrelevant import (
        generate_perturbations)
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        WordTokenizer)

    scen = generate_perturbations(irrelevant_scenarios(),
                                  irrelevant_statements())
    rows = [(s, p) for s in scen for p in s["perturbations_with_irrelevant"]]
    words = []
    for s in scen:
        words += (s["response_format"].split()
                  + s["confidence_format"].split() + list(s["target_tokens"]))
        for p in s["perturbations_with_irrelevant"]:
            words += p["perturbed_text"].split()
    return rows, WordTokenizer(words)


def reserve_section(attention, _build):
    """What the runtime holds once the context, cuBLAS and the kernels'
    libraries are loaded, with the caching allocator emptied."""
    import torch

    a = torch.randn(256, 256, device=DEVICE, dtype=torch.bfloat16)
    (a @ a).sum().item()
    q8 = torch.ones(32, 64, device=DEVICE, dtype=torch.int8)
    w8 = torch.ones(64, 64, device=DEVICE, dtype=torch.int8)
    torch._int_mm(q8, w8.t().contiguous().t()).sum().item()
    _build.build_all(attention.KERNEL_SOURCES)
    q = torch.randn(1, 64, 4, 64, device=DEVICE, dtype=torch.bfloat16)
    k = torch.randn(1, 64, 1, 64, device=DEVICE, dtype=torch.bfloat16)
    lengths = torch.full((1,), 64, device=DEVICE, dtype=torch.int32)
    attention.causal_grouped_attention(q, k, k, lengths)
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    attention.grouped_attention(qh, kh, kh, lengths)
    attention.flash_attention(qh, kh.expand(1, 4, 64, 64).contiguous(),
                              kh.expand(1, 4, 64, 64).contiguous(), lengths)
    torch.cuda.synchronize()
    del a, q8, w8, q, k, qh, kh, lengths
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    reserved = torch.cuda.memory_reserved()
    return dict(total_memory=torch.cuda.get_device_properties(0).total_memory,
                mem_get_info_total=total, free=free,
                allocator_reserved=reserved,
                context_bytes=total - free - reserved)


def distill_section(weights, tok, rows, quant):
    """Peak of the K-head's distillation (``decoder.distill_k_head`` at
    K = 4 on 32 corpus prompts, as the CLI distills one) above what was
    allocated before it, and the head's own bytes."""
    import torch

    from llm_interpretation_replication_tpu_torch.scoring.prompts import (
        format_binary_prompt)

    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    eng = emod.ScoringEngine("falcon", falcon("flash"), weights, tok,
                             device=DEVICE,
                             engine_config=emod.EngineConfig(decode_k=4))
    prompts = [format_binary_prompt(p["perturbed_text"], s["response_format"])
               for s, p in rows[:32]]
    head, peak = peak_of(lambda: eng.distill_k_head_on(prompts))
    rec = dict(quant=quant, decode_k=4, rows=len(prompts), peak=peak,
               head_bytes=head["w"].numel() * head["w"].element_size())
    eng.close(release_params=False)
    del head
    torch.cuda.empty_cache()
    say("distill", json.dumps(rec))
    return rec


def load_section(seed, workdir):
    """Peak of ``runtime/loader.load_model`` above what was allocated
    before it, and the weights it leaves, for a Falcon-7B-width snapshot
    (random bf16 weights from ``seed``, written with chip_smoke.py's
    writer) at 2 layers and at full depth, read as bf16 and as w8a8."""
    import dataclasses

    import torch

    import chip_smoke
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.runtime import loader

    out = []
    for layers in (2, None):
        cfg = falcon()
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        snap = os.path.join(workdir, f"falcon-{cfg.num_layers}l")
        os.makedirs(snap)
        w = convert.random_params(cfg, seed=seed, device=DEVICE,
                                  dtype="bf16")
        chip_smoke._write_safetensors(
            os.path.join(snap, "model.safetensors"),
            chip_smoke._falcon_state_dict(w.tree(), cfg))
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(chip_smoke._falcon_config_json(cfg), f)
        del w
        torch.cuda.empty_cache()
        for quant in ("none", "int8"):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _, _, got = loader.load_model(snap, dtype="bf16", quant=quant,
                                          attention_impl="flash",
                                          device=DEVICE)
            torch.cuda.synchronize()
            rec = dict(layers=cfg.num_layers, quant=quant,
                       peak=torch.cuda.max_memory_allocated() - before,
                       kept=torch.cuda.memory_allocated() - before)
            del got
            torch.cuda.empty_cache()
            out.append(rec)
            say("load", json.dumps(rec))
        os.remove(os.path.join(snap, "model.safetensors"))
    return out


def make_weights(cfg, quant, seed):
    import torch

    from llm_interpretation_replication_tpu_torch.models import convert

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    w = convert.random_params(cfg, seed=seed, device=DEVICE, dtype="bf16",
                              quant=quant)
    torch.cuda.synchronize()
    rec = dict(quant=quant, bytes=torch.cuda.memory_allocated() - base,
               peak_while_made=torch.cuda.max_memory_allocated() - base,
               seconds=time.perf_counter() - t0)
    return w, rec


def blocks_section(cfg, weights, quant):
    """Peak transient of one layer's sub-blocks (inputs allocated before
    each measurement; outputs counted)."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.ops.attention import (
        cache_extend_attention)

    lp = decoder._layer(decoder._tree(weights)["layers"], 0)
    h, n, g, d = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    out = []
    for b, s in BLOCK_SHAPES:
        x = torch.randn(b, s, h, generator=gen, device=DEVICE,
                        dtype=torch.bfloat16)
        mask = torch.ones(b, s, device=DEVICE, dtype=torch.int64)
        pos = decoder._positions(mask)
        sin_cos = decoder.rotary_embedding(pos, decoder._rotary_dim(cfg),
                                           cfg.rope_theta, torch.bfloat16)
        bias = decoder.make_attention_bias(cfg, pos, pos, mask.bool())
        lengths = mask.sum(-1).to(torch.int32).contiguous()
        rec = dict(quant=quant, batch=b, seq=s)
        _, rec["mlp"] = peak_of(lambda: decoder._mlp(cfg, lp, x))
        _, rec["attn_dense"] = peak_of(
            lambda: decoder._attn(cfg, lp, x, sin_cos, bias)[0])
        _, rec["attn_kernel"] = peak_of(
            lambda: decoder._attn(cfg, lp, x, sin_cos, None, None, lengths)[0])
        _, rec["block_dense"] = peak_of(
            lambda: decoder._block(cfg, lp, x, sin_cos, bias)[0])
        _, rec["block_kernel"] = peak_of(
            lambda: decoder._block(cfg, lp, x, sin_cos, None, None,
                                   lengths)[0])
        c = min(BLOCK_CHUNK, s)
        qc = torch.randn(b, c, n, d, generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
        kp = torch.randn(b, s, g, d, generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
        kt = torch.randn(b, c, g, d, generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
        ebias = torch.zeros(b, 1, c, s + c, device=DEVICE)
        rec["extend_chunk"] = c
        _, rec["attn_extend"] = peak_of(
            lambda: cache_extend_attention(qc, kp, kp, kt, kt, ebias))
        rec["bias_bytes"] = bias.numel() * bias.element_size()
        rec["extend_bias_bytes"] = ebias.numel() * ebias.element_size()
        out.append(rec)
        del x, mask, pos, sin_cos, bias, lengths, qc, kp, kt, ebias
        torch.cuda.empty_cache()
        say("blocks", json.dumps(rec))
    return out


def ladder_inputs(tok, n, seed):
    """``n`` prefixes of random word ids whose lengths fill the ``seq``
    bucket, each with the corpus's first scenario's two format suffixes."""
    import numpy as np

    from llm_interpretation_replication_tpu_torch.config import (
        irrelevant_scenarios)

    s0 = irrelevant_scenarios()[0]
    seq = LADDER_SEQ
    rng = np.random.default_rng(seed)
    lens = rng.integers(seq - 15, seq + 1, n)
    prefixes = [rng.integers(3, len(tok), int(k)).tolist() for k in lens]
    suffixes = tuple(tok(" " + s0[key], add_special_tokens=False)
                     ["input_ids"] for key in ("response_format",
                                               "confidence_format"))
    return prefixes, suffixes, tuple(s0["target_tokens"])


def packed_inputs(rows, q):
    """Packs of ``q`` consecutive corpus binary prompts (demos "Yes")."""
    from llm_interpretation_replication_tpu_torch.scoring import packed
    from llm_interpretation_replication_tpu_torch.scoring.prompts import (
        format_binary_prompt)

    prompts = [format_binary_prompt(p["perturbed_text"], s["response_format"])
               for s, p in rows]
    return (packed.build_packs(prompts, q),
            [tuple(s["target_tokens"]) for s, _ in rows])


def run_workload(eng, workload, prefixes, suffixes, targets, packs=None):
    from llm_interpretation_replication_tpu_torch.runtime.engine import LegSpec

    if workload == "binary":            # the whole prompt fills the bucket
        return eng.score_prompts(prefixes, targets)
    if workload == "full":
        return eng.score_prefixed(
            [(p, suffixes) for p in prefixes], targets,
            legs=[LegSpec("binary"), LegSpec("confidence",
                                             with_confidence=True,
                                             max_new_tokens=CONF_CAP)])
    return eng.score_packed(packs, targets)


def engine_for(cfg, weights, tok, workload, batch, kv, chunk, oom=False):
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    ecfg = emod.EngineConfig(
        batch_size=batch, kv_dtype=kv, prefill_chunk=chunk,
        decode_completions=workload != "binary", oom_backoff=oom)
    return emod.ScoringEngine("falcon", cfg, weights, tok, device=DEVICE,
                              engine_config=ecfg)


def engine_section(weights_by_quant, tok, rows, seed):
    """Peak memory of whole engine calls at the ladder's operating points;
    a batch that runs out of memory ends its point's ladder."""
    import torch

    out = []
    for workload, impl, quant, kv, chunk in LADDER_POINTS:
        batches = (PACKED_LADDER_BATCHES if workload == "packed"
                   else LADDER_BATCHES)
        cfg = falcon(impl, kv)
        for b in batches:
            rec = dict(workload=workload, attention_impl=impl, quant=quant,
                       kv_dtype=kv, prefill_chunk=chunk, batch=b,
                       pipeline_depth=2)
            packs = None
            if workload == "packed":
                packs, targets = packed_inputs(rows[:2 * b * PACKED_LADDER_Q],
                                               PACKED_LADDER_Q)
                prefixes, suffixes = None, None
                lens = [sum(len(tok.encode(p)) for p, _ in pk)
                        + sum(len(tok.encode(dm, add_special_tokens=False))
                              for _, dm in pk if dm) for pk in packs]
                rec.update(packing=PACKED_LADDER_Q, rows=len(packs),
                           max_tokens=max(lens))
            else:
                prefixes, suffixes, target = ladder_inputs(tok, 2 * b, seed)
                targets = target
                rec.update(rows=len(prefixes), seq=LADDER_SEQ,
                           max_tokens=max(map(len, prefixes)),
                           suffix_tokens=[len(x) for x in suffixes])
            eng = engine_for(cfg, weights_by_quant[quant], tok, workload, b,
                             kv, chunk)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rec["allocated_before"] = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            try:
                res = run_workload(eng, workload, prefixes, suffixes,
                                   targets, packs)
                torch.cuda.synchronize()
                rec["oom"] = False
                del res
            except torch.OutOfMemoryError as err:
                rec["oom"] = True
                rec["error"] = str(err).splitlines()[0][:200]
            rec["seconds"] = time.perf_counter() - t0
            rec["peak_allocated"] = torch.cuda.max_memory_allocated()
            rec["peak_reserved"] = torch.cuda.max_memory_reserved()
            rec["fault_events"] = len(getattr(eng, "fault_events", []))
            eng.close(release_params=False)
            del eng
            torch.cuda.empty_cache()
            out.append(rec)
            say("engine", json.dumps(rec))
            if rec["oom"]:
                break
    return out


def rates_section(weights, tok, rows):
    """rows/s (questions/s packed) on the corpus, w8a8 on the kernel
    route; each number a call ending in ``torch.cuda.synchronize()``."""
    import numpy as np
    import torch

    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.scoring.prompts import (
        format_binary_prompt)

    binary = [format_binary_prompt(p["perturbed_text"], s["response_format"])
              for s, p in rows]
    pairs = [(p["perturbed_text"],
              (" " + s["response_format"], " " + s["confidence_format"]))
             for s, p in rows]
    targets = [tuple(s["target_tokens"]) for s, _ in rows]
    tok_rec = dict(
        rows=len(rows),
        binary_tokens_mean=float(np.mean([len(tok.encode(t))
                                          for t in binary])),
        prefix_tokens_mean=float(np.mean([len(tok.encode(p))
                                          for p, _ in pairs])),
        binary_tokens_max=max(len(tok.encode(t)) for t in binary))
    prefix_ids = [tok.encode(p) for p, _ in pairs]
    tok_rec["prefix_buckets"] = sorted({batching.bucket_for(len(x))
                                        for x in prefix_ids})
    out = dict(tokens=tok_rec, runs=[])

    def timed(label, workload, batch, n, kv="bf16", chunk=0, packing=0):
        from llm_interpretation_replication_tpu_torch.runtime.engine import (
            LegSpec)

        eng = engine_for(falcon("flash", kv), weights, tok, workload, batch,
                         kv, chunk, oom=True)
        if workload == "packed":
            packs, tg = packed_inputs(rows[:n], packing)

            def call(m):
                return eng.score_packed(packs[:max(1, m // packing)],
                                        tg[:max(1, m // packing) * packing])
        elif workload == "binary":
            def call(m):
                return eng.score_prompts(binary[:m], targets[:m])
        else:
            def call(m):
                return eng.score_prefixed(
                    pairs[:m], targets[:m],
                    legs=[LegSpec("binary"),
                          LegSpec("confidence", with_confidence=True,
                                  max_new_tokens=CONF_CAP)])
        call(min(n, batch * max(1, packing)))        # warm-up, one batch
        torch.cuda.synchronize()
        for rep in range(RATE_REPEATS):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = call(n)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rec = dict(label=label, workload=workload, batch=batch,
                       kv_dtype=kv, prefill_chunk=chunk, packing=packing,
                       repeat=rep, rows=len(res) if workload != "full"
                       else len(res[0]), seconds=sec,
                       rows_per_s=(len(res) if workload != "full"
                                   else len(res[0])) / sec,
                       peak_allocated=torch.cuda.max_memory_allocated(),
                       fault_events=len(eng.fault_events))
            out["runs"].append(rec)
            say("rate", json.dumps(rec))
        eng.close(release_params=False)
        torch.cuda.empty_cache()

    for b in RATE_BATCHES:
        timed("binary", "binary", b, 4 * b)
    for b in RATE_BATCHES:
        timed("full", "full", b, 2 * b)
    timed("full_int8_kv", "full", PENALTY_BATCH, 2 * PENALTY_BATCH, kv="int8")
    timed("full_chunk", "full", PENALTY_BATCH, 2 * PENALTY_BATCH,
          chunk=RATE_CHUNK)
    for q in PACKINGS:
        timed(f"packed_q{q}", "packed", PACKED_QUESTIONS // q,
              4 * PACKED_QUESTIONS, packing=q)
    out["phases"] = {w: phase_shares(weights, tok, binary, pairs, targets,
                                     w) for w in ("binary", "full")}
    # the port's pack encoding: tokens a packed row adds a question over
    # its questions' isolated prompts
    from llm_interpretation_replication_tpu_torch.scoring import packed

    enc = {}
    for q in PACKINGS:
        packs, _ = packed_inputs(rows[:4 * PACKED_QUESTIONS], q)
        ids, _ = packed.encode_packs(tok, packs)
        iso = sum(len(tok.encode(p)) for pk in packs for p, _ in pk)
        enc[q] = dict(rows=len(ids), questions=sum(map(len, packs)),
                      row_tokens_mean=float(np.mean([len(x) for x in ids])),
                      demo_tokens_per_question=(sum(map(len, ids)) - iso)
                      / sum(map(len, packs)))
    out["pack_encoding"] = enc
    return out


def phase_shares(weights, tok, binary, pairs, targets, workload):
    """Self seconds by span phase of one call (two batches at
    PENALTY_BATCH) under the span tracer in sync mode, so a span's time is
    its device time: the decode legs' share of the full-study row, the
    prompt side's of the binary row."""
    import torch

    from llm_interpretation_replication_tpu_torch.obs import tracer
    from llm_interpretation_replication_tpu_torch.runtime.engine import LegSpec

    n = 2 * PENALTY_BATCH
    eng = engine_for(falcon("flash"), weights, tok, workload, PENALTY_BATCH,
                     "bf16", 0, oom=True)

    def call():
        if workload == "binary":
            return eng.score_prompts(binary[:n], targets[:n])
        return eng.score_prefixed(
            pairs[:n], targets[:n],
            legs=[LegSpec("binary"), LegSpec("confidence",
                                             with_confidence=True,
                                             max_new_tokens=CONF_CAP)])

    call()                                       # warm-up
    torch.cuda.synchronize()
    tracer.enable(sync=True)
    try:
        snap = tracer.phase_snapshot()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        totals = tracer.phase_totals_since(snap)
    finally:
        tracer.disable()
    eng.close(release_params=False)
    rec = dict(workload=workload, rows=n, wall_s=wall, phases=totals)
    say("phases", json.dumps(rec))
    return rec


def measure(args):
    import torch

    if not torch.cuda.is_available():
        print("calibrate_plan_torch: CUDA is not available; the measurement "
              "needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from llm_interpretation_replication_tpu_torch.ops import _build

    attention = importlib.import_module(
        "llm_interpretation_replication_tpu_torch.ops.attention")
    sections = args.sections.split(",")
    t_all = time.perf_counter()
    res = dict(device=torch.cuda.get_device_name(0), card=card_line(),
               torch=torch.__version__, cuda=torch.version.cuda,
               seed=args.seed, sections={})
    say("device", res["device"], res["card"])
    res["sections"]["reserve"] = reserve_section(attention, _build)
    say("reserve", json.dumps(res["sections"]["reserve"]))
    rows, tok = corpus()
    weights, wrecs = {}, []
    for quant in ("none", "int8"):
        weights[quant], rec = make_weights(falcon(), quant, args.seed)
        wrecs.append(rec)
        say("weights", json.dumps(rec))
    res["sections"]["weights"] = wrecs
    if "load" in sections:
        with tempfile.TemporaryDirectory() as workdir:
            res["sections"]["load"] = load_section(args.seed, workdir)
    if "blocks" in sections:
        res["sections"]["blocks"] = [
            r for q in ("none", "int8")
            for r in blocks_section(falcon(), weights[q], q)]
    if "distill" in sections:
        res["sections"]["distill"] = [distill_section(weights[q], tok, rows, q)
                                      for q in ("none", "int8")]
    if "engine" in sections:
        res["sections"]["engine"] = engine_section(weights, tok, rows,
                                                   args.seed)
    if "rates" in sections:
        del weights["none"]
        torch.cuda.empty_cache()
        res["sections"]["rates"] = rates_section(weights["int8"], tok, rows)
    res["seconds"] = time.perf_counter() - t_all
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    say(json.dumps(dict(device=res["device"], card=res["card"],
                        seconds=res["seconds"], out=args.out)))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated subset of " + ",".join(SECTIONS)
                         + " (reserve and weights always run)")
    ap.add_argument("--out", default=OUT, help="the measured file")
    ap.add_argument("--fit", metavar="FILE", nargs="+", default=None,
                    help="fit the coefficients from measured files (host "
                         "only; a later file's sections replace an earlier "
                         "one's)")
    args = ap.parse_args(argv)
    if args.fit:
        return fit(args.fit)
    return measure(args)


MIB64 = 64 << 20


def _ceil_to(x, step):
    return int(-(-x // step) * step)


def _mean(xs):
    return sum(xs) / len(xs)


def _saturating_fit(rates):
    """(ceiling, half batch) of ``rate = C * b / (b + H)``: a least-squares
    line of 1/rate on 1/batch over ``{batch: rate}``."""
    xs = [1.0 / b for b in rates]
    ys = [1.0 / r for r in rates.values()]
    mx, my = _mean(xs), _mean(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    ceil_ = 1.0 / (my - slope * mx)
    return ceil_, slope * ceil_


def _rates_by(runs, label):
    """{batch: [rows/s of each repeat]} of one rate label."""
    out = {}
    for r in runs:
        if r["label"] == label:
            out.setdefault(r["batch"], []).append(r["rows_per_s"])
    return out


def fit_coefficients(res):
    """The plan model's coefficients solved from a measured file: each
    memory coefficient the largest bytes per element over its measured
    shapes (an envelope, so the model does not under-predict them), each
    allocator headroom the largest slack of its workload's ladder, the
    rate curve a least-squares fit of 1/rate on 1/batch."""
    import dataclasses

    from llm_interpretation_replication_tpu_torch.runtime import plan

    sec = res["sections"]
    cfg = falcon()
    h, n, d, f = (cfg.hidden_size, cfg.num_heads, cfg.head_dim,
                  cfg.intermediate_size)
    co = {"RESERVE_BYTES": _ceil_to(sec["reserve"]["context_bytes"], MIB64)}
    blocks = sec.get("blocks", [])
    bf = [b for b in blocks if b["quant"] == "none"]
    if blocks:
        co["SCORE_BYTES_PER_ELEMENT"] = max(
            (b["attn_dense"] + b["bias_bytes"]) / (b["batch"] * n * b["seq"]
                                                   * b["seq"]) for b in bf)
        co["EXTEND_SCORE_BYTES_PER_ELEMENT"] = max(
            (b["attn_extend"] + b["extend_bias_bytes"])
            / (b["batch"] * n * b["extend_chunk"]
               * (b["seq"] + b["extend_chunk"])) for b in blocks)
        co["FLASH_BYTES_PER_ELEMENT"] = max(
            b["attn_kernel"] / (b["batch"] * b["seq"] * n * d)
            for b in blocks)
        co["ACT_MLP_BYTES"] = max(b["mlp"] / (b["batch"] * b["seq"] * f)
                                  for b in bf)
        co["ACT_MLP_BYTES_INT8"] = max(
            b["mlp"] / (b["batch"] * b["seq"] * f)
            for b in blocks if b["quant"] == "int8")
        co["ACT_HIDDEN_BYTES"] = max(
            max(0, b["block_kernel"] - max(b["mlp"], b["attn_kernel"]))
            / (b["batch"] * b["seq"] * h) for b in blocks)
    for ld in sec.get("load", []):
        full = plan.weight_bytes(dataclasses.replace(
            cfg, num_layers=ld["layers"]), "none")
        name = ("LOAD_BYTES_PER_WEIGHT_BYTE_INT8" if ld["quant"] == "int8"
                else "LOAD_BYTES_PER_WEIGHT_BYTE")
        co[name] = max(co.get(name, 0.0), ld["peak"] / full)
    for d in sec.get("distill", []):
        co["DISTILL_SOLVE_BYTES"] = max(
            co.get("DISTILL_SOLVE_BYTES", 0.0),
            (d["peak"] - d["head_bytes"]) / (h * cfg.vocab_size)
            - 4 * (d["decode_k"] - 1))
    eng = [e for e in sec.get("engine", []) if not e["oom"]]
    for name, wl in (("THRASH_HEADROOM_BYTES", "full"),
                     ("BINARY_SWEEP_HEADROOM_BYTES", "binary"),
                     ("PACKED_SWEEP_HEADROOM_BYTES", "packed")):
        slack = [e["peak_reserved"] - e["peak_allocated"] for e in eng
                 if e["workload"] == wl]
        if slack:
            co[name] = _ceil_to(max(slack), MIB64)
    rates = sec.get("rates")
    spread = {}
    if rates:
        runs = rates["runs"]
        binary = {b: _mean(v) for b, v in _rates_by(runs, "binary").items()}
        # 1/r = 1/C + (H/C) / B, least squares over the batches
        ceil_, half = _saturating_fit(binary)
        co["ROWS_CEILING"], co["BATCH_HALF_SAT"] = ceil_, half

        def curve(b):
            return ceil_ * b / (b + half)

        # the full-study row saturates at its own batch: its curve's
        # ceiling over the binary one is the work factor
        full = {b: _mean(v) for b, v in _rates_by(runs, "full").items()}
        full_ceil, co["FULL_STUDY_HALF_SAT"] = _saturating_fit(full)
        co["FULL_STUDY_WORK"] = ceil_ / full_ceil

        def penalty(label):
            """1 - rate / the plain full-study rate at PENALTY_BATCH; 0.0
            when the difference lies within the two runs' spread (the
            measurement does not resolve it)."""
            got = _rates_by(runs, label)[PENALTY_BATCH]
            ref = _rates_by(runs, "full")[PENALTY_BATCH]
            d = 1.0 - _mean(got) / _mean(ref)
            noise = max((max(v) - min(v)) / _mean(v) for v in (got, ref))
            return d if abs(d) > noise else 0.0

        co["INT8_KV_PENALTY"] = penalty("full_int8_kv")
        buckets = rates["tokens"]["prefix_buckets"]
        replays = _mean([max(0, -(-bk // RATE_CHUNK) - 1) for bk in buckets])
        co["CHUNK_PENALTY"] = penalty("full_chunk") / replays
        tokens = rates["tokens"]
        co["PACKED_QUESTION_TOKENS"] = tokens["binary_tokens_mean"]
        co["PACKED_SHARED_TOKENS"] = 0.0
        enc = rates["pack_encoding"]
        q_top = str(max(PACKINGS))
        co["PACKED_DEMO_TOKENS"] = enc[q_top]["demo_tokens_per_question"]
        qt, dt = co["PACKED_QUESTION_TOKENS"], co["PACKED_DEMO_TOKENS"]
        gains = {}
        for q in PACKINGS:
            got = _mean(_rates_by(runs, f"packed_q{q}")[PACKED_QUESTIONS // q])
            gains[q] = got / (curve(PACKED_QUESTIONS) * qt / (qt + dt))
        co["PACKED_NO_DECODE_GAIN"] = gains[max(PACKINGS)]
        co["CALIBRATION_PARAMS"] = plan.param_count(cfg)
        ph = rates.get("phases", {})
        if "full" in ph:
            tot = ph["full"]["phases"]
            co["K_DECODE_SHARE"] = ((tot.get("decode", 0.0)
                                     + tot.get("pooled_decode", 0.0))
                                    / sum(tot.values()))
        if "binary" in ph:
            tot = ph["binary"]["phases"]
            co["PREFILL_PHASE_SHARE"] = 1.0 - (
                tot.get("decode", 0.0) + tot.get("pooled_decode", 0.0)) \
                / sum(tot.values())
        for label in ("binary", "full", "full_int8_kv", "full_chunk",
                      *(f"packed_q{q}" for q in PACKINGS)):
            for b, v in _rates_by(runs, label).items():
                spread[f"{label}@{b}"] = dict(
                    mean=_mean(v), min=min(v), max=max(v),
                    spread=(max(v) - min(v)) / _mean(v))
        spread["packed_gain_by_q"] = gains
    return co, spread


def predicted_need(e):
    """The budget model's need (module coefficients) at one engine point,
    with its terms."""
    from llm_interpretation_replication_tpu_torch.runtime import (
        plan, plan_search)
    from llm_interpretation_replication_tpu_torch.runtime.batching import (
        bucket_for)

    cfg = falcon(e["attention_impl"], e["kv_dtype"])
    wb = plan.weight_bytes(cfg, e["quant"])
    impl = e["attention_impl"]
    depth = e["pipeline_depth"]
    if e["workload"] == "binary":
        terms = plan_search.binary_need_terms(
            cfg, wb, e["batch"], e["seq"], depth, impl, quant=e["quant"])
    elif e["workload"] == "full":
        terms = plan.full_study_need_terms(
            cfg, wb, impl, e["batch"], e["seq"], pipeline_depth=depth,
            kv_dtype=e["kv_dtype"], prefill_chunk=e["prefill_chunk"],
            pooled_confidence=True, slot_repack=True, quant=e["quant"])
    else:
        terms = plan.packed_need_terms(
            cfg, wb, impl, e["batch"], bucket_for(e["max_tokens"]),
            e["packing"], depth, quant=e["quant"])
    return sum(terms.values()), terms


def fit(paths):
    sys.path.insert(0, ROOT)
    res = None
    for path in paths:
        with open(path) as f:
            got = json.load(f)
        if res is None:
            res = got
        elif got["card"] != res["card"]:
            raise ValueError(f"{path} was measured on {got['card']}, not "
                             f"{res['card']}")
        else:
            res["sections"].update(got["sections"])
    co, spread = fit_coefficients(res)
    from llm_interpretation_replication_tpu_torch.runtime import plan

    cfg = falcon()
    weights = {w["quant"]: w["bytes"] for w in res["sections"]["weights"]}
    points = []
    for e in res["sections"].get("engine", []):
        if e["oom"]:
            points.append(dict(point=_label(e), oom=True))
            continue
        need, terms = predicted_need(e)
        # the point's own peak: its increment over what was resident (both
        # quants' weights) plus its quant's measured weights
        measured = (e["peak_allocated"] - e["allocated_before"]
                    + weights[e["quant"]])
        points.append(dict(point=_label(e), measured=measured,
                           predicted=need, ratio=need / measured,
                           slack=e["peak_reserved"] - e["peak_allocated"]))
    out = dict(device=res["device"], card=res["card"], coefficients=co,
               rate_spread=spread,
               weights={q: dict(measured=b,
                                predicted=plan.weight_bytes(cfg, q))
                        for q, b in weights.items()},
               points=points,
               min_ratio=min((p["ratio"] for p in points if "ratio" in p),
                             default=None))
    print(json.dumps(out, indent=1))
    return 0 if out["min_ratio"] is None or out["min_ratio"] >= 1.0 else 1


def _label(e):
    return (f"{e['workload']} {e['attention_impl']} {e['quant']} "
            f"kv {e['kv_dtype']} chunk {e['prefill_chunk']} "
            f"batch {e['batch']}")


if __name__ == "__main__":
    sys.exit(main())
