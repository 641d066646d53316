#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure (the exit code is then non-zero and no result
line is printed):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile every CUDA kernel of the slice from ``ops/csrc``;
3. kernels: hold each kernel against its plain PyTorch version (float32
   from the same bf16 inputs) at the shapes the main path gives it, and
   time it (CUDA events) beside its plain version, its bound and one
   PyTorch library call computing the same function;
4. slice: Falcon-7B at its published width and depth, bf16, random weights
   from ``--seed``, scores 96 pre-tokenized prompts of 100-440 tokens in
   batches of 32 through ``ScoringEngine.score_prompts`` with the kernel
   carrying every prefill; the launch counters must show the kernel ran,
   the same prompts go through the dense path, and the position-0 logits of
   both are held against a float32 reference of the same weights.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Per-shape details go to
``chiprun_out/chip_smoke.json``.  Needs one CUDA device; runs nothing on the
CPU in its place.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ERR_TOL = 1e-2            # kernel vs plain, bf16 output of unit-normal inputs
# position-0 logits: the kernel path's relative L2 distance from a float32
# reference may exceed the dense bf16 path's by at most this factor
KERNEL_VS_DENSE_ERR_RATIO = 1.25
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak, same source
KERNEL_SHAPES = [         # (label, B, S, N, G, D)
    ("falcon-7b", 32, 432, 71, 1, 64),
    ("falcon-7b-long", 4, 2048, 71, 1, 64),
    ("gqa", 16, 448, 32, 8, 128),
    ("mha-small-1b", 16, 320, 16, 16, 128),
]
N_PROMPTS, BATCH = 96, 32


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


def kernel_phase(attention, gen):
    """Every shape, causal and not: error vs the plain version, times."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows = []
    for label, b, s, n, g, d in KERNEL_SHAPES:
        q = torch.randn(b, s, n, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, s, g, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, s, g, d, generator=gen, device=dev).bfloat16()
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
        lengths[0] = s
        if b > 2:
            lengths[1], lengths[2] = 1, 0
        pos = torch.arange(s, device=dev)
        valid = (pos[None, :] < lengths[:, None])[:, :, None, None]
        for causal in (True, False):
            out = attention.causal_grouped_attention(q, k, v, lengths, causal)
            torch.cuda.synchronize()
            ref = attention.causal_grouped_attention_plain(
                q.float(), k.float(), v.float(), lengths, causal)
            err = float(((out.float() - ref).abs() * valid).max())
            zero_rows = out[lengths == 0]
            if not torch.isfinite(out).all():
                raise AssertionError(f"{label}: non-finite kernel output")
            if zero_rows.numel() and bool((zero_rows != 0).any()):
                raise AssertionError(f"{label}: length-0 rows are not zero")
            if err > ERR_TOL:
                raise AssertionError(f"{label} causal={causal}: max abs err "
                                     f"{err} > {ERR_TOL}")
            ms = time_ms(lambda: attention.causal_grouped_attention(
                q, k, v, lengths, causal), iters=50)
            plain_ms = time_ms(lambda: attention.causal_grouped_attention_plain(
                q, k, v, lengths, causal), iters=3, warmup=1)
            # yardstick only: one PyTorch call computing the same function
            bound = torch.minimum(lengths[:, None].long(), pos[None, :] + 1) \
                if causal else lengths[:, None].long().expand(b, s)
            mask = (pos[None, None, :] < bound[:, :, None])[:, None]
            qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=g != n), iters=10)
            bound_ms, bound_by = attention_bound_ms(
                b, s, n, g, d, lengths.tolist(), causal)
            row = dict(shape=label, B=b, S=s, N=n, G=g, D=d, causal=causal,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
            rows.append(row)
            say("kernel", json.dumps(row))
            del out, ref
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _to_float32(tree):
    return {k: _to_float32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def slice_phase(seed, attention):
    """Falcon-7B binary-leg scoring through the port's engine."""
    import numpy as np
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
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.linspace(100, 440, N_PROMPTS).astype(int))
    prompts = [rng.integers(3, len(tok), int(n)).tolist() for n in lengths]
    ecfg = emod.EngineConfig(decode_completions=False, phase2_pool=False,
                             batch_size=BATCH)
    engine = emod.ScoringEngine("falcon", cfg, weights, tok, engine_config=ecfg,
                                device=device)
    engine.score_prompts(prompts[:BATCH])              # warm-up, not counted
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    attention.causal_grouped_attention.launches = 0
    t0 = time.perf_counter()
    rows = engine.score_prompts(prompts)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = attention.causal_grouped_attention.launches
    peak = torch.cuda.max_memory_allocated()

    batches = list(batching.batches_for_prompts(
        prompts, BATCH, ecfg.buckets, pad_id=tok.pad_token_id,
        length_sorted=True))
    if launches < cfg.num_layers * len(batches):
        raise AssertionError(f"kernel launched {launches} times; the "
                             f"{len(batches)} prefills need "
                             f"{cfg.num_layers * len(batches)}")
    if len(rows) != N_PROMPTS or not all(r["success"] for r in rows):
        raise AssertionError("missing or failed rows")
    for r in rows:
        vals = [r[f] for f in ("yes_prob", "no_prob", "relative_prob",
                               "first_token_relative_prob")]
        if not all(np.isfinite(vals)) or not 0 <= r["relative_prob"] <= 1:
            raise AssertionError(f"bad row {r}")

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
        sq["kernel_vs_dense"] += float((a - b).square().sum())
        sq["kernel_vs_fp32"] += float((a - r).square().sum())
        sq["dense_vs_fp32"] += float((b - r).square().sum())
        den_bf16 += float(b.square().sum())
        den_fp32 += float(r.square().sum())
        hit_a = yes_no.first_token_scan(a, yes_id, no_id, ecfg.top_k)[4]
        hit_b = yes_no.first_token_scan(b, yes_id, no_id, ecfg.top_k)[4]
        same_hit0 += int((hit_a == hit_b).sum())
        undecided += int((~hit_a).sum())
    del ref_weights

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
    return result


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
    from llm_interpretation_replication_tpu_torch.ops import _build, attention

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    say(smi.splitlines()[0])

    t0 = time.perf_counter()
    rec = _build.build(attention.KERNEL_SOURCE)
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for line in rec.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"build {attention.KERNEL_SOURCE}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    krows = kernel_phase(attention, gen)
    sres = slice_phase(args.seed, attention)

    main_row = next(r for r in krows if r["shape"] == "falcon-7b" and r["causal"])
    kernels = [dict(
        name="causal_grouped_attention", route="cuda",
        source="llm_interpretation_replication_tpu_torch/ops/csrc/"
               "causal_grouped_attention.cu",
        replaces="llm_interpretation_replication_tpu/ops/attention.py:355",
        launches=sres["kernel_launches"],
        max_abs_err=max(r["max_abs_err"] for r in krows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"])]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, kernel_rows=krows,
                       slice=sres, kernels=kernels), f, indent=1)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
