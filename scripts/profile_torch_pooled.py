#!/usr/bin/env python3
"""Where the time goes in the engine's binary schedule, on one GPU.

    python3 scripts/profile_torch_pooled.py [--seed N]

Sets up ``chip_smoke.py``'s pooled phase (Falcon-7B at its published width
and depth, bf16, random weights from ``--seed``; its 384 prompts and
per-prompt targets, batch 32, ring capacity 16) and, for the per-batch
route, the whole-flush route and the slot ring, runs ``score_prompts``
after a warm-up batch:

1. with a pair of CUDA events around every prefill and every look-ahead
   decode call (``models.decoder.prefill`` / ``decode_steps``): the summed
   device spans of each, beside the host wall time of the call (what is
   left is host work outside them: scans, gathers, ring repacks, rows);
2. for the ring only (the other routes launch up to ~3x more kernels),
   under ``torch.profiler`` (CUDA activity): the device busy time (the sum
   of kernel durations), its idle share of the wall time, the kernel
   launches and the kernels that take the most device time.

Prints one JSON object and writes it to
``chiprun_out/profile_torch_pooled.json``.  Needs a CUDA device.
"""

import argparse
import collections
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spans(decoder, call):
    """Run ``call`` with CUDA events around every prefill and decode call:
    (wall s, {name: (calls, summed device span s)})."""
    import torch

    events = collections.defaultdict(list)
    real = {"prefill": decoder.prefill, "decode_steps": decoder.decode_steps}

    def timed(name):
        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args, **kwargs)
            end.record()
            events[name].append((start, end))
            return out
        return wrapped

    for name in real:
        setattr(decoder, name, timed(name))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(decoder, name, fn)
    return wall, {name: (len(pairs), sum(s.elapsed_time(e) for s, e in pairs)
                         / 1e3)
                  for name, pairs in events.items()}


def _profile(call):
    """``call`` under torch.profiler: wall, device busy, idle share,
    launches, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e6
            launches += 1
    busy = sum(by_name.values())
    return dict(wall_s=wall, device_busy_s=busy,
                device_idle_share=1 - busy / wall, kernel_launches=launches,
                top_kernels=[dict(name=n[:100], s=t, share=t / busy)
                             for n, t in by_name.most_common(8)])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_pooled: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from llm_interpretation_replication_tpu_torch.models import config
    from llm_interpretation_replication_tpu_torch.models import convert
    from llm_interpretation_replication_tpu_torch.models import decoder
    from llm_interpretation_replication_tpu_torch.runtime import batching
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod

    cfg = config.DecoderConfig(**config.FALCON_7B_GEOMETRY,
                               attention_impl="flash")
    weights = convert.random_params(cfg, seed=args.seed, dtype="bf16")
    tok = cs._id_tokenizer(cfg.vocab_size)
    prompts = cs._prompts(args.seed, tok, cs.POOL_PROMPTS)
    base = emod.EngineConfig(decode_completions=False, batch_size=cs.BATCH,
                             phase2_pool_target=cs.POOL_TARGET)
    batches = list(batching.batches_for_prompts(
        prompts, cs.BATCH, base.buckets, pad_id=tok.pad_token_id,
        length_sorted=True))
    targets = cs._pool_targets(args.seed, weights, cfg, batches,
                               cs.POOL_PROMPTS)
    out = dict(device=torch.cuda.get_device_name(0), prompts=len(prompts),
               batches=len(batches), routes={})
    for name, ecfg in (
            ("per_batch", dataclasses.replace(base, phase2_pool=False)),
            ("whole_flush", dataclasses.replace(base, slot_repack=False)),
            ("ring", base)):
        engine = emod.ScoringEngine("falcon", cfg, weights, tok,
                                    engine_config=ecfg)
        engine.score_prompts(prompts[:cs.BATCH], targets[:cs.BATCH])

        def call():
            return engine.score_prompts(prompts, targets)

        wall, spans = _spans(decoder, call)
        inside = sum(s for _, s in spans.values())
        route = dict(wall_s=wall, rows_per_s=len(prompts) / wall,
                     spans={k: dict(calls=n, device_span_s=s)
                            for k, (n, s) in spans.items()},
                     outside_spans_s=wall - inside)
        if name == "ring":
            route["profile"] = _profile(call)
        out["routes"][name] = route
        print(name, json.dumps(route), flush=True)
        engine.close()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_pooled.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
