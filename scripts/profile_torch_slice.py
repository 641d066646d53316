#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's scoring slice, on one GPU.

    python3 scripts/profile_torch_slice.py [--seed N] [--bucket 448]

Builds Falcon-7B (published width and depth, bf16, random weights from
``--seed``), then profiles with ``torch.profiler`` (CPU + CUDA activities)
one prefill of a batch of 32 prompts (kernel attention) and one scored
look-ahead chunk of 5 steps over the same 32 rows, and the same prefill
with every layer's attention forced through
``attention_bsnd(force="grouped")``, the head-major route chip_smoke.py
times.  For each it reports the host wall time, the device busy time (the
sum of kernel durations), the device's idle share of the wall time, the
kernel launches, and the kernels that take the most device time.  Prints
one JSON object and writes it to ``chiprun_out/profile_torch_slice.json``.
Needs a CUDA device.
"""

import argparse
import collections
import functools
import importlib
import json
import os
import sys
import time


def profile(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()                                  # warm-up outside the window
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms,
                kernel_launches=len(kernels),
                top_kernels=[dict(name=n[:120], ms=ms, share=ms / busy_ms)
                             for n, ms in by_name.most_common(8)])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket", type=int, default=448)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_slice: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from llm_interpretation_replication_tpu_torch.models import config, convert, decoder
    # the ops package re-exports a function named ``attention``
    attention = importlib.import_module(
        "llm_interpretation_replication_tpu_torch.ops.attention")

    cfg = config.DecoderConfig(**{**config.FALCON_7B_GEOMETRY,
                                  "attention_impl": "flash"})
    weights = convert.random_params(cfg, seed=args.seed, dtype="bf16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    b, s = 32, args.bucket
    ids = torch.randint(3, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    lengths = torch.randint(s - 40, s + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None]).int()
    last, cache = decoder.prefill(weights, cfg, ids, mask, s)
    tgt = torch.tensor([[3, 4]] * b, device="cuda")
    steps = 5
    out = dict(
        device=torch.cuda.get_device_name(0),
        batch=b, bucket=s,
        prefill=profile(lambda: decoder.prefill(weights, cfg, ids, mask, s)),
        lookahead_chunk=profile(lambda: decoder.decode_steps(
            weights, cfg, cache, last, mask.sum(-1), 0, steps, None, None,
            with_scores="reduced", target_ids=tgt)),
        lookahead_steps=steps,
    )
    routed = decoder.attention_bsnd
    decoder.attention_bsnd = functools.partial(attention.attention_bsnd,
                                               force="grouped")
    try:
        out["grouped_prefill"] = profile(
            lambda: decoder.prefill(weights, cfg, ids, mask, s))
    finally:
        decoder.attention_bsnd = routed
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_slice.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
