#!/usr/bin/env python3
"""Where the port's launch paths make the host wait for the card.

    python3 scripts/sync_sites.py [--out FILE]

Scores a few calls on a small Falcon geometry (``FLAGSHIP_SMALL_GEOMETRY``,
bf16, the causal kernel) on the card: ``score_prompts`` at its defaults,
the pooled binary route, ``score_prefixed`` with a binary and a confidence
leg, ``score_packed`` and ``first_token_relative_prob``.  Each pipeline's
``launch`` callback runs under PyTorch's sync debug mode "warn"; every
synchronizing CUDA operation it makes is recorded with the innermost frames
of the package that made it.  Prints one JSON object ``{"card": ...,
"sites": {"file:line:function <- ...": count}}`` (the mode's own
prototype-feature warning is not a site).  It touches only the engine's
``_run_pipelined`` signature, so it runs on a tree without
``runtime/strict.py`` as well (put that tree first on ``PYTHONPATH``).
Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import traceback
import warnings

PACKAGE = "llm_interpretation_replication_tpu_torch"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sync_sites: CUDA is not available", file=sys.stderr)
        return 2
    from llm_interpretation_replication_tpu_torch.models import config, convert
    from llm_interpretation_replication_tpu_torch.runtime import engine as emod
    from llm_interpretation_replication_tpu_torch.scoring import packed
    from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
        WordTokenizer)

    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if PACKAGE in f.filename]
        key = " <- ".join(
            f"{f.filename.split(PACKAGE + os.sep)[-1]}:{f.lineno}:{f.name}"
            for f in reversed(frames[-4:]))
        sites[key] = sites.get(key, 0) + 1

    real = emod.ScoringEngine._run_pipelined

    def run_pipelined(self, batches, launch, consume, rebatch=None):
        def warned_launch(batch):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return launch(batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return real(self, batches, warned_launch, consume, rebatch)

    emod.ScoringEngine._run_pipelined = run_pipelined
    warnings.showwarning = record
    warnings.simplefilter("always")

    tok = WordTokenizer([f"w{i}" for i in range(200)] + ["Yes", "No"])
    rng = np.random.default_rng(0)
    prompts = [" ".join(f"w{int(j)}" for j in rng.integers(0, 200, int(n)))
               for n in rng.integers(8, 60, 16)]
    cfg = config.DecoderConfig(**config.FLAGSHIP_SMALL_GEOMETRY,
                               attention_impl="flash")
    weights = convert.random_params(cfg, seed=1, device="cuda", dtype="bf16")

    def engine(**kw):
        return emod.ScoringEngine(
            "falcon", cfg, weights, tok, device="cuda",
            engine_config=emod.EngineConfig(batch_size=8, max_new_tokens=12,
                                            **kw))

    legs = [emod.LegSpec("binary"),
            emod.LegSpec("confidence", with_confidence=True,
                         max_new_tokens=10)]
    engine().score_prompts(prompts)
    engine(decode_completions=False).score_prompts(prompts)
    engine().score_prefixed([(p, (" Yes or No", " w1 w2")) for p in prompts],
                            legs=legs)
    engine().score_packed(packed.build_packs(prompts, 4, ["Yes"] * 16),
                          ("Yes", "No"))
    engine().first_token_relative_prob(prompts, top_filter=20)
    torch.cuda.synchronize()
    emod.ScoringEngine._run_pipelined = real
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    doc = {"card": card[0] if card else torch.cuda.get_device_name(0),
           "sites": sites}
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
