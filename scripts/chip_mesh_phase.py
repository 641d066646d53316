#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh phase (26) alone, on one GPU.

    python3 scripts/chip_mesh_phase.py [--seed N]

Builds every kernel as the smoke's build phase does, brings up the NCCL
world of one that the smoke's train phase leaves for it, and runs
``chip_smoke.mesh_phase``: (a) Falcon-7B at full width and depth through
``bind_mesh(make_mesh())`` against no mesh, and (b) dp2 and tp2 on two
gloo processes of the card against the world of one.  Prints the phase's
lines and its seconds; exits 1 when a gate of the phase fails.  Needs a
CUDA device.
"""

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from llm_interpretation_replication_tpu_torch.ops import _build
    from llm_interpretation_replication_tpu_torch.parallel import (
        initialize_distributed)

    if not torch.cuda.is_available():
        print("chip_mesh_phase: CUDA is not available", file=sys.stderr)
        return 2
    # the ops package re-exports a function named ``attention``
    attention = importlib.import_module(
        "llm_interpretation_replication_tpu_torch.ops.attention")
    chip_smoke.build_phase(_build, attention)
    with tempfile.TemporaryDirectory() as work:
        initialize_distributed(num_processes=1, process_id=0, device="cuda",
                               init_method="file://" + os.path.join(
                                   work, "rendezvous"))
        t0 = time.perf_counter()
        try:
            res = chip_smoke.mesh_phase(args.seed, attention, work,
                                        torch.cuda.get_device_name(0))
        except AssertionError as err:
            print(f"chip_mesh_phase: {err}", file=sys.stderr)
            return 1
        print(json.dumps(dict(seconds=time.perf_counter() - t0,
                              part_seconds=res["part_seconds"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
