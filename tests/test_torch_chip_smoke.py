"""``chip_smoke.py``'s kernel tables stay true to the sources they name, and
its pooled phase keeps driving the engine's default schedule.

The card run reads two hand-kept tables: ``KERNELS`` (wrapper, CUDA source,
line of the TPU kernel it replaces) and ``TILE_KERNELS`` (the wrappers whose
kernels run ``attention_tile.cuh`` and so go through the edge phase).  A
wrapper whose entry point moves onto the tile core must join the edge
phase; a line number must name the TPU kernel.  These tests read the files
as text: no card, no ``nvcc``.
"""

import ast
import inspect
import os
import re

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "llm_interpretation_replication_tpu_torch", "ops",
                    "csrc")
TPU_ATTENTION = os.path.join(ROOT, "llm_interpretation_replication_tpu", "ops",
                             "attention.py")


def _entry_body(source_text, entry):
    """The body of ``extern "C" int <entry>(...)`` in a CUDA source."""
    m = re.search(r'extern "C" int ' + re.escape(entry) + r"\(", source_text)
    assert m, f"no entry point {entry}"
    start = source_text.index("{", m.end())
    depth = 0
    for i in range(start, len(source_text)):
        depth += {"{": 1, "}": -1}.get(source_text[i], 0)
        if depth == 0:
            return source_text[start:i + 1]
    raise AssertionError(f"unbalanced braces in {entry}")


@pytest.mark.parametrize("wrapper,source", [k[:2] for k in chip_smoke.KERNELS])
def test_tile_core_kernels_are_in_the_edge_phase(wrapper, source):
    """A wrapper whose source includes ``attention_tile.cuh`` and whose
    entry point (``<wrapper>_bf16``) launches ``attn_tile::launch`` is in
    ``TILE_KERNELS``; one that does not is not."""
    with open(os.path.join(CSRC, source + ".cu"), encoding="utf-8") as f:
        text = f.read()
    on_core = ('#include "attention_tile.cuh"' in text
               and "attn_tile::launch" in _entry_body(text, wrapper + "_bf16"))
    assert on_core == (wrapper in chip_smoke.TILE_KERNELS)


def test_tile_kernels_are_known_wrappers():
    assert set(chip_smoke.TILE_KERNELS) <= set(chip_smoke.KERNEL_NAMES)
    assert len(set(chip_smoke.TILE_KERNELS)) == len(chip_smoke.TILE_KERNELS)


@pytest.mark.parametrize("wrapper,line", [(k[0], k[2])
                                          for k in chip_smoke.KERNELS])
def test_kernel_lines_name_the_tpu_kernel(wrapper, line):
    """Each ``KERNELS`` line number points at ``def <tpu kernel>(`` in the
    JAX package: ``_causal_grouped_kernel`` for ``causal_grouped_attention``
    and so on."""
    tpu_kernel = "_" + wrapper[:-len("_attention")] + "_kernel"
    with open(TPU_ATTENTION, encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert lines[line - 1].startswith(f"def {tpu_kernel}(")


def _call_name(call):
    return getattr(call.func, "attr", getattr(call.func, "id", None))


def test_pooled_phase_runs_the_default_schedule_beside_the_per_batch_route():
    """The pooled phase builds its engines from one ``EngineConfig`` that
    leaves ``phase2_pool``, ``slot_repack``, ``pipeline_depth`` and the OOM
    settings at their defaults, and derives the per-batch route
    (``phase2_pool=False``), the whole-flush route and depth 1 from it."""
    tree = ast.parse(inspect.getsource(chip_smoke.pooled_phase))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    configs = [c for c in calls if _call_name(c) == "EngineConfig"]
    assert len(configs) == 1
    assert {k.arg for k in configs[0].keywords} == {
        "decode_completions", "batch_size", "phase2_pool_target"}
    replaced = [{k.arg: ast.literal_eval(k.value) for k in c.keywords}
                for c in calls if _call_name(c) == "replace"]
    for override in ({"phase2_pool": False}, {"slot_repack": False},
                     {"pipeline_depth": 1}):
        assert override in replaced
    runs = {elt.elts[0].value: elt.elts[1] for elt in ast.walk(tree)
            if isinstance(elt, ast.Tuple) and len(elt.elts) == 3
            and isinstance(elt.elts[0], ast.Constant)}
    assert isinstance(runs["ring"], ast.Name) and runs["ring"].id == "base"
