"""Rules the PyTorch port keeps, and its copies of the reference's host code.

The port (and ``chip_smoke.py``, which drives it on the card) imports no
JAX, nothing of the JAX package and no ``transformers``/``tokenizers``/
``pandas``/``safetensors``/``regex``/``sentencepiece``: the machine with
the card is not known to have them.  Its copies of host-only modules
must behave exactly as the originals.
"""

import ast
import os

import numpy as np
import pytest

from llm_interpretation_replication_tpu.config import DEFAULT_BUCKETS as J_BUCKETS
from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.runtime import batching as jbatching
from llm_interpretation_replication_tpu.runtime import plan as jplan
from llm_interpretation_replication_tpu_torch.config import DEFAULT_BUCKETS
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.runtime import batching, plan
from test_torch_slots import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "llm_interpretation_replication_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "llm_interpretation_replication_tpu",
             "transformers", "tokenizers", "pandas", "safetensors", "regex",
             "sentencepiece"}


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "profile_torch_slice.py"),
           os.path.join(ROOT, "scripts", "profile_torch_pooled.py"),
           os.path.join(ROOT, "scripts", "sync_sites.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    return sorted(out)


def _forbidden_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(os.path.relpath(path, ROOT), n) for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_imports_nothing_of_jax():
    sources = _port_sources()
    assert len(sources) > 10
    bad = []
    for path in sources:
        bad += _forbidden_imports(path)
    assert not bad, bad


@pytest.mark.parametrize("rel", [
    "chip_smoke.py",
    "scripts/profile_torch_slice.py",
    "scripts/profile_torch_pooled.py",
    "scripts/sync_sites.py",
    "llm_interpretation_replication_tpu_torch/ops/__init__.py",
    "llm_interpretation_replication_tpu_torch/ops/_build.py",
    "llm_interpretation_replication_tpu_torch/ops/attention.py",
    "llm_interpretation_replication_tpu_torch/ops/quant.py",
    "llm_interpretation_replication_tpu_torch/models/config.py",
    "llm_interpretation_replication_tpu_torch/models/convert.py",
    "llm_interpretation_replication_tpu_torch/models/decoder.py",
    "llm_interpretation_replication_tpu_torch/runtime/engine.py",
    "llm_interpretation_replication_tpu_torch/runtime/slots.py",
    "llm_interpretation_replication_tpu_torch/runtime/faults.py",
    "llm_interpretation_replication_tpu_torch/runtime/batching.py",
    "llm_interpretation_replication_tpu_torch/runtime/plan.py",
    "llm_interpretation_replication_tpu_torch/utils/telemetry.py",
    "llm_interpretation_replication_tpu_torch/__main__.py",
    "llm_interpretation_replication_tpu_torch/config/__init__.py",
    "llm_interpretation_replication_tpu_torch/gen/rephrase.py",
    "llm_interpretation_replication_tpu_torch/runtime/loader.py",
    "llm_interpretation_replication_tpu_torch/scoring/prompts.py",
    "llm_interpretation_replication_tpu_torch/sweeps/base_vs_instruct_100q.py",
    "llm_interpretation_replication_tpu_torch/sweeps/perturbation.py",
    "llm_interpretation_replication_tpu_torch/scoring/packed.py",
    "llm_interpretation_replication_tpu_torch/sweeps/writers.py",
    "llm_interpretation_replication_tpu_torch/utils/checkpoint.py",
    "llm_interpretation_replication_tpu_torch/utils/logging.py",
    "llm_interpretation_replication_tpu_torch/utils/retry.py",
    "llm_interpretation_replication_tpu_torch/utils/tokenizer.py",
    "llm_interpretation_replication_tpu_torch/utils/xlsx.py",
    "llm_interpretation_replication_tpu_torch/device.py",
    "llm_interpretation_replication_tpu_torch/obs/__init__.py",
    "llm_interpretation_replication_tpu_torch/obs/benchdiff.py",
    "llm_interpretation_replication_tpu_torch/obs/flight.py",
    "llm_interpretation_replication_tpu_torch/obs/metrics.py",
    "llm_interpretation_replication_tpu_torch/obs/profiler.py",
    "llm_interpretation_replication_tpu_torch/obs/report.py",
    "llm_interpretation_replication_tpu_torch/obs/tracer.py",
    "llm_interpretation_replication_tpu_torch/runtime/strict.py",
    "llm_interpretation_replication_tpu_torch/utils/profiling.py",
    "llm_interpretation_replication_tpu_torch/sweeps/instruct_sweep.py",
])
def test_slice_modules_are_guarded(rel):
    """The modules the kernels, the int8 path, the pool, the slot ring,
    the OOM ladder, the sweep shells, the family translators and
    converters, the loader, the CLI, the strict guard and the
    observability layer live in are among the guarded sources and import
    nothing forbidden."""
    path = os.path.join(ROOT, rel)
    assert path in _port_sources()
    assert not _forbidden_imports(path)


def test_known_phases_match_reference():
    """The phase table every span's ``phase`` comes from is the JAX
    package's, name for name."""
    from llm_interpretation_replication_tpu.obs import tracer as jtracer
    from llm_interpretation_replication_tpu_torch.obs import tracer

    assert tracer.KNOWN_PHASES == jtracer.KNOWN_PHASES


def test_cli_refuses_only_the_plan_and_mesh_flags():
    """Of the run-config flags, only the plan search and the mesh axes
    still refuse; the observability flags run."""
    import argparse

    from llm_interpretation_replication_tpu_torch import __main__ as cli

    parser = argparse.ArgumentParser()
    cli._add_run_config_args(parser)
    refused = set()
    for argv in (["--strict"], ["--trace"], ["--profile", "p"],
                 ["--metrics"], ["--plan-search"], ["--mesh-model", "2"],
                 ["--mesh-seq", "2"]):
        try:
            cli._refuse_unported(parser.parse_args(argv))
        except NotImplementedError:
            refused.add(argv[0])
    assert refused == {"--plan-search", "--mesh-model", "--mesh-seq"}
    with open(os.path.join(PORT, "__main__.py"), encoding="utf-8") as f:
        assert "Guards and device observability" not in f.read()


def test_ops_api_matches_reference():
    """The port's ops package exports the reference's attention and int8
    names (its MoE ops are ROADMAP.md queue 1's "MoE ops" item)."""
    import llm_interpretation_replication_tpu.ops as jops
    import llm_interpretation_replication_tpu_torch.ops as tops

    assert set(tops.__all__) == set(jops.__all__) - {
        "init_moe_params", "moe_mlp_dense", "moe_mlp_sharded"}
    for name in tops.__all__:
        assert callable(getattr(tops, name))


@pytest.mark.parametrize("source,tpu_kernel", [
    ("causal_grouped_attention", "_causal_grouped_kernel"),
    ("head_major_attention", "_grouped_kernel"),
    ("head_major_attention", "_flash_kernel"),
])
def test_every_tpu_kernel_has_a_cuda_source(source, tpu_kernel):
    """Each function of the reference that reaches ``pl.pallas_call`` has a
    CUDA source in the port that names it as the kernel it replaces."""
    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu", "ops",
                           "attention.py"), encoding="utf-8") as f:
        assert f"def {tpu_kernel}(" in f.read()
    with open(os.path.join(PORT, "ops", "csrc", source + ".cu"),
              encoding="utf-8") as f:
        assert f"`{tpu_kernel}`" in f.read()


def test_copied_config_matches_reference():
    assert DEFAULT_BUCKETS == J_BUCKETS
    assert tconfig.FALCON_7B_GEOMETRY == jconfig.FALCON_7B_GEOMETRY
    assert tconfig.FLAGSHIP_SMALL_GEOMETRY == jconfig.FLAGSHIP_SMALL_GEOMETRY
    t = tconfig.DecoderConfig(**tconfig.FALCON_7B_GEOMETRY)
    j = jconfig.DecoderConfig(**jconfig.FALCON_7B_GEOMETRY)
    assert ({f: getattr(t, f) for f in t.__dataclass_fields__}
            == {f: getattr(j, f) for f in j.__dataclass_fields__})
    for impl in ("xla", "flash", "auto"):
        tc = tconfig.DecoderConfig(**{**tconfig.FALCON_7B_GEOMETRY,
                                      "attention_impl": impl})
        jc = jconfig.DecoderConfig(**{**jconfig.FALCON_7B_GEOMETRY,
                                      "attention_impl": impl})
        for s in (432, 2048):
            assert tc.use_flash_attention(s) == jc.use_flash_attention(s)
    with pytest.raises(ValueError):
        tconfig.DecoderConfig(**{**tconfig.FALCON_7B_GEOMETRY,
                                 "attention_impl": "flash",
                                 "position_embedding": "alibi"})


def test_falcon_config_translator_matches_reference():
    import types

    hf = types.SimpleNamespace(vocab_size=65024, hidden_size=4544,
                               num_hidden_layers=32, num_attention_heads=71,
                               multi_query=True, parallel_attn=True, bias=False)
    assert tconfig.falcon_config(hf).__dict__ == jconfig.falcon_config(hf).__dict__


@pytest.mark.parametrize("length_sorted", [True, False])
def test_copied_batching_matches_reference(length_sorted):
    rng = np.random.default_rng(0)
    encoded = [list(rng.integers(3, 100, int(n)))
               for n in rng.integers(1, 140, 23)]
    got = list(batching.batches_for_prompts(encoded, 4, (64, 80, 144),
                                            pad_id=0, length_sorted=length_sorted))
    ref = list(jbatching.batches_for_prompts(encoded, 4, (64, 80, 144),
                                             pad_id=0, length_sorted=length_sorted))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.bucket_len == r.bucket_len
        for f in ("token_ids", "attention_mask", "indices"):
            np.testing.assert_array_equal(getattr(g, f), getattr(r, f))
    with pytest.raises(ValueError):
        batching.bucket_for(3000)


def test_copied_plan_matches_reference():
    for args in [(10, 10, 50, False, None), (10, 10, 50, True, None),
                 (10, 10, 50, True, 7), (4, 10, 50, True, 23)]:
        got, ref = plan.generation_plan(*args), jplan.generation_plan(*args)
        assert (got.scan_steps, got.total_new_tokens, got.chunks,
                got.cache_key) == (ref.scan_steps, ref.total_new_tokens,
                                   ref.chunks, ref.cache_key)
        assert tuple(got) == tuple(ref)
        assert plan.plan_cache_key(*args) == jplan.plan_cache_key(*args)
    assert plan.POOL_LEN_MENU == jplan.POOL_LEN_MENU
    assert plan.CONF_POOL_LEN_MENU == jplan.CONF_POOL_LEN_MENU
    for n in (1, 64, 256, 257, 320, 448, 512, 600, 2048, 3000):
        assert plan.pool_len_for(n) == jplan.pool_len_for(n)
        assert plan.conf_pool_len_for(n) == jplan.conf_pool_len_for(n)
