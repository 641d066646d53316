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
             "sentencepiece", "google.protobuf"}
#: modules the card's machine lacks that the port may import only where
#: nothing on the card reaches: the figures module, sklearn's TF-IDF
#: inside the similarity validator's one function that uses it, and
#: sentence-transformers inside the similarity report's optional
#: embedding-model loader
OFF_CARD = {"matplotlib": {"viz/figures.py": None},
            "sklearn": {"stats/similarity.py": "tfidf_cosine_matrix"},
            "sentence_transformers": {
                "analysis/similarity_report.py": "load_embedding_model"}}


def _imported_names(node):
    """The dotted module names an import statement reaches (``from a
    import b`` reaches ``a`` and ``a.b``)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        mod = node.module or ""
        return [mod] + [f"{mod}.{a.name}" for a in node.names]
    return []


def _matches(name, modules):
    return any(name == m or name.startswith(m + ".") for m in modules)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "profile_torch_slice.py"),
           os.path.join(ROOT, "scripts", "profile_torch_pooled.py"),
           os.path.join(ROOT, "scripts", "sync_sites.py"),
           os.path.join(ROOT, "scripts", "decode_layout_probe.py"),
           os.path.join(ROOT, "scripts", "calibrate_plan_torch.py"),
           os.path.join(ROOT, "scripts", "chip_mesh_phase.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    return sorted(out)


def _forbidden_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        names = _imported_names(node)
        bad += [(os.path.relpath(path, ROOT), n) for n in names
                if _matches(n, FORBIDDEN)]
    return sorted(set(bad))


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
    "scripts/decode_layout_probe.py",
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
    "llm_interpretation_replication_tpu_torch/serve/__init__.py",
    "llm_interpretation_replication_tpu_torch/serve/config.py",
    "llm_interpretation_replication_tpu_torch/serve/request.py",
    "llm_interpretation_replication_tpu_torch/serve/queue.py",
    "llm_interpretation_replication_tpu_torch/serve/coalescer.py",
    "llm_interpretation_replication_tpu_torch/serve/scheduler.py",
    "llm_interpretation_replication_tpu_torch/serve/replay.py",
    "llm_interpretation_replication_tpu_torch/serve/load.py",
    "llm_interpretation_replication_tpu_torch/serve/supervisor.py",
    "llm_interpretation_replication_tpu_torch/serve/pool.py",
    "llm_interpretation_replication_tpu_torch/serve/cli.py",
    "llm_interpretation_replication_tpu_torch/api_backends/__init__.py",
    "llm_interpretation_replication_tpu_torch/api_backends/cost.py",
    "llm_interpretation_replication_tpu_torch/utils/testing.py",
    "llm_interpretation_replication_tpu_torch/api_backends/transport.py",
    "llm_interpretation_replication_tpu_torch/api_backends/cache.py",
    "llm_interpretation_replication_tpu_torch/api_backends/openai_client.py",
    "llm_interpretation_replication_tpu_torch/api_backends/anthropic_client.py",
    "llm_interpretation_replication_tpu_torch/api_backends/gemini_client.py",
    "llm_interpretation_replication_tpu_torch/api_backends/evaluators.py",
    "llm_interpretation_replication_tpu_torch/gen/__init__.py",
    "llm_interpretation_replication_tpu_torch/gen/irrelevant.py",
    "llm_interpretation_replication_tpu_torch/sweeps/api_perturbation.py",
    "llm_interpretation_replication_tpu_torch/utils/sentencepiece_model.py",
    "llm_interpretation_replication_tpu_torch/utils/strict_json.py",
    "llm_interpretation_replication_tpu_torch/native/__init__.py",
    "llm_interpretation_replication_tpu_torch/stats/__init__.py",
    "llm_interpretation_replication_tpu_torch/stats/bootstrap.py",
    "llm_interpretation_replication_tpu_torch/stats/normality.py",
    "llm_interpretation_replication_tpu_torch/stats/power.py",
    "llm_interpretation_replication_tpu_torch/stats/similarity.py",
    "llm_interpretation_replication_tpu_torch/stats/truncated.py",
    "llm_interpretation_replication_tpu_torch/viz/__init__.py",
    "llm_interpretation_replication_tpu_torch/viz/latex.py",
    "llm_interpretation_replication_tpu_torch/viz/figures.py",
    "llm_interpretation_replication_tpu_torch/utils/frame.py",
    "llm_interpretation_replication_tpu_torch/stats/compliance.py",
    "llm_interpretation_replication_tpu_torch/stats/correlations.py",
    "llm_interpretation_replication_tpu_torch/survey/__init__.py",
    "llm_interpretation_replication_tpu_torch/survey/pipeline.py",
    "llm_interpretation_replication_tpu_torch/survey/mae_100q.py",
    "llm_interpretation_replication_tpu_torch/survey/demographics.py",
    "llm_interpretation_replication_tpu_torch/survey/variants.py",
    "llm_interpretation_replication_tpu_torch/analysis/__init__.py",
    "llm_interpretation_replication_tpu_torch/analysis/questions.py",
    "llm_interpretation_replication_tpu_torch/analysis/perturbation_report.py",
    "llm_interpretation_replication_tpu_torch/analysis/similarity_report.py",
    "llm_interpretation_replication_tpu_torch/analysis/model_comparison.py",
    "llm_interpretation_replication_tpu_torch/analysis/base_vs_instruct_figs.py",
    "llm_interpretation_replication_tpu_torch/analysis/combined_confidence.py",
    "llm_interpretation_replication_tpu_torch/runtime/__init__.py",
    "llm_interpretation_replication_tpu_torch/runtime/plan.py",
    "llm_interpretation_replication_tpu_torch/runtime/plan_search.py",
    "llm_interpretation_replication_tpu_torch/parallel/__init__.py",
    "llm_interpretation_replication_tpu_torch/parallel/mesh.py",
    "llm_interpretation_replication_tpu_torch/parallel/sharding.py",
    "llm_interpretation_replication_tpu_torch/parallel/tensor_parallel.py",
    "llm_interpretation_replication_tpu_torch/parallel/pipeline.py",
    "llm_interpretation_replication_tpu_torch/parallel/ring_attention.py",
    "llm_interpretation_replication_tpu_torch/parallel/ulysses.py",
    "llm_interpretation_replication_tpu_torch/runtime/train.py",
    "llm_interpretation_replication_tpu_torch/runtime/row_parallel.py",
    "llm_interpretation_replication_tpu_torch/lint/__init__.py",
    "llm_interpretation_replication_tpu_torch/lint/report.py",
    "llm_interpretation_replication_tpu_torch/lint/baseline.py",
    "llm_interpretation_replication_tpu_torch/lint/visitor.py",
    "llm_interpretation_replication_tpu_torch/lint/rules.py",
    "llm_interpretation_replication_tpu_torch/lint/threads.py",
    "llm_interpretation_replication_tpu_torch/lint/contracts.py",
    "llm_interpretation_replication_tpu_torch/lint/cli.py",
    "scripts/calibrate_plan_torch.py",
    "scripts/chip_mesh_phase.py",
])
def test_slice_modules_are_guarded(rel):
    """The modules the kernels, the int8 path, the pool, the slot ring,
    the OOM ladder, the sweep shells, the family translators and
    converters, the loader, the CLI, the strict guard, the
    observability layer and the linter live in are among the guarded
    sources and import nothing forbidden."""
    path = os.path.join(ROOT, rel)
    assert path in _port_sources()
    assert not _forbidden_imports(path)


def test_api_leg_imports_no_pandas_at_run_time():
    """Importing the API leg (clients, evaluators, sweeps, the corpus
    generator, the CLI) loads neither pandas nor JAX nor the JAX package,
    and creates no CUDA context: the card's machine has no pandas, and the
    API commands do no device work."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "import llm_interpretation_replication_tpu_torch.api_backends\n"
        "import llm_interpretation_replication_tpu_torch.sweeps.api_perturbation\n"
        "import llm_interpretation_replication_tpu_torch.gen\n"
        "import llm_interpretation_replication_tpu_torch.__main__\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('pandas', 'jax', 'jaxlib', 'llm_interpretation_replication_tpu'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_forbidden_imports_catch_protobuf(tmp_path):
    """``google.protobuf`` is caught however it is imported; the rest of
    ``google`` is not forbidden."""
    path = tmp_path / "m.py"
    for src, caught in (("import google.protobuf", True),
                        ("from google.protobuf import message", True),
                        ("from google import protobuf", True),
                        ("import google.auth", False)):
        path.write_text(src + "\n")
        assert bool(_forbidden_imports(str(path))) == caught, src


def test_off_card_modules_stay_where_nothing_on_the_card_reaches():
    """``matplotlib`` is imported only by ``viz/figures.py``, ``sklearn``
    only inside ``stats/similarity.tfidf_cosine_matrix`` and
    ``sentence_transformers`` only inside
    ``analysis/similarity_report.load_embedding_model`` (the card's
    machine has none of them)."""
    found = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        rel = os.path.relpath(path, PORT)
        funcs = {}
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    funcs.setdefault(id(node), fn.name)
        for node in ast.walk(tree):
            for name in _imported_names(node):
                for mod, allowed in OFF_CARD.items():
                    if not _matches(name, {mod}):
                        continue
                    where = funcs.get(id(node))
                    found.append((rel, mod, where))
                    assert rel in allowed and allowed[rel] in (None, where), \
                        (rel, name, where)
    assert {(r, m) for r, m, _ in found} == {
        ("viz/figures.py", "matplotlib"), ("stats/similarity.py", "sklearn"),
        ("analysis/similarity_report.py", "sentence_transformers")}


def test_host_layers_import_nothing_off_card_at_run_time():
    """Importing the port's CLI, ``stats``, ``survey``, ``analysis``,
    ``utils.frame``, ``native``, ``viz.latex`` and the SentencePiece
    reader loads neither matplotlib nor sklearn nor sentence-transformers
    (nor pandas, protobuf or JAX) and creates no CUDA context."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "import llm_interpretation_replication_tpu_torch.__main__\n"
        "import llm_interpretation_replication_tpu_torch.stats\n"
        "import llm_interpretation_replication_tpu_torch.survey\n"
        "import llm_interpretation_replication_tpu_torch.analysis\n"
        "import llm_interpretation_replication_tpu_torch.utils.frame\n"
        "import llm_interpretation_replication_tpu_torch.native\n"
        "import llm_interpretation_replication_tpu_torch.viz.latex\n"
        "import llm_interpretation_replication_tpu_torch.utils."
        "sentencepiece_model\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'sklearn', 'sentence_transformers', 'pandas', "
        "'jax', 'jaxlib', 'llm_interpretation_replication_tpu') or "
        "m.startswith("
        "'google.protobuf'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


#: the host commands and their option counts (``-h`` included)
HOST_COMMANDS = {
    "power-analysis": 5, "sample-statements": 4,
    "analyze-survey": 7, "analyze-combined": 3, "demographics-table": 4,
    "analyze-perturbations": 4, "similarity": 6, "analyze-100q": 6,
    "analyze-mae-100q": 7, "extract-survey2-questions": 4,
    "analyze-3way": 6, "analyze-agreement": 7,
    "analyze-family-differences": 7, "ground-truth-figure": 4,
    "model-comparison": 6, "cross-kappa": 5,
    "run-closed-source": 6, "run-irrelevant": 13, "verify-replication": 27,
}


#: run-config options the port has and the reference has not
PORT_ONLY_RUN_CONFIG = {"hbm_gib"}


@pytest.mark.parametrize("command", sorted(HOST_COMMANDS))
def test_host_command_parsers_match_reference(command):
    """The port's host commands (``power-analysis``, ``sample-statements``,
    the fourteen analysis commands and the three vendor-evaluation ones)
    take the reference's options with the same defaults, types and
    arities; ``verify-replication``'s run-config options by name (their
    device default is the card's)."""
    import argparse

    from llm_interpretation_replication_tpu import __main__ as jmain
    from llm_interpretation_replication_tpu_torch import __main__ as tmain

    shared = set()
    if command == "verify-replication":       # it takes the run config
        run_config = argparse.ArgumentParser()
        tmain._add_run_config_args(run_config)
        shared = {a.dest for a in run_config._actions if a.dest != "help"}

    def options(parser):
        return sorted((tuple(a.option_strings), a.dest)
                      + ((a.default, a.required, str(a.type), a.nargs,
                          a.const) if a.dest not in shared else ())
                      for a in parser._actions)

    got = options(_serve_parser(tmain, command, []))
    ref = options(_serve_parser(jmain, command, []))
    if shared:
        # the port's run config adds the device memory the plan search
        # budgets (it has no built-in device size)
        port_only = [o for o in got if o[1] in PORT_ONLY_RUN_CONFIG]
        assert [o[1] for o in port_only] == sorted(PORT_ONLY_RUN_CONFIG)
        got = [o for o in got if o not in port_only]
    assert got == ref
    assert len(got) == HOST_COMMANDS[command]


def test_known_phases_match_reference():
    """The phase table every span's ``phase`` comes from is the JAX
    package's, name for name."""
    from llm_interpretation_replication_tpu.obs import tracer as jtracer
    from llm_interpretation_replication_tpu_torch.obs import tracer

    assert tracer.KNOWN_PHASES == jtracer.KNOWN_PHASES


def test_cli_refuses_only_the_plan_and_mesh_flags():
    """No run-config flag refuses any more: the plan search, the
    observability flags and, since the engine runs on a mesh, the mesh
    axes all land in the ``RunConfig`` (a world too small for the mesh
    raises when the engine is built, ``tests/test_torch_cli.py``)."""
    import argparse

    from llm_interpretation_replication_tpu_torch import __main__ as cli

    parser = argparse.ArgumentParser()
    cli._add_run_config_args(parser)
    assert not hasattr(cli, "_refuse_unported")
    for argv in (["--strict"], ["--trace"], ["--profile", "p"],
                 ["--metrics"], ["--plan-search"], ["--mesh-model", "2"],
                 ["--mesh-seq", "2"]):
        rc = cli._run_config(parser.parse_args(argv))
        assert (rc.mesh_model, rc.mesh_seq) == (
            2 if argv[0] == "--mesh-model" else 1,
            2 if argv[0] == "--mesh-seq" else 1)
    with open(os.path.join(PORT, "__main__.py"), encoding="utf-8") as f:
        assert "Guards and device observability" not in f.read()


#: the files holding the plan model's coefficients (the reference's
#: ``lint/contracts.CALIBRATED_FILES``)
CALIBRATED_FILES = ("runtime/plan.py", "runtime/plan_search.py")
#: a coefficient's provenance: measured by the calibration script on a
#: named card at a named power limit, or a prior with its reason
ANCHOR_RE = (r"#:?\s*(anchor: scripts/calibrate_plan_torch\.py on "
             r"NVIDIA [^,]+, \d+\.\d+ W$|prior: \S)")
#: what no line of those files may name: a TPU record or chip
TPU_ANCHOR_RE = r"BENCH_r\d|MULTICHIP_r\d|v5e|HBM_BYTES_V5E"


def _coefficient_lines(text):
    """(name, line number, cited) of every module-level UPPER_CASE name
    bound to a numeric literal; the citation rides the line or the comment
    block right above it (the reference's rule)."""
    import re

    def numeric(node):
        if isinstance(node, ast.Constant):
            return (isinstance(node.value, (int, float))
                    and not isinstance(node.value, bool))
        if isinstance(node, ast.UnaryOp):
            return numeric(node.operand)
        if isinstance(node, ast.BinOp):
            return numeric(node.left) and numeric(node.right)
        return False

    lines = text.splitlines()
    out = []
    for node in ast.parse(text).body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and re.fullmatch(r"[A-Z][A-Z0-9_]*", node.targets[0].id)
                and numeric(node.value)):
            continue
        cited = bool(re.search(ANCHOR_RE, lines[node.lineno - 1]))
        i = node.lineno - 2
        while not cited and i >= 0 and lines[i].lstrip().startswith("#"):
            cited = bool(re.search(ANCHOR_RE, lines[i]))
            i -= 1
        out.append((node.targets[0].id, node.lineno, cited))
    return out


@pytest.mark.parametrize("rel", CALIBRATED_FILES)
def test_plan_coefficients_carry_their_provenance(rel):
    """Every coefficient of the port's plan model carries an ``# anchor:``
    naming the calibration script, the card and its power limit, or a
    ``# prior:`` with its reason; no line names a TPU record or chip."""
    import re

    with open(os.path.join(PORT, rel), encoding="utf-8") as f:
        text = f.read()
    found = _coefficient_lines(text)
    assert len(found) >= (9 if rel.endswith("plan.py") else 17)
    assert [name for name, _, cited in found if not cited] == []
    assert not re.search(TPU_ANCHOR_RE, text)


@pytest.mark.parametrize("line,cited", [
    ("X = 1.0  # anchor: scripts/calibrate_plan_torch.py on NVIDIA H100 "
     "80GB HBM3, 700.00 W", True),
    ("X = 1.0  # prior: one card, no run to measure", True),
    ("X = 1.0  # anchor: BENCH_r05", False),
    ("X = 1.0  # anchor: scripts/calibrate_plan_torch.py", False),
    ("X = 1 << 28", False),
    ("X = (1, 2)  # a menu, not a coefficient", None),
])
def test_provenance_rule_catches_a_missing_or_tpu_anchor(line, cited):
    found = _coefficient_lines(line + "\n")
    assert (found[0][2] if found else None) == cited


def test_ops_api_matches_reference():
    """The port's ops package exports every name of the reference's: the
    attention, int8 and MoE ops."""
    import llm_interpretation_replication_tpu.ops as jops
    import llm_interpretation_replication_tpu_torch.ops as tops

    assert set(tops.__all__) == set(jops.__all__)
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


def _fields(cls):
    import dataclasses

    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_copied_serve_config_and_request_match_reference():
    """``serve/config.py`` and ``serve/request.py`` are copies: the same
    fields and defaults, the same error hierarchy, the same validation."""
    from llm_interpretation_replication_tpu.serve import config as jsc
    from llm_interpretation_replication_tpu.serve import request as jreq
    from llm_interpretation_replication_tpu_torch.serve import config as tsc
    from llm_interpretation_replication_tpu_torch.serve import request as treq

    assert _fields(tsc.SchedulerConfig) == _fields(jsc.SchedulerConfig)
    assert _fields(treq.ScoreRequest) == _fields(jreq.ScoreRequest)
    for name in ("DeadlineExceeded", "QueueFull", "SchedulerClosed",
                 "PoisonousRequest"):
        t, j = getattr(treq, name), getattr(jreq, name)
        assert issubclass(t, treq.ServeError) and issubclass(j, jreq.ServeError)
        assert [c.__name__ for c in t.__mro__] == [c.__name__ for c in j.__mro__]
    assert treq.ScoreFuture.__slots__ == jreq.ScoreFuture.__slots__
    for kw in (dict(), dict(prompt="p", prefix="a", suffix="b"),
               dict(prefix="a"), dict(prompt="p", targets=("Yes",)),
               dict(prompt="p", decode_k=0), dict(prompt="p"),
               dict(prefix="a", suffix="b", decode_k=2)):
        errs = []
        for mod in (treq, jreq):
            try:
                mod.ScoreRequest(**kw).validate()
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], kw


def test_copied_queue_matches_reference():
    """``serve/queue.py``: the same pops, expiries and refusals on the
    same tickets."""
    from llm_interpretation_replication_tpu.serve import queue as jq
    from llm_interpretation_replication_tpu.serve import request as jreq
    from llm_interpretation_replication_tpu_torch.serve import queue as tq
    from llm_interpretation_replication_tpu_torch.serve import request as treq

    def run(q_mod, r_mod):
        q = q_mod.RequestQueue(5)
        spec = [(0, 0.0, None, "a"), (3, 0.1, None, "b"), (3, 0.2, 0.5, "a"),
                (1, 0.3, None, "a"), (0, 0.4, 0.2, "b")]
        for i, (prio, t, dl, key) in enumerate(spec):
            q.put(q_mod.Ticket(request=r_mod.ScoreRequest(prompt=f"q{i}",
                                                          priority=prio),
                               future=r_mod.ScoreFuture(), seq=i + 1,
                               enqueue_t=t, deadline=dl, key=key))
        out = []
        try:
            q.put(q_mod.Ticket(request=r_mod.ScoreRequest(prompt="x"),
                               future=r_mod.ScoreFuture(), seq=9,
                               enqueue_t=0.0, deadline=None))
        except r_mod.QueueFull as e:
            out.append(("full", str(e)))
        out.append([t.seq for t in q.pop_compatible("a", 1,
                                                     now_fn=lambda: 0.3)])
        out.append(q.oldest_wait_s(now_fn=lambda: 1.0))
        group, expired = q.pop_group(2, 0.05, now_fn=lambda: 0.6)
        out.append(([t.seq for t in group], [t.seq for t in expired]))
        q.close()
        group, expired = q.pop_group(8, 10.0, now_fn=lambda: 0.6)
        out.append(([t.seq for t in group], [t.seq for t in expired]))
        out.append(q.pop_group(8, 10.0, now_fn=lambda: 0.6))
        return out

    assert run(tq, treq) == run(jq, jreq)


def test_copied_cost_tracker_matches_reference():
    """``api_backends/cost.py`` and its pricing table: the same tallies
    and costs on the same calls, and ``api_models.json`` byte-identical."""
    from llm_interpretation_replication_tpu.api_backends import cost as jcost
    from llm_interpretation_replication_tpu_torch.api_backends import (
        cost as tcost)

    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu",
                           "data_assets", "api_models.json"), "rb") as f:
        ref = f.read()
    with open(os.path.join(PORT, "data_assets", "api_models.json"),
              "rb") as f:
        assert f.read() == ref
    got = []
    for mod in (tcost, jcost):
        tr = mod.CostTracker()
        models = sorted(tr.pricing)
        assert models
        for i, m in enumerate(models):
            tr.record(m, 1000 * (i + 1), 50 * i)
            tr.record_response(m, {"usage": {"prompt_tokens": 7,
                                             "completion_tokens": 3}})
        tr.record("unpriced", 10, 10)
        got.append((tr.pricing, tr.summary(), tr.total_cost(),
                    tr.extrapolate(models[0], 2, 10), tr.cost("unpriced")))
    assert got[0] == got[1]


def _serve_parser(main_mod, command="serve", argv=("--model", "m")):
    """The ``serve`` subparser a package's CLI builds (or ``command``'s)."""
    import argparse

    class Built(Exception):
        pass

    real = argparse.ArgumentParser.parse_args

    def capture(self, *args, **kwargs):
        raise Built(self)

    argparse.ArgumentParser.parse_args = capture
    try:
        main_mod.main([command, *argv])
    except Built as built:
        parser = built.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[command]


def test_serve_parser_options_match_reference():
    """The port's ``serve`` takes every option of the reference's: the
    run-config options by name (their device and dtype defaults are the
    card's), the serve options with the same defaults, types and
    arities."""
    import argparse

    from llm_interpretation_replication_tpu import __main__ as jmain
    from llm_interpretation_replication_tpu_torch import __main__ as tmain

    run_config = argparse.ArgumentParser()
    tmain._add_run_config_args(run_config)
    shared = {a.dest for a in run_config._actions} - PORT_ONLY_RUN_CONFIG

    def options(parser):
        return sorted((tuple(a.option_strings), a.dest)
                      + ((a.default, a.required, str(a.type), a.nargs,
                          a.const) if a.dest not in shared else ())
                      for a in parser._actions
                      if a.dest not in PORT_ONLY_RUN_CONFIG)

    got, ref = options(_serve_parser(tmain)), options(_serve_parser(jmain))
    assert got == ref
    assert ("--pool-replicas",) in [o[0] for o in got]
    assert len(got) - len(shared) == 17
