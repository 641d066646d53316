"""The port's ``run-perturbation`` command against the JAX package's, on
the same tiny Falcon snapshot (written with ``transformers``'
``FalconForCausalLM`` and ``build_inprocess_tokenizer``) and the same
perturbations file: ``--device cpu --dtype float32`` on both sides writes
workbooks equal cell for cell (text identical, numbers rtol 2e-5, atol
1e-9; ``tests/test_torch_sweep.py``'s comparison), also with ``--packed``
and ``--decode-k``; ``--plan-search`` writes the workbook of its chosen
flags given by hand.  Each flag whose path the port does not cover raises
``NotImplementedError`` naming its ROADMAP.md item; the observability
flags (``--strict``, ``--trace``, ``--profile``, ``--metrics``) run and
leave the workbook as it is without them.
"""

import json
import os

import pytest
import torch

from helpers import build_test_tokenizer
from llm_interpretation_replication_tpu.__main__ import main as jmain
from llm_interpretation_replication_tpu_torch.__main__ import main as tmain
from llm_interpretation_replication_tpu_torch.config import legal_scenarios
from test_torch_slots import one_torch_thread  # noqa: F401
from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx
from test_torch_sweep import assert_workbooks_equal


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    from transformers import FalconConfig, FalconForCausalLM

    snap = tmp_path_factory.mktemp("falcon_snap")
    config = FalconConfig(vocab_size=300, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, multi_query=True,
                          parallel_attn=True, new_decoder_architecture=False,
                          bias=False, alibi=False)
    torch.manual_seed(7)
    FalconForCausalLM(config).eval().save_pretrained(str(snap),
                                                     safe_serialization=True)
    build_test_tokenizer(300).save_pretrained(str(snap))
    return str(snap)


@pytest.fixture(scope="module")
def perturbations(tmp_path_factory):
    path = tmp_path_factory.mktemp("pert") / "perturbations.json"
    path.write_text(json.dumps([
        dict(s, rephrasings=[f"Variant one of: {s['original_main'][:60]}",
                             f"Variant two: {s['original_main'][20:70]}"])
        for s in legal_scenarios()]))
    return str(path)


def _argv(snapshot, perturbations, out, *extra):
    return ["run-perturbation", "--device", "cpu", "--dtype", "float32",
            "--model", snapshot, "--perturbations", perturbations,
            "--batch-size", "4", "--output-dir", str(out), *extra]


@pytest.mark.parametrize("extra", [
    (),
    ("--attention-impl", "flash", "--prefill-chunk", "64",
     "--kv-dtype", "int8", "--no-slot-repack", "--phase2-pool-target", "2",
     "--max-rephrasings", "1", "--score-chunk", "3",
     "--confidence-max-new-tokens", "6"),
], ids=["defaults", "flash-chunked-int8kv-flushes"])
def test_run_perturbation_matches_reference(snapshot, perturbations,
                                            tmp_path, capsys, extra):
    jmain(_argv(snapshot, perturbations, tmp_path / "j", *extra))
    tmain(_argv(snapshot, perturbations, tmp_path / "t", *extra))
    lines = capsys.readouterr().out.splitlines()
    n = 5 if "--max-rephrasings" in extra else 10
    assert lines.count(f"{n} rows") == 2
    rows = assert_workbooks_equal(tmp_path / "t" / "perturbation_results.xlsx",
                                  tmp_path / "j" / "perturbation_results.xlsx")
    assert len(rows) == n and all(r["Model"] == snapshot for r in rows)


@pytest.mark.parametrize("extra,title", [
    (("--mesh-model", "2"), "needs a world of a multiple of 2 ranks"),
    (("--mesh-seq", "2"), "needs a world of a multiple of 2 ranks"),
])
def test_unported_flags_raise(snapshot, perturbations, tmp_path, extra, title):
    """``--mesh-model`` and ``--mesh-seq`` build a mesh over the world's
    ranks, for ``run-perturbation`` (``tests/test_torch_mesh.py`` runs it on
    two) and for ``serve`` (``tests/test_torch_mesh_serve.py`` runs it on
    two): in a world of one process both raise, naming the ranks the mesh
    needs."""
    with pytest.raises(ValueError, match=title):
        tmain(_argv(snapshot, perturbations, tmp_path, *extra))
    with pytest.raises(ValueError, match=title):
        tmain(["serve", "--model", snapshot, "--device", "cpu", *extra])


def test_plan_search_runs_its_chosen_flags(snapshot, perturbations,
                                           tmp_path, capsys):
    """``run-perturbation --plan-search`` at an explicit memory prints the
    candidate table, logs its ``[plan]`` decision, and writes the workbook
    a run with the chosen flags given by hand writes."""
    import re
    import shutil

    from llm_interpretation_replication_tpu_torch.models.config import (
        from_hf_config)
    from llm_interpretation_replication_tpu_torch.runtime import (
        loader, plan, plan_search)

    snap = str(tmp_path / "snap")
    shutil.copytree(snapshot, snap)
    name = "perturbation_results.xlsx"
    # a memory that holds batch 32 but not the top of the ladder: the CPU
    # pads each batch to its size, and 512 rows take half a minute here
    cfg = from_hf_config(loader.load_hf_config(snap))[1]
    need32 = max(c.need_bytes for c in plan_search.search_plans(
        cfg, "none", 1, batches=(32,), hbm_bytes=1 << 40))
    gib = (plan.RESERVE_BYTES + plan.THRASH_HEADROOM_BYTES + need32
           + (1 << 20)) / 2**30
    tmain(_argv(snap, perturbations, tmp_path / "searched", "--plan-search",
                "--hbm-gib", repr(gib)))
    captured = capsys.readouterr()
    chosen = re.search(
        r"#   chosen : mesh dp1xpp1xtp1 batch (\d+) kv (\w+) chunk (\d+) "
        r"pool (\w+)(?: decode-k (\d+))?", captured.err)
    assert chosen, captured.err
    batch, kv, chunk, pool, k = chosen.groups()
    assert "[plan] plan search chose mesh dp1xtp1 batch " + batch in (
        captured.out + captured.err)
    tmain(_argv(snap, perturbations, tmp_path / "hand", "--batch-size", batch,
                "--kv-dtype", kv, "--prefill-chunk", chunk,
                "--phase2-pool-target", "0" if pool == "batch" else pool,
                "--decode-k", k or "1"))
    assert_workbooks_equal(tmp_path / "searched" / name,
                           tmp_path / "hand" / name)


def test_plan_search_needs_a_memory_and_one_device(snapshot, perturbations,
                                                   tmp_path, capsys,
                                                   monkeypatch):
    """``plan search --format json`` runs at ``--hbm-gib`` and raises
    without it where there is no card; ``--plan-search`` searches the
    meshes of the world's ranks and builds the chosen one over them (here
    a world of 8 stands in, and the mesh is recorded, not built)."""
    import re

    from llm_interpretation_replication_tpu_torch import __main__ as cli

    with pytest.raises(SystemExit) as done:
        tmain(["plan", "search", "--format", "json", "--hbm-gib", "80"])
    assert done.value.code == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["chosen"]["mesh"] == {"data": 1, "pipe": 1, "model": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="memory"):
        tmain(["plan", "search", "--format", "json"])
    with pytest.raises(RuntimeError, match="memory"):
        tmain(_argv(snapshot, perturbations, tmp_path / "a", "--plan-search"))
    from llm_interpretation_replication_tpu_torch import parallel

    class Built(Exception):
        pass

    def make_mesh(**shape):
        raise Built(shape)

    monkeypatch.setattr(cli, "_world", lambda rc: 8)
    monkeypatch.setattr(parallel, "make_mesh", make_mesh)
    with pytest.raises(Built) as built:
        tmain(_argv(snapshot, perturbations, tmp_path / "b", "--plan-search",
                    "--hbm-gib", "80"))
    shape = built.value.args[0]
    assert shape["data"] * shape["model"] == 8
    chosen = re.search(r"#   chosen : mesh dp(\d+)xpp1xtp(\d+) batch \d+ "
                       r"kv \w+ chunk \d+ pool \w+ ->",
                       capsys.readouterr().err)
    assert chosen, "no chosen mesh without the joint K-token decode"
    assert (shape["data"], shape["model"]) == tuple(map(int, chosen.groups()))


@pytest.fixture(scope="module")
def plain_workbook(snapshot, perturbations, tmp_path_factory):
    """The unflagged run's workbook rows."""
    out = tmp_path_factory.mktemp("plain")
    tmain(_argv(snapshot, perturbations, out))
    return read_xlsx(str(out / "perturbation_results.xlsx"))


def obs_artifacts_ok(flag, path, err, heartbeats=None):
    """Assert the artifact of one observability flag: the Chrome trace and
    its span log (``--trace``), the profiler capture (``--profile``), the
    JSONL metrics log with one sample a heartbeat (``--metrics``; at least
    one unless ``heartbeats`` says how many), the strict audit line with no
    blocked sync (``--strict``).  ``path`` is the flag's argument."""
    from llm_interpretation_replication_tpu_torch.obs import report
    from llm_interpretation_replication_tpu_torch.obs.tracer import KNOWN_PHASES
    from llm_interpretation_replication_tpu_torch.utils import profiling

    if flag == "--trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert {"launch", "consume", "prefill"} <= {e["name"] for e in events}
        spans = report.load_spans(path + ".spans.jsonl")
        assert len(spans) == len(events)
        assert {s["phase"] for s in spans} - {None} <= KNOWN_PHASES
        assert "written to" in err
    elif flag == "--profile":
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(path))
        assert profiling.top_device_ops(path, 5)
    elif flag == "--metrics":
        with open(path) as f:
            samples = [json.loads(line) for line in f]
        assert (len(samples) == heartbeats if heartbeats is not None
                else samples)
        assert all("counters" in s and "gauges" in s for s in samples)
    else:
        audit = [json.loads(line.split(": ", 1)[1])
                 for line in err.splitlines() if line.startswith("# strict: ")]
        assert audit and all(a["enabled"] and a["blocked_transfers"] == 0
                             for a in audit)


@pytest.mark.parametrize("flag", ["--strict", "--trace", "--profile",
                                  "--metrics"])
def test_observability_flag_runs(snapshot, perturbations, tmp_path, capsys,
                                 plain_workbook, flag):
    """Each flag runs ``run-perturbation`` to its end, leaves its artifact,
    and leaves the workbook as the unflagged run's, cell for cell."""
    from llm_interpretation_replication_tpu_torch.runtime import strict

    path = str(tmp_path / "artifact")
    extra = [flag] if flag == "--strict" else [flag, path]
    tmain(_argv(snapshot, perturbations, tmp_path / "out", *extra))
    captured = capsys.readouterr()
    assert "10 rows" in captured.out.splitlines()
    obs_artifacts_ok(flag, path, captured.err)
    assert read_xlsx(str(tmp_path / "out" / "perturbation_results.xlsx")) \
        == plain_workbook
    assert not strict.strict_enabled()      # the command disarms on exit


@pytest.mark.parametrize("flag", ["--packed", "--decode-k"])
def test_packed_and_decode_k_flags_run(snapshot, perturbations, tmp_path,
                                       capsys, flag):
    """``--packed 4`` writes ``perturbation_results_packed.xlsx`` (the
    packed extractor's tag) and prints the drift block, both as the JAX
    CLI's.  ``--decode-k 4`` distills a K-head, writes ``k_head.npz``
    beside the snapshot and the K=1 workbook; a second run loads the head
    and writes the same workbook, and the JAX CLI loads the port's file
    and writes it too."""
    import shutil

    snap = str(tmp_path / "snap")
    shutil.copytree(snapshot, snap)
    if flag == "--packed":
        jmain(_argv(snap, perturbations, tmp_path / "j", "--packed", "4"))
        tmain(_argv(snap, perturbations, tmp_path / "t", "--packed", "4"))
        lines = capsys.readouterr().out.splitlines()
        assert lines.count("10 rows (packed Q=4)") == 2
        drift = [json.loads(x)["packed_drift"] for x in lines
                 if x.startswith('{"packed_drift"')]
        assert len(drift) == 2 and drift[0] == drift[1]
        assert drift[0]["n_questions"] == 10 and drift[0]["packing"] == 4
        rows = assert_workbooks_equal(
            tmp_path / "t" / "perturbation_results_packed.xlsx",
            tmp_path / "j" / "perturbation_results_packed.xlsx")
        assert {r["Log Probabilities"] for r in rows} == {
            "local:packed4:first_token_top20"}
        return
    name = "perturbation_results.xlsx"
    tmain(_argv(snap, perturbations, tmp_path / "k1"))
    tmain(_argv(snap, perturbations, tmp_path / "t", "--decode-k", "4"))
    err = capsys.readouterr().err
    assert "# K-head distilled for decode_k=4" in err
    assert os.path.exists(os.path.join(snap, "k_head.npz"))
    assert_workbooks_equal(tmp_path / "t" / name, tmp_path / "k1" / name)
    tmain(_argv(snap, perturbations, tmp_path / "t2", "--decode-k", "4"))
    jmain(_argv(snap, perturbations, tmp_path / "j", "--decode-k", "4"))
    err = capsys.readouterr().err
    assert err.count("# K-head loaded from snapshot (k_head.npz, "
                     "decode_k=4)") == 2
    assert "distilled" not in err
    assert_workbooks_equal(tmp_path / "t2" / name, tmp_path / "t" / name)
    assert_workbooks_equal(tmp_path / "j" / name, tmp_path / "t" / name)


def test_default_device_is_cuda(snapshot, perturbations, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    argv = _argv(snapshot, perturbations, tmp_path)
    i = argv.index("--device")
    del argv[i:i + 2]
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain(argv)


def test_mismatched_perturbations_file_raises(snapshot, tmp_path):
    recs = [dict(s, rephrasings=["r"]) for s in legal_scenarios()]
    recs[0]["original_main"] = "another scenario"
    path = tmp_path / "p.json"
    path.write_text(json.dumps(recs))
    with pytest.raises(ValueError, match="scenario mismatch"):
        tmain(_argv(snapshot, str(path), tmp_path))


# -- the API leg's commands, over scripted vendors ---------------------------

API_SWEEPS = {
    # one model: several run on threads and print in completion order
    "run-api-perturbation": ["--model", "gpt-4.1-2025-04-14"],
    "run-claude-perturbation": [],
    "run-gpt-perturbation": ["--sleep", "0", "--max-rephrasings", "4"],
    "run-gemini-perturbation": ["--threads", "1", "--rps", "1000"],
}


@pytest.fixture
def scripted_vendors(monkeypatch):
    """Both packages' clients talk to ``chip_smoke._api_transport``'s
    scripted vendors (no socket); the keys are set."""
    import importlib

    import chip_smoke

    for pkg in ("llm_interpretation_replication_tpu",
                "llm_interpretation_replication_tpu_torch"):
        api = importlib.import_module(f"{pkg}.api_backends")
        for mod, vendor in (("openai_client", "openai"),
                            ("anthropic_client", "anthropic"),
                            ("gemini_client", "gemini")):
            monkeypatch.setattr(
                importlib.import_module(f"{pkg}.api_backends.{mod}"),
                "UrllibTransport",
                lambda api=api, vendor=vendor: chip_smoke._api_transport(
                    api, vendor))
    for var in ("OPENAI_API_KEY", "ANTHROPIC_API_KEY", "GEMINI_API_KEY"):
        monkeypatch.setenv(var, "scripted-key")


@pytest.fixture
def api_perturbations(tmp_path):
    """Two scenarios of five rephrasings (the other three scenarios empty,
    so the file passes the identity check)."""
    path = tmp_path / "api_perturbations.json"
    path.write_text(json.dumps([
        dict(s, rephrasings=[f"{s['original_main'][:70]} (rephrasing {i})"
                             for i in range(5)] if k < 2 else [])
        for k, s in enumerate(legal_scenarios())]))
    return str(path)


@pytest.mark.parametrize("cmd", sorted(API_SWEEPS))
def test_api_sweep_command_matches_reference(cmd, scripted_vendors,
                                             api_perturbations, tmp_path,
                                             capsys):
    """Each API sweep command end to end on both packages: the same
    stdout, the same workbook cells; a second run resumes and changes
    nothing."""
    got = {}
    for name, main in (("jax", jmain), ("torch", tmain)):
        d = str(tmp_path / name)
        os.makedirs(d)
        out = os.path.join(d, "out.xlsx")
        argv = [cmd, "--perturbations", api_perturbations, "--output", out,
                *API_SWEEPS[cmd]]
        main(argv)
        first = (capsys.readouterr().out.replace(d, "<d>"), read_xlsx(out))
        main(argv)
        capsys.readouterr()
        got[name] = (first, read_xlsx(out))
    assert got["torch"] == got["jax"]
    (stdout, (cols, rows)), again = got["torch"]
    assert again == (cols, rows)
    assert len(rows) == (8 if cmd == "run-gpt-perturbation" else 10)


def test_generate_rephrasings_and_repair_batch_commands(scripted_vendors,
                                                        tmp_path, capsys):
    got = {}
    req, resp = tmp_path / "req.jsonl", tmp_path / "resp.jsonl"
    req.write_text("\n".join(json.dumps({"custom_id": f"q{i}"})
                             for i in range(2)) + "\n")
    resp.write_text("\n".join(json.dumps({"response": {"candidates": [{
        "content": {"parts": [{"text": f"Part(text='{t}')"}]}}]}})
        for t in ("85", "It's")) + "\n")
    for name, main in (("jax", jmain), ("torch", tmain)):
        d = tmp_path / name
        main(["generate-rephrasings", "--sessions", "3", "--target", "2",
              "--output", str(d / "p.json")])
        main(["repair-batch", "--requests", str(req), "--responses",
              str(resp), "--output", str(d / "fixed.jsonl")])
        got[name] = (capsys.readouterr().out.replace(str(d), "<d>"),
                     (d / "p.json").read_bytes(),
                     (d / "fixed.jsonl").read_bytes())
    assert got["torch"] == got["jax"]
    assert [len(r["rephrasings"]) for r in json.loads(got["torch"][1])] == \
        [2] * 5


@pytest.mark.parametrize("argv", [
    ["generate-rephrasings"],
    ["run-api-perturbation", "--perturbations", "p.json", "--model", "m"],
    ["run-claude-perturbation", "--perturbations", "p.json"],
    ["run-gpt-perturbation", "--perturbations", "p.json"],
    ["run-gemini-perturbation", "--perturbations", "p.json"],
], ids=lambda a: a[0])
def test_api_keyed_commands_require_env(monkeypatch, argv):
    """Without its key each command exits naming the variable, as the JAX
    package's does."""
    for var in ("ANTHROPIC_API_KEY", "OPENAI_API_KEY", "GEMINI_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    msgs = []
    for main in (jmain, tmain):
        with pytest.raises(SystemExit, match="API_KEY not set") as err:
            main(argv)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["run-api-perturbation", "--perturbations", "p", "--model", "m"],
    ["run-claude-perturbation", "--perturbations", "p"],
    ["run-gpt-perturbation", "--perturbations", "p"],
    ["run-gemini-perturbation", "--perturbations", "p"],
    ["generate-rephrasings"],
    ["generate-irrelevant"],
    ["repair-batch", "--requests", "a", "--responses", "b", "--output", "c"],
    ["run-gemini-perturbation", "--perturbations", "p", "--threads", "3",
     "--rps", "1.5", "--max-rephrasings", "2", "--model", "g",
     "--output", "o.xlsx"],
    ["run-api-perturbation", "--perturbations", "p", "--model", "a",
     "--model", "b", "--reasoning-logprob-runs"],
], ids=lambda a: "_".join(a[:1] + [x for x in a[1:] if x.startswith("--")]))
def test_api_command_flags_and_defaults_match_reference(monkeypatch, argv):
    """The parsed arguments (flags and defaults) of each API-leg command
    are the JAX CLI's."""
    import argparse

    parsed = []
    real = argparse.ArgumentParser.parse_args

    def capture(self, *args, **kwargs):
        ns = real(self, *args, **kwargs)
        parsed.append({k: v for k, v in vars(ns).items() if k != "fn"})
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    for main in (jmain, tmain):
        with pytest.raises(_Parsed):
            main(list(argv))
    assert parsed[0] == parsed[1]


# -- the analysis commands (survey, Table 5, agreement, comparison) -------------------
#
# Each runs in process on both packages with the same arguments (the JAX
# command first; each writes under its own directory): every file either
# writes is byte-equal, figures included, and so is what it prints (with
# the directory written as <d>).

@pytest.fixture(scope="module")
def analysis_inputs(tmp_path_factory):
    import numpy as np

    from test_torch_analysis import workbook_rows, write_workbook
    from test_torch_survey import results_csv, survey_files

    root = tmp_path_factory.mktemp("analysis_inputs")
    paths = {"surveys": survey_files(root)}
    for schema in ("100q", "instruct", "base"):
        paths[schema] = results_csv(root, schema)
    rng = np.random.default_rng(41)
    scen = legal_scenarios()
    for name, n in (("a", 30), ("b", 24)):
        paths[f"wb_{name}"] = write_workbook(
            root / f"{name}.xlsx", workbook_rows(rng, scen[:2], f"m-{name}", n)
            + workbook_rows(rng, scen[2:3], f"m-{name}x", 8))
    pert = root / "perturbations.json"
    pert.write_text(json.dumps([
        dict(s, rephrasings=[f"{s['original_main'][:80]} (take {k})"
                             for k in range(4)] + [
            "An unrelated sentence about bananas."]) for s in scen]))
    paths["perturbations"] = str(pert)
    return paths


def _analysis_argv(command, p, extra):
    s1, s2 = p["surveys"]
    base = {
        "analyze-survey": ["--survey1-csv", s1, "--survey2-csv", s2,
                           "--llm-csv", p["instruct"], "--bootstrap", "200",
                           "--cross-prompt-bootstrap", "10",
                           "--output-dir", "<d>"],
        "analyze-combined": ["--workbook", f"A={p['wb_a']}",
                             "--workbook", f"B={p['wb_b']}",
                             "--output-dir", "<d>"],
        "demographics-table": ["--csv", s1, "--csv", s2],
        "analyze-perturbations": ["--workbook", p["wb_a"], "--simulations",
                                  "2000", "--output-dir", "<d>"],
        "similarity": ["--perturbations", p["perturbations"],
                       "--output-dir", "<d>"],
        "analyze-100q": ["--results", p["100q"]],
        "analyze-mae-100q": ["--results", p["100q"], "--survey1-csv", s1,
                             "--survey2-csv", s2],
        "extract-survey2-questions": ["--survey-csv", s2,
                                      "--output", "<d>/q.txt"],
        "analyze-3way": ["--llm-csv", p["100q"], "--survey1-csv", s1,
                         "--survey2-csv", s2, "--output-dir", "<d>"],
        "analyze-agreement": ["--llm-csv", p["instruct"], "--survey-csv", s1,
                              "--bootstrap", "120", "--output-dir", "<d>"],
        "analyze-family-differences": ["--llm-csv", p["100q"],
                                       "--survey1-csv", s1, "--survey2-csv",
                                       s2, "--bootstrap", "30",
                                       "--output-dir", "<d>"],
        "ground-truth-figure": ["--survey1-csv", s1, "--survey2-csv", s2,
                                "--output-dir", "<d>"],
        "model-comparison": ["--results", p["instruct"], "--bootstrap", "60",
                             "--output-dir", "<d>"],
        "cross-kappa": ["--results", p["100q"], p["instruct"],
                        "--bootstrap", "60"],
    }[command]
    extra = [x.replace("<base>", p["base"]) for x in extra]
    return [command, *base, *extra]


ANALYSIS_CASES = [
    ("analyze-survey", []),
    ("analyze-combined", []),
    ("demographics-table", []),
    ("demographics-table", ["--column", "Sex", "--column", "Age",
                            "--output", "<d>/demographics.tex"]),
    ("analyze-perturbations", []),
    ("similarity", ["--max-rephrasings", "3"]),
    ("analyze-100q", ["--output-json", "<d>/o.json"]),
    ("analyze-100q", ["--latex", "--survey1-csv", "SURVEY1"]),
    ("analyze-mae-100q", ["--latex", "--output-tex", "<d>/t.tex",
                          "--output-json", "<d>/o.json"]),
    ("extract-survey2-questions", []),
    ("extract-survey2-questions", ["--ascii-quotes"]),
    ("analyze-3way", []),
    ("analyze-3way", ["--no-figures"]),
    ("analyze-agreement", ["--base-csv", "<base>", "--seed", "3"]),
    ("analyze-family-differences", []),
    ("ground-truth-figure", []),
    ("model-comparison", []),
    ("model-comparison", ["--reference-model", "tiiuae/falcon-7b",
                          "--no-figures"]),
    ("model-comparison", ["--reference-model", "tiiuae/falcon-7b"]),
    ("cross-kappa", ["--threshold", "0.4", "--output-json", "<d>/k.json"]),
]


def run_in(main, argv, d, capsys):
    d.mkdir(parents=True, exist_ok=True)
    main([a.replace("<d>", str(d)) for a in argv])
    printed = capsys.readouterr().out.replace(str(d), "<d>")
    files = {os.path.relpath(os.path.join(r, f), d):
             open(os.path.join(r, f), "rb").read()
             for r, _, fs in os.walk(d) for f in fs}
    return printed, files


@pytest.mark.parametrize("command,extra", ANALYSIS_CASES,
                         ids=lambda v: v if isinstance(v, str) else
                         "_".join(x.lstrip("-") for x in v if x.startswith("--")))
def test_analysis_command_matches_reference(analysis_inputs, tmp_path, capsys,
                                            command, extra):
    extra = [analysis_inputs["surveys"][0] if x == "SURVEY1" else x
             for x in extra]
    argv = _analysis_argv(command, analysis_inputs, extra)
    got = {tag: run_in(main, argv, tmp_path / tag, capsys)
           for tag, main in (("jax", jmain), ("port", tmain))}
    assert got["port"] == got["jax"]
    assert got["port"][0] or got["port"][1]


def test_family_differences_reads_a_saved_agreement(analysis_inputs, tmp_path,
                                                    capsys):
    argv = _analysis_argv("analyze-family-differences", analysis_inputs, [])
    saved = run_in(jmain, argv, tmp_path / "first", capsys)[1]
    path = tmp_path / "agreement.json"
    path.write_bytes(saved["llm_human_agreement_bootstrap.json"])
    argv = ["analyze-family-differences", "--agreement-json", str(path),
            "--output-dir", "<d>"]
    got = {tag: run_in(main, argv, tmp_path / tag, capsys)
           for tag, main in (("jax", jmain), ("port", tmain))}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("argv,message", [
    (["analyze-100q", "--results", "R", "--latex"], "--latex emits"),
    (["analyze-family-differences"], "pass --llm-csv"),
    (["analyze-combined", "--workbook", "nameless"], "NAME=PATH"),
    (["analyze-combined", "--workbook", "A=W", "--workbook", "A=W"],
     "duplicate workbook"),
])
def test_analysis_command_refusals_match_reference(analysis_inputs, tmp_path,
                                                   monkeypatch, argv, message):
    argv = [analysis_inputs["100q"] if a == "R" else
            a.replace("=W", "=" + analysis_inputs["wb_a"]) for a in argv]
    monkeypatch.chdir(tmp_path)    # a refused command may make its output dir
    msgs = []
    for main in (jmain, tmain):
        with pytest.raises(SystemExit, match=message) as err:
            main(list(argv))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_similarity_command_embeddings_leg_matches_reference(
        analysis_inputs, tmp_path, capsys, monkeypatch):
    """``similarity --embeddings`` through a stand-in
    ``sentence_transformers`` (nothing is downloaded): the embedding
    column joins the workbook, on both packages alike."""
    import sys
    import types

    import numpy as np

    fake = types.ModuleType("sentence_transformers")

    class SentenceTransformer:
        def __init__(self, name):
            self.name = name

        def encode(self, texts):
            return np.random.default_rng(len(texts)).normal(size=(len(texts), 6))

    fake.SentenceTransformer = SentenceTransformer
    monkeypatch.setitem(sys.modules, "sentence_transformers", fake)
    argv = _analysis_argv("similarity", analysis_inputs,
                          ["--embeddings", "--embedding-model", "stub"])
    got = {tag: run_in(main, argv, tmp_path / tag, capsys)
           for tag, main in (("jax", jmain), ("port", tmain))}
    assert got["port"] == got["jax"]
    assert "embedding_cosine_similarity" in got["port"][0]
