"""The port's ``run-perturbation`` command against the JAX package's, on
the same tiny Falcon snapshot (written with ``transformers``'
``FalconForCausalLM`` and ``build_inprocess_tokenizer``) and the same
perturbations file: ``--device cpu --dtype float32`` on both sides writes
workbooks equal cell for cell (text identical, numbers rtol 2e-5, atol
1e-9; ``tests/test_torch_sweep.py``'s comparison), also with ``--packed``
and ``--decode-k``.  Each flag whose path the port does not cover raises
``NotImplementedError`` naming its ROADMAP.md item.
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
    (("--strict",), "Guards and device observability"),
    (("--trace",), "Guards and device observability"),
    (("--profile", "prof"), "Guards and device observability"),
    (("--metrics",), "Guards and device observability"),
    (("--plan-search",), "Planning for the H100"),
    (("--mesh-model", "2"), "Parallel and training"),
    (("--mesh-seq", "2"), "Parallel and training"),
])
def test_unported_flags_raise(snapshot, perturbations, tmp_path, extra, title):
    with pytest.raises(NotImplementedError, match=title):
        tmain(_argv(snapshot, perturbations, tmp_path, *extra))


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
