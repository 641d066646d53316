"""``ops/_build`` names each kernel library after everything it is built
from, so a stale library is never loaded.

``ops/_build._target`` hashes the ``.cu`` source, every ``csrc/*.cuh``
header (a source may include any of them) and the nvcc flags.  No ``nvcc``
is needed: the tests only compute names and look for built files.
"""

import os
import shutil

import pytest

from llm_interpretation_replication_tpu_torch.ops import _build
from test_torch_slots import one_torch_thread  # noqa: F401

REAL_CSRC = _build.CSRC


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private copy of ``ops/csrc`` and build directory, with no cached
    build records."""
    src = tmp_path / "csrc"
    shutil.copytree(REAL_CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_records", {})
    monkeypatch.setattr(_build, "_libs", {})
    return src


def _edit(path):
    with open(path, "a", encoding="utf-8") as f:
        f.write("\n// edited\n")


@pytest.mark.parametrize("source", ["causal_grouped_attention",
                                    "head_major_attention"])
def test_editing_the_tile_header_renames_the_library(csrc, source):
    """Both sources include attention_tile.cuh: editing it changes the
    library name of each, and the name stays in the build directory."""
    before = _build._target(source)
    assert os.path.dirname(before) == _build.BUILD_DIR
    assert _build._target(source) == before            # deterministic
    _edit(csrc / "attention_tile.cuh")
    assert _build._target(source) != before


def test_source_header_and_flags_each_count(csrc, monkeypatch):
    name = "causal_grouped_attention"
    names = {_build._target(name)}
    _edit(csrc / f"{name}.cu")
    names.add(_build._target(name))
    (csrc / "new_header.cuh").write_text("#pragma once\n")   # a new header
    names.add(_build._target(name))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    names.add(_build._target(name))
    assert len(names) == 4


def test_a_stale_library_is_never_loaded(csrc, monkeypatch):
    """A library built before a header edit is found while it is current and
    ignored after the edit: ``build_all`` then compiles anew (here nvcc is
    stubbed to show it is reached)."""
    name = "head_major_attention"
    path = _build._target(name)
    os.makedirs(_build.BUILD_DIR)
    open(path, "wb").close()
    assert _build.build_all([name])[name].path == path

    def no_nvcc():
        raise RuntimeError("nvcc reached")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_records", {})
    _edit(csrc / "attention_tile.cuh")
    with pytest.raises(RuntimeError, match="nvcc reached"):
        _build.build_all([name])
