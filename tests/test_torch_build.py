"""The CUDA build's library names (gunrockinst_tpu_torch.ops._build): a
library is named by the hash of its source, of every header under
`csrc/` the source includes (directly or through another header) and
of the flags, so a changed header rebuilds every library that reads it
and no other.  Nothing is compiled here: the names are computed on the
host."""

import pytest

from gunrockinst_tpu_torch.ops import _build


@pytest.fixture
def srcdir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "a.cu").write_text('#include <cstdint>\n#include "w.cuh"\n'
                                   "int a;\n")
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "w.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("int inner;\n")
    return tmp_path


def test_sources_follow_quoted_includes(srcdir):
    assert [p.name for p in _build.sources_of("a")] == [
        "a.cu", "w.cuh", "inner.cuh"]
    assert [p.name for p in _build.sources_of("b")] == ["b.cu"]


@pytest.mark.parametrize("edited,rebuilt", [
    ("a.cu", {"a"}), ("w.cuh", {"a"}), ("inner.cuh", {"a"}),
    ("b.cu", {"b"})])
def test_a_changed_header_renames_its_libraries(srcdir, edited, rebuilt):
    before = {n: _build.library_path(n) for n in ("a", "b")}
    path = srcdir / edited
    path.write_text(path.read_text() + "// edited\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert {n for n in before if before[n] != after[n]} == rebuilt


def test_a_missing_header_raises(srcdir):
    (srcdir / "c.cu").write_text('#include "gone.cuh"\n')
    with pytest.raises(FileNotFoundError):
        _build.library_path("c")


def test_the_port_sources_name_their_headers():
    """The port's sources as they are: the step kernel and the touched
    sweep share the warp walk's header."""
    for name in ("mega_step", "touch_sweep"):
        assert [p.name for p in _build.sources_of(name)] == [
            f"{name}.cu", "warp_walk.cuh"]
    for name in ("chain_bfs", "value_step"):
        assert [p.name for p in _build.sources_of(name)] == [f"{name}.cu"]
