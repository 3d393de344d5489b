"""The kernels' build cache key (`ops/_build.target`) covers every file
under `ops/csrc/` and the compiler flags, so an edited kernel or header is
rebuilt and a stale library is never loaded.  Needs no nvcc: it hashes a
temporary copy of the sources."""
import shutil

import pytest

from tf_operator_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_copy_keys_like_the_checkout(csrc, monkeypatch):
    here = _build.target()
    monkeypatch.setattr(_build, "CSRC", _build.SOURCE.parent)
    assert _build.target() == here


@pytest.mark.parametrize("name", ["flash_attention.cu", "hopper.cuh"])
def test_editing_any_source_changes_the_target(csrc, name):
    before = _build.target()
    path = csrc / name
    text = path.read_text()
    path.write_text(text + "\n// edited\n")
    assert _build.target() != before
    path.write_text(text)
    assert _build.target() == before


def test_a_new_or_renamed_file_changes_the_target(csrc):
    before = _build.target()
    extra = csrc / "extra.cuh"
    extra.write_text("#pragma once\n")
    with_extra = _build.target()
    assert with_extra != before
    extra.rename(csrc / "other.cuh")
    assert _build.target() not in (before, with_extra)
    (csrc / "other.cuh").unlink()
    assert _build.target() == before


def test_flags_change_the_target(csrc, monkeypatch):
    before = _build.target()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.target() != before


def test_target_lives_in_the_ignored_build_dir(csrc):
    out = _build.target()
    assert out.parent == _build.BUILD_DIR
    assert out.name.startswith("libflash_attention-") and out.suffix == ".so"


def test_the_parts_are_the_sources_translation_units():
    """nvcc compiles flash_attention.cu once per part (FA_PART 1..PARTS, in
    parallel) and links the objects: every part the source defines is
    built, and no part is built that defines nothing."""
    import re

    parts = {int(n) for n in re.findall(r"#if FA_IN_PART\((\d+)\)",
                                        _build.SOURCE.read_text())}
    assert parts == set(range(1, _build.PARTS + 1))


def test_parts_change_the_target(csrc, monkeypatch):
    before = _build.target()
    monkeypatch.setattr(_build, "PARTS", _build.PARTS + 1)
    assert _build.target() != before
