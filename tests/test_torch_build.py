"""The port's kernel builds (``repro_torch.kernels._build``): the name of a
built library covers every file under its ``csrc/`` and every compiler
flag, so an edited source, header or flag never reuses a stale build.
Nothing here runs ``nvcc``: the compiler is replaced by a stub that fails
the test if it is called."""

import subprocess

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._build import COMMON_FLAGS, CudaLibrary  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K2  # noqa: E402
from repro_torch.kernels.fused_fold import kernel as K1  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as K3  # noqa: E402

LIBRARIES = {"fused_fold": K1.LIBRARY, "flash_attention": K2.LIBRARY,
             "flash_attention_wgmma": K2.WGMMA_LIBRARY,
             "ssd_scan": K3.LIBRARY}


@pytest.fixture(autouse=True)
def no_compiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError(f"a compiler was started: {a}")
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(_build.subprocess, "Popen", refuse)


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "kern.cu").write_text('#include "common.cuh"\nint f() { return 1; }\n')
    (d / "common.cuh").write_text("#pragma once\n")
    (d / "other.cu").write_text("int g() { return 2; }\n")
    return d


def lib(csrc, *flags):
    return CudaLibrary(csrc / "kern.cu", lambda _: None, extra_flags=flags)


def test_key_is_stable_and_names_the_source(csrc):
    a, b = lib(csrc).target(), lib(csrc).target()
    assert a == b
    assert a.parent == _build.BUILD_DIR
    assert a.name.startswith("kern-") and a.suffix == ".so"


@pytest.mark.parametrize("edit", ["kern.cu", "common.cuh", "other.cu",
                                  "new.cuh"])
def test_editing_any_file_under_csrc_changes_the_key(csrc, edit):
    before = lib(csrc).target()
    f = csrc / edit
    f.write_text((f.read_text() if f.exists() else "") + "// edited\n")
    assert lib(csrc).target() != before


def test_files_outside_csrc_do_not_change_the_key(csrc):
    before = lib(csrc).target()
    (csrc.parent / "kernel.py").write_text("# the binding, not a source\n")
    assert lib(csrc).target() == before


def test_renaming_a_header_changes_the_key(csrc):
    before = lib(csrc).target()
    (csrc / "common.cuh").rename(csrc / "renamed.cuh")
    assert lib(csrc).target() != before


@pytest.mark.parametrize("flags", [("-lcuda",),
                                   ("-I/usr/local/cutlass/include",),
                                   ("-lcuda", "-DX=1")])
def test_extra_flags_change_the_key_and_follow_the_common_ones(csrc, flags):
    plain, extra = lib(csrc), lib(csrc, *flags)
    assert extra.target() != plain.target()
    assert extra.flags() == [*COMMON_FLAGS, *flags]
    assert plain.flags() == list(COMMON_FLAGS)
    assert lib(csrc, *flags).target() == extra.target()


def test_common_flags_change_every_key(csrc, monkeypatch):
    before = lib(csrc).target()
    monkeypatch.setattr(_build, "COMMON_FLAGS", COMMON_FLAGS + ("-G",))
    assert lib(csrc).target() != before


def test_start_and_get_reuse_a_finished_build(csrc, tmp_path, monkeypatch):
    """A library whose file already exists under its key is loaded, not
    rebuilt (the stubbed compiler would fail the test)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda p: loaded.append(p))
    one = lib(csrc)
    one.target().parent.mkdir(parents=True)
    one.target().write_bytes(b"")
    one.start()
    one.get()
    assert loaded == [str(one.target())]


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_repo_libraries(name):
    """Each of the port's libraries has its source under a ``csrc/``; only
    the wgmma flash-attention library links libcuda."""
    L = LIBRARIES[name]
    assert L.source.is_file() and L.source.parent.name == "csrc"
    assert L.source.stem == name
    want = ("-lcuda",) if name == "flash_attention_wgmma" else ()
    assert L.extra_flags == want
    assert L.target().name.startswith(f"{name}-")


def test_the_two_flash_attention_builds_share_csrc_but_not_a_key():
    assert K2.LIBRARY.source.parent == K2.WGMMA_LIBRARY.source.parent
    assert K2.LIBRARY.target() != K2.WGMMA_LIBRARY.target()
