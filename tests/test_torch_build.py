"""The port's kernel builds (``repro_torch.kernels._build``): the name of a
built library covers every file under its ``csrc/``, every shared header
they include from outside it, and every compiler flag, so an edited
source, header or flag never reuses a stale build.
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

LIBRARIES = {"fused_fold": K1.LIBRARY,
             "flash_attention_wgmma": K2.WGMMA_LIBRARY,
             "ssd_scan_wgmma": K3.WGMMA_LIBRARY}
SHARED_HEADER = "hopper.cuh"


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
    the two wgmma libraries link libcuda (for their tensor maps)."""
    L = LIBRARIES[name]
    assert L.source.is_file() and L.source.parent.name == "csrc"
    assert L.source.stem == name
    want = ("-lcuda",) if name.endswith("_wgmma") else ()
    assert L.extra_flags == want
    assert L.target().name.startswith(f"{name}-")


@pytest.mark.parametrize("mod", [K2, K3], ids=["flash_attention",
                                               "ssm_scan"])
def test_each_kernel_package_builds_one_library_from_its_csrc(mod):
    """K2 and K3 each have one kernel family: their ``csrc/`` holds the
    wgmma library's source and nothing else that nvcc compiles."""
    csrc = mod.WGMMA_LIBRARY.source.parent
    assert sorted(p.name for p in csrc.glob("*.cu")) == [
        mod.WGMMA_LIBRARY.source.name]
    assert not hasattr(mod, "LIBRARY")


@pytest.fixture
def shared(tmp_path):
    """Two kernel packages whose sources include one header under
    ``common/``, which includes a second one."""
    common = tmp_path / "common"
    common.mkdir()
    (common / "hopper.cuh").write_text('#pragma once\n#include "ptx.cuh"\n')
    (common / "ptx.cuh").write_text("#pragma once\n")
    libs = []
    for pkg in ("one", "two"):
        d = tmp_path / pkg / "csrc"
        d.mkdir(parents=True)
        (d / f"{pkg}.cu").write_text(
            '#include "../../common/hopper.cuh"\nint f() { return 1; }\n')
        libs.append(CudaLibrary(d / f"{pkg}.cu", lambda _: None))
    return common, libs


@pytest.mark.parametrize("edit", ["hopper.cuh", "ptx.cuh"])
def test_editing_a_shared_header_changes_both_keys(shared, edit):
    common, libs = shared
    before = [L.target() for L in libs]
    f = common / edit
    f.write_text(f.read_text() + "// edited\n")
    after = [L.target() for L in libs]
    assert all(a != b for a, b in zip(after, before))


def test_headers_nobody_includes_do_not_change_the_keys(shared):
    common, libs = shared
    before = [L.target() for L in libs]
    (common / "unused.cuh").write_text("#pragma once\n")
    assert [L.target() for L in libs] == before


def test_shared_headers_are_inputs_after_the_own_files(shared):
    common, libs = shared
    names = [p.name for p in libs[0].inputs()]
    assert names == ["one.cu", "hopper.cuh", "ptx.cuh"]


@pytest.mark.parametrize("name", ["flash_attention_wgmma", "ssd_scan_wgmma"])
def test_wgmma_libraries_hash_the_shared_hopper_header(name):
    """Both wgmma sources include ``kernels/common/hopper.cuh``: it is one
    of their build inputs, so editing it rebuilds both."""
    inputs = LIBRARIES[name].inputs()
    hdr = [p for p in inputs if p.name == SHARED_HEADER]
    assert len(hdr) == 1 and hdr[0].parent.name == "common"
    assert hdr[0].parent.parent == LIBRARIES[name].source.parents[2]
