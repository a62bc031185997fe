"""The kernel build cache: a library's key covers the headers it includes.

Runs on the CPU: nothing is compiled, only the cache's paths are read.
"""
import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import backward, kernel
from repro_torch.kernels.ssm_scan import backward as ssm_backward
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel


def test_flash_libraries_share_the_hopper_header():
    for lib in (kernel.LIBRARY, backward.LIBRARY):
        assert lib.headers() == [build.CSRC / "hopper.cuh"]


def test_ssm_libraries_share_the_scan_header():
    """The backward re-runs the forward's own chunk step: both sources
    include ``ssm_scan.cuh``, so a change to it rebuilds both."""
    for lib in (ssm_kernel.LIBRARY, ssm_backward.LIBRARY):
        assert lib.headers() == [build.CSRC / "ssm_scan.cuh"]
    assert ssm_kernel.LIBRARY.path() != ssm_backward.LIBRARY.path()


@pytest.mark.parametrize("edit, rebuilds", [
    ("header", True), ("nested header", True), ("source", True),
    ("unincluded header", False)])
def test_library_key_follows_source_and_included_headers(tmp_path,
                                                         monkeypatch, edit,
                                                         rebuilds):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include <stdint.h>\n'
                                   '  #  include "h.cuh"\nint f();\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text('#pragma once\n')
    (tmp_path / "x.cuh").write_text('#pragma once\n')
    lib = build.KernelLibrary("a", "a.cu", {})
    assert lib.headers() == [tmp_path / "h.cuh", tmp_path / "g.cuh"]
    before = lib.path()
    assert before == lib.path()
    target = {"header": "h.cuh", "nested header": "g.cuh",
              "source": "a.cu", "unincluded header": "x.cuh"}[edit]
    with open(tmp_path / target, "a") as f:
        f.write("// changed\n")
    assert (lib.path() != before) == rebuilds
    assert lib.path().parent == build.BUILD_DIR
