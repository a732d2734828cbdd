"""How the port builds its CUDA kernels (paddle_tpu_torch/ops/_build.py),
checked without ``nvcc``: every listed source exists, the headers its
sources include exist, and a library's name changes with anything that
changes what ``nvcc`` would build — the source, a shared ``csrc/*.cuh``
header, the flags — so an edited header never reuses a stale library.
"""
import re

import pytest

from paddle_tpu_torch.ops import _build


def test_every_source_and_included_header_exists():
    assert "flash_attention_sm90" in _build.SOURCES
    for name in _build.SOURCES:
        src = _build._CSRC / f"{name}.cu"
        assert src.is_file(), src
        for header in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (_build._CSRC / header).is_file(), (name, header)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    root = tmp_path / "csrc"
    root.mkdir()
    (root / "kern.cu").write_text('#include "common.cuh"\n')
    (root / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "_CSRC", root)
    monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return root


def test_library_name_is_stable_for_unchanged_inputs(csrc):
    assert _build._target("kern") == _build._target("kern")
    assert _build._target("kern").parent == csrc.parent / "build"


@pytest.mark.parametrize("change", ["source", "header", "new header",
                                    "flags"])
def test_library_name_follows_every_build_input(csrc, monkeypatch, change):
    before = _build._target("kern")
    if change == "source":
        (csrc / "kern.cu").write_text('#include "common.cuh"\n// edit\n')
    elif change == "header":
        (csrc / "common.cuh").write_text("// v2\n")
    elif change == "new header":
        (csrc / "extra.cuh").write_text("// more\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("kern") != before
