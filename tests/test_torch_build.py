"""The port's kernel builder and device selection, on a machine without
CUDA: what they do before any kernel can run."""

import pytest
import torch

from styler_tpu_torch.core.device import resolve_device
from styler_tpu_torch.ops import build
from tests.test_torch_golden_cache import torch_threads  # noqa: F401 (autouse)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("STYLER_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["lstm"])


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    """An edited kernel source gets a new library path, so a stale build
    is never loaded."""
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    monkeypatch.setenv("STYLER_TORCH_BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build._target("k")
    src.write_text("// two\n")
    second = build._target("k")
    assert first != second
    assert first.startswith(str(tmp_path / "build")) and first.endswith(".so")


def test_every_kernel_has_a_source():
    for name in build.KERNELS:
        assert build._target(name).endswith(".so")


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
