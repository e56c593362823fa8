"""Boundaries of the port package (paddle_tpu_torch) and chip_smoke.py.

Neither imports JAX or the JAX package — checked both at run time (a
fresh interpreter imports every submodule) and in the source (an AST scan
of every import).  Entry points run on the card by default and raise
``UnavailableError`` without one instead of moving to the CPU quietly.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu  # noqa: F401  (the tests import both packages)
import paddle_tpu_torch
from paddle_tpu_torch.framework import device as device_mod
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_serve_profile.py",
    ROOT / "tools" / "torch_train_profile.py",
    ROOT / "tools" / "torch_embedding_determinism.py",
    ROOT / "tools" / "torch_resnet_conditioning.py",
    ROOT / "tools" / "torch_flash_bwd_rounding.py",
    ROOT / "tools" / "torch_kernel_ab.py",
    ROOT / "tools" / "torch_pool_channels_last_grad.py",
    ROOT / "tools" / "torch_serve_train_ab.py",
    ROOT / "tools" / "torch_sparse_step_ab.py",
    ROOT / "tools" / "torch_tensor_cases.py"]


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top.startswith("jax") or top == "paddle_tpu"


def test_import_pulls_in_no_jax_and_no_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = out.stdout.split()
    assert "paddle_tpu_torch.serving.generation" in mods
    assert "paddle_tpu_torch.ops.paged_attention" in mods
    assert "paddle_tpu_torch.ops.fused_layernorm" in mods
    assert "paddle_tpu_torch.ops.fused_softmax_xent" in mods
    assert "paddle_tpu_torch.ops.quantized_matmul" in mods
    assert "paddle_tpu_torch.slim.quantization" in mods
    assert "paddle_tpu_torch.hapi.model" in mods
    assert "paddle_tpu_torch.ops.flash_attention" in mods
    assert "paddle_tpu_torch.nn.functional.attention" in mods
    assert "paddle_tpu_torch.ops.grouped_matmul" in mods
    assert "paddle_tpu_torch.moe.layer" in mods
    assert "paddle_tpu_torch.moe.stats" in mods
    for mod in ("framework.selected_rows", "models.wide_deep", "native",
                "io.in_memory_dataset", "optimizer.averaging",
                "optimizer.gradient_merge", "optimizer.dgc",
                "nn.functional.common", "tuning", "tuning.trace",
                "inference", "jit", "serving.engine", "serving.bucketing"):
        assert f"paddle_tpu_torch.{mod}" in mods, mod
    assert [m for m in mods if _forbidden(m)] == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_default_device_is_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(UnavailableError):
        GPTForCausalLM(gpt_tiny())
    with pytest.raises(UnavailableError):
        paddle_tpu_torch.get_device()
    assert GPTForCausalLM(gpt_tiny(), device="cpu").device.type == "cpu"


def test_set_device_cpu_is_an_explicit_choice():
    try:
        assert str(paddle_tpu_torch.set_device("cpu")) == "cpu"
        assert paddle_tpu_torch.get_device() == "cpu"
        assert GPTForCausalLM(gpt_tiny()).device.type == "cpu"
    finally:
        device_mod._chosen = None


def test_kernel_build_is_lazy_and_keyed_by_source_and_flags():
    lib = _build.library_path("paged_attention")
    assert lib.parent == _build.OUT and lib.name.startswith(
        "paged_attention-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    if not any(os.access(p, os.X_OK) for p in (
            "/usr/local/cuda/bin/nvcc",
            *(os.path.join(d, "nvcc") for d in
              os.environ.get("PATH", "").split(os.pathsep)))):
        with pytest.raises(UnavailableError, match="nvcc"):
            _build.nvcc()


def test_library_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    """A source that includes a csrc/*.cuh must rebuild when the header
    changes, or a stale library would load."""
    src = '#include "h.cuh"\nint f() { return %sg(); }\n'
    (tmp_path / "k.cu").write_text(src % "")
    (tmp_path / "h.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("inline int g() { return 2; }\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "k.cu").write_text(src % "-")
    assert _build.library_path("k") not in (first, second)


def test_native_ingest_is_built_lazily_inside_the_checkout():
    """The ingest engine is the port's own copy of the C++ source, built
    with g++ into the package's gitignored ``native/_build`` on first use
    (never at import), keyed by the source and the flags."""
    from paddle_tpu_torch import native

    code = ("import paddle_tpu_torch.native as n, paddle_tpu_torch.io\n"
            "print(n._lib is None)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.split() == ["True"], out.stderr
    path = native.library_path()
    assert path.parent == ROOT / "paddle_tpu_torch" / "native" / "_build"
    assert native.SRC == ROOT / "paddle_tpu_torch" / "native" / "ingest.cc"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "paddle_tpu_torch/native/_build/" in ignored
    jax_src = (ROOT / "paddle_tpu" / "native" / "ingest.cc").read_text()
    port_src = native.SRC.read_text()
    body = "#include <atomic>"
    assert port_src[port_src.index(body):] == jax_src[jax_src.index(body):]
