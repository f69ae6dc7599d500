"""The port imports no JAX and nothing of tony_tpu (nor the launcher that
runs it under ``tony serve``), and needs a CUDA device unless the CPU is
asked for; the launcher imports neither JAX nor torch."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "tony_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
LAUNCH_FILES = sorted((ROOT / "tony_tpu_torch_launch").rglob("*.py"))


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_tony_tpu_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tony_tpu", "tony_tpu_torch_launch"), f"{path.name} imports {mod}"


@pytest.mark.parametrize("path", LAUNCH_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_launcher_imports_no_jax_and_no_torch(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "torch", "tony_tpu_torch"), f"{path.name} imports {mod}"


def _assert_import_loads_none_of(modules: str, banned: tuple[str, ...]) -> None:
    code = (f"import sys, {modules}; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {banned!r}]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _assert_import_loads_no_jax(modules: str) -> None:
    _assert_import_loads_none_of(modules, ("jax", "tony_tpu"))


def test_serving_http_import_loads_no_jax():
    _assert_import_loads_no_jax("tony_tpu_torch.models.serving_http, tony_tpu_torch.models.convert")


def test_hf_loading_imports_neither_transformers_nor_safetensors():
    """The card has neither package: the checkpoint reader and the server
    that uses it load none of them, nor jax."""
    _assert_import_loads_none_of("tony_tpu_torch.models.convert, tony_tpu_torch.models.serving_http",
                                 ("jax", "tony_tpu", "transformers", "safetensors"))


def test_training_import_loads_no_jax():
    _assert_import_loads_no_jax(
        "tony_tpu_torch.train.loop, tony_tpu_torch.ops.attention, tony_tpu_torch.train.pretrain")


def test_gang_modules_import_loads_no_jax():
    _assert_import_loads_no_jax(
        "tony_tpu_torch.runtime, tony_tpu_torch.data.dataset, tony_tpu_torch.data.native, "
        "tony_tpu_torch.obs.metrics, tony_tpu_torch.obs.trace, tony_tpu_torch.obs.logging, "
        "tony_tpu_torch.obs.introspect, tony_tpu_torch.chaos.inject, "
        "tony_tpu_torch.train.checkpoint, tony_tpu_torch.train.profiling")


def test_serving_fleet_modules_import_loads_no_jax():
    _assert_import_loads_no_jax(
        "tony_tpu_torch.cluster.rpc, tony_tpu_torch.serve.disagg, tony_tpu_torch.models.paged_cache, "
        "tony_tpu_torch.models.serving_http")


def test_launcher_import_loads_no_jax_and_no_torch():
    """The launcher and the control plane it runs (the fleet router,
    coordinator, load generator, the bench gate) load neither framework:
    the fleet process needs no JAX on the card's machine."""
    _assert_import_loads_none_of(
        "tony_tpu_torch_launch.serve, tony_tpu.serve.disagg, tony_tpu.serve.loadgen, "
        "tony_tpu.serve.router, tony_tpu.cli.loadtest, tony_tpu.histserver.gate",
        ("jax", "jaxlib", "torch", "tony_tpu_torch"))


def test_mixtral_import_loads_no_jax():
    _assert_import_loads_no_jax(
        "tony_tpu_torch.models.mixtral, tony_tpu_torch.train.pretrain_mixtral, "
        "tony_tpu_torch.ops.moe_gemm, tony_tpu_torch.parallel.expert")


def test_bert_import_loads_no_jax():
    _assert_import_loads_no_jax(
        "tony_tpu_torch.models.bert, tony_tpu_torch.data.dataset, tony_tpu_torch.train.pretrain_bert")


def test_cuda_is_the_default_device():
    from tony_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()


def test_training_defaults_to_cuda():
    """``run_lm_training`` with no device named runs on the card, so without
    one it raises instead of training on the CPU."""
    from tony_tpu_torch.models import llama
    from tony_tpu_torch.train.loop import LoopConfig, parse_loop_args, run_lm_training

    assert LoopConfig().device == "cuda" and parse_loop_args([])[0].device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_lm_training(llama, llama.LLAMA_TINY, LoopConfig(steps=1))
