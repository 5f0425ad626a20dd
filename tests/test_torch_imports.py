"""The port stands alone: no JAX and nothing of samd_tpu in samd_tpu_torch,
chip_smoke.py or the card-only kernel test, and no silent fall back to the
CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
# the port, its chip script, the card-only tests that must run where JAX is
# not installed, and the worker of the multi-process tests, which must not
# import JAX either
PORT_FILES = sorted((ROOT / "samd_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernel_cuda.py",
    ROOT / "tests" / "test_torch_device_loop_cuda.py",
    ROOT / "tests" / "torch_parallel_worker.py"]


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_found():
    assert len(PORT_FILES) > 10
    for rel in ("fused_sam.py", "ops/quant.py", "ops/int4_matmul.py",
                "cache.py", "tools/profile_step.py", "server.py",
                "ops/ngram_index.py", "batching.py", "interleave.py",
                "sam/automaton.py", "sam/native.py",
                "drafters/sam_drafter.py", "drafters/token_recycle.py",
                "pld.py", "token_recycle_fused.py", "fused_hybrid.py",
                "eagle_fused.py", "drafters/eagle/net.py",
                "drafters/eagle/drafter.py", "drafters/eagle/eagle1.py",
                "cli.py", "training.py", "profiling.py", "models/loader.py",
                "models/checkpoint.py", "evaluation/__init__.py",
                "evaluation/runner.py", "evaluation/codecs.py",
                "evaluation/equal.py", "evaluation/speed.py",
                "evaluation/synthetic.py", "evaluation/accept_demo.py",
                "evaluation/specbench_demo.py", "evaluation/neartie.py",
                "evaluation/profile_run.py", "evaluation/parity.py",
                "evaluation/launch.py", "evaluation/bench_emit.py",
                "tools/build_sam.py",
                "tools/gen_corpus.py", "parallel/__init__.py",
                "parallel/comm.py", "parallel/sharding.py",
                "parallel/seq_parallel.py", "parallel/multihost.py",
                "ops/request_noise.py", "device_loop.py"):
        assert ROOT / "samd_tpu_torch" / rel in PORT_FILES, rel


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "samd_tpu", "flax"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_tf32_is_refused_on_cuda_and_left_alone():
    """The port never changes the process's TF32 flags; on a CUDA device it
    raises while TF32 matmuls are on, and the CPU is unaffected."""
    from samd_tpu_torch.device import require_full_f32, resolve_device

    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        resolve_device("cpu")
        assert torch.backends.cuda.matmul.allow_tf32
        require_full_f32(torch.device("cpu"))
        with pytest.raises(RuntimeError, match="TF32"):
            require_full_f32(torch.device("cuda"))
        torch.backends.cuda.matmul.allow_tf32 = False
        require_full_f32(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_engines_without_device_raise_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from samd_tpu_torch.eagle_fused import FusedEagle2Engine
    from samd_tpu_torch.engine import ArBaseline
    from samd_tpu_torch.fused_hybrid import (
        BatchedFusedHybridEagleEngine, BatchedFusedHybridEngine,
        FusedHybridEagleEngine, FusedHybridEngine,
        PagedBatchedFusedHybridEagleEngine, PagedBatchedFusedHybridEngine)
    from samd_tpu_torch.fused_sam import FusedSamEngine
    from samd_tpu_torch.models import tiny_config
    from samd_tpu_torch.pld import PldEngine
    from samd_tpu_torch.token_recycle_fused import FusedTokenRecycleEngine

    cfg = tiny_config(vocab_size=32)
    params = {"embed": torch.zeros(32, 64)}
    for make in (lambda: ArBaseline(cfg, params),
                 lambda: FusedSamEngine(cfg, params),
                 lambda: PldEngine(cfg, params),
                 lambda: FusedTokenRecycleEngine(cfg, params),
                 lambda: FusedHybridEngine(cfg, params),
                 lambda: BatchedFusedHybridEngine(cfg, params),
                 lambda: PagedBatchedFusedHybridEngine(cfg, params),
                 lambda: FusedEagle2Engine(cfg, params),
                 lambda: FusedHybridEagleEngine(cfg, params),
                 lambda: BatchedFusedHybridEagleEngine(cfg, params),
                 lambda: PagedBatchedFusedHybridEagleEngine(cfg, params)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
