"""The port (nomad_tpu_torch) stands alone: it imports torch and never
jax, and nothing of the JAX package; its entry points run on CUDA
unless the CPU is asked for, and raise without a card."""

from __future__ import annotations

import ast
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_parity  # noqa: F401  (the port on the CPU, one torch thread)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nomad_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "nomad_tpu")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "topk_profile.py"]
    assert len(files) > 30
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nomad_tpu_torch\n"
        "for m in pkgutil.walk_packages(nomad_tpu_torch.__path__,"
        " 'nomad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith("
        "'nomad_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) > 30


def test_dense_factory_needs_cuda_unless_cpu_is_asked_for():
    from nomad_tpu_torch.device import default_device, set_default_device
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.state import StateStore

    logger = logging.getLogger("test")
    set_default_device(None)
    try:
        if torch.cuda.is_available():
            assert default_device().type == "cuda"
            sched = new_scheduler("service-gpu", logger,
                                  StateStore().snapshot(), None)
            assert sched.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                default_device()
            with pytest.raises(RuntimeError, match="CUDA"):
                new_scheduler("service-gpu", logger,
                              StateStore().snapshot(), None)
        # The host oracle never needs a device.
        new_scheduler("service", logger, StateStore().snapshot(), None)
        set_default_device("cpu")
        sched = new_scheduler("batch-gpu", logger, StateStore().snapshot(),
                              None)
        assert sched.device == torch.device("cpu") and sched.batch
    finally:
        set_default_device("cpu")


def test_kernel_wrappers_take_the_plain_path_only_for_cpu_tensors():
    """A wrapper given a tensor on a device it has no kernel for
    raises; it never falls back to the plain version."""
    from nomad_tpu_torch.ops.prng import threefry_uniform

    keys = torch.zeros((1, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        threefry_uniform(keys, (4,), 0.0, 1.0)


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """chip_smoke.py in a directory holding nothing else of the repo
    (or on a machine with no card) exits non-zero and prints no
    result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_without_a_card_fails_without_a_result():
    """Beside the port but on a machine with no CUDA device, the smoke
    exits non-zero before any phase and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr
