"""The import check compares whole top-level names, and a run gives no
result where it cannot measure."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

from portbench import run


def test_whole_names():
    assert run.forbidden_modules(["transformer_gan_torch.models.xl",
                                  "jaxtyping", "flaxen", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                                  "transformer_gan_tpu.models",
                                  "flax.linen"]) == [
        "flax", "jax", "jaxlib", "transformer_gan_tpu"]


def test_benchmark_loads_no_jax():
    code = ("import portbench.run, portbench.drivers.mle, "
            "portbench.drivers.evalgen, portbench.trace, portbench.calibrate, "
            "portbench.reference.train, portbench.reference.generate; "
            "import transformer_gan_torch.train.loop; "
            "print(portbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _command(cwd):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "xl_baseline.mle_b128", "--seed", str(2 ** 31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _command(run.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
