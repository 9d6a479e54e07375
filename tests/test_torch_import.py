"""The port never imports jax: the card's machine has none.

tests/conftest.py imports jax before any test runs, so the import check
runs in a fresh interpreter.
"""
import os
import re
import subprocess
import sys

import miso_tpu_torch

PKG = os.path.dirname(os.path.abspath(miso_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)


def test_port_imports_leave_jax_out():
    code = ("import sys, miso_tpu_torch, miso_tpu_torch.pipeline, "
            "miso_tpu_torch.cli.main, miso_tpu_torch.kernels, "
            "miso_tpu_torch.sampler.model, miso_tpu_torch.testing, "
            "miso_tpu_torch.sampler.marginal_kernel, "
            "miso_tpu_torch.sampler.convergent, miso_tpu_torch.stats.rhat; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.')))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)
    offenders = []
    for d, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                with open(path) as f:
                    if pat.search(f.read()):
                        offenders.append(os.path.relpath(path, ROOT))
    assert not offenders
    # the smoke script reaches the JAX package's host code only through
    # the port
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        assert not re.search(r"^\s*(import|from) (jax|miso_tpu)\b",
                             f.read(), re.M)


def test_tf32_is_off():
    import torch
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
