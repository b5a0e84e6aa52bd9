"""The check that no run loads JAX or the JAX package: whole top-level
names, so the port passes; and neither the harness nor the reference needs
either."""

from __future__ import annotations

import subprocess
import sys

from portbench import run


def test_whole_top_level_names(monkeypatch):
    base = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "swiftmp3_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "swiftmp3_tpu.ops.kernels", object())
    monkeypatch.setitem(sys.modules, "jax._src.core", object())
    assert set(run.forbidden_modules()) == base | {"swiftmp3_tpu", "jax"}


def test_a_run_and_the_reference_load_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from portbench.tests.conftest import tiny_run\n"
        "import portbench.check, portbench.golden.encoder\n"
        "r, _ = tiny_run('compat128.corpus')\n"
        "from portbench.run import forbidden_modules\n"
        "print(r['correct'], r['checks']['jax_modules']['value'], forbidden_modules(),"
        " 'swiftmp3_tpu_torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=run.__file__.rsplit("/portbench/", 1)[0])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True 0 [] True"


def test_the_reference_imports_numpy_alone():
    code = (
        "import sys\n"
        "import portbench.check\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'swiftmp3_tpu', 'swiftmp3_tpu_torch')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=run.__file__.rsplit("/portbench/", 1)[0])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
