"""Import hygiene: the port and chip_smoke.py pull in neither JAX nor
any module of the ``repro`` package."""
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.path.insert(0, "src")
    sys.path.insert(0, ".")
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    chip_smoke._imports()
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "jaxlib", "repro")
                 or m.startswith(("jax.", "jaxlib.", "repro.")))
    print(len(names), bad)
    assert not bad, bad
    for want in ("serving.engine", "serving.kv_pool", "faults.plan",
                 "faults.chaos", "obs.tracing", "obs.flight", "obs.export",
                 "obs.perf", "obs.server", "launch.serve",
                 "core.simt.machine", "runtime.spawn",
                 "runtime.kernels_src.rodinia", "obs.demo"):
        assert "repro_torch." + want in names, (want, names)
""")


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[0].isdigit()
