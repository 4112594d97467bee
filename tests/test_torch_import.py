"""The port stands alone: it imports no jax (directly or through
auncel_tpu), and chip_smoke.py refuses to run without a CUDA device or
outside the repository."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(code_or_args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) \
        else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import auncel_tpu_torch\n"
        "for m in pkgutil.walk_packages(auncel_tpu_torch.__path__,\n"
        "                               'auncel_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n == 'jax' or n.startswith(('jax.', 'auncel_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(code, REPO)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_chip_smoke_fails_without_cuda(monkeypatch, capsys):
    import torch
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, even where CUDA is present, the script cannot
    import the port and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    res = _run(code, tmp_path)
    assert res.returncode != 0
    assert "auncel_tpu_torch" in res.stderr
    assert '"ok"' not in res.stdout
