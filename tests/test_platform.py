"""Platform rules: the peaks table, the compile-cache location, meshes
that raise instead of falling back to the CPU, and ``chip_smoke.py``
refusing to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_peaks_known_card():
    from paddle_sparse_jax.peaks import peaks_for
    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert p.hbm_gbps == 3350.0 and p.link_gbps == 450.0
    assert p.bf16_tflops == 989.0 and p.hbm_gb == 80.0


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100"])
def test_peaks_unknown_card_raises(kind):
    from paddle_sparse_jax.peaks import peaks_for
    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for(kind)


def test_scaling_needs_a_known_card():
    from paddle_sparse_jax.parallel import estimate_scaling
    with pytest.raises(KeyError):
        estimate_scaling("ring", 4, 1000, 100, 100, 8, achieved_gbps=1.0,
                         device_kind="NVIDIA A100")


@pytest.mark.parametrize("env", [None, "/somewhere/else"])
def test_compile_cache_rule(monkeypatch, env):
    """The environment variable wins when set; otherwise a fixed
    directory inside the checkout."""
    from paddle_sparse_jax import cache
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert cache.compile_cache_dir() == env


def test_make_mesh_raises_without_enough_devices():
    import jax

    from paddle_sparse_jax.parallel import make_mesh
    from paddle_sparse_jax.parallel.spmm2d import make_mesh_2d
    n = len(jax.devices())
    assert make_mesh(n).devices.size == n
    with pytest.raises(RuntimeError, match="need"):
        make_mesh(n + 1)
    with pytest.raises(RuntimeError, match="need"):
        make_mesh_2d(2, n)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PATH=os.environ.get("PATH", ""))
    env.pop("PSP_TESTS_ON_GPU", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or '"ok": true' not in lines[-1]


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0 and _no_result(proc)


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0 and _no_result(proc)


def test_import_starts_no_backend():
    """Importing the package must not start a device backend: a process
    that only checks or plans (chip_smoke.py's parent before its card
    tests) must not reserve the card's memory."""
    code = ("import paddle_sparse_jax\n"
            "from jax._src import xla_bridge as xb\n"
            "print(bool(xb._backends))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "False"
