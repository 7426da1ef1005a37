"""Backend choice, DP-kernel choice, compile cache and the smoke's gate."""

import os
import sys

import jax
import pytest

from hairsplitter_jax import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,kernel", [("gpu", "jnp"), ("cpu", "native")])
def test_dp_kernel_choice(platform, kernel):
    assert runtime.dp_kernel(platform) == kernel


@pytest.mark.parametrize("platform", ["metal", "rocm", ""])
def test_dp_kernel_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no DP kernel"):
        runtime.dp_kernel(platform)


def test_platform_is_cpu_here_and_summary_matches():
    assert runtime.platform() == "cpu"
    assert not runtime.on_gpu()
    s = runtime.device_summary()
    assert s == {"platform": "cpu", "kind": jax.devices()[0].device_kind, "count": len(jax.devices())}


def test_platform_refuses_unknown_backend(monkeypatch):
    class Dev:
        platform = "metal"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        runtime.platform()


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_wins(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.init_compile_cache() == str(tmp_path)
    # the code sets no directory of its own: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.init_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert runtime.init_compile_cache() == path  # no pid, time or temp name
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_smoke_device_gate_refuses_cpu():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.device_gate()


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_smoke_script_fails_without_gpu_or_repo(alone, tmp_path):
    """Run as a script on the CPU - or copied into a directory without the
    rest of the repo - chip_smoke.py exits non-zero and prints no result."""
    import shutil
    import subprocess

    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
