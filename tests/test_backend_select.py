"""Backend selection without hidden fallbacks, and the compile cache.

Whether a GPU exists is decided inside each test, never at import.
"""
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMALL = os.path.join(_REPO, "streams", "postfilter_384x192.ivf")


def _has_gpu():
    import jax
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def test_platform_gpu_without_gpu_raises():
    from av1dec_tpu.api import Decoder
    from av1dec_tpu.config import DecoderConfig
    from av1dec_tpu.container import read_ivf
    if _has_gpu():
        pytest.skip("this machine has a GPU")
    dec = Decoder(DecoderConfig(platform="gpu"))
    _, tu = next(read_ivf(_SMALL))
    with pytest.raises(RuntimeError, match="platform='gpu'"):
        dec.decode(tu)
    dec.close()


def test_gop_workers_with_device_refused_before_workers(monkeypatch):
    from av1dec_tpu import cli, container

    def no_workers(*a, **k):
        raise AssertionError("a GOP worker was started")

    monkeypatch.setattr(container, "_run_jobs_elastic", no_workers)
    monkeypatch.setattr(container, "index_keyframes", no_workers)
    with pytest.raises(ValueError, match="worker processes"):
        cli.main([_SMALL, "--gop-workers", "2", "--device", "gpu",
                  "--md5"])


def test_chip_smoke_refuses_cpu_backend():
    import chip_smoke
    if _has_gpu():
        pytest.skip("this machine has a GPU")
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.device_check()
    # the script itself: non-zero exit, the reason, and no result line
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_compile_cache_env_set(monkeypatch, tmp_path):
    import jax

    from av1dec_tpu import compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch):
    import jax

    from av1dec_tpu import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(_REPO, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_keeps_configured_dir(monkeypatch, tmp_path):
    import jax

    from av1dec_tpu import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_gop_workers_on_cpu_backend_allowed(monkeypatch):
    """The CPU backend reserves no card memory, so GOP workers may each
    run the device path on it."""
    from av1dec_tpu import container
    from av1dec_tpu.config import DecoderConfig
    started = []

    def workers(jobs, n):
        started.append([j[3]["platform"] for j in jobs])
        return []

    monkeypatch.setattr(container, "_run_jobs_elastic", workers)
    container.decode_gops_parallel(_SMALL, workers=2,
                                   config=DecoderConfig(platform="cpu"))
    assert started == [["cpu", "cpu"]]
