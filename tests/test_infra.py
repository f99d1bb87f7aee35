"""Compile-cache placement, the host-keyed native build, decoder import
errors, the CLI's Flax check, and the on-card attention parity (gpu)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILE = ("import sys; sys.path.insert(0, {repo!r}); import jax; "
            "jax.config.update('jax_persistent_cache_min_compile_time_secs', "
            "0); from patent_tpu.utils.compile_cache import "
            "enable_compilation_cache as e; print(e()); import jax.numpy as "
            "jnp; jax.jit(lambda x: jnp.sin(x) * 3.0 + x)(jnp.ones(7))"
            ".block_until_ready()")


def _run_compile(env_extra: dict, tmp_path) -> str:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu", HOME=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", _COMPILE.format(repo=REPO)],
                       env=env, capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_uses_env_dir_only(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: entries land there, nowhere else."""
    cache = tmp_path / "jaxcache"
    fixed = os.path.join(REPO, ".jax_cache", "cpu")
    before = set(os.listdir(fixed)) if os.path.isdir(fixed) else set()
    got = _run_compile({"JAX_COMPILATION_CACHE_DIR": str(cache)}, tmp_path)
    assert got == str(cache)
    assert cache.is_dir() and any(cache.iterdir())
    after = set(os.listdir(fixed)) if os.path.isdir(fixed) else set()
    assert after == before


def test_compile_cache_default_is_fixed_checkout_path(tmp_path):
    got = _run_compile({}, tmp_path)
    assert got == os.path.join(REPO, ".jax_cache", "cpu")
    assert os.path.isdir(got) and os.listdir(got)


def test_native_build_key_tracks_source_and_host(monkeypatch):
    from patent_tpu.input import native

    key = native.build_key()
    assert native._lib_path().endswith(
        os.path.join("native", "build", key, "libpatent_io.so"))
    monkeypatch.setattr(native, "_cpu_flags", lambda: "flags : other-cpu")
    assert native.build_key() != key
    monkeypatch.setattr(native.platform, "machine", lambda: "aarch64")
    assert native.build_key() != key


def test_missing_pil_raises_not_skips(monkeypatch, tmp_path):
    """A decoder that cannot be imported must raise: turning it into None
    per image would silently empty a gallery."""
    from patent_tpu.input import pipeline

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        pipeline.decode_image_u8(str(tmp_path / "x.png"), 32)
    with pytest.raises(ImportError):
        pipeline.decode_image(str(tmp_path / "x.png"), 32)


def test_cli_flax_actions_fail_at_start(monkeypatch, capsys, tmp_path):
    import importlib.util

    from patent_tpu.cli import main as cli

    real = importlib.util.find_spec
    monkeypatch.setattr(cli.importlib.util, "find_spec",
                        lambda name, *a: None if name == "flax"
                        else real(name, *a))
    assert cli.main(["train_hyp", "--path", str(tmp_path)]) == 2
    assert "needs Flax" in capsys.readouterr().err
    assert not os.listdir(tmp_path)          # nothing ran


@pytest.mark.gpu
def test_cudnn_attention_matches_xla_on_card(gpu_device):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((4, 197, 12, 64)),
                           jnp.bfloat16) for _ in range(3))
    a = jax.nn.dot_product_attention(q, k, v, implementation="cudnn")
    b = jax.nn.dot_product_attention(q, k, v, implementation="xla")
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=2e-2)
