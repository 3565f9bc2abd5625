"""Auxiliary-subsystem tests: sanitizers, logging, checkpointing,
distributed helpers (SURVEY.md §5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu.utils.debug import checked_solve, debug_nans
from diffmpc_tpu.utils.logging import CSVLogger, JSONLLogger, table_log


def test_checked_solve_catches_nan():
    def bad(x):
        return x / jnp.sum(x * 0.0)  # 0/0

    err, _ = jax.jit(checked_solve(bad))(jnp.ones(4))
    with pytest.raises(Exception):
        err.throw()

    def good(x):
        return x * 2.0

    err, out = jax.jit(checked_solve(good))(jnp.ones(4))
    err.throw()  # must not raise
    np.testing.assert_allclose(np.asarray(out), 2.0)


def test_debug_nans_context_restores_flag():
    before = jax.config.jax_debug_nans
    with debug_nans(True):
        assert jax.config.jax_debug_nans is True
    assert jax.config.jax_debug_nans == before


def test_loggers(tmp_path):
    csv_path = os.path.join(tmp_path, "m.csv")
    log = CSVLogger(csv_path, ["step", "loss"])
    log.log(step=0, loss=1.5)
    log.log(step=1, loss=1.2)
    log.close()
    lines = open(csv_path).read().strip().split("\n")
    assert lines[0] == "step,loss" and len(lines) == 3

    jl = JSONLLogger(os.path.join(tmp_path, "m.jsonl"))
    jl.log(step=0, loss=1.5)
    jl.close()
    import json

    row = json.loads(open(os.path.join(tmp_path, "m.jsonl")).read())
    assert row["loss"] == 1.5 and "time" in row

    line = table_log("t", (("a", 1), ("b", 1.23456, "{:.2f}")))
    assert line == "[t] a=1 b=1.23"


def test_checkpoint_roundtrip(tmp_path):
    from diffmpc_tpu.checkpoint import latest_step, restore_checkpoint, save_checkpoint

    state = {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3), "n": jnp.asarray(3)}
    save_checkpoint(str(tmp_path), state, 10)
    save_checkpoint(str(tmp_path), state, 20)
    assert latest_step(str(tmp_path)) == 20
    got = restore_checkpoint(str(tmp_path), state)
    np.testing.assert_allclose(np.asarray(got["w"]), np.asarray(state["w"]))


def test_distributed_initialize_single_process():
    from diffmpc_tpu.parallel import distributed

    assert distributed.initialize() == jax.process_index()


def test_host_local_to_global_single_host():
    from diffmpc_tpu.parallel import distributed
    from diffmpc_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()
    local = np.arange(32, dtype=np.float32).reshape(16, 2)
    arr = distributed.host_local_to_global(mesh, local, batch_dim=0)
    assert arr.shape == (16, 2)
    np.testing.assert_allclose(np.asarray(arr), local)


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_rule(env_dir, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the helper touches nothing (JAX reads
    the variable itself). Unset: the cache goes to the fixed <repo>/.jax_cache."""
    from diffmpc_tpu.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
    try:
        got = compile_cache.enable_compile_cache()
        if env_dir is None:
            assert got == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            assert got is None
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
