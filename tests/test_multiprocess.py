"""Real multi-PROCESS process-group tests (SURVEY.md §5.8).

Everything else distributed in this suite runs on a single-process
8-virtual-device mesh, which never executes ``distributed.initialize()``'s
process-group join or ``host_local_to_global()``'s cross-process array
assembly — the actual multi-host code path of the 65k-ensemble eval shape
(BASELINE.md row 3). These tests spawn TWO localhost CPU processes with 4
forced-host devices each (explicit coordinator, like a 2-host pod) and
assert the data-parallel train step agrees EXACTLY (f64, eps=0 fixed work)
with the single-process 8-device result.

Real pods cannot be tested in this container; the process-group mechanics
can — and the loud-failure contract of ``initialize()`` (explicit args must
raise on inconsistency, never degrade to silent single-process) is pinned
here too.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sockets_allowed() -> bool:
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            s.listen(1)
        return True
    except OSError:
        return False


needs_sockets = pytest.mark.skipif(
    not _sockets_allowed(),
    reason="localhost sockets unavailable in this sandbox — "
    "multi-process group tests need a loopback listener",
)


@needs_sockets
def test_two_process_dp_train_step_matches_single_process():
    """2 processes x 4 devices == 1 process x 8 devices, exactly.

    The workers join an explicit coordinator, assemble the global batch
    from per-process halves via ``host_local_to_global``, and run one
    ``make_dp_train_step`` step; the reference is the same seeded step on
    this process's own 8-device mesh."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    # JAX_NUM_CPU_DEVICES would override XLA_FLAGS if a conftest-launched
    # parent exported it; make the worker topology explicit either way.
    env.pop("JAX_NUM_CPU_DEVICES", None)

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(pid)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, (
            f"worker failed rc={rc}\n--- stdout ---\n{out[-2000:]}\n"
            f"--- stderr ---\n{err[-4000:]}"
        )
    lines = [
        l for rc, out, err in outs for l in out.splitlines()
        if l.startswith("MP_RESULT ")
    ]
    assert len(lines) == 1, f"expected exactly one MP_RESULT line, got {lines}"
    mp = json.loads(lines[0][len("MP_RESULT "):])

    # Single-process 8-device reference (conftest mesh), same seeded problem.
    import jax.numpy as jnp
    import optax

    sys.path.insert(0, os.path.dirname(WORKER))
    from _mp_worker import seeded_problem

    from diffmpc_tpu.parallel import (
        init_train_state, make_dp_train_step, make_mesh, shard_batch,
    )

    dtype = jnp.float64
    config, cost, dx, x_init = seeded_problem(dtype)
    B, T = x_init.shape[0], config.T
    u_expert = jnp.zeros((T, B, 1), dtype)

    def make_problem(params):
        return cost, dx.replace(params=params)

    opt = optax.sgd(1e-2)
    mesh = make_mesh()
    step = make_dp_train_step(config, make_problem, opt, mesh, -2.0, 2.0)
    state, stats = step(
        init_train_state(dx.params, opt),
        shard_batch(mesh, jnp.asarray(x_init), 0),
        shard_batch(mesh, u_expert, 1),
    )

    np.testing.assert_allclose(mp["loss"], float(stats.loss), rtol=1e-12)
    np.testing.assert_allclose(
        mp["grad_norm"], float(stats.grad_norm), rtol=1e-10
    )
    np.testing.assert_allclose(
        mp["converged_frac"], float(stats.converged_frac), atol=0
    )
    np.testing.assert_allclose(
        np.asarray(mp["params"]), np.asarray(state.params), atol=1e-12
    )


def test_initialize_explicit_args_raise_on_inconsistency():
    """Explicit-argument ``initialize()`` must FAIL LOUDLY: a bad topology
    must never silently degrade to single-process and
    compute un-psummed gradients. In THIS process JAX backends are already
    live, so any explicit call raises the backends-live error — still
    loud, but it exercises call-ordering, not argument validation; the
    fresh-process variant below pins the validation path itself."""
    from diffmpc_tpu.parallel import distributed

    with pytest.raises(Exception):
        # process_id alone is inconsistent — pre-fix this fell through to
        # auto-discovery and was silently swallowed.
        distributed.initialize(process_id=1)
    with pytest.raises(Exception):
        distributed.initialize(num_processes=2)


def test_initialize_fresh_process_arg_validation_and_reentry():
    """The contracts only a FRESH interpreter can exercise (JAX validates
    arguments before touching backends only when none are initialized):
    (a) incomplete explicit args raise the coordinator-address validation
    error, not the backends-live error; (b) after a successful 1-process
    explicit join, the auto-discovery re-entry is the documented
    idempotent no-op (JAX raises 'should only be called once', which
    initialize() must swallow — a round-4 review found the old matcher
    only knew 'already initialized' and crashed here)."""
    code = """
import sys
from diffmpc_tpu.parallel import distributed

# (a) incomplete explicit args in a fresh process: validation error
try:
    distributed.initialize(num_processes=2, process_id=0)
    print("NO_RAISE")
    sys.exit(1)
except Exception as e:
    assert "coordinator" in str(e).lower(), repr(e)
    print("ARG_VALIDATION_OK")

# (b) real join then re-entry: no-op, same index
import socket
s = socket.socket()
s.bind(("127.0.0.1", 0))
port = s.getsockname()[1]
s.close()
idx = distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=1, process_id=0
)
assert idx == 0, idx
assert distributed.initialize() == 0
print("REENTRY_OK")
"""
    if not _sockets_allowed():
        pytest.skip("sandbox forbids sockets")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ARG_VALIDATION_OK" in res.stdout
    assert "REENTRY_OK" in res.stdout


def test_initialize_auto_path_raises_on_malformed_cluster_env():
    """A MALFORMED cluster environment must fail loudly on the
    auto-discovery path: the benign single-process
    ValueError is matched by message ('coordinator_address should be
    defined'); any other ValueError — here a partial cluster env var
    (JAX_COORDINATOR_ADDRESS set, process count/id absent) — must raise,
    never degrade to a silent un-psummed single-process run. Needs a
    fresh interpreter: once backends are live JAX short-circuits to the
    backends-live RuntimeError before validating the cluster env."""
    code = """
from diffmpc_tpu.parallel import distributed
try:
    distributed.initialize()
    print("NO_RAISE")
except ValueError as e:
    assert "Number of processes" in str(e), repr(e)
    print("LOUD_FAILURE_OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:12345"
    res = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOUD_FAILURE_OK" in res.stdout, res.stdout


def test_initialize_auto_path_is_noop_without_cluster():
    """Auto-discovery with no cluster environment stays a single-process
    no-op (the reference's only mode) returning process index 0 — but once
    JAX backends are live (this process), the skipped group join is
    surfaced as a RuntimeWarning, never swallowed silently."""
    import warnings

    from diffmpc_tpu.parallel import distributed

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert distributed.initialize() == 0
    assert any(
        issubclass(x.category, RuntimeWarning)
        and "auto-discovery was skipped" in str(x.message)
        for x in w
    ), [str(x.message) for x in w]
