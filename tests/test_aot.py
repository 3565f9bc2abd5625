"""AOT export/load of solve programs (diffmpc_tpu/aot.py).

The serialized artifact must reproduce the live program exactly (same
StableHLO → same numerics), expose the chosen runtime inputs positionally,
and — at vjp_order>=1 — re-enter the serialized analytic KKT backward
under jax.grad after a load in (conceptually) another process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu import MPCConfig, QuadCost, mpc_solve
from diffmpc_tpu.aot import export_solve, load_solve
from diffmpc_tpu.models import PendulumDx


def _problem(B=8, T=6, lqr_iter=4):
    dx = PendulumDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=1e-5,
        exit_unconverged=False, detach_unconverged=False,
        dtype=jnp.float32,
    )
    rng = np.random.default_rng(42)
    th = rng.uniform(-np.pi, np.pi, B)
    x = jnp.asarray(
        np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1),
        jnp.float32,
    )
    return config, cost, dx, x


def test_roundtrip_matches_live_solve(tmp_path):
    config, cost, dx, x = _problem()
    blob = export_solve(config, cost, dx, B=x.shape[0],
                        u_lower=-2.0, u_upper=2.0)
    assert isinstance(blob, (bytes, bytearray))
    # survive the artifact store (file write/read)
    f = tmp_path / "solve.bin"
    f.write_bytes(blob)
    solve = load_solve(f.read_bytes())

    got = solve(x)
    want = mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    np.testing.assert_allclose(got.us, want.us, atol=1e-6)
    np.testing.assert_allclose(got.objs, want.objs, atol=1e-5)
    assert bool(jnp.all(got.us >= -2.0)) and bool(jnp.all(got.us <= 2.0))
    # full MPCSolution pytree comes back, info included
    np.testing.assert_array_equal(got.info.converged, want.info.converged)


def test_warm_start_input_is_live(tmp_path):
    """u_init must be a RUNTIME input: two different warm starts through
    one artifact give the two live answers."""
    config, cost, dx, x = _problem(lqr_iter=2)
    blob = export_solve(config, cost, dx, B=x.shape[0],
                        u_lower=-2.0, u_upper=2.0, warm_start=True)
    solve = load_solve(blob)
    u0 = jnp.zeros((config.T, x.shape[0], 1), jnp.float32)
    u1 = jnp.full_like(u0, 0.5)
    for u in (u0, u1):
        got = solve(x, u)
        want = mpc_solve(config, x, cost, dx, u_init=u,
                         u_lower=-2.0, u_upper=2.0)
        np.testing.assert_allclose(got.us, want.us, atol=1e-6)
    assert float(jnp.max(jnp.abs(solve(x, u0).us - solve(x, u1).us))) > 0


def test_params_input_and_grad_through_artifact():
    """Serve a learned model: params are a runtime input and, with
    vjp_order=1, jax.grad re-enters the serialized KKT backward — parity
    with the live gradient (the sysid-through-the-artifact use)."""
    config, cost, dx, x = _problem(lqr_iter=3)
    blob = export_solve(
        config, cost, dx, B=x.shape[0], u_lower=-2.0, u_upper=2.0,
        params_input=True, vjp_order=1,
    )
    solve = load_solve(blob)

    params = jnp.asarray(dx.params) * 1.1

    def loss_aot(p):
        return jnp.sum(solve(x, p).us ** 2)

    def loss_live(p):
        return jnp.sum(
            mpc_solve(config, x, cost, dx.replace(params=p),
                      u_lower=-2.0, u_upper=2.0).us ** 2
        )

    np.testing.assert_allclose(loss_aot(params), loss_live(params),
                               rtol=1e-6)
    g_aot = jax.grad(loss_aot)(params)
    g_live = jax.grad(loss_live)(params)
    np.testing.assert_allclose(g_aot, g_live, rtol=2e-4, atol=1e-6)


def test_params_input_requires_params():
    from diffmpc_tpu.types import LinDx

    config, cost, dx, x = _problem()
    T, B, n, m = config.T, x.shape[0], 3, 1
    lin = LinDx(
        jnp.zeros((T, B, n, n + m), jnp.float32),
        jnp.zeros((T, B, n), jnp.float32),
    )
    with pytest.raises(ValueError, match="params_input"):
        export_solve(config, cost, lin, B=B, params_input=True)


def test_jit_and_introspection():
    config, cost, dx, x = _problem(lqr_iter=2)
    blob = export_solve(config, cost, dx, B=x.shape[0],
                        u_lower=-2.0, u_upper=2.0)
    solve = load_solve(blob)
    # composes under an outer jit (serving loop pattern)
    jitted = jax.jit(lambda xi: solve(xi).objs)
    np.testing.assert_allclose(jitted(x), solve(x).objs, atol=1e-6)
    assert solve.exported.in_avals  # introspection surface


def test_mesh_export_multi_device(tmp_path):
    """Multi-chip serving: export the SHARDED program over an 8-device
    ('batch',) mesh — batch and per-scenario parameter rows sharded,
    artifact records the device count — and match the single-device
    answer after a load."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    config, cost, dx, x = _problem(B=16, T=6, lqr_iter=3)
    B = x.shape[0]
    # per-scenario params: (B, 3) rows shard with the batch
    scale = jnp.linspace(0.95, 1.05, B, dtype=jnp.float32)[:, None]
    dxb = dx.replace(params=jnp.asarray(dx.params) * scale)

    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    blob = export_solve(
        config, cost, dxb, B=B, u_lower=-2.0, u_upper=2.0,
        params_input=True, mesh=mesh,
    )
    solve = load_solve(blob)
    assert solve.exported.nr_devices == 8

    xs = jax.device_put(x, NamedSharding(mesh, P("batch")))
    ps = jax.device_put(
        jnp.asarray(dxb.params), NamedSharding(mesh, P("batch"))
    )
    got = solve(xs, ps)
    want = mpc_solve(config, x, cost, dxb, u_lower=-2.0, u_upper=2.0)
    np.testing.assert_allclose(got.us, want.us, atol=1e-5)
    np.testing.assert_allclose(got.objs, want.objs, atol=1e-4)


TRITON_CALL = "__gpu$xla.gpu.triton"


def test_cross_platform_cuda_export_bakes_fused_dispatch():
    """Build-host story: platforms=['cuda'] on a CPU host must cross-lower
    the FUSED program — use_pallas=None follows the export target through
    the platform table, not the build host, which would silently bake the
    slower XLA orchestration into the GPU artifact. Pinned by the Triton
    kernel call in the artifact's StableHLO (exported past jax.export's
    custom-call allowlist); execution on the card is verified by
    chip_smoke.py."""
    config, cost, dx, x = _problem(B=1024, T=10, lqr_iter=3)
    # a real build host exports with x64 off (the kernels are f32)
    jax.config.update("jax_enable_x64", False)
    try:
        blob = export_solve(
            config, cost, dx, B=1024, u_lower=-2.0, u_upper=2.0,
            platforms=["cuda"],
        )
    finally:
        jax.config.update("jax_enable_x64", True)
    exp = load_solve(blob).exported
    assert exp.platforms == ("cuda",)
    assert TRITON_CALL in exp.mlir_module(), (
        "cross-lowered CUDA artifact does not contain the Triton kernel — "
        "the XLA orchestration was baked instead"
    )


def test_load_refuses_an_artifact_from_another_jax():
    """The Triton kernel call has no cross-version guarantee, so an
    artifact loads only under the JAX version recorded in its manifest."""
    import json
    import struct

    from diffmpc_tpu.aot import _MAGIC, read_manifest

    config, cost, dx, x = _problem(lqr_iter=1)
    blob = export_solve(config, cost, dx, B=x.shape[0],
                        u_lower=-2.0, u_upper=2.0)
    m = read_manifest(blob)
    assert m["jax_version"] == jax.__version__
    (mlen,) = struct.unpack(">I", blob[len(_MAGIC):len(_MAGIC) + 4])
    payload = blob[len(_MAGIC) + 4 + mlen:]
    old = json.dumps(dict(m, jax_version="0.0.1")).encode()
    forged = _MAGIC + struct.pack(">I", len(old)) + old + payload
    with pytest.raises(ValueError, match="built with jax 0.0.1"):
        load_solve(forged)


def test_artifact_composes_under_lax_scan():
    """The receding-serving pattern: a loaded
    artifact must be callable INSIDE a scanned loop — `exp.call` under
    `lax.scan` inlines into one compiled program, so deployed throughput
    recovers the lax.map/scan dispatch amortization the live solve gets.
    Correctness: the scanned artifact must equal the scanned live solve."""
    config, cost, dx, x = _problem(lqr_iter=2)
    blob = export_solve(config, cost, dx, B=x.shape[0],
                        u_lower=-2.0, u_upper=2.0, warm_start=True)
    solve = load_solve(blob)
    u0 = jnp.zeros((config.T, x.shape[0], 1), jnp.float32)

    @jax.jit
    def episode_aot(x0, u_init, n=4):
        def step(u, _):
            sol = solve(x0, u)
            return jnp.roll(sol.us, -1, axis=0), sol.objs
        _, objs = jax.lax.scan(step, u_init, None, length=n)
        return objs

    @jax.jit
    def episode_live(x0, u_init, n=4):
        def step(u, _):
            sol = mpc_solve(config, x0, cost, dx, u_init=u,
                            u_lower=-2.0, u_upper=2.0)
            return jnp.roll(sol.us, -1, axis=0), sol.objs
        _, objs = jax.lax.scan(step, u_init, None, length=n)
        return objs

    np.testing.assert_allclose(
        np.asarray(episode_aot(x, u0)), np.asarray(episode_live(x, u0)),
        atol=1e-5,
    )


def test_manifest_roundtrip_and_validation():
    """Self-describing artifacts: the embedded manifest
    must round-trip the calling convention (input NAMES in order, shapes),
    the baked config digest, bounds, platforms, vjp_order and mesh — all
    readable WITHOUT deserializing the program — and a wrong-arity call
    must fail with a message that names the missing input."""
    from diffmpc_tpu import __version__
    from diffmpc_tpu.aot import read_manifest

    config, cost, dx, x = _problem(lqr_iter=2)
    B = x.shape[0]
    blob = export_solve(
        config, cost, dx, B=B, u_lower=-2.0, u_upper=2.0,
        warm_start=True, params_input=True, vjp_order=1,
    )

    # fleet-side: manifest parses from the raw blob, no deserialize
    m = read_manifest(blob)
    assert m is not None
    assert m["format_version"] == 1
    assert m["library_version"] == __version__
    assert m["input_names"] == ["x_init", "u_init", "params"]
    assert m["inputs"][0]["shape"] == [B, 3]
    assert m["inputs"][1]["shape"] == [config.T, B, 1]
    assert m["inputs"][2]["leaves"]  # params pytree leaf avals with names
    assert m["bounds"]["u_lower"] == -2.0 and m["bounds"]["u_upper"] == 2.0
    assert m["vjp_order"] == 1 and m["mesh"] is None
    assert m["dynamics"] == "PendulumDx"
    assert m["config"]["T"] == config.T
    assert len(m["config_digest"]) == 64

    # same config → same digest; different config → different digest
    blob2 = export_solve(
        config, cost, dx, B=B, u_lower=-2.0, u_upper=2.0,
        warm_start=True, params_input=True, vjp_order=1,
    )
    assert read_manifest(blob2)["config_digest"] == m["config_digest"]
    import dataclasses

    blob3 = export_solve(
        dataclasses.replace(config, lqr_iter=3), cost, dx, B=B,
        u_lower=-2.0, u_upper=2.0,
    )
    assert read_manifest(blob3)["config_digest"] != m["config_digest"]

    # loader side: .manifest exposed, wrong arity names the missing input
    solve = load_solve(blob)
    assert solve.manifest == m
    with pytest.raises(TypeError, match="missing: u_init, params"):
        solve(x)
    with pytest.raises(TypeError, match="expects 3 positional"):
        solve(x, jnp.zeros((config.T, B, 1), jnp.float32),
              jnp.asarray(dx.params), x)

    # the program still runs and matches live
    got = solve(
        jnp.asarray(x), jnp.zeros((config.T, B, 1), jnp.float32),
        jnp.asarray(dx.params),
    )
    want = mpc_solve(
        config, x, cost, dx,
        u_init=jnp.zeros((config.T, B, 1), jnp.float32),
        u_lower=-2.0, u_upper=2.0,
    )
    np.testing.assert_allclose(got.us, want.us, atol=1e-6)


def test_manifest_format_version_gate_and_legacy_blob():
    """A newer-format manifest must raise loudly; a pre-manifest raw
    jax.export payload must still load (manifest None) — old artifact
    stores keep working."""
    import struct

    from diffmpc_tpu.aot import _MAGIC, read_manifest

    config, cost, dx, x = _problem(lqr_iter=2)
    blob = export_solve(config, cost, dx, B=x.shape[0],
                        u_lower=-2.0, u_upper=2.0)
    (mlen,) = struct.unpack(">I", blob[len(_MAGIC):len(_MAGIC) + 4])
    payload = blob[len(_MAGIC) + 4 + mlen:]

    # legacy: raw payload loads, manifest is None, call still works
    legacy = load_solve(payload)
    assert legacy.manifest is None
    np.testing.assert_allclose(legacy(x).us, load_solve(blob)(x).us,
                               atol=0)

    # future format version: loud failure
    import json

    future = json.dumps({"format_version": 99}).encode()
    forged = _MAGIC + struct.pack(">I", len(future)) + future + payload
    with pytest.raises(ValueError, match="format_version 99"):
        read_manifest(forged)
    with pytest.raises(ValueError, match="format_version 99"):
        load_solve(forged)

    # a manifest without a format version: a named ValueError, not KeyError
    bare = json.dumps({"library": "diffmpc_tpu"}).encode()
    forged = _MAGIC + struct.pack(">I", len(bare)) + bare + payload
    with pytest.raises(ValueError, match="no format_version"):
        read_manifest(forged)

    # truncated/corrupt blobs: clean named errors, not struct/json noise
    with pytest.raises(ValueError, match="truncated"):
        read_manifest(blob[: len(_MAGIC) + 2])  # cut inside the header
    with pytest.raises(ValueError, match="declares"):
        # length field larger than the remaining bytes
        read_manifest(_MAGIC + struct.pack(">I", 10**6) + b"xx")


def test_mesh_export_fused_shard_map_matches_unsharded():
    """Pallas-speed multi-device serving artifact:
    with use_pallas=True, mesh= export wraps the FUSED solve in shard_map
    (manual SPMD — the kernel custom call needs no GSPMD rule), so the
    8-device artifact runs the mega-kernel per batch shard. Must match
    the unsharded fused solve exactly (interpret mode on CPU); the
    warm-start input shards on its batch axis."""
    import dataclasses

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from diffmpc_tpu.aot import read_manifest

    from diffmpc_tpu.mpc import _would_use_fused

    config, cost, dx, x = _problem(B=16, T=6, lqr_iter=3)
    config = dataclasses.replace(
        config, use_pallas=True, pallas_interpret=True
    )
    B = x.shape[0]
    # CLAUDE.md kernel-test rule: assert the config genuinely engages the
    # fused dispatch (per-device local batch) — otherwise both sides of
    # the comparison silently take the XLA path and the test is vacuous.
    assert _would_use_fused(
        config, dx, is_quad=True, constrained=True, is_lin=False
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    blob = export_solve(
        config, cost, dx, B=B, u_lower=-2.0, u_upper=2.0,
        warm_start=True, mesh=mesh,
    )
    assert read_manifest(blob)["mesh"]["form"] == "shard_map_fused"
    solve = load_solve(blob)
    assert solve.exported.nr_devices == 8

    u0 = jnp.zeros((config.T, B, 1), jnp.float32)
    xs = jax.device_put(x, NamedSharding(mesh, P("batch")))
    us = jax.device_put(u0, NamedSharding(mesh, P(None, "batch")))
    got = solve(xs, us)
    want = mpc_solve(config, x, cost, dx, u_init=u0,
                     u_lower=-2.0, u_upper=2.0)
    np.testing.assert_array_equal(np.asarray(got.us), np.asarray(want.us))
    np.testing.assert_array_equal(np.asarray(got.objs), np.asarray(want.objs))
    np.testing.assert_array_equal(
        np.asarray(got.info.converged), np.asarray(want.info.converged)
    )
    assert int(got.info.n_iters) == int(want.info.n_iters)


def test_mesh_export_fused_cross_lowered_cuda():
    """The deployment target: mesh= + platforms=['cuda'] from a CPU build
    host cross-lowers the 8-device shard_map program with the REAL Triton
    kernel embedded (use_pallas=None resolves fused for a GPU target).
    Execution on four cards: chip_smoke.py --four-cards."""
    from jax.sharding import Mesh

    from diffmpc_tpu.aot import read_manifest

    config, cost, dx, x = _problem(B=1024, T=10, lqr_iter=3)
    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    jax.config.update("jax_enable_x64", False)  # the kernels are f32
    try:
        blob = export_solve(
            config, cost, dx, B=1024, u_lower=-2.0, u_upper=2.0,
            platforms=["cuda"], mesh=mesh,
        )
    finally:
        jax.config.update("jax_enable_x64", True)
    m = read_manifest(blob)
    assert m["mesh"] == {
        "axis_names": ["batch"], "shape": [8], "form": "shard_map_fused",
    }
    exp = load_solve(blob).exported
    assert exp.platforms == ("cuda",) and exp.nr_devices == 8
    assert TRITON_CALL in exp.mlir_module(), (
        "sharded CUDA artifact lost the Triton kernel — the XLA "
        "orchestration was baked instead"
    )


def test_mesh_export_form_reflects_real_dispatch():
    """The manifest's mesh form is keyed on the REAL fused-dispatch
    predicate, not the knob: a config the mega-kernel rejects must either
    fail loudly (explicit use_pallas=True) or fall back to the honestly-
    labeled GSPMD form (auto-resolved) — never ship an XLA program
    labeled 'shard_map_fused'."""
    import dataclasses

    from jax.sharding import Mesh

    from diffmpc_tpu.aot import read_manifest
    from diffmpc_tpu.types import GradMethods

    config, cost, dx, x = _problem(B=16, T=6, lqr_iter=2)
    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    # FINITE_DIFF linearization never rides the mega-kernel
    bad = dataclasses.replace(
        config, use_pallas=True, pallas_interpret=True,
        grad_method=GradMethods.FINITE_DIFF,
    )
    with pytest.raises(ValueError, match="cannot engage"):
        export_solve(bad, cost, dx, B=16, u_lower=-2.0, u_upper=2.0,
                     mesh=mesh)

    # auto-resolution (None) for a GPU target with the same non-fusable
    # config: falls back to the GSPMD XLA form, manifest labeled honestly
    auto = dataclasses.replace(config, grad_method=GradMethods.FINITE_DIFF)
    jax.config.update("jax_enable_x64", False)
    try:
        blob = export_solve(auto, cost, dx, B=16, u_lower=-2.0,
                            u_upper=2.0, mesh=mesh, platforms=["cuda"])
    finally:
        jax.config.update("jax_enable_x64", True)
    m = read_manifest(blob)
    assert m["mesh"]["form"] == "gspmd_xla"
    assert TRITON_CALL not in load_solve(blob).exported.mlir_module()


def test_mesh_export_fused_rejects_indivisible_batch():
    import dataclasses

    from jax.sharding import Mesh

    config, cost, dx, x = _problem(B=8, T=6, lqr_iter=2)
    config = dataclasses.replace(
        config, use_pallas=True, pallas_interpret=True
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    with pytest.raises(ValueError, match="divide"):
        export_solve(config, cost, dx, B=12, u_lower=-2.0, u_upper=2.0,
                     mesh=mesh)


def test_export_without_an_installed_flatbuffers():
    """jax.export's serializer needs flatbuffers, which JAX does not
    require; without it aot.py falls back to the vendored copy, only once
    an artifact is (de)serialized, and an artifact still round-trips
    (fresh interpreter, package hidden)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.modules['flatbuffers'] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import diffmpc_tpu.aot as aot\n"
        "assert sys.modules['flatbuffers'] is None\n"
        "from __graft_entry__ import _pendulum_setup, _x_init\n"
        "cfg, cost, dx = _pendulum_setup(T=4)\n"
        "blob = aot.export_solve(cfg, cost, dx, 8, u_lower=-2.0, u_upper=2.0)\n"
        "import flatbuffers\n"
        "assert '_vendor' in flatbuffers.__file__, flatbuffers.__file__\n"
        "print(aot.load_solve(blob)(_x_init(8)).us.shape)\n"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "(4, 8, 1)" in out.stdout
