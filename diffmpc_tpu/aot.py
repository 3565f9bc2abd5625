"""Ahead-of-time export of MPC solve programs (``jax.export``).

Serving deployment support (SURVEY.md §5.4 — the reference's deployment
story is per-process Python): a solve program — config, cost, dynamics,
bounds, batch shape all fixed — is serialized as a StableHLO artifact
(Triton kernel custom calls embedded) that a serving process loads and
calls WITHOUT the model/config Python or retracing. Honest scope:
deserialization skips tracing/lowering, and the backend compile of the
artifact is cached by the persistent compilation cache
(``JAX_COMPILATION_CACHE_DIR``) like any program; the artifact is a
versioned deployment unit, not a compile-time bypass. The Triton custom
call is outside ``jax.export``'s compatibility guarantee, so an artifact
records the JAX version that built it and loads only under that version.

Runtime inputs are opt-in and positional, in this order:
``f(x_init[, u_init][, params])`` —

- ``warm_start=True`` adds ``u_init`` (the receding-horizon pattern:
  ship one artifact, thread the shifted plan at runtime);
- ``params_input=True`` adds the dynamics-model parameter pytree (serve a
  sysid/learned model whose weights update without re-exporting; shapes
  are taken from ``dx.params``, per-scenario ``(B, P)`` rows included);
- ``vjp_order=1`` makes the artifact differentiable after load
  (``jax.grad`` through ``load_solve(blob)`` re-enters the serialized
  analytic KKT backward) — training against a frozen solver build.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import sys
from typing import Optional

import jax
import jax.numpy as jnp
from jax import export as _jexport

from .mpc import MPCInfo, MPCSolution, mpc_solve
from .types import MPCConfig

# Self-describing artifact container: a serving fleet must
# be able to validate an artifact — which opt-in positional inputs it
# takes, what config/bounds were baked, what library version built it —
# WITHOUT calling it. Layout: MAGIC | u32 manifest length (big-endian) |
# manifest JSON (utf-8) | jax.export payload. Raw jax.export blobs (pre-
# manifest artifacts) are still loadable; their ``.manifest`` is None.
_MAGIC = b"DMPCAOT1"
_FORMAT_VERSION = 1
_TRITON_CALL = "__gpu$xla.gpu.triton"

# The artifact's output tree contains these NamedTuples; their treedefs
# must be serializable (and re-registered identically at load — importing
# this module does both sides).
for _nt in (MPCSolution, MPCInfo):
    try:
        _jexport.register_namedtuple_serialization(
            _nt, serialized_name=f"diffmpc_tpu.{_nt.__name__}"
        )
    except ValueError:  # already registered (re-import / reload)
        pass


def _ensure_flatbuffers() -> None:
    """jax.export's (de)serializer imports ``flatbuffers``, which JAX does
    not require (the ``aot`` extra installs it). Where it is missing, load
    the vendored copy (``_vendor/README.md``) under that name, once, just
    before the first (de)serialization."""
    try:
        import flatbuffers  # noqa: F401
    except ImportError:
        import importlib.util

        fb_dir = os.path.join(os.path.dirname(__file__), "_vendor", "flatbuffers")
        spec = importlib.util.spec_from_file_location(
            "flatbuffers", os.path.join(fb_dir, "__init__.py"),
            submodule_search_locations=[fb_dir],
        )
        # registered before it runs: its own relative imports look it up
        sys.modules["flatbuffers"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["flatbuffers"])


def export_solve(
    config: MPCConfig,
    cost,
    dx,
    B: int,
    *,
    u_lower=None,
    u_upper=None,
    warm_start: bool = False,
    params_input: bool = False,
    vjp_order: int = 0,
    platforms: Optional[list] = None,
    mesh=None,
) -> bytes:
    """Serialize the solve program for batch size ``B`` to bytes.

    ``platforms`` passes through to ``jax.export.export`` (e.g.
    ``['cuda']`` to cross-lower from a CPU build host); default = the
    current backend. With ``use_pallas=None`` the solver path follows the
    export target through the platform table
    (:func:`diffmpc_tpu.ops.lqr_step.use_kernels`), not the build host:
    a CUDA artifact built on a CPU host carries the Triton kernels.

    ``mesh``: a 1-D ``jax.sharding.Mesh`` — exports the MULTI-DEVICE
    program with the scenario batch (and the parameter rows of a
    per-scenario model, per ``dx.param_batch_shape``) sharded over its
    axis; the artifact records the device count and runs on a same-shape
    mesh at load. Shared parameter leaves are replicated. Two sharded
    forms:

    - **fused shard_map** (``use_pallas=True``, or ``None`` resolving to
      a GPU target): the whole solve is wrapped in ``jax.shard_map`` —
      manual SPMD, so the mega-kernel needs NO GSPMD partitioning rule;
      each device runs the fused kernel on its batch shard.
    - **GSPMD XLA** (``use_pallas=False``, or ``None`` resolving to a
      CPU target): the XLA orchestration with ``NamedSharding`` inputs,
      partitioned by GSPMD (a bare kernel custom call under GSPMD would
      replicate the batch per device; shard_map avoids that).
    """
    from .ops.lqr_step import use_kernels

    explicit_pallas = config.use_pallas is True
    if config.use_pallas is None:
        if platforms:
            targets = list(platforms)
        elif mesh is not None:
            targets = [mesh.devices.flat[0].platform]
        else:
            targets = [None]  # the tracing default
        config = dataclasses.replace(
            config,
            use_pallas=all(
                use_kernels(None, config.pallas_interpret, p) for p in targets
            ),
        )
    if mesh is not None and config.use_pallas:
        # The manifest's mesh form must reflect the DISPATCH, not the
        # knob: a config the mega-kernel rejects (non-fusable dx,
        # FINITE_DIFF, non-quadratic cost, no box) would silently run the
        # XLA path inside an unnecessary shard_map while the manifest
        # claimed 'shard_map_fused'.
        from .mpc import _would_use_fused
        from .types import LinDx, QuadCost

        can_fuse = _would_use_fused(
            config, dx,
            is_quad=isinstance(cost, QuadCost),
            constrained=u_lower is not None,
            is_lin=isinstance(dx, LinDx),
        )
        if not can_fuse:
            if explicit_pallas:
                raise ValueError(
                    "mesh= export with use_pallas=True, but the fused "
                    "mega-kernel cannot engage for this configuration "
                    "(requires QuadCost + box bounds + an entries_step/"
                    "kernel_params dynamics model, grad_method != "
                    "FINITE_DIFF and verbose <= 0). Pass use_pallas=False "
                    "(or None) for the GSPMD XLA artifact instead."
                )
            config = dataclasses.replace(config, use_pallas=False)
    T, n, m = config.T, config.n_state, config.n_ctrl
    dtype = config.dtype

    def solve(x, u_init=None, params=None):
        d = dx if params is None else dx.replace(params=params)
        return mpc_solve(
            config, x, cost, d, u_init=u_init,
            u_lower=u_lower, u_upper=u_upper,
        )

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        axis = mesh.axis_names[0]
        # Per-scenario-ness of params comes from the model's own
        # declaration (Dynamics.param_batch_shape), NOT a raw shape
        # heuristic: a custom model may carry a legitimately-shared 2-D
        # params array whose first dim coincides with B
        # (mpc._check_param_batch's documented override case) — those
        # must stay replicated.
        params_per_scenario = getattr(dx, "param_batch_shape", ()) == (B,)

        def _param_sds(a):
            shape = jnp.shape(a)
            spec = (
                PartitionSpec(axis)
                if params_per_scenario and len(shape) >= 2 and shape[0] == B
                else PartitionSpec()
            )
            return jax.ShapeDtypeStruct(
                shape, jnp.asarray(a).dtype,
                sharding=NamedSharding(mesh, spec),
            )

        x_s = jax.ShapeDtypeStruct(
            (B, n), dtype, sharding=NamedSharding(mesh, PartitionSpec(axis))
        )
    else:

        def _param_sds(a):
            return jax.ShapeDtypeStruct(jnp.shape(a), jnp.asarray(a).dtype)

        x_s = jax.ShapeDtypeStruct((B, n), dtype)

    u_s = None
    if warm_start:
        if mesh is not None:
            # u_init is (T, B, m): batch on dim 1
            u_s = jax.ShapeDtypeStruct(
                (T, B, m), dtype,
                sharding=NamedSharding(mesh, PartitionSpec(None, axis)),
            )
        else:
            u_s = jax.ShapeDtypeStruct((T, B, m), dtype)
    p_s = jax.tree.map(_param_sds, getattr(dx, "params", None))
    if params_input and p_s is None:
        raise ValueError(
            "params_input=True requires a dynamics model with a .params "
            f"pytree; {type(dx).__name__} has none"
        )

    # Fixed positional signatures: the artifact's calling convention must
    # not depend on keyword plumbing that the loading process can't see.
    if mesh is not None and config.use_pallas:
        # Fused multi-device artifact: manual SPMD via shard_map — each
        # device runs the mega-kernel on its batch shard, so no GSPMD
        # partitioning rule is needed. check_vma=False is the documented
        # Pallas-under-shard_map requirement (CLAUDE.md "VMA-checked
        # Pallas composition"); verified bitwise vs the unsharded fused
        # solve in tests/test_aot.py and by chip_smoke.py --four-cards.
        from jax.sharding import PartitionSpec

        n_dev = mesh.devices.size
        if B % n_dev:
            raise ValueError(
                f"the mesh's {n_dev} devices must evenly divide B={B} for "
                "the fused shard_map export"
            )
        x_spec = PartitionSpec(axis)
        u_spec = PartitionSpec(None, axis)
        # in_specs reuse the shardings already decided on the p_s avals
        # (_param_sds is the one copy of the per-scenario rule)
        p_spec = (
            jax.tree.map(lambda s: s.sharding.spec, p_s)
            if params_input
            else None
        )
        batched = PartitionSpec(axis)
        out_specs = MPCSolution(
            xs=PartitionSpec(None, axis),
            us=PartitionSpec(None, axis),
            objs=batched,
            info=MPCInfo(
                converged=batched,
                n_iters=PartitionSpec(),
                last_improvement=batched,
                mean_alpha=batched,
                clamp_frac=batched,
                qp_iters=batched,
                iters=batched,
            ),
        )

        def local_solve(x, u_init=None, params=None):
            sol = solve(x, u_init, params)
            # n_iters is a per-shard scalar; make it genuinely replicated
            # (max over devices) so the P() out_spec is honest.
            info = sol.info._replace(
                n_iters=jax.lax.pmax(sol.info.n_iters, axis)
            )
            return sol._replace(info=info)

        def _smap(in_specs, f):
            return jax.shard_map(
                f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                check_vma=False,
            )

        if warm_start and params_input:
            fn = _smap((x_spec, u_spec, p_spec),
                       lambda x, u, p: local_solve(x, u, p))
            args = (x_s, u_s, p_s)
        elif warm_start:
            fn = _smap((x_spec, u_spec), lambda x, u: local_solve(x, u))
            args = (x_s, u_s)
        elif params_input:
            fn = _smap((x_spec, p_spec),
                       lambda x, p: local_solve(x, params=p))
            args = (x_s, p_s)
        else:
            fn = _smap((x_spec,), lambda x: local_solve(x))
            args = (x_s,)
    elif warm_start and params_input:
        fn, args = (lambda x, u, p: solve(x, u, p)), (x_s, u_s, p_s)
    elif warm_start:
        fn, args = (lambda x, u: solve(x, u)), (x_s, u_s)
    elif params_input:
        fn, args = (lambda x, p: solve(x, params=p)), (x_s, p_s)
    else:
        fn, args = (lambda x: solve(x)), (x_s,)

    kw = {} if platforms is None else {"platforms": platforms}
    if config.use_pallas:
        # The Triton kernel call is not on jax.export's list of custom
        # calls with a stability guarantee; the manifest's jax_version
        # (checked by load_solve) stands in for that guarantee.
        kw["disabled_checks"] = [
            _jexport.DisabledSafetyCheck.custom_call(_TRITON_CALL)
        ]
    exp = _jexport.export(jax.jit(fn), **kw)(*args)
    _ensure_flatbuffers()
    payload = exp.serialize(vjp_order=vjp_order)

    input_names = ["x_init"]
    if warm_start:
        input_names.append("u_init")
    if params_input:
        input_names.append("params")

    def _aval_json(s):
        return {"shape": list(s.shape), "dtype": str(jnp.dtype(s.dtype))}

    inputs = [dict(name="x_init", **_aval_json(x_s))]
    if warm_start:
        inputs.append(dict(name="u_init", **_aval_json(u_s)))
    if params_input:
        leaves = [
            dict(name="params" + jax.tree_util.keystr(path), **_aval_json(l))
            for path, l in jax.tree_util.tree_flatten_with_path(p_s)[0]
        ]
        inputs.append({"name": "params", "leaves": leaves})

    def _bound_json(b):
        if b is None:
            return None
        arr = jnp.asarray(b)
        if arr.ndim == 0:
            return float(arr)
        return {"shape": list(arr.shape), "dtype": str(arr.dtype)}

    config_dict = {
        k: (str(v) if not isinstance(v, (bool, int, float, str, type(None))) else v)
        for k, v in dataclasses.asdict(config).items()
    }
    config_json = json.dumps(config_dict, sort_keys=True)
    from . import __version__

    manifest = {
        "format_version": _FORMAT_VERSION,
        "library": "diffmpc_tpu",
        "library_version": __version__,
        "jax_version": jax.__version__,
        "inputs": inputs,
        "input_names": input_names,
        "config": config_dict,
        "config_digest": hashlib.sha256(config_json.encode()).hexdigest(),
        "bounds": {"u_lower": _bound_json(u_lower), "u_upper": _bound_json(u_upper)},
        "batch_size": B,
        "platforms": list(exp.platforms),
        "vjp_order": vjp_order,
        "mesh": (
            None
            if mesh is None
            else {
                "axis_names": list(mesh.axis_names),
                "shape": [int(s) for s in mesh.devices.shape],
                "form": (
                    "shard_map_fused" if config.use_pallas else "gspmd_xla"
                ),
            }
        ),
        "dynamics": type(dx).__name__,
    }
    mbytes = json.dumps(manifest, sort_keys=True).encode("utf-8")
    return _MAGIC + struct.pack(">I", len(mbytes)) + mbytes + payload


def read_manifest(blob: bytes) -> Optional[dict]:
    """Parse an artifact's manifest WITHOUT deserializing the program —
    the fleet-side validation hook (a scheduler can check input names,
    config digest, platforms, and mesh shape before shipping the blob to
    a worker). Returns ``None`` for pre-manifest raw ``jax.export``
    blobs; raises on a manifest written by a newer format version."""
    if not blob.startswith(_MAGIC):
        return None
    hdr = len(_MAGIC) + 4
    if len(blob) < hdr:
        raise ValueError(
            f"corrupt/truncated artifact: {len(blob)} bytes is shorter "
            "than the manifest header"
        )
    (mlen,) = struct.unpack(">I", blob[len(_MAGIC) : hdr])
    if len(blob) < hdr + mlen:
        raise ValueError(
            f"corrupt/truncated artifact: manifest declares {mlen} bytes "
            f"but only {len(blob) - hdr} follow the header"
        )
    manifest = json.loads(blob[hdr : hdr + mlen])
    if not isinstance(manifest, dict) or "format_version" not in manifest:
        raise ValueError(
            "corrupt artifact: the manifest has no format_version"
        )
    if manifest["format_version"] > _FORMAT_VERSION:
        raise ValueError(
            f"artifact manifest format_version {manifest['format_version']} "
            f"is newer than this library supports ({_FORMAT_VERSION}); "
            "upgrade diffmpc_tpu to load it"
        )
    return manifest


def load_solve(blob: bytes):
    """Deserialize an :func:`export_solve` artifact into a callable.

    The callable takes the positional runtime inputs chosen at export time
    and returns the full :class:`~diffmpc_tpu.mpc.MPCSolution` pytree. It
    is jit-compatible and, if exported with ``vjp_order>=1``,
    differentiable. ``call.manifest`` carries the artifact's embedded
    self-description (None for pre-manifest blobs); a wrong-arity call
    fails eagerly with the expected input names."""
    manifest = read_manifest(blob)
    if manifest is not None and manifest.get("jax_version") != jax.__version__:
        raise ValueError(
            f"artifact was built with jax {manifest.get('jax_version')} but "
            f"this process runs jax {jax.__version__}; its Triton kernel "
            "calls carry no cross-version guarantee — rebuild the artifact "
            "with this jax"
        )
    if manifest is not None:
        (mlen,) = struct.unpack(">I", blob[len(_MAGIC) : len(_MAGIC) + 4])
        payload = blob[len(_MAGIC) + 4 + mlen :]
    else:
        payload = blob
    _ensure_flatbuffers()
    exp = _jexport.deserialize(payload)
    names = manifest["input_names"] if manifest is not None else None

    def call(*args):
        if names is not None and len(args) != len(names):
            missing = names[len(args) :]
            raise TypeError(
                f"artifact expects {len(names)} positional input(s) "
                f"({', '.join(names)}), got {len(args)}"
                + (f" — missing: {', '.join(missing)}" if missing else "")
            )
        return exp.call(*args)

    call.exported = exp  # introspection: .in_avals, .platforms, ...
    call.manifest = manifest
    return call
