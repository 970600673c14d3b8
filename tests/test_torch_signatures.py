"""Every public callable of the port takes the JAX package's parameters at
the JAX package's positions.

Both packages are walked module by module (``pkgutil``); every public
function and class defined in a module of the JAX package, and every
public method of such a class, is paired with the port's callable of the
same module path and name. The port's positional parameters must start
with the JAX callable's, in the JAX order, and every keyword-only
parameter of the JAX callable must be one the port accepts, so a caller
written for the JAX package runs on the port whether it passes arguments
by position or by keyword. Port-only parameters (``kernel_impl``,
``device``, ...) come after all of the JAX ones.

``ALLOWED`` holds the differences that are by design, each with its
reason, and nothing else.
"""
import importlib
import inspect
import pkgutil

import pytest

JAX_PKG = "pointcloud_stitching_tpu"
PORT_PKG = "pointcloud_stitching_tpu_torch"

# (scope, JAX parameter) -> (the port's parameter in its place, or None
# where the port takes none; the reason). A scope is a module path (every
# callable of it) or "module::callable".
TPU = "a tuning knob of the Pallas kernel; the CUDA kernel has none"
INTERP = "Pallas's interpreter; CPU tensors take the plain version"
MXU = "the MXU's bf16 pass count; Hopper's float32 arithmetic is exact"
ALLOWED = {
    ("kernels.segment_reduce", "chunk"): (None, TPU),
    ("kernels.segment_reduce", "precision"): (None, MXU),
    ("kernels.segment_reduce", "group"): (None, TPU),
    ("kernels.segment_reduce", "sub"): (None, TPU),
    ("kernels.segment_reduce", "interpret"): (None, INTERP),
    ("kernels.nn_pallas", "rT"): ("refT", "the port's prepared reference [B, 3, M] stands in its place"),
    ("kernels.nn_pallas", "rsq"): (None, "|r|^2 of the MXU form; the CUDA kernel takes direct differences"),
    ("kernels.nn_pallas", "num_ref"): (None, "the unpadded count; the port does not pad the reference"),
    ("kernels.nn_pallas", "ref_block"): (None, TPU + " (K4 keeps its own)"),
    ("kernels.nn_pallas", "interpret"): (None, INTERP),
    ("kernels.nn_pallas", "precision"): (None, MXU),
    ("kernels.nn_pallas", "method"): (None, "the 'mxu' variant, which the JAX package keeps for comparison only"),
    ("kernels.patch_gather", "bricks_per_step"): (None, TPU),
    ("kernels.patch_gather", "mode"): (None, "the TPU's DMA or one-hot gather; the CUDA kernel has one"),
    ("kernels.patch_gather", "interpret"): (None, INTERP),
    ("utils.config::StitchConfig", "kernel_interpret"): (None, INTERP + "; tests/test_torch_ops.py pins it as dropped"),
}
# JAX names with no counterpart in the port
ALLOWED_MISSING = {
    "kernels.limbs": "the bf16 Veltkamp split of the TPU's MXU passes; Hopper's f32 FMA is exact",
    "utils.platform::apply_platform_override": "pins JAX's platform; the port's platform_device() does that job",
}


def _walk(pkg_name: str) -> dict:
    """{module path: {public name: callable}} of every module of a package,
    read as each module is imported. A submodule named like a callable its
    package defines (``native/build.py``, the ``python -m`` entry of
    ``native.build()``) is not imported: importing it would put the
    module where the function is."""
    out = {}
    todo = [importlib.import_module(pkg_name)]
    while todo:
        mod = todo.pop()
        key = mod.__name__[len(pkg_name) + 1:]
        out[key] = {
            name: obj for name, obj in vars(mod).items()
            if not name.startswith("_") and callable(obj)
            and not inspect.ismodule(obj)
            and getattr(obj, "__module__", None) == mod.__name__}
        for info in pkgutil.iter_modules(getattr(mod, "__path__", [])):
            shadowed = getattr(mod, info.name, None)
            if info.name.startswith("_") or getattr(
                    shadowed, "__module__", None) == mod.__name__:
                continue
            todo.append(importlib.import_module(
                f"{mod.__name__}.{info.name}"))
    return out


def _cases():
    jax_mods, port_mods = _walk(JAX_PKG), _walk(PORT_PKG)
    cases = []
    for mod in sorted(jax_mods):
        for name in sorted(jax_mods[mod]):
            jobj = jax_mods[mod][name]
            pobj = port_mods.get(mod, {}).get(name)
            cases.append(pytest.param(mod, name, jobj, pobj,
                                      id=f"{mod}::{name}"))
            if not inspect.isclass(jobj) or pobj is None:
                continue
            for meth in sorted(vars(jobj)):
                if meth.startswith("_") and meth != "__call__":
                    continue
                jfn = getattr(jobj, meth)
                if not callable(jfn) or inspect.isclass(jfn):
                    continue
                cases.append(pytest.param(
                    mod, f"{name}.{meth}", jfn, getattr(pobj, meth, None),
                    id=f"{mod}::{name}.{meth}"))
    return cases


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _allowed(mod: str, name: str, param: str):
    """(True, the port's name or None) if the JAX parameter is allowed to
    differ, else (False, None)."""
    for scope in (f"{mod}::{name.split('.')[0]}", mod):
        if (scope, param) in ALLOWED:
            return True, ALLOWED[(scope, param)][0]
    return False, None


CASES = _cases()


def test_the_walk_finds_the_entry_points():
    """The walk reaches every entry point whose order once differed
    (``native.build`` despite ``native/build.py``), and methods."""
    ids = {c.id for c in CASES}
    for want in ("ops.nn::nearest_neighbors", "ops.icp::icp_batched",
                 "ops.icp::icp_point_to_plane_batched", "ops.icp::icp",
                 "ops.icp::icp_converge",
                 "models.registration::register_pair",
                 "models.registration::register_global",
                 "ops.voxel::voxel_downsample",
                 "models.voxel_map::voxel_map_update",
                 "models.voxel_map::TemporalAccumulator",
                 "models.voxel_map::TemporalAccumulator.load",
                 "models.stitcher::StitchingPipeline",
                 "models.stitcher::StitchingPipeline.__call__",
                 "native::build", "kernels.nn_pallas::nn_batched_prepared"):
        assert want in ids, want
    assert len(CASES) > 200


@pytest.mark.parametrize("mod,name,jax_obj,port_obj", CASES)
def test_port_takes_the_jax_positional_order(mod, name, jax_obj, port_obj):
    if port_obj is None:
        assert mod in ALLOWED_MISSING or f"{mod}::{name}" in \
            ALLOWED_MISSING, f"the port has no {mod}::{name}"
        return
    js, ps = _signature(jax_obj), _signature(port_obj)
    if js is None:
        return              # a builtin or C callable: nothing to compare
    assert ps is not None, f"{mod}::{name} has no signature in the port"
    pparams = ps.parameters
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    want = []
    for p in js.parameters.values():
        ok, sub = _allowed(mod, name, p.name)
        if p.kind in positional:
            if ok and sub is not None:
                want.append(sub)
            elif not (ok and p.name not in pparams):
                want.append(p.name)
        elif p.kind == inspect.Parameter.KEYWORD_ONLY and not ok:
            assert p.name in pparams or any(
                q.kind == inspect.Parameter.VAR_KEYWORD
                for q in pparams.values()), \
                f"{mod}::{name} takes no keyword {p.name!r}"
    got = [p.name for p in pparams.values() if p.kind in positional]
    assert got[:len(want)] == want, (
        f"{mod}::{name}: the port's positional order {got} does not start "
        f"with the JAX package's {want}")


def test_the_allowlist_holds_only_what_it_needs():
    """Every allowed difference is one some JAX callable still has."""
    used = set()
    for c in CASES:
        mod, name, jax_obj, port_obj = c.values
        js = _signature(jax_obj)
        if js is None or port_obj is None:
            continue
        for p in js.parameters:
            for scope in (f"{mod}::{name.split('.')[0]}", mod):
                if (scope, p) in ALLOWED:
                    used.add((scope, p))
    assert used == set(ALLOWED), sorted(set(ALLOWED) - used)
    missing = {c.values[0] for c in CASES if c.values[3] is None} | {
        f"{c.values[0]}::{c.values[1]}" for c in CASES
        if c.values[3] is None}
    assert set(ALLOWED_MISSING) <= missing
