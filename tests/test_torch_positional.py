"""Callers written for the JAX package run on the port by position.

One case per entry point whose parameters once sat at other positions in
the port than in the JAX package. Each case calls the JAX function and
the port's with the JAX package's positional order, on the same numpy
inputs and under the tolerances of the existing parity tests (whose
scenes it reuses): JAX on its CPU path, with its Pallas NN in interpret
mode where those tests run it so, and the port on CPU tensors, so its
kernel wrappers take their plain versions. The port's positional call
must also equal, bit for bit, the same call made with keywords named as
the JAX package names its parameters. A second test makes the calls that
ROADMAP.md's fault list ran, which raised before the port took the JAX
order.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointcloud_stitching_tpu.ops as J
from pointcloud_stitching_tpu import PointCloud as JPointCloud
from pointcloud_stitching_tpu.models import StitchingPipeline as JPipeline
from pointcloud_stitching_tpu.models import registration as JR
from pointcloud_stitching_tpu.models import voxel_map as JV
from pointcloud_stitching_tpu.native import build as jax_native_build
import pointcloud_stitching_tpu_torch as P
import pointcloud_stitching_tpu_torch.ops as T
from pointcloud_stitching_tpu_torch import native
from pointcloud_stitching_tpu_torch.models import registration as PR
from pointcloud_stitching_tpu_torch.models import voxel_map as TV
from pointcloud_stitching_tpu_torch.utils import prng
from pointcloud_stitching_tpu_torch.utils.types import PointCloud
from oracle import random_se3, transform_np
from test_torch_ops import _icp_pair, _voxel_inputs
from test_torch_registration import (_icp_scene, _scene_cloud,
                                     jax_icp_direct_nn)  # noqa: F401
from test_torch_stitcher import _jax_cfg, _jax_step, _port_state, _scene
from test_torch_voxel_map import _assert_same_map, _clouds, _frames, _maps

INF = float("inf")


def t(a):
    return torch.from_numpy(np.array(a))


def _leaves(x) -> list:
    """Every tensor (and plain value) of a result, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x)
                for v in _leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _leaves(item)]
    return [x]


def assert_bitwise(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def keywords(jax_fn, args) -> dict:
    """``args`` as keywords, named as the JAX function names its
    positional parameters."""
    names = [p.name for p in inspect.signature(jax_fn).parameters.values()
             if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    assert len(args) <= len(names)
    return dict(zip(names, args))


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's entry points default to the card; PCS_PLATFORM=cpu is
    how a caller asks for the CPU."""
    monkeypatch.setenv("PCS_PLATFORM", "cpu")


def _jp(xyz, mask):
    return (JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)),
            PointCloud(xyz=t(xyz), mask=t(mask)))


# --- one case per row ------------------------------------------------------

def case_nearest_neighbors():
    rng = np.random.default_rng(1101)
    q = rng.normal(size=(300, 3)).astype(np.float32)
    r = rng.normal(size=(500, 3)).astype(np.float32)
    m = rng.random(500) > 0.2
    want = J.nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                               jnp.asarray(m), 128, 128, "pallas", True)
    args = (t(q), t(r), t(m), 128, 128, "auto", True)
    got = T.nearest_neighbors(*args)
    assert_bitwise(got, T.nearest_neighbors(
        **keywords(J.nearest_neighbors, args)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)


def _icp_batched_case(point_to_plane: bool):
    rng = np.random.default_rng(21 if point_to_plane else 22)
    src, dst, normals, mask = _icp_pair(rng)
    js, ps = _jp(src, mask)
    jd, pd = _jp(dst, mask)
    jn, pn = (jnp.asarray(normals),), (t(normals),)
    if not point_to_plane:
        jn = pn = ()
    jfn, pfn = ((J.icp_point_to_plane_batched, T.icp_point_to_plane_batched)
                if point_to_plane else (J.icp_batched, T.icp_batched))
    want = jfn(js, jd, *jn, None, 4, 0.2, 128, 4096, "pallas", 0.1, True)
    args = (ps, pd, *pn, None, 4, 0.2, 128, 4096, "auto", 0.1, True)
    got = pfn(*args)
    assert_bitwise(got, pfn(**keywords(jfn, args)))
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    np.testing.assert_array_equal(got.num_inliers.numpy(),
                                  np.asarray(want.num_inliers))


def case_icp_batched():
    _icp_batched_case(point_to_plane=False)


def case_icp_point_to_plane_batched():
    _icp_batched_case(point_to_plane=True)


def _single_icp_case(jax_fns, converge: bool):
    """JAX's icp/icp_converge on the direct-difference NN of its Pallas
    kernel (``jax_icp_direct_nn`` of test_torch_registration.py)."""
    rng = np.random.default_rng(31 + converge)
    src, dst, smask, dmask, _ = _icp_scene(rng)
    js, ps = _jp(src, smask)
    jd, pd = _jp(dst, dmask)
    j_icp, j_icp_converge = jax_fns
    if converge:
        jfn, pfn = j_icp_converge, T.icp_converge
        tail = (None, 8, 0.0, 0.2, 1024, 4096, "auto", 0.0, False)
    else:
        jfn, pfn = j_icp, T.icp
        tail = (None, 6, 0.2, 1024, 4096, "auto", 0.1, False)
    want = jfn(js, jd, *tail)
    args = (ps, pd, *tail)
    got = pfn(*args)
    assert_bitwise(got, pfn(**keywords(jfn, args)))
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.num_inliers) == int(want.num_inliers)


def case_icp(jax_fns):
    _single_icp_case(jax_fns, converge=False)


def case_icp_converge(jax_fns):
    _single_icp_case(jax_fns, converge=True)


def case_register_pair():
    """test_torch_registration.py's picked pair, both refinements
    unpruned (the JAX package ignores ``prune`` off the TPU)."""
    rng = np.random.default_rng(106)
    src, dst, smask, dmask, T_true = _icp_scene(rng)
    di = np.array([3, 1000, 2000, 2900])
    moved = transform_np(T_true, src)
    si = np.array([int(np.argmin(np.linalg.norm(moved - dst[d], axis=-1)))
                   for d in di])
    js, ps = _jp(src, np.ones_like(smask))
    jd, pd = _jp(dst, np.ones_like(dmask))
    tail = (si, di, True, 30, 1e-8, 0.2, 1024, 4096, 0.0, False)
    want = JR.register_pair(js, jd, *tail)
    args = (ps, pd, *tail)
    got = PR.register_pair(*args)
    assert_bitwise(got, PR.register_pair(**keywords(JR.register_pair, args)))
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    np.testing.assert_allclose(got.T.numpy(), T_true, atol=1e-3)


def case_register_global():
    """Both sides draw from key 0: the same starts (identity, the 24 PCA
    alignments and JAX's one random rotation)."""
    xyz, mask = _scene_cloud(seed=3)
    T_true = random_se3(seed=8, max_angle=1.0, max_trans=0.2)
    dxyz = transform_np(T_true, xyz).astype(np.float32)
    js, ps = _jp(xyz, mask)
    jd, pd = _jp(dxyz, mask)
    tail = (25, 0.08, 512, 15, None, 0.1, 512, 1024, True, 0, 8)
    want = JR.register_global(js, jd, jax.random.key(0), *tail,
                              max_iterations=30)
    args = (ps, pd, prng.key(0), *tail)
    got = PR.register_global(*args, max_iterations=30)
    assert_bitwise(got, PR.register_global(
        **keywords(JR.register_global, args), max_iterations=30))
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-4)


def case_voxel_downsample():
    xyz, mask, _ = _voxel_inputs(np.random.default_rng(1234), False, False)
    jpc, ppc = _jp(xyz, mask)
    want = J.voxel_downsample(jpc, 0.02, 2048, "xla", False, "never")
    args = (ppc, 0.02, 2048, "auto", False, "never")
    got = T.voxel_downsample(*args)
    assert_bitwise(got, T.voxel_downsample(
        **keywords(J.voxel_downsample, args)))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                               atol=1e-5)


def case_voxel_map_update():
    rng = np.random.default_rng(1102)
    jm, tm = _maps(4096, 0.25)
    km = tm
    for xyz, _ in _frames(rng, 2, 800, scale=2.0):
        jc, tc = _clouds(xyz, capacity=1024)
        jm = JV.voxel_map_update(jm, jc, 0.9, 0.05, INF, "xla", False)
        args = (tm, tc, 0.9, 0.05, INF, "auto", False)
        tm = TV.voxel_map_update(*args)
        km = TV.voxel_map_update(**keywords(
            JV.voxel_map_update, (km, *args[1:])))
        assert_bitwise(tm, km)
    _assert_same_map(jm, tm)


def case_TemporalAccumulator(tmp_path):
    """The constructor, and ``load`` (whose ``interpret`` moved too)."""
    rng = np.random.default_rng(1103)
    head = (2048, 0.2, 0.9, 0.05, INF, False)
    jacc = JV.TemporalAccumulator(*head, "xla", False)
    args = (*head, "auto", False)
    tacc = TV.TemporalAccumulator(*args)
    kacc = TV.TemporalAccumulator(**keywords(JV.TemporalAccumulator, args))
    assert tacc.state.device == torch.device("cpu")
    for xyz, _ in _frames(rng, 3, 300):
        jc, tc = _clouds(xyz, capacity=384)
        jacc.update(jc)
        tacc.update(tc)
        kacc.update(tc)
    assert_bitwise(tacc.state, kacc.state)
    _assert_same_map(jacc.state, tacc.state)
    jacc.save(str(tmp_path / "jax.npz"))
    tacc.save(str(tmp_path / "port.npz"))
    tail = (2048, 0.9, 0.05, INF)
    jload = JV.TemporalAccumulator.load(str(tmp_path / "jax.npz"), *tail,
                                        "xla", False)
    load_args = (str(tmp_path / "port.npz"), *tail, "auto", False)
    tload = TV.TemporalAccumulator.load(*load_args)
    kload = TV.TemporalAccumulator.load(**keywords(
        JV.TemporalAccumulator.load, load_args))
    assert_bitwise(tload.state, kload.state)
    _assert_same_map(jload.state, tload.state)


def case_StitchingPipeline():
    """test_torch_stitcher.py's small rig, two frames in 'track' mode
    (the refined extrinsics become the next frame's)."""
    depths, ji, ext = _scene()
    jcfg = _jax_cfg()
    jpipe = JPipeline(jcfg, ji, jnp.asarray(ext), "track", 0.3)
    jpipe._step = lambda *a, **k: _jax_step(jcfg, *a, **k)
    pi, pcfg = _port_state(ji, jcfg)
    args = (pcfg, pi, ext, "track", 0.3)
    ppipe = P.StitchingPipeline(*args)
    kpipe = P.StitchingPipeline(**keywords(JPipeline, args))
    assert ppipe.device == torch.device("cpu")
    for _ in range(2):
        want = jpipe(jnp.asarray(depths))
        got = ppipe(torch.from_numpy(depths))
        assert_bitwise(got, kpipe(torch.from_numpy(depths)))
        np.testing.assert_allclose(ppipe.extrinsics.numpy(),
                                   np.asarray(jpipe.extrinsics), atol=1e-4)
    assert not np.array_equal(ppipe.extrinsics.numpy(), ext)   # tracked


def case_build():
    """``force`` rebuilds. The JAX package's ``build`` writes into the JAX
    package's own directory, so it is not run here; its ``force`` is the
    same test (``force or stale``)."""
    before = native.build()
    mtime = before.stat().st_mtime_ns
    got = native.build(True)
    assert got == before and got.stat().st_mtime_ns > mtime
    mtime = got.stat().st_mtime_ns
    kw = native.build(**keywords(native.build, (True,)))
    assert kw == got and kw.stat().st_mtime_ns > mtime
    assert native.build(False).stat().st_mtime_ns == kw.stat().st_mtime_ns
    assert native.available()


CASES = {
    "ops.nn::nearest_neighbors": case_nearest_neighbors,
    "ops.icp::icp_batched": case_icp_batched,
    "ops.icp::icp_point_to_plane_batched": case_icp_point_to_plane_batched,
    "ops.icp::icp": case_icp,
    "ops.icp::icp_converge": case_icp_converge,
    "models.registration::register_pair": case_register_pair,
    "models.registration::register_global": case_register_global,
    "ops.voxel::voxel_downsample": case_voxel_downsample,
    "models.voxel_map::voxel_map_update": case_voxel_map_update,
    "models.voxel_map::TemporalAccumulator": case_TemporalAccumulator,
    "models.stitcher::StitchingPipeline": case_StitchingPipeline,
    "native::build": case_build,
}


@pytest.mark.parametrize("entry", list(CASES))
def test_jax_positional_order_matches_jax_and_keywords(
        entry, on_cpu, jax_icp_direct_nn, tmp_path):
    fn = CASES[entry]
    params = inspect.signature(fn).parameters
    kw = {"jax_fns": jax_icp_direct_nn, "tmp_path": tmp_path}
    fn(**{k: v for k, v in kw.items() if k in params})


# --- the calls ROADMAP.md's fault list ran ---------------------------------

def _roadmap_calls():
    rng = np.random.default_rng(1104)
    src, dst, smask, dmask, _ = _icp_scene(rng, n=800)
    ps = PointCloud(xyz=t(src), mask=t(smask))
    pd = PointCloud(xyz=t(dst), mask=t(dmask))
    depths, ji, ext = _scene()
    pi, pcfg = _port_state(ji, _jax_cfg())
    return {
        "nearest_neighbors": (T.nearest_neighbors, J.nearest_neighbors,
                              lambda: (ps.xyz, pd.xyz, None, 1024, 4096)),
        "icp": (T.icp, J.icp, lambda: (ps, pd, None, 5, 0.1, 1024, 4096)),
        "icp_converge": (T.icp_converge, J.icp_converge, lambda: (
            ps, pd, None, 50, 1e-8, 0.25, 1024, 4096)),
        "register_pair": (PR.register_pair, JR.register_pair, lambda: (
            ps, pd, None, None, True, 50, 1e-8, 0.25, 1024, 4096, 0.0,
            False)),
        "register_global": (PR.register_global, JR.register_global,
                            lambda: (ps, pd, prng.key(0), 4, 0.05, 1024, 15,
                                     None, 0.1, 512, 1024, True, 0, 8)),
        "StitchingPipeline": (
            lambda *a, **k: P.StitchingPipeline(*a, **k)(
                torch.from_numpy(depths)),
            JPipeline, lambda: (pcfg, pi, ext, "track")),
    }


@pytest.mark.parametrize("call", ["nearest_neighbors", "icp", "icp_converge",
                                  "register_pair", "register_global",
                                  "StitchingPipeline"])
def test_roadmap_calls_equal_their_keyword_calls(call, on_cpu):
    """Each of these raised before the port took the JAX order
    (``native.build(True)``, the seventh, is ``case_build`` above)."""
    port_fn, jax_fn, make_args = _roadmap_calls()[call]
    got = port_fn(*make_args())
    assert_bitwise(got, port_fn(**keywords(jax_fn, make_args())))


def test_the_default_device_is_the_card(monkeypatch):
    """Without ``device`` the pipeline and the accumulator take
    ``platform_device()``: the card, and never the CPU on their own."""
    monkeypatch.delenv("PCS_PLATFORM", raising=False)
    depths, ji, ext = _scene()
    pi, pcfg = _port_state(ji, _jax_cfg())
    if torch.cuda.is_available():
        assert P.StitchingPipeline(pcfg, pi, ext).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="PCS_PLATFORM"):
        P.StitchingPipeline(pcfg, pi, ext, "track")
    with pytest.raises(RuntimeError, match="PCS_PLATFORM"):
        TV.TemporalAccumulator(64, 0.1)
    cpu = P.StitchingPipeline(pcfg, pi, ext, "track", device="cpu")
    assert cpu.device == torch.device("cpu")


def test_chip_smoke_names_the_jax_order():
    """chip_smoke.py, which may not import JAX, keeps its own list of the
    JAX names its card calls use as keywords; it must be JAX's."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_names", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    jax_fns = {"nearest_neighbors": J.nearest_neighbors,
               "icp_batched": J.icp_batched,
               "icp_point_to_plane_batched": J.icp_point_to_plane_batched,
               "icp": J.icp, "icp_converge": J.icp_converge,
               "register_pair": JR.register_pair,
               "register_global": JR.register_global,
               "voxel_downsample": J.voxel_downsample,
               "voxel_map_update": JV.voxel_map_update,
               "TemporalAccumulator": JV.TemporalAccumulator,
               "StitchingPipeline": JPipeline,
               "build": jax_native_build}
    assert set(smoke.JAX_ORDER) == set(jax_fns)
    for name, fn in jax_fns.items():
        names = tuple(keywords(fn, [None] * len(smoke.JAX_ORDER[name])))
        assert smoke.JAX_ORDER[name] == names, name
