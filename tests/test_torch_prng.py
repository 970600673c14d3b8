"""The port's random draws (``utils/prng.py``) against ``jax.random``.

JAX runs on the CPU, as the rest of the suite runs it; its keys cross as
their two uint32 words (``utils.convert.key_from_jax``). Bit for bit:
``key``, ``split``, ``bits``, ``uniform``, ``randint``, ``choice(p=...)``
and the prefix sum under it (``kernels.prng.scan16`` against
``jnp.cumsum``), at sizes up to the flagship's 262,144 slots.
``categorical``'s indices are equal on these seeds. ``normal`` is held to
1e-5 relative: ``torch.erfinv`` differs from XLA's ``erf_inv`` in about
60% of float32 inputs, by up to ~6e-6 relative. The plain versions of the
two kernels are also held against a numpy transcription of the algorithms
(uint32 threefry2x32, the recursive blocked scan), and ``chip_smoke.py``'s
literal JAX values against live ``jax.random``.
"""
import gc
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu_torch.kernels import prng as KP
from pointcloud_stitching_tpu_torch.utils import prng
from pointcloud_stitching_tpu_torch.utils.convert import key_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [1, 16, 17, 4096, 262144]
SEEDS = [0, 5, 2 ** 32 + 7]


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """The suite runs in one process, and every program XLA compiles on
    the CPU holds about four memory maps while JAX caches it; by the end
    of the suite they near vm.max_map_count (65,530), past which the next
    compile crashes the process. When this module ends, the programs that
    it and the modules before it compiled are dropped from JAX's caches
    (a later test that needs one compiles it again)."""
    yield
    jax.clear_caches()
    gc.collect()


def jkey(seed):
    return jax.random.key(seed)


def pkey(k):
    """The port's key for JAX key ``k``."""
    return key_from_jax(np.asarray(jax.random.key_data(k)))


def u32(x):
    return np.asarray(x).astype(np.int64)


def f32_bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# --- numpy transcriptions of the two kernels -----------------------------------

def np_threefry2x32(k0, k1, n):
    """(x0, x1) uint32 for the counters 0 .. n-1 (hi, lo of each)."""
    i = np.arange(n, dtype=np.uint64)
    x = [(i >> np.uint64(32)).astype(np.uint32),
         (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    ks = [np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA)]
    rot = [(13, 15, 26, 6), (17, 29, 16, 24)]
    with np.errstate(over="ignore"):
        x[0] = x[0] + ks[0]
        x[1] = x[1] + ks[1]
        for g in range(5):
            for r in rot[g % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(g + 1) % 3]
            x[1] = x[1] + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x


def np_scan16(x):
    """XLA's CPU cumsum order: blocks of 16 in sequence, block totals
    scanned recursively, prefix[b - 1] + inner for block b >= 1."""
    x = np.asarray(x, np.float32)
    n = len(x)
    nb = -(-n // 16)
    blocks = np.zeros(nb * 16, np.float32)
    blocks[:n] = x
    blocks = blocks.reshape(nb, 16)
    inner = blocks.copy()
    for j in range(1, 16):
        inner[:, j] = inner[:, j - 1] + blocks[:, j]
    if nb > 1:
        prefix = np_scan16(inner[:, -1])
        inner[1:] = prefix[:-1, None] + inner[1:]
    return inner.reshape(-1)[:n]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 17, 4096])
def test_threefry_plain_matches_numpy(seed, n):
    k = pkey(jkey(seed))
    x0, x1 = np_threefry2x32(int(k[0]), int(k[1]), n)
    np.testing.assert_array_equal(
        KP.threefry2x32(k, n, pairs=True).numpy(), np.stack([x0, x1], 1))
    np.testing.assert_array_equal(KP.threefry2x32(k, n).numpy(), x0 ^ x1)


def test_threefry_with_both_key_words_set():
    """A key whose high word is set (keys from split are such keys)."""
    k0, k1 = 0xDEADBEEF, 0x01234567
    key = torch.tensor([k0, k1], dtype=torch.int64)
    x0, x1 = np_threefry2x32(k0, k1, 40)
    got = KP.threefry2x32(key, 40).numpy()
    np.testing.assert_array_equal(got, x0 ^ x1)
    np.testing.assert_array_equal(got, u32(jax.random.bits(
        jax.random.wrap_key_data(np.array([k0, k1], np.uint32)), (40,))))


@pytest.mark.parametrize("n", [1, 5, 16, 17, 100, 300, 4096, 131072, 262144])
def test_scan16_matches_jnp_cumsum(n):
    rng = np.random.default_rng(n)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    for x in (mask / max(mask.sum(), 1.0),
              rng.standard_normal(n).astype(np.float32)):
        want = np.asarray(jnp.cumsum(jnp.asarray(x)))
        got = KP.scan16(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(f32_bits(got), f32_bits(want))
        np.testing.assert_array_equal(f32_bits(np_scan16(x)), f32_bits(want))


def test_scan16_is_not_torch_cumsum():
    """The reason for the kernel: torch.cumsum rounds elsewhere."""
    x = np.full(262144, 1.0 / 200_000, np.float32)
    a = KP.scan16(torch.from_numpy(x))
    assert not torch.equal(a, torch.cumsum(torch.from_numpy(x), 0))


# --- jax.random, function by function ------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 5, 2 ** 32 + 7,
                                  2 ** 40 + 3, -3])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  u32(jax.random.key_data(jkey(seed))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_bits_matches_jax(seed, n):
    k = jkey(seed)
    np.testing.assert_array_equal(prng.bits(pkey(k), (n,)).numpy(),
                                  u32(jax.random.bits(k, (n,))))


def test_bits_shapes_match_jax():
    k = jkey(11)
    for shape in ((), (3, 5), (2, 1, 7)):
        got = prng.bits(pkey(k), shape).numpy()
        assert got.shape == shape
        np.testing.assert_array_equal(got, u32(jax.random.bits(k, shape)))


@pytest.mark.parametrize("num", [2, 3, 17])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, num):
    k = jkey(seed)
    want = u32(jax.random.key_data(jax.random.split(k, num)))
    np.testing.assert_array_equal(prng.split(pkey(k), num).numpy(), want)
    # and a split of a split: keys with both words set
    np.testing.assert_array_equal(
        prng.split(prng.split(pkey(k), num)[-1]).numpy(),
        u32(jax.random.key_data(jax.random.split(
            jax.random.split(k, num)[-1]))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_uniform_matches_jax(seed, n):
    k = jkey(seed)
    np.testing.assert_array_equal(
        f32_bits(prng.uniform(pkey(k), (n,)).numpy()),
        f32_bits(jax.random.uniform(k, (n,))))
    np.testing.assert_array_equal(
        f32_bits(prng.uniform(pkey(k), (n,), -2.5, 7.0).numpy()),
        f32_bits(jax.random.uniform(k, (n,), minval=-2.5, maxval=7.0)))


@pytest.mark.parametrize("lo,hi", [(0.1, 0.7), (-3.3e-3, 1e4), (1e-30, 3.7),
                                   (-1e-7, 1.0)])
def test_uniform_ranges_match_jax(lo, hi):
    """Ranges where rounding f * span before adding minval would differ
    from XLA's fused multiply-add in a third of the draws."""
    k = jkey(5)
    n = 65536
    np.testing.assert_array_equal(
        f32_bits(prng.uniform(pkey(k), (n,), lo, hi).numpy()),
        f32_bits(jax.random.uniform(k, (n,), minval=lo, maxval=hi)))


@pytest.mark.parametrize("lo,hi", [(0, 8), (-5, 100003), (3, 3), (7, 2),
                                   (0, 2 ** 20 + 3), (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("n", [1, 17, 4096, 262144])
def test_randint_matches_jax(n, lo, hi):
    k = jkey(9)
    got = prng.randint(pkey(k), (n,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.randint(k, (n,), lo, hi)))


@pytest.mark.parametrize("n,h", [(5000, 64), (113301, 256), (262144, 1024),
                                 (1, 4), (17, 3)])
def test_choice_matches_jax(n, h):
    """jax.random.choice with p, as segment_plane calls it: the mask of
    valid slots over its count."""
    rng = np.random.default_rng(n)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    mask[0] = 1.0
    p = mask / max(mask.sum(), 1.0)
    k = jkey(7)
    want = np.asarray(jax.random.choice(k, n, shape=(h, 3),
                                        p=jnp.asarray(p)))
    np.testing.assert_array_equal(
        prng.choice(pkey(k), n, (h, 3), p=torch.from_numpy(p)).numpy(), want)


def test_choice_of_zero_p_is_index_0():
    k = jkey(1)
    want = np.asarray(jax.random.choice(k, 10, shape=(4,), p=jnp.zeros(10)))
    got = prng.choice(pkey(k), 10, (4,), p=torch.zeros(10)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()


@pytest.mark.parametrize("seed", range(6))
def test_categorical_matches_jax(seed):
    """register_global's FPFH triples: logits 0 on valid descriptors and
    -1e9 elsewhere, shape (starts, 3)."""
    rng = np.random.default_rng(seed)
    logits = np.where(rng.random(1024) < 0.8, 0.0, -1e9).astype(np.float32)
    k = jkey(seed)
    want = np.asarray(jax.random.categorical(k, jnp.asarray(logits),
                                             shape=(16, 3)))
    got = prng.categorical(pkey(k), torch.from_numpy(logits), shape=(16, 3))
    np.testing.assert_array_equal(got.numpy(), want)
    lg = rng.standard_normal((5, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        prng.categorical(pkey(k), torch.from_numpy(lg)).numpy(),
        np.asarray(jax.random.categorical(k, jnp.asarray(lg))))


@pytest.mark.parametrize("n", [1, 17, 39 * 4, 262144])
def test_normal_within_1e5_of_jax(n):
    """torch.erfinv against XLA's erf_inv: within ~6e-6 relative, not
    bitwise."""
    k = jkey(4)
    want = np.asarray(jax.random.normal(k, (n,)))
    got = prng.normal(pkey(k), (n,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_gumbel_within_ulps_of_jax():
    k = jkey(2)
    want = np.asarray(jax.random.gumbel(k, (4096,)))
    np.testing.assert_allclose(prng.gumbel(pkey(k), (4096,)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


# --- the contract around the draws ---------------------------------------------

def test_a_generator_is_refused():
    g = torch.Generator().manual_seed(0)
    for call in (lambda: prng.split(g), lambda: prng.bits(g, (3,)),
                 lambda: prng.uniform(g, (3,)), lambda: prng.normal(g, (3,)),
                 lambda: prng.randint(g, (3,), 0, 4),
                 lambda: prng.choice(g, 3, (2,), p=torch.ones(3) / 3),
                 lambda: prng.categorical(g, torch.zeros(4))):
        with pytest.raises(TypeError, match=r"prng\.key\(seed\)"):
            call()


def test_kernels_refuse_cuda_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        KP.threefry2x32(prng.key(0), 4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        KP.scan16(torch.ones(4), impl="cuda")


def test_impl_reaches_the_kernels_of_every_draw():
    """Each draw passes ``impl`` down to its kernels: 'cuda' on a CPU key
    reaches a wrapper, which refuses it; 'torch' takes the plain path."""
    k, p = prng.key(0), torch.ones(8) / 8
    for call in (lambda i: prng.split(k, impl=i),
                 lambda i: prng.bits(k, (3,), impl=i),
                 lambda i: prng.uniform(k, (3,), -2.5, 7.0, impl=i),
                 lambda i: prng.normal(k, (3,), impl=i),
                 lambda i: prng.gumbel(k, (3,), impl=i),
                 lambda i: prng.randint(k, (3,), 0, 4, impl=i),
                 lambda i: prng.choice(k, 8, (2,), p=p, impl=i),
                 lambda i: prng.categorical(k, torch.zeros(4), impl=i)):
        with pytest.raises(ValueError, match="CUDA"):
            call("cuda")
        assert torch.equal(call("torch"), call("auto"))


def test_key_on_checks_the_key():
    k = prng.key(4)
    assert torch.equal(prng.key_on(k, "cpu"), k)
    with pytest.raises(TypeError, match=r"prng\.key\(seed\)"):
        prng.key_on(torch.Generator(), "cpu")


def test_key_from_jax_checks_its_input():
    np.testing.assert_array_equal(
        key_from_jax(np.array([1, 2 ** 32 - 1], np.uint32)).numpy(),
        [1, 2 ** 32 - 1])
    with pytest.raises(ValueError):
        key_from_jax(np.array([1, 2, 3], np.uint32))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_draws", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_literals_are_jax():
    """chip_smoke.py holds the card's draws against JAX's values written
    in as literals (it may not import JAX): they must be live JAX's."""
    want = _chip_smoke().JAX_DRAWS
    got = {}
    k5 = jkey(want["seed"])
    n = want["choice_n"]
    got["bits"] = u32(jax.random.bits(k5, (len(want["bits"]),))).tolist()
    got["split"] = u32(jax.random.key_data(
        jax.random.split(k5, len(want["split"])))).tolist()
    got["uniform"] = f32_bits(jax.random.uniform(
        k5, (len(want["uniform"]),))).tolist()
    got["randint"] = np.asarray(jax.random.randint(
        k5, (len(want["randint"]),), 0, want["randint_hi"])).tolist()
    big = u32(jax.random.bits(k5, (want["bits_n"],)))
    got["bits_sum"] = int(big.sum())
    got["bits_last"] = int(big[-1])
    mask = (np.arange(n) % want["choice_mod"] != 0).astype(np.float32)
    idx = np.asarray(jax.random.choice(
        k5, n, shape=(want["choice_h"], 3),
        p=jnp.asarray(mask / mask.sum())))
    got["choice_head"] = idx.reshape(-1)[:len(want["choice_head"])].tolist()
    got["choice_sum"] = int(idx.astype(np.int64).sum())
    for name, value in got.items():
        assert want[name] == value, name
    # and the port's own draws on the CPU, as chip_smoke.py draws them on
    # the card
    pk = prng.key(want["seed"])
    pbig = prng.bits(pk, (want["bits_n"],))
    pidx = prng.choice(pk, n, (want["choice_h"], 3),
                       p=torch.from_numpy(mask / mask.sum()))
    port = {"bits": prng.bits(pk, (len(want["bits"]),)).tolist(),
            "split": prng.split(pk, len(want["split"])).tolist(),
            "uniform": prng.uniform(pk, (len(want["uniform"]),)).view(
                torch.int32).tolist(),
            "randint": prng.randint(pk, (len(want["randint"]),), 0,
                                    want["randint_hi"]).tolist(),
            "bits_sum": int(pbig.sum()), "bits_last": int(pbig[-1]),
            "choice_head": pidx.reshape(-1)[:len(want["choice_head"])]
            .tolist(),
            "choice_sum": int(pidx.sum())}
    assert port == got
