"""The port's geometry against the JAX package's, on the CPU.

On CPU tensors the port's ``raycast_walls`` (K1) and ``progress_and_collision`` (K2)
run their plain PyTorch versions, which are what these tests hold to JAX; the CUDA
kernels are held to the same plain versions on the card (chip_smoke.py,
tests/test_torch_cuda_kernels.py).

Tolerances:
 - K1 in float64: exact. A ray may differ only on a near-tie (two hit ratios equal
   to within the rounding of the cross products, where the tree fold and JAX's
   sequential fold can pick different winners); such rays are counted and the
   count must be 0 on these seeds.
 - K1 in float32: hit/no-hit identical, distances within 1 ulp.
 - K2: exact (same index, so same progress, same crashed), also on exact d^2 ties.
 - car_corners and car_update in float64: rtol 1e-12, because cos, sin (and sqrt
   after them) may round differently in XLA's CPU math and in PyTorch's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from self_play_racing_tpu.envs import track as jtrack
from self_play_racing_tpu.ops import dynamics as jdyn
from self_play_racing_tpu.ops import geometry as jgeo
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.ops import dynamics as tdyn
from self_play_racing_tpu_torch.ops import geometry as tgeo


def _t(a):
    return torch.from_numpy(np.array(a))


def _soup(rng, n, r, s, dtype, n_pad=24):
    """Random rays and a random segment soup per row, with zero-direction padding."""
    ox, oy = rng.uniform(-20, 20, (2, n, r))
    ang = rng.uniform(0, 2 * np.pi, (n, r))
    sx, sy = rng.uniform(-40, 40, (2, n, 1, s))
    vx, vy = rng.uniform(-15, 15, (2, n, 1, s))
    for a in (sx, sy, vx, vy):
        a[..., s - n_pad:] = 0.0
    rays = [a.astype(dtype) for a in (ox, oy, np.cos(ang), np.sin(ang))]
    segs = [a.astype(dtype) for a in (sx, sy, vx, vy)]
    segs.append((segs[3] * segs[0] - segs[2] * segs[1]).astype(dtype))  # seg_c
    return rays, segs


def _pool_rays(rng, pool, r, dtype):
    """Rays from points near each pool row's centreline, as the env casts them."""
    n = pool.wp_x.shape[0]
    n_wp = np.asarray(pool.n_wp)
    i = rng.integers(0, n_wp)
    x = np.asarray(pool.wp_x)[np.arange(n), i] + rng.uniform(-3, 3, n)
    y = np.asarray(pool.wp_y)[np.arange(n), i] + rng.uniform(-3, 3, n)
    ang = rng.uniform(0, 2 * np.pi, n)[:, None] + np.linspace(-np.pi / 3, np.pi / 3, r)
    rays = [np.broadcast_to(x[:, None], ang.shape), np.broadcast_to(y[:, None], ang.shape),
            np.cos(ang), np.sin(ang)]
    segs = [np.asarray(getattr(pool, f))[:, None, :]
            for f in ("seg_sx", "seg_sy", "seg_vx", "seg_vy", "seg_c")]
    return [a.astype(dtype) for a in rays], [a.astype(dtype) for a in segs]


def _both_raycasts(rays, segs, max_dist=50.0):
    j = np.asarray(jgeo.raycast_walls(*map(jnp.asarray, rays), *map(jnp.asarray, segs[:4]),
                                      max_dist, seg_c=jnp.asarray(segs[4])))
    t = tgeo.raycast_walls(*map(_t, rays), *map(_t, segs[:4]), max_dist,
                           seg_c=_t(segs[4])).numpy()
    return j, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raycast_soup_f64_exact(seed):
    rays, segs = _soup(np.random.default_rng(seed), 16, 11, 200, np.float64)
    j, t = _both_raycasts(rays, segs)
    assert (j < 50.0).mean() > 0.3  # the soup is dense enough to hit
    assert int((j != t).sum()) == 0
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("lod", [1, 4])
def test_raycast_pool_rows_f64_exact(lod):
    np.random.seed(3)
    pool = jtrack.make_track_pool(jtrack.gen_tracks(16, seed=3), 7.0, dtype=jnp.float64,
                                  sensor_lod=lod)
    rays, segs = _pool_rays(np.random.default_rng(lod), pool, 11, np.float64)
    j, t = _both_raycasts(rays, segs)
    assert int((j != t).sum()) == 0
    np.testing.assert_array_equal(t, j)


def test_raycast_without_seg_c_matches():
    rays, segs = _soup(np.random.default_rng(7), 8, 5, 64, np.float64)
    j = np.asarray(jgeo.raycast_walls(*map(jnp.asarray, rays), *map(jnp.asarray, segs[:4]),
                                      30.0))
    t = tgeo.raycast_walls(*map(_t, rays), *map(_t, segs[:4]), 30.0).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1])
def test_raycast_f32_within_one_ulp(seed):
    rays, segs = _soup(np.random.default_rng(10 + seed), 32, 11, 256, np.float32)
    j, t = _both_raycasts(rays, segs)
    np.testing.assert_array_equal(j == 50.0, t == 50.0)
    assert (np.abs(t - j) <= np.spacing(np.abs(j))).all()
    assert int((j != t).sum()) == 0


def test_raycast_all_miss_and_padding_rows_return_max_dist_exactly():
    """Segments behind the ray plus zero-direction padding: max_dist exactly, in
    both packages; and a hit among padding rows still wins."""
    starts = np.array([[-5.0, -2.0], [-3.0, 1.0], [-8.0, 4.0]])
    vecs = np.array([[0.0, 3.0], [1.5, 0.5], [2.0, -1.0]])
    pad = np.zeros((4, 2))
    sx, sy = np.concatenate([starts, pad]).T
    vx, vy = np.concatenate([vecs, pad]).T
    c = vy * sx - vx * sy
    for dtype in (np.float32, np.float64):
        segs = [a.astype(dtype) for a in (sx, sy, vx, vy, c)]
        for oy in (0.0, 2.5, -4.0):
            rays = [np.asarray(v, dtype) for v in (1.0, oy, 1.0, 0.0)]
            j, t = _both_raycasts(rays, segs)
            assert float(j) == 50.0 and float(t) == 50.0
        rays = [np.asarray(v, dtype) for v in (-4.0, 0.0, -1.0, 0.0)]
        j, t = _both_raycasts(rays, segs)
        assert float(t) == float(j) and abs(float(t) - 1.0) < 1e-6


def _kernel_order_fold(a, d, lanes=32):
    """The CUDA kernel's reduction order, in NumPy: each of 32 lanes folds a
    contiguous run of segments in index order from the identity (inf, 1), then the
    runs combine pairwise at offsets 1, 2, 4, 8, 16 (left before right)."""
    s = a.shape[-1]
    run = -(-s // lanes)
    pa = np.full(a.shape[:-1] + (lanes,), np.inf, a.dtype)
    pd = np.ones_like(pa)
    with np.errstate(invalid="ignore"):
        for lane in range(lanes):
            for i in range(min(lane * run, s), min(lane * run + run, s)):
                take = a[..., i] * pd[..., lane] < pa[..., lane] * d[..., i]
                pa[..., lane] = np.where(take, a[..., i], pa[..., lane])
                pd[..., lane] = np.where(take, d[..., i], pd[..., lane])
        o = 1
        while o < lanes:
            for lane in range(0, lanes, 2 * o):
                qa, qd = pa[..., lane + o], pd[..., lane + o]
                take = qa * pd[..., lane] < pa[..., lane] * qd
                pa[..., lane] = np.where(take, qa, pa[..., lane])
                pd[..., lane] = np.where(take, qd, pd[..., lane])
            o *= 2
    return pa[..., 0], pd[..., 0]


def test_kernel_reduction_order_matches_plain_fold():
    """The kernel's run-then-tree order picks the plain tree fold's winner,
    including on duplicated (exactly tied) segments and padding rows."""
    rng = np.random.default_rng(5)
    rays, segs = _soup(rng, 6, 11, 300, np.float32, n_pad=20)
    segs = [np.concatenate([a[..., :150], a[..., :150]], -1) for a in segs]  # exact ties
    ox, oy, dx, dy = (a[..., None] for a in rays)
    sx, sy, vx, vy, c = segs
    cn = oy * vx - ox * vy + c
    dotp = vy * dx - vx * dy
    sn = sx * dy - sy * dx - (ox * dy - oy * dx)
    d = np.abs(dotp)
    hit = (d > 1e-10) & (cn * dotp >= 0) & (sn * dotp >= 0) & (np.abs(sn) <= d)
    a = np.where(hit, np.abs(cn), np.inf).astype(np.float32)
    ka, kd = _kernel_order_fold(a, d)
    ta, td = tgeo._ratio_min_fold(_t(a), _t(d))
    np.testing.assert_array_equal(ka, ta.numpy())
    np.testing.assert_array_equal(kd, td.numpy())


def _k2_inputs(rng, pool):
    n = pool.wp_x.shape[0]
    n_wp = np.asarray(pool.n_wp)
    i = rng.integers(0, n_wp)
    x = np.asarray(pool.wp_x)[np.arange(n), i] + rng.uniform(-6, 6, n)
    y = np.asarray(pool.wp_y)[np.arange(n), i] + rng.uniform(-6, 6, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    cx, cy = (np.asarray(a) for a in jgeo.car_corners(jnp.asarray(x), jnp.asarray(y),
                                                      jnp.asarray(ang), 2.0, 1.0))
    fields = [np.asarray(getattr(pool, f)) for f in ("wp_x", "wp_y", "nrm_x", "nrm_y")]
    return [x, y, cx, cy] + fields + [n_wp, np.asarray(pool.track_width)]


def _both_track_queries(args):
    j = jgeo.progress_and_collision(*map(jnp.asarray, args))
    t = tgeo.progress_and_collision(*map(_t, args))
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_progress_and_collision_pool_rows_exact(dtype):
    np.random.seed(4)
    pool = jtrack.make_track_pool(jtrack.gen_tracks(16, seed=4), 6.0, dtype=jnp.float64)
    args = _k2_inputs(np.random.default_rng(0), pool)
    args = [a.astype(dtype) if a.dtype.kind == "f" else a for a in args]
    (jp, jc), (tp, tc) = _both_track_queries(args)
    assert 0 < jc.sum() < len(jc)  # both outcomes occur
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc, jc)


def test_progress_and_collision_exact_ties_take_lower_index():
    """Query at the origin, equidistant waypoints at indices 3 and 7 (and 12 for a
    corner); the lower index must win, with its own normal's projection."""
    w = 16
    wp_x = np.full((1, w), 1e8)
    wp_y = np.full((1, w), 1e8)
    nrm_x = np.zeros((1, w))
    nrm_y = np.zeros((1, w))
    for i, (px, py, nx) in {3: (1.0, 0.0, 1.0), 7: (-1.0, 0.0, 0.0),
                            12: (0.0, 1.0, 0.0)}.items():
        wp_x[0, i], wp_y[0, i], nrm_x[0, i] = px, py, nx
    x = np.zeros(1)
    y = np.zeros(1)
    cx = np.zeros((1, 4))  # every corner at the origin too: ties, then |proj| = 1
    cy = np.zeros((1, 4))
    for tw, crashed in ((0.5, True), (1.5, False)):
        args = [x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, np.array([10], np.int32),
                np.array([tw])]
        (jp, jc), (tp, tc) = _both_track_queries(args)
        assert tp[0] == jp[0] == 3 / 10
        assert tc[0] == jc[0] == crashed


def test_car_corners_f64():
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-50, 50, (2, 64))
    ang = rng.uniform(-7, 7, 64)
    j = jgeo.car_corners(jnp.asarray(x), jnp.asarray(y), jnp.asarray(ang), 2.0, 1.0)
    t = tgeo.car_corners(_t(x), _t(y), _t(ang), 2.0, 1.0)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-12)


def test_car_update_f64():
    rng = np.random.default_rng(2)
    n = 64
    x, y = rng.uniform(-50, 50, (2, n))
    ang = rng.uniform(0, 2 * np.pi, n)
    vx, vy = rng.uniform(-35, 35, (2, n))  # some above max speed: the clamp runs
    crashed = rng.random(n) < 0.2
    steering = rng.uniform(-1, 1, n)
    throttle = rng.uniform(0, 1, n)
    args = [x, y, ang, vx, vy, crashed, steering, throttle]
    j = jdyn.car_update(*map(jnp.asarray, args))
    t = tdyn.car_update(*map(_t, args))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-12)
    # crashed cars are frozen bit for bit
    for a, b in zip(t, (x, y, ang, vx, vy)):
        np.testing.assert_array_equal(a.numpy()[crashed], b[crashed])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (tgeo.raycast_walls_launches, tgeo.progress_and_collision_launches)
    pool = ttrack.default_track_pool(torch.float64, device="cpu")
    rays, segs = _pool_rays(np.random.default_rng(0), pool, 3, np.float64)
    tgeo.raycast_walls(*map(_t, rays), *map(_t, segs[:4]), 50.0, seg_c=_t(segs[4]))
    assert (tgeo.raycast_walls_launches, tgeo.progress_and_collision_launches) == before


def test_unsupported_device_raises():
    seg = torch.zeros((1, 8), device="meta")
    ray = torch.zeros((1,), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tgeo.raycast_walls(ray, ray, ray, ray, seg, seg, seg, seg, 50.0)
