"""The redesigned env-step kernels' shapes, on the CPU.

``multi_observe`` (``csrc/multi_observe.cu``) folds K1's 32 runs of L = ceil(S/32)
segments but stops each at the row's real extent E, and ``multi_transition``
(``csrc/multi_transition.cu``) searches a row's real waypoints first and the padding
only where its box could hold a winner. Neither may change a bit, so the plain models
of both (``geo.raycast_walls_fold_shape``, ``geo.waypoint_search_model``) are held
here to what they replace:

 - the fold's shape against JAX ``raycast_walls`` and ``raycast_walls_plain`` by
   K1's rule: hit/no-hit identical, distances within 2 ulp (a near-tie, two hit
   ratios equal to within the rounding of the cross products, may pick another
   winner in another reduction order); float32 and float64. Jitted JAX on the CPU
   contracts the cross products into FMAs, which neither JAX's eager ops nor the
   port's kernels (built with -fmad=false) do, so against it the distances agree
   to a relative 1e-4 in float32 and 1e-12 in float64 (seen: 268 and 163 ulp where
   a cross product cancels), hit/no-hit still identical;
 - the fold stopped at E bitwise the fold over every run, at the boundaries of the
   runs, on rows of padding only, with zero-direction segments inside the row and
   with rays whose direction is NaN or infinite;
 - the real-waypoints-first search bitwise the search over all W waypoints on the
   canonical pool's rows, at queries on the track, far off it (where the padding
   wins), at +-1e19, +-inf and NaN;
 - the two kernels' launch plans (plain Python, ``ops/_cuda.py``), which take the
   first kernels (a block a row) on few env rows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.ops import geometry as jgeo
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import geometry as tgeo
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool

MAX_DIST = 50.0
S = 896
L = -(-S // 32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _soup(rng, n, r, s, dtype, n_pad):
    """Rays [n, r] and a segment soup [n, 1, s] per row, its last n_pad segments
    zero-direction padding."""
    ox, oy = rng.uniform(-20, 20, (2, n, r))
    ang = rng.uniform(0, 2 * np.pi, (n, r))
    sx, sy = rng.uniform(-40, 40, (2, n, 1, s))
    vx, vy = rng.uniform(-15, 15, (2, n, 1, s))
    for a in (sx, sy, vx, vy):
        a[..., s - n_pad:] = 0.0
    rays = [a.astype(dtype) for a in (ox, oy, np.cos(ang), np.sin(ang))]
    segs = [a.astype(dtype) for a in (sx, sy, vx, vy)]
    segs.append((segs[3] * segs[0] - segs[2] * segs[1]).astype(dtype))
    return rays, segs


def _pool_rays(rng, pool, r, dtype):
    """Rays from points near each canonical row's centreline, as the env casts them."""
    n = pool.wp_x.shape[0]
    n_wp = pool.n_wp.numpy()
    i = rng.integers(0, n_wp)
    x = pool.wp_x.numpy()[np.arange(n), i] + rng.uniform(-3, 3, n)
    y = pool.wp_y.numpy()[np.arange(n), i] + rng.uniform(-3, 3, n)
    ang = rng.uniform(0, 2 * np.pi, n)[:, None] + np.linspace(-np.pi / 2, np.pi / 2, r)
    rays = [np.broadcast_to(x[:, None], ang.shape), np.broadcast_to(y[:, None], ang.shape),
            np.cos(ang), np.sin(ang)]
    segs = [getattr(pool, f).double().numpy()[:, None, :]
            for f in ("seg_sx", "seg_sy", "seg_vx", "seg_vy", "seg_c")]
    return [a.astype(dtype) for a in rays], [a.astype(dtype) for a in segs]


def _shape(rays, segs, stop_at_extent=False):
    return tgeo.raycast_walls_fold_shape(*map(_t, rays), *map(_t, segs[:4]), MAX_DIST,
                                         seg_c=_t(segs[4]), stop_at_extent=stop_at_extent)


def _assert_k1_rule(got, want):
    """K1's rule: hit/no-hit identical, distances within 2 ulp."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got == MAX_DIST, want == MAX_DIST)
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows", ["soup", "canonical"])
def test_fold_shape_is_k1_by_its_rule(dtype, rows):
    """The kernels' reduction shape, with and without the stop at E, against JAX
    and the plain tree fold by K1's rule, and against jitted JAX (the track fields
    jit arguments) with its FMAs; most rays hit, and most agree with JAX to the bit."""
    rng = np.random.default_rng(0 if rows == "soup" else 1)
    if rows == "soup":
        rays, segs = _soup(rng, 24, 11, S, dtype, n_pad=S - 660)
    else:
        pool = canonical_bench_pool(16, dtype=torch.float64, device="cpu")
        rays, segs = _pool_rays(rng, pool, 11, dtype)
    shape = _shape(rays, segs)
    stopped = _shape(rays, segs, stop_at_extent=True)
    assert torch.equal(_bits(shape), _bits(stopped))
    def raycast(ox, oy, dx, dy, sx, sy, vx, vy, c):
        return jgeo.raycast_walls(ox, oy, dx, dy, sx, sy, vx, vy, MAX_DIST, seg_c=c)

    args = list(map(jnp.asarray, rays + segs))
    want = np.asarray(raycast(*args))
    jitted = np.asarray(jax.jit(raycast)(*args))
    plain = tgeo.raycast_walls_plain(*map(_t, rays), *map(_t, segs[:4]), MAX_DIST,
                                     seg_c=_t(segs[4])).numpy()
    got = shape.numpy()
    _assert_k1_rule(got, want)
    _assert_k1_rule(got, plain)
    np.testing.assert_array_equal(got == MAX_DIST, jitted == MAX_DIST)
    np.testing.assert_allclose(got, jitted, rtol=1e-4 if dtype == np.float32 else 1e-12)
    assert (want < MAX_DIST).mean() > 0.3
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("extent", [1, L - 1, L, L + 1, 23 * L + 16, S, 0])
def test_fold_stopped_at_the_real_extent_is_bitwise_the_whole_fold(extent):
    """Rows whose real extent sits at the run boundaries (0: a row of padding
    only), with zero-direction segments inside the row: the same bits, float32 and
    float64; rays pointing every way, some with a NaN or infinite direction."""
    for dtype in (np.float32, np.float64):
        rays, segs = _soup(np.random.default_rng(extent), 8, 11, S, dtype, n_pad=S - extent)
        if extent >= 4:
            for f in segs[:4]:
                f[:, :, [extent // 3, 3 * extent // 4]] = 0.0  # zero direction inside
        rays[2][:, 0], rays[3][:, 1] = np.nan, np.inf
        shape = _shape(rays, segs)
        stopped = _shape(rays, segs, stop_at_extent=True)
        assert torch.equal(_bits(shape), _bits(stopped))
        if extent == 0:
            assert bool((stopped == MAX_DIST).all())
        elif extent >= L:
            assert bool((stopped < MAX_DIST).any())


def _queries(rng, pool):
    """Per canonical row [16, Q]: points on and near the track, far off it (where a
    padding waypoint at 1e8 is nearer than every real one), and +-1e19, +-inf, NaN."""
    n = pool.wp_x.shape[0]
    i = rng.integers(0, pool.n_wp.numpy()[:, None], (n, 64))
    qx = pool.wp_x.numpy()[np.arange(n)[:, None], i] + rng.uniform(-12, 12, (n, 64))
    qy = pool.wp_y.numpy()[np.arange(n)[:, None], i] + rng.uniform(-12, 12, (n, 64))
    far = np.array([1e9, -1e9, 2e8, 1e10, 1e19, -1e19, np.inf, -np.inf, np.nan, 0.0, 3e38])
    ex = np.broadcast_to(np.stack(np.meshgrid(far, far), -1).reshape(-1, 2),
                         (n, far.size ** 2, 2))
    return (np.concatenate([qx, ex[..., 0]], 1).astype(np.float32),
            np.concatenate([qy, ex[..., 1]], 1).astype(np.float32))


def test_real_waypoints_first_is_the_search_over_every_waypoint():
    """On the canonical pool's rows (n_wp 300-390 of W = 512, padding at 1e8): the
    redesigned search's winner is bitwise the full search's at every query. The
    real waypoints alone are not enough: far off the track a padding waypoint is
    the nearest, and the box bound sends those queries to the padding."""
    pool = canonical_bench_pool(16, device="cpu")
    qx, qy = _queries(np.random.default_rng(2), pool)
    rows = [pool.wp_x[:, None, :], pool.wp_y[:, None, :]]
    n_wp = pool.n_wp[:, None]
    full = tgeo.waypoint_search_model(_t(qx), _t(qy), *rows, n_wp, real_first=False)
    first = tgeo.waypoint_search_model(_t(qx), _t(qy), *rows, n_wp)
    assert torch.equal(full, first)
    padding_wins = full >= n_wp
    assert bool(padding_wins.any()) and bool((full[:, :64] < n_wp).all())
    assert bool((full == tgeo.NO_WAYPOINT).any())
    # the full search is torch.argmin's wherever a d^2 is finite
    d2 = (_t(qx)[..., None] - rows[0]) ** 2 + (_t(qy)[..., None] - rows[1]) ** 2
    finite = torch.isfinite(d2).any(dim=-1)
    assert torch.equal(full[finite], torch.argmin(torch.where(torch.isnan(d2), np.inf, d2),
                                                  dim=-1)[finite])


@pytest.mark.parametrize("n_wp", [0, 1, 31, 32, 33, 330, 511, 512, 600])
def test_real_waypoints_first_at_every_count(n_wp):
    """Counts from none to all W (and past it), the padding anywhere: the same
    winners as the full search."""
    rng = np.random.default_rng(n_wp)
    wx, wy = (rng.uniform(-60, 60, (8, 1, 512)).astype(np.float32) for _ in range(2))
    qx, qy = (rng.uniform(-90, 90, (8, 40)).astype(np.float32) for _ in range(2))
    args = (_t(qx), _t(qy), _t(wx), _t(wy), torch.full((8, 1), n_wp))
    assert torch.equal(tgeo.waypoint_search_model(*args),
                       tgeo.waypoint_search_model(*args, real_first=False))


@pytest.mark.parametrize("cars,sensors,per_car,rows_per_block", [
    (1, 11, True, 4), (2, 11, True, 2), (8, 11, True, 1), (3, 7, False, 2),
    (2, 7, False, 2), (16, 11, True, 1)])
def test_observe_plan_groups_rays_by_car(cars, sensors, per_car, rows_per_block):
    """A group is one car's rays wherever K1's grouping gives one car a group (2 x
    11: the self-play launch); at 3 x 7 a group spans two cars. A block stages as
    many rows as give it 4 warps, a warp a group and row (at most 8)."""
    plan = _cuda.multi_observe_plan(cars, sensors, S)
    assert plan.per_car == per_car and plan.rows_per_block == rows_per_block
    assert plan.rays_per_lane in _cuda.K1_RAYS_PER_LANE_CHOICES
    assert not per_car or plan.rays_per_lane == sensors
    groups = -(-cars * sensors // plan.rays_per_lane)
    assert plan.threads == 32 * min(8, rows_per_block * groups) >= 32 * rows_per_block


@pytest.mark.parametrize("segments,cars,overlay", [
    (768, 2, True), (896, 2, True), (896, 8, False), (4096, 2, True), (11_000, 2, True),
    (64, 2, False)])
def test_observe_plan_fits_in_a_block(segments, cars, overlay):
    """The procgen (768) and canonical (896) rows, rows far longer than the pool
    builders make and a short one: within 227 KB, fewer rows a block where needed;
    the staged fields hold S floats, with no padding to 32 runs (a field's stage a
    multiple of 16 bytes, as the bulk copies need); the run results take the staged
    rows' place where every item has a thread and they fit there (not at 8 cars:
    88 rays' results outgrow a row of 896 segments)."""
    plan = _cuda.multi_observe_plan(cars, 11, segments)
    assert plan.smem <= _cuda.BLOCK_SMEM_LIMIT
    assert (-(-segments // 4) * 4 + 4) * 4 % 16 == 0
    assert plan.overlay == overlay
    rays = cars * 11
    slots = -(-rays // plan.rays_per_lane) * plan.rays_per_lane
    row = (5 * (-(-segments // 4) * 4 + 4) + 5 * slots + 18 * cars + rays * cars
           + (0 if overlay else 2 * 33 * slots))
    assert plan.smem == plan.rows_per_block * row * 4
    assert plan.rows_per_block == (1 if segments == 11_000 else max(1, 4 // -(-rays // 11)))
    fewer = _cuda._observe_shape(cars, 11, segments, plan.rows_per_block, plan.rows_per_block)
    assert not fewer.overlay or fewer.threads // 32 >= fewer.rows_per_block * -(-rays // 11)


@pytest.mark.parametrize("rows,observe_small,transition_small", [
    (None, False, False), (4096, False, False), (2048, False, False), (1536, False, True),
    (640, False, True), (639, True, True), (200, True, True), (40, True, True)])
def test_plans_take_the_first_kernels_on_few_rows(rows, observe_small, transition_small):
    """Under OBSERVE_SMALL_BELOW (640) and TRANSITION_SMALL_BELOW (2048) env rows (a
    match's 40, an evaluation's 200) the plans launch the first kernels, a block a
    row, as their own plans say; from there on the redesigned ones, whose plans do
    not depend on the row count."""
    observe = _cuda.multi_observe_plan(2, 11, S, rows)
    transition = _cuda.multi_transition_plan(2, 512, True, rows)
    assert (observe.small, transition.small) == (observe_small, transition_small)
    first_obs = _cuda.raycast_walls_and_cars_plan(2, 11, S)
    first_tr = _cuda.car_step_query_plan(2, 512, True, tail=True)
    if observe_small:
        assert (observe.threads, observe.smem, observe.rays_per_lane) == (
            first_obs.threads, first_obs.smem, first_obs.rays_per_lane)
        assert observe.rows_per_block == 1 and not observe.per_car and not observe.overlay
    else:
        assert observe == _cuda.multi_observe_plan(2, 11, S)
    if transition_small:
        assert (transition.threads, transition.smem, transition.rows_per_block) == (
            first_tr.threads, first_tr.smem, 1)
    else:
        assert transition == _cuda.multi_transition_plan(2, 512, True)


def test_plans_refuse_what_the_kernels_cannot_take():
    """Past 227 KB for one row, or without a segment or waypoint, the plans refuse,
    for the redesigned kernels and, on few rows, for the first ones."""
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.multi_observe_plan(2, 11, 11_600)
    with pytest.raises(ValueError, match="segment"):
        _cuda.multi_observe_plan(2, 11, 0)
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.multi_observe_plan(2, 11, 11_600, 40)
    with pytest.raises(ValueError, match="segment"):
        _cuda.multi_observe_plan(2, 11, 0, 40)
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.multi_transition_plan(2, 29_100, True)
    with pytest.raises(ValueError, match="waypoint"):
        _cuda.multi_transition_plan(2, 0, True)
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.multi_transition_plan(2, 29_100, True, 40)


@pytest.mark.parametrize("cars,waypoints,rows,warps", [
    (1, 512, 8, 4), (2, 512, 4, 4), (3, 384, 2, 4), (8, 512, 1, 4), (20, 512, 1, 4),
    (2, 4096, 4, 4), (2, 14_000, 2, 4)])
def test_transition_plan(cars, waypoints, rows, warps):
    """A block serves 8 cars' rows (fewer where 227 KB do not hold them), a warp a car
    for the search (4 warps, looping over the rest); its rows' positions (two fields
    of W floats), 18 words a car and 2 a row in shared memory."""
    plan = _cuda.multi_transition_plan(cars, waypoints, cars > 1)
    assert plan.rows_per_block == rows and plan.threads == 32 * warps
    assert plan.smem == rows * (2 * (-(-waypoints // 4) * 4 + 4) + 2 + 18 * cars) * 4
    assert plan.smem <= _cuda.BLOCK_SMEM_LIMIT


def _vertex_rows(rng, n, r, dtype):
    """Rows of one car each: r rays from one origin, a segment soup [n, 1, S] whose
    first segments form a diamond of vertices on the axes around the origin (a ray
    along an axis passes exactly through a vertex shared by two segments; the rays
    at +-pi/2 from cos and sin pass within the last bit of one), then random walls,
    then zero-direction padding."""
    ox, oy = np.zeros((2, n))
    ox[1::2] = rng.uniform(-0.5, 0.5, n // 2)  # some origins off the axes' crossing
    ang = np.concatenate([np.arange(8) * np.pi / 4, [np.pi / 2, -np.pi / 2, 1.0]])[:r]
    dx = np.broadcast_to(np.cos(ang), (n, r)).copy()
    dy = np.broadcast_to(np.sin(ang), (n, r)).copy()
    dx[:, [0, 4]], dy[:, [0, 4]] = [1.0, -1.0], 0.0    # exactly along the x axis
    dx[:, [2, 6]], dy[:, [2, 6]] = 0.0, [1.0, -1.0]    # and the y axis
    _, segs = _soup(rng, n, r, S, np.float64, n_pad=S - 600)
    corners = np.array([[10.0, 0.0], [0.0, 10.0], [-10.0, 0.0], [0.0, -10.0]])
    for k in range(4):
        a, b = corners[k], corners[(k + 1) % 4]
        segs[0][:, :, k], segs[1][:, :, k] = a
        segs[2][:, :, k], segs[3][:, :, k] = b - a
    segs[4] = segs[3] * segs[0] - segs[2] * segs[1]
    rays = [np.broadcast_to(ox[:, None], (n, r)), np.broadcast_to(oy[:, None], (n, r)), dx, dy]
    return [a.astype(dtype) for a in rays], [a.astype(dtype) for a in segs]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rays_per_group", [4, 6])
def test_one_cars_rays_in_groups_are_the_ungrouped_fold_bitwise(dtype, rays_per_group):
    """The single-car observation's shape (``ops/_cuda.py:single_observe_plan``): a
    row's 11 rays, one car's, in groups of 4 or 6, each segment's cross term formed
    once a group from the group's first ray: bitwise the ungrouped fold, stopped at
    the real extent as the kernel stops, on the canonical pool's rows and on rows
    whose rays pass through a vertex; the grouping rule holds these groups to be one
    car's. Two cars' rays in groups of 6 are not (a group holds both cars' rays), and
    there the grouped cross term would change the result."""
    assert _cuda.groups_are_cars(1, 11, rays_per_group)
    rng = np.random.default_rng(rays_per_group)
    pool = canonical_bench_pool(16, dtype=torch.float64, device="cpu")
    cases = [_pool_rays(rng, pool, 11, dtype), _vertex_rows(rng, 16, 11, dtype)]
    for rays, segs in cases:
        whole = _shape(rays, segs, stop_at_extent=True)
        grouped = tgeo.raycast_walls_fold_shape(
            *map(_t, rays), *map(_t, segs[:4]), MAX_DIST, seg_c=_t(segs[4]),
            stop_at_extent=True, rays_per_group=rays_per_group)
        assert torch.equal(_bits(whole), _bits(grouped))
        assert bool((whole < MAX_DIST).any())
    assert bool((whole[:, [0, 2, 4, 6]] < MAX_DIST).all())  # the diamond's vertices hit
    # two cars a row: the second car's origin elsewhere
    rays2 = [np.concatenate([a, a + (3.0 if k < 2 else 0.0)], axis=-1).astype(dtype)
             for k, a in enumerate(cases[0][0])]
    assert not _cuda.groups_are_cars(2, 11, 6)
    whole = _shape(rays2, cases[0][1], stop_at_extent=True)
    grouped = tgeo.raycast_walls_fold_shape(
        *map(_t, rays2), *map(_t, cases[0][1][:4]), MAX_DIST, seg_c=_t(cases[0][1][4]),
        stop_at_extent=True, rays_per_group=6)
    assert not torch.equal(_bits(whole), _bits(grouped))


@pytest.mark.parametrize("sensors,segments,rows_per_block", [
    (11, 896, None), (11, 768, None), (7, 896, None), (11, 11_000, 1)])
def test_single_observe_plan(sensors, segments, rows_per_block):
    """The single-car observation's launch at every width: a row's rays in
    ``SINGLE_OBSERVE_GROUPS`` groups of the fewest rays a lane that give as many (11
    rays: 6 a lane for 2 groups, 4 for 3, 3 for 4), each group the one car's rays, so
    the kernel forms the cross term once a group; ``SINGLE_OBSERVE_ROWS`` rows a
    block, fewer where 227 KB do not hold them; a warp a group and row, the run
    results over the staged rows. On per-env rows in ``SINGLE_OBSERVE_MULTI_PLAN_ROWS``
    (where the grouped plan's one wave is spent and the multi-car plan's is not) the
    multi-car plan; on the tiled layout the grouped plan at every width. The
    multi-car plans are not moved (one car: a warp a row's 11 rays, four rows a block;
    the first kernel on few rows)."""
    plan = _cuda.single_observe_plan(sensors, segments)
    band = _cuda.SINGLE_OBSERVE_MULTI_PLAN_ROWS
    for rows in (1, 640, band[0] - 1, band[-1] + 1, 4096):
        assert _cuda.single_observe_plan(sensors, segments, False, rows) == plan
    for rows in (band[0], band[-1]):
        assert _cuda.single_observe_plan(sensors, segments, False, rows) == (
            _cuda.multi_observe_plan(1, sensors, segments, rows))
        assert _cuda.single_observe_plan(sensors, segments, True, rows) == (
            _cuda.single_observe_plan(sensors, segments, True))
    groups = _cuda.SINGLE_OBSERVE_GROUPS
    even = -(-sensors // groups)
    assert plan.rays_per_lane == min(r for r in _cuda.K1_RAYS_PER_LANE_CHOICES if r >= even)
    assert -(-sensors // plan.rays_per_lane) == groups and plan.per_car and not plan.small
    assert plan.rows_per_block == (rows_per_block or _cuda.SINGLE_OBSERVE_ROWS)
    assert plan.threads == 32 * min(8, plan.rows_per_block * groups) and plan.overlay
    assert plan.smem <= _cuda.BLOCK_SMEM_LIMIT - _cuda.STATIC_SMEM_RESERVE
    assert plan == _cuda._observe_shape(1, sensors, segments, plan.rows_per_block,
                                        rays_per_lane=plan.rays_per_lane)
    assert _cuda.multi_observe_plan(1, 11, 896) == _cuda.ObservePlan(
        128, 4 * (5 * _cuda._field_capacity(896) + 11 * 5 + 18 + 11) * 4, 11, True, 4, True)
    assert _cuda.multi_observe_plan(1, 11, 896, 1).small
    # on the tiled layout a block's rows share one staged row: the five fields once,
    # the ray tables and run results of every row (the results over the staged row)
    shared = _cuda.single_observe_plan(sensors, segments, shared_row=True)
    rows, groups = shared.rows_per_block, _cuda.SINGLE_OBSERVE_SHARED_GROUPS
    assert shared.shared_row and rows <= _cuda.SINGLE_OBSERVE_SHARED_ROWS
    assert -(-sensors // shared.rays_per_lane) == groups and shared.per_car
    assert shared.threads == 32 * min(8, rows * groups)
    slots = groups * shared.rays_per_lane
    stage = 5 * _cuda._field_capacity(segments)
    assert shared.overlay == (stage >= 2 * 33 * slots * rows)
    assert shared.smem == (stage + rows * (5 * slots + 18 + sensors)
                           + (0 if shared.overlay else 2 * 33 * slots * rows)) * 4
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.single_observe_plan(11, 11_600)
    with pytest.raises(ValueError, match="segment"):
        _cuda.single_observe_plan(11, 0)
