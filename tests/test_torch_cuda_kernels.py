"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA card (the kernels have no CPU mode). On a machine with one
(``--noconftest``: the repo's conftest sets up JAX, which such a machine may lack):

  python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerance: K2 exact, also with waypoint rows shared by the cars of a row. K1
hit/no-hit identical and distances bitwise equal, except rays that are near-ties
(two hit ratios equal to within the rounding of the cross products), which may
differ by at most 2 ulp. Both are held at every row length their staging and
layouts treat apart, on rows off 16-byte alignment, and with more rows (one block
each) than an H100 holds blocks at once. K3 (rays against cars), K4 (car-pair SAT) and K5 (car
dynamics) bitwise equal to their plain versions: the kernels keep the plain
versions' operation order, build without FMA contraction and divide and take
square roots as IEEE; K5 calls the same cosf/sinf as PyTorch's CUDA cos/sin. K6
(GAE) bitwise equal: the kernel walks the plain version's order and is built
without FMA contraction. K7 (the epoch permutations) exactly equal, and a
permutation. The envs' two kernels: ``raycast_walls_and_cars`` bitwise equal to
``torch.minimum`` of the K1 and K3 kernels on the rays and corners PyTorch forms
(what the multi-car env launched before), and to its plain version by K1's rule
(its wall part is K1's fold); ``car_step_and_query`` bitwise equal to its plain
version and to the K5 kernel, ``car_corners`` and the K2 kernel one after another,
and with the pair test bitwise equal to that chain followed by K4, the mask, the sum
and the velocity ladder. With row ids (the capacity layouts: the pool's rows
resident, env i reading row ``row_ids[i]``) each of K1, ``raycast_walls_and_cars``
and ``car_step_and_query`` is bitwise itself on the gathered rows, and its plain
version as above, with ids that repeat, skip rows and come out of order. The
multi-car env's step (``multi.transition`` and ``multi.observe``, one launch each:
the narrow env kernels with the reward tail and the observation row in their
blocks) bitwise, -0.0 apart from 0.0, equal to its plain version (the narrow kernel
and PyTorch around it, what the env ran before) at 1, 2, 3 and 8 cars on per-env
rows and by row id. Their redesign (``csrc/multi_observe.cu``,
``csrc/multi_transition.cu``) the same way on rows whose real extent sits at the
fold's run boundaries, on rows off 16-byte alignment and with cars far off the
track, the observation also bitwise the fold's shape model
(``chip_smoke.shape_model_observe``). The PPO minibatch step's two kernels
(``ops/minibatch.py``): ``ppo_head``'s forward and backward (the loss past the MLPs
and its gradients) and ``adam_tail`` against their plain compositions on rows that
take every branch, at 1 to 65,536 rows, on a group's flat-buffer gradients, and over
a whole update: d/d mu, d/d v and the tail bitwise, the head's stats bitwise its
transcription (``chip_smoke.head_sums_model``) and within ``ops/minibatch.py``'s
``SUM_REL_FLOOR`` / ``SUM_CONTROL_FACTOR`` rule of the float64 sums, clip_frac
bitwise; the head also through the minibatch's unit index (the rollout's units read
in place) and with one input's gradient not asked for, the tail as one thread block
cluster on 1 to 32 tensors and over 16 replays of a CUDA graph; the advantage
moments (``advantage_moments``, one launch an update) bitwise their transcription
and within the same rule (``chip_smoke.hold_moments``). The single-car
env's step (``single.transition``, ``csrc/single_transition.cu``, and
``single.observe``, the multi-car observation kernel at one car a row without its
car pass; one launch each) bitwise, -0.0 apart from 0.0, its plain version (the
narrow kernels and PyTorch) at 1 to 5008 rows, per-env and by row id, with the
speed weight a constant and an annealed tensor, the sensing clamped and not; the
transition's kernel of several rows a block too (on no path, forced) at widths that
leave a block part-filled. The minibatch step's actor and critic MLPs
(``ops/mlp.py``, ``csrc/mlp_towers.cu``: one launch forward, two backward) within
chip_smoke.py phase p's tolerance of the plain composition (cuBLAS and autograd) at
every instantiated (obs_dim, hidden) and 1 to 65,536 rows, two runs bitwise,
through the unit index bitwise the gathered rows, graph replays bitwise eager, the
forward row-invariant bitwise, an update launching each kernel once a minibatch
step, and float64, non-contiguous and unlisted towers refused. The reduce's global
norm (``ppo.norm_route``): within phase p's norm tolerance of the float64 norm of
the same flat at every tower, the flat bitwise the norm-less launch's, the
norm-only mode bitwise the fused norm, graph replays bitwise with the ticket's
counter back at 0, and no ``global_norm`` composition left in a no-group update.
The rollout step's policy (``ops/policy.py``, ``csrc/policy.cu``): kernel A (the
normaliser, both towers, the sample and its log-prob, row t of the rollout's
buffers) and kernel B (the pool opponents' actions) as chip_smoke.py phase q holds
them: mu and v within phase p's tolerance of the composition, everything after the
towers bitwise the composition on the kernels' own mu, graph replays bitwise eager,
refusals before any launch; a rollout launching kernel A once a step and kernel B
once a self-play step, and each update's first minibatch at approx_kl and clip_frac
exactly 0. The transitions' autoreset mode (``csrc/autoreset.cuh``: the NEXT_STEP reset,
the merge, the info, the masks, the episode statistics, the rollout's rows and the PFSP
counts in the transition's launch) bitwise the composition, the plain mode and the
PyTorch glue, at 16, 1279/1280, 2047/2048 and 4096 rows, and graph replays bitwise
eager.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_dist_workers import group_of_one
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.envs import multi as menv
from self_play_racing_tpu_torch.envs import single as senv
from self_play_racing_tpu_torch.envs import track as trk
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import dynamics
from self_play_racing_tpu_torch.ops import gae
from self_play_racing_tpu_torch.ops import geometry as geo
from self_play_racing_tpu_torch.ops import minibatch as mbops
from self_play_racing_tpu_torch.ops import mlp as mlpops
from self_play_racing_tpu_torch.ops import prng
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_k1_close(k, p, max_dist):
    assert torch.equal(k == max_dist, p == max_dist)
    ulp = torch.nextafter(p.abs(), torch.full_like(p, float("inf"))) - p.abs()
    assert bool(((k - p).abs() <= 2 * ulp).all())


def _soup(rng, rows, segs, dev):
    f = lambda *shape, lo, hi: torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                                               device=dev)
    sx, sy = f(rows, segs, lo=-40, hi=40), f(rows, segs, lo=-40, hi=40)
    vx, vy = f(rows, segs, lo=-15, hi=15), f(rows, segs, lo=-15, hi=15)
    for t in (sx, sy, vx, vy):
        t[:, -7:] = 0.0  # zero-direction padding
    return sx, sy, vx, vy


@pytest.mark.parametrize("rays,segs,with_c", [(11, 896, True), (40, 300, True),
                                               (3, 3000, False), (1, 37, True)])
def test_raycast_kernel_matches_plain(cuda, rays, segs, with_c):
    rng = np.random.default_rng(rays + segs)
    rows = 64
    sx, sy, vx, vy = _soup(rng, rows, segs, cuda)
    c = vy * sx - vx * sy if with_c else None
    ang = torch.as_tensor(rng.uniform(0, 6.3, (rows, rays)), dtype=torch.float32, device=cuda)
    ox = torch.as_tensor(rng.uniform(-20, 20, (rows, 1)), dtype=torch.float32,
                         device=cuda).expand(rows, rays)
    oy = torch.as_tensor(rng.uniform(-20, 20, (rows, 1)), dtype=torch.float32,
                         device=cuda).expand(rows, rays)
    seg_args = [t[:, None, :] for t in (sx, sy, vx, vy)]
    c_arg = None if c is None else c[:, None, :]
    before = geo.raycast_walls_launches
    k = geo.raycast_walls(ox, oy, torch.cos(ang), torch.sin(ang), *seg_args, 50.0, seg_c=c_arg)
    assert geo.raycast_walls_launches == before + 1
    p = geo.raycast_walls_plain(ox, oy, torch.cos(ang), torch.sin(ang), *seg_args, 50.0,
                                seg_c=c_arg)
    torch.cuda.synchronize()
    _assert_k1_close(k, p, 50.0)
    # one ray per row against [rows, S] segments: the same rows, flat layout
    k1 = geo.raycast_walls(ox[:, 0].contiguous(), oy[:, 0].contiguous(), torch.cos(ang[:, 0]),
                           torch.sin(ang[:, 0]), sx, sy, vx, vy, 50.0, seg_c=c)
    _assert_k1_close(k1, p[:, 0], 50.0)


def test_raycast_kernel_padding_rows(cuda):
    sx = torch.tensor([-5.0, -3.0, -8.0, 0, 0, 0, 0], device=cuda)
    sy = torch.tensor([-2.0, 1.0, 4.0, 0, 0, 0, 0], device=cuda)
    vx = torch.tensor([0.0, 1.5, 2.0, 0, 0, 0, 0], device=cuda)
    vy = torch.tensor([3.0, 0.5, -1.0, 0, 0, 0, 0], device=cuda)
    ox = torch.tensor([1.0, 1.0, 1.0, -4.0], device=cuda)
    oy = torch.tensor([0.0, 2.5, -4.0, 0.0], device=cuda)
    dx = torch.tensor([1.0, 1.0, 1.0, -1.0], device=cuda)
    dy = torch.zeros(4, device=cuda)
    k = geo.raycast_walls(ox, oy, dx, dy, sx, sy, vx, vy, 50.0)
    assert k[:3].tolist() == [50.0, 50.0, 50.0] and abs(float(k[3]) - 1.0) < 1e-6
    assert torch.equal(k, geo.raycast_walls_plain(ox, oy, dx, dy, sx, sy, vx, vy, 50.0))


# More rows than an H100 holds blocks at once (32 a block per SM, 132 SMs), so that
# K1 and K2, one block per row, run in more than one wave.
ROWS_PAST_ONE_WAVE = 5000


def _f32(rng, shape, lo, hi, dev, offset=0):
    """Uniform float32 on the card; ``offset`` > 0 starts it that many floats into
    its storage, so that rows are not 16-byte-aligned."""
    flat = torch.as_tensor(rng.uniform(lo, hi, int(np.prod(shape)) + offset),
                           dtype=torch.float32, device=dev)
    return flat[offset:].view(shape)


def _shifted(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` floats into its storage."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:] = t.flatten()
    return buf[offset:].view(t.shape)


def _raycast_case(cuda, rng, rows, rays, segs, offset=0, with_c=True):
    sx, sy = (_f32(rng, (rows, 1, segs), -40, 40, cuda, offset) for _ in range(2))
    vx, vy = (_f32(rng, (rows, 1, segs), -15, 15, cuda, offset) for _ in range(2))
    if segs > 7:
        for t in (sx, sy, vx, vy):
            t[..., -7:] = 0.0  # zero-direction padding
    c = (vy * sx - vx * sy) if with_c else None
    ang = _f32(rng, (rows, rays), 0, 6.3, cuda)
    ox, oy = (_f32(rng, (rows, 1), -20, 20, cuda).expand(rows, rays) for _ in range(2))
    args = (ox, oy, torch.cos(ang), torch.sin(ang), sx, sy, vx, vy, 50.0)
    before = geo.raycast_walls_launches
    k = geo.raycast_walls(*args, seg_c=c)
    assert geo.raycast_walls_launches == before + 1
    p = geo.raycast_walls_plain(*args, seg_c=c)
    torch.cuda.synchronize()
    _assert_k1_close(k, p, 50.0)
    return k


@pytest.mark.parametrize("rays", [1, 11, 22, 40])
@pytest.mark.parametrize("segs", [1, 31, 33, 864, 896, 1023, 1024])
def test_raycast_kernel_over_row_lengths_and_rays(cuda, segs, rays):
    """Every row length the staging treats apart (S below a warp, odd and even run
    lengths, a 32-way bank conflict per read at S = 1024, rows that are not a
    multiple of 4 floats), with more rows than the card holds blocks at once."""
    k = _raycast_case(cuda, np.random.default_rng(segs * 100 + rays), ROWS_PAST_ONE_WAVE,
                      rays, segs)
    if segs > 30:
        assert float((k < 50.0).float().mean()) > 0.05  # the rays do hit walls


@pytest.mark.parametrize("segs,offset,with_c", [(31, 1, True), (896, 2, True), (1023, 3, False),
                                                (1024, 1, True), (33, 2, False)])
def test_raycast_kernel_takes_rows_off_16_byte_alignment(cuda, segs, offset, with_c):
    """Segment fields that start off a 16-byte boundary: the bulk copies take the
    aligned middle of each row and the lanes the head and tail."""
    _raycast_case(cuda, np.random.default_rng(offset * segs), 700, 11, segs, offset, with_c)


def test_raycast_kernel_rows_of_padding_only(cuda):
    rows, rays, segs = 300, 22, 896
    zeros = torch.zeros((rows, 1, segs), device=cuda)
    ang = torch.linspace(0, 6.28, rows * rays, device=cuda).view(rows, rays)
    o = torch.ones((rows, rays), device=cuda)
    args = (o, o, torch.cos(ang), torch.sin(ang), zeros, zeros, zeros, zeros, 50.0)
    k = geo.raycast_walls(*args, seg_c=zeros)
    assert bool((k == 50.0).all())
    assert torch.equal(k, geo.raycast_walls_plain(*args, seg_c=zeros))


def test_raycast_kernel_near_ties_on_the_canonical_pool(cuda):
    """The canonical pool at chip_smoke.py's poses (seed 0), where rays pass near
    segment ends: single-car rays [4096, 11] and the self-play launch [4096, 2, 11]
    against [4096, 1, 1, 896] rows, held to the plain version by the 2-ulp rule."""
    from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool

    track = trk.gather_tracks(canonical_bench_pool(16, device=cuda), np.arange(4096) % 16)
    rng = np.random.default_rng(0)
    fields = ("seg_sx", "seg_sy", "seg_vx", "seg_vy", "seg_c")
    for cars in (1, 2):
        i = torch.as_tensor(rng.integers(0, track.n_wp.cpu().numpy()), device=cuda)
        rows = torch.arange(4096, device=cuda)
        x = (track.wp_x[rows, i][:, None] + _f32(rng, (4096, cars), -8, 8, cuda)).contiguous()
        y = (track.wp_y[rows, i][:, None] + _f32(rng, (4096, cars), -8, 8, cuda)).contiguous()
        world = _f32(rng, (4096, cars, 1), 0, 6.3, cuda) + torch.linspace(
            -1.57, 1.57, 11, device=cuda)
        segs = [getattr(track, f)[:, None, None, :] for f in fields]
        args = (x[..., None].expand(world.shape), y[..., None].expand(world.shape),
                torch.cos(world), torch.sin(world), *segs[:4], 200.0)
        k = geo.raycast_walls(*args, seg_c=segs[4])
        p = geo.raycast_walls_plain(*args, seg_c=segs[4])
        torch.cuda.synchronize()
        _assert_k1_close(k, p, 200.0)


@pytest.mark.parametrize("cars", [1, 2, 8])
@pytest.mark.parametrize("waypoints,offset", [(1, 0), (33, 0), (512, 0), (600, 0), (33, 1),
                                              (600, 3), (513, 2)])
def test_progress_kernel_over_row_lengths_and_cars(cuda, waypoints, offset, cars):
    """Cars [N, A] against waypoint rows [N, 1, W] of every length the staging
    treats apart, some off 16-byte alignment, more rows than the card holds blocks
    at once: progress and crashed exactly equal to the plain version."""
    rng = np.random.default_rng(waypoints * 10 + cars + offset)
    rows = ROWS_PAST_ONE_WAVE
    t = torch.linspace(0, 6.283, waypoints, device=cuda)
    radius = _f32(rng, (rows, 1, 1), 20, 40, cuda)
    wp_x = _shifted(radius * torch.cos(t) + _f32(rng, (rows, 1, waypoints), -1, 1, cuda), offset)
    wp_y = _shifted(radius * torch.sin(t) + _f32(rng, (rows, 1, waypoints), -1, 1, cuda), offset)
    nrm = _f32(rng, (rows, 1, waypoints), 0, 6.3, cuda)
    nx, ny = _shifted(torch.cos(nrm), offset), _shifted(torch.sin(nrm), offset)
    x, y = (_f32(rng, (rows, cars), -35, 35, cuda) for _ in range(2))
    cx, cy = geo.car_corners(x, y, _f32(rng, (rows, cars), 0, 6.3, cuda), 2.0, 1.0)
    n_wp = torch.as_tensor(rng.integers(1, waypoints + 1, (rows, 1)), dtype=torch.int32,
                           device=cuda)
    width = _f32(rng, (rows, 1), 3, 9, cuda)
    args = (x, y, cx, cy, wp_x, wp_y, nx, ny, n_wp, width)
    before = geo.progress_and_collision_launches
    kp, kc = geo.progress_and_collision(*args)
    assert geo.progress_and_collision_launches == before + 1
    pp, pc = geo.progress_and_collision_plain(*args)
    torch.cuda.synchronize()
    assert kp.shape == (rows, cars)
    assert torch.equal(kp, pp) and torch.equal(kc, pc)
    if waypoints > 1:
        assert 0 < int(kc.sum()) < rows * cars


@pytest.mark.parametrize("batch", [(64,), (8, 3)])
def test_progress_kernel_matches_plain(cuda, batch):
    rng = np.random.default_rng(len(batch))
    np.random.seed(2)
    pool = trk.make_track_pool(trk.gen_tracks(4, seed=2), 7.0, device=cuda)
    n = int(np.prod(batch))
    ids = np.arange(n) % 4
    track = trk.gather_tracks(pool, ids)
    i = torch.as_tensor(rng.integers(0, track.n_wp.cpu().numpy()), device=cuda)
    rows = torch.arange(n, device=cuda)
    x = track.wp_x[rows, i] + torch.as_tensor(rng.uniform(-7, 7, n), dtype=torch.float32,
                                              device=cuda)
    y = track.wp_y[rows, i] + torch.as_tensor(rng.uniform(-7, 7, n), dtype=torch.float32,
                                              device=cuda)
    ang = torch.as_tensor(rng.uniform(0, 6.3, n), dtype=torch.float32, device=cuda)
    cx, cy = geo.car_corners(x, y, ang, 2.0, 1.0)
    shape = lambda t: t.reshape(batch + t.shape[1:]).contiguous()
    args = [shape(t) for t in (x, y, cx, cy, track.wp_x, track.wp_y, track.nrm_x, track.nrm_y,
                               track.n_wp, track.track_width)]
    kp, kc = geo.progress_and_collision(*args)
    pp, pc = geo.progress_and_collision_plain(*args)
    assert torch.equal(kp, pp) and torch.equal(kc, pc)
    assert 0 < int(kc.sum()) < n


def _cars(rng, rows, a, dev, spread=8.0):
    f = lambda *shape, lo, hi: torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                                               device=dev)
    x, y = f(rows, a, lo=-spread, hi=spread), f(rows, a, lo=-spread, hi=spread)
    ang = f(rows, a, lo=0, hi=6.3)
    cx, cy = geo.car_corners(x, y, ang, 2.0, 1.0)
    return x, y, ang, cx.contiguous(), cy.contiguous()


@pytest.mark.parametrize("a,rays", [(2, 11), (8, 11), (3, 100), (1, 5)])
def test_raycast_cars_kernel_matches_plain(cuda, a, rays):
    rng = np.random.default_rng(a * rays)
    rows = 512
    x, y, ang, cx, cy = _cars(rng, rows, a, cuda)
    # every car casts rays from its own centre (its own body skipped), as the env does
    world = ang[:, :, None] + torch.linspace(-1.57, 1.57, rays, device=cuda)
    per_car = (rows, a, rays)
    ox, oy = x[:, :, None].expand(per_car), y[:, :, None].expand(per_car)
    args = (ox, oy, torch.cos(world), torch.sin(world), cx[:, None, None], cy[:, None, None],
            x[:, None, None, :].contiguous(), y[:, None, None, :].contiguous(), 50.0)
    before = geo.raycast_cars_launches
    k = geo.raycast_cars(*args)
    assert geo.raycast_cars_launches == before + 1
    p = geo.raycast_cars_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    if a > 1:
        assert 0.01 < float((k < 50.0).float().mean()) < 0.99


@pytest.mark.parametrize("a", [1, 2, 3, 8])
def test_rectangles_intersect_kernel_matches_plain(cuda, a):
    rng = np.random.default_rng(a)
    _, _, _, cx, cy = _cars(rng, 2048, a, cuda, spread=4.0)
    before = geo.rectangles_intersect_launches
    k = geo.rectangles_intersect_pairs(cx, cy)
    assert geo.rectangles_intersect_launches == before + 1
    p = geo.rectangles_intersect_pairs_plain(cx, cy)
    assert k.shape == (2048, a, a) and torch.equal(k, p)
    assert k[:, range(a), range(a)].all()
    if a > 1:
        off = k[:, ~torch.eye(a, dtype=torch.bool, device=cuda)]
        assert 0.05 < float(off.float().mean()) < 0.95


@pytest.mark.parametrize("shape", [(4096, 2), (4096,), (3, 5, 7)])
def test_car_update_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(len(shape))
    f = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                                       device=cuda)
    args = (f(-80, 80), f(-80, 80), f(-7, 7), f(-35, 35), f(-35, 35),
            torch.as_tensor(rng.random(shape) < 0.2, device=cuda), f(-1, 1), f(0, 1))
    before = dynamics.car_update_launches
    k = dynamics.car_update(*args, 0.05)
    assert dynamics.car_update_launches == before + 1
    p = dynamics.car_update_plain(*args, 0.05)
    torch.cuda.synchronize()
    for name, a, b in zip(("x", "y", "angle", "vx", "vy"), k, p):
        assert a.shape == shape and torch.equal(a, b), name
    # non-contiguous inputs are taken (the kernel reads contiguous copies)
    k2 = dynamics.car_update(*(t.T.contiguous().T if t.ndim == 2 else t for t in args), 0.05)
    assert all(torch.equal(a, b) for a, b in zip(k2, p))


def test_progress_kernel_takes_rows_that_lead_the_cars(cuda):
    """Cars [N, A] against waypoint rows [N, 1, W]: equal to the plain version and to
    a launch on rows expanded per car."""
    rng = np.random.default_rng(5)
    np.random.seed(2)
    pool = trk.make_track_pool(trk.gen_tracks(4, seed=2), 7.0, device=cuda)
    n, a = 256, 3
    track = trk.gather_tracks(pool, np.arange(n) % 4)
    i = torch.as_tensor(rng.integers(0, track.n_wp.cpu().numpy()), device=cuda)
    rows = torch.arange(n, device=cuda)
    jitter = lambda: torch.as_tensor(rng.uniform(-7, 7, (n, a)), dtype=torch.float32, device=cuda)
    x = (track.wp_x[rows, i][:, None] + jitter()).contiguous()
    y = (track.wp_y[rows, i][:, None] + jitter()).contiguous()
    ang = torch.as_tensor(rng.uniform(0, 6.3, (n, a)), dtype=torch.float32, device=cuda)
    cx, cy = geo.car_corners(x, y, ang, 2.0, 1.0)
    wp = [t[:, None, :] for t in (track.wp_x, track.wp_y, track.nrm_x, track.nrm_y)]
    shared = (x, y, cx, cy, *wp, track.n_wp[:, None], track.track_width[:, None])
    kp, kc = geo.progress_and_collision(*shared)
    pp, pc = geo.progress_and_collision_plain(*shared)
    ep, ec = geo.progress_and_collision(
        x, y, cx, cy, *(t.expand(n, a, t.shape[-1]).contiguous() for t in wp),
        track.n_wp[:, None], track.track_width[:, None])
    assert kp.shape == (n, a)
    assert torch.equal(kp, pp) and torch.equal(kc, pc)
    assert torch.equal(kp, ep) and torch.equal(kc, ec)
    assert 0 < int(kc.sum()) < n * a


def test_kernels_reject_what_they_do_not_take(cuda):
    seg = torch.zeros((2, 16), device=cuda)
    ray = torch.zeros((2,), device=cuda)
    with pytest.raises(TypeError):
        geo.raycast_walls(ray.double(), ray, ray, ray, *(seg.double(),) * 4, 50.0)
    with pytest.raises(ValueError, match="contiguous"):
        geo.raycast_walls(ray, ray, ray, ray, *(torch.zeros((16, 2), device=cuda).T,) * 4, 50.0)
    with pytest.raises(ValueError, match="lead"):
        geo.raycast_walls(*(torch.zeros((3,), device=cuda),) * 4, *(seg,) * 4, 50.0)
    with pytest.raises(ValueError):
        geo.raycast_walls(ray.cpu(), ray, ray, ray, *(seg,) * 4, 50.0)
    wp = torch.zeros((2, 16), device=cuda)
    corners = torch.zeros((2, 4), device=cuda)
    with pytest.raises(TypeError):
        geo.progress_and_collision(ray, ray, corners, corners, wp, wp, wp, wp,
                                   torch.ones(2, dtype=torch.int64, device=cuda), ray)
    with pytest.raises(ValueError):
        geo.progress_and_collision(ray, ray, corners, corners, wp[:1], wp[:1], wp[:1], wp[:1],
                                   torch.ones(2, dtype=torch.int32, device=cuda), ray)
    cars = torch.zeros((2, 3, 4), device=cuda)
    centres = torch.zeros((2, 3), device=cuda)
    rays3 = torch.zeros((2, 5), device=cuda)
    with pytest.raises(TypeError):
        geo.raycast_cars(rays3, rays3, rays3, rays3, cars.double(), cars.double(),
                         centres, centres, 50.0)
    with pytest.raises(ValueError, match="contiguous"):
        geo.raycast_cars(rays3, rays3, rays3, rays3, cars.transpose(0, 1).contiguous()
                         .transpose(0, 1), cars, centres, centres, 50.0)
    with pytest.raises(ValueError, match="lead"):
        geo.raycast_cars(*(torch.zeros((3, 5), device=cuda),) * 4, cars, cars, centres,
                         centres, 50.0)
    with pytest.raises(TypeError):
        geo.rectangles_intersect_pairs(cars.double(), cars.double())
    with pytest.raises(ValueError):
        geo.rectangles_intersect_pairs(torch.zeros((2, 3, 5), device=cuda),
                                       torch.zeros((2, 3, 5), device=cuda))
    with pytest.raises(TypeError):
        dynamics.car_update(*(centres,) * 5, centres, centres, centres)  # crashed not bool
    with pytest.raises(TypeError):
        dynamics.car_update(*(centres.double(),) * 5, centres.bool(), centres, centres)


def test_env_step_on_card_follows_cpu(cuda):
    """One env step from the same state on the card (kernels) and on the CPU
    (plain versions), 40 times over a random drive: done flags equal, rewards and
    observations within float32 rounding of cos/sin, which the card's math
    library rounds differently."""
    from self_play_racing_tpu_torch._tree import tree_map
    from self_play_racing_tpu_torch.envs import single as senv

    np.random.seed(1)
    cps = trk.gen_tracks(4, seed=1)
    cfg = senv.RacingConfig(num_sensors=11)
    ids = np.arange(64) % 4
    tracks = {d: trk.gather_tracks(trk.make_track_pool(cps, 7.0, device=d), ids)
              for d in ("cpu", cuda)}
    state, _ = senv.reset(cfg, tracks["cpu"])
    rng = np.random.default_rng(0)
    mismatched_rays = 0
    for _ in range(40):
        action = torch.as_tensor(np.stack([rng.uniform(-1, 1, 64), rng.uniform(0, 1, 64)], -1),
                                 dtype=torch.float32)
        out = {}
        for d in ("cpu", cuda):
            s = tree_map(lambda t: t.to(d), state)
            out[d] = senv.step(cfg, tracks[d], s, action.to(d))
        (cs, cobs, cr, cterm, ctrunc, _), (gs, gobs, gr, gterm, gtrunc, _) = (
            out["cpu"], tree_map(lambda t: t.cpu(), out[cuda]))
        assert torch.equal(cterm, gterm) and torch.equal(ctrunc, gtrunc)
        torch.testing.assert_close(gr, cr, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(gobs[:, 11:], cobs[:, 11:], rtol=1e-5, atol=1e-5)
        # a ray that grazes a segment end can switch walls on a one-ulp turn
        mismatched_rays += int(((gobs[:, :11] - cobs[:, :11]).abs() > 1e-4).sum())
        state = cs
    assert mismatched_rays <= 5


def _gae_args(rng, steps, envs, dev, done_p=0.05):
    f = lambda *shape: torch.as_tensor(rng.normal(0, 3, shape), dtype=torch.float32, device=dev)
    dones = torch.as_tensor(rng.random((steps, envs)) < done_p, device=dev)
    next_done = torch.as_tensor(rng.random(envs) < done_p, device=dev)
    return f(steps, envs), dones, f(steps, envs), f(envs), next_done


@pytest.mark.parametrize("steps,envs,done_p", [(256, 4096, 0.02), (37, 100, 0.3),
                                               (16, 33, 1.0), (5, 7, 0.0), (1, 1, 0.5),
                                               (2048, 16, 0.01), (300, 4096 + 17, 0.02)])
def test_gae_kernel_matches_plain(cuda, steps, envs, done_p):
    args = _gae_args(np.random.default_rng(steps), steps, envs, cuda, done_p)
    before = gae.compute_gae_launches
    ka, kr = gae.compute_gae(*args, 0.99, 0.95)
    assert gae.compute_gae_launches == before + 1
    pa, pr = gae.compute_gae_plain(*args, 0.99, 0.95)
    torch.cuda.synchronize()
    assert torch.equal(ka, pa) and torch.equal(kr, pr)


@pytest.mark.parametrize("steps,envs", [(1, 5), (32, 16), (33, 40), (64, 17), (97, 15),
                                        (300, 4096 + 17)])
def test_gae_kernel_over_chunks_and_tiles(cuda, steps, envs):
    """Time columns shorter than, equal to and past the 32-step chunk and the two
    buffers the producers and the consumer hand over, whole and ragged tiles of
    16 envs, through the launcher."""
    from self_play_racing_tpu_torch.ops import _cuda

    args = _gae_args(np.random.default_rng(steps * envs), steps, envs, cuda, 0.1)
    adv, ret = torch.empty_like(args[0]), torch.empty_like(args[0])
    _cuda.launch_compute_gae(*args, adv, ret, steps, envs, float(np.float32(0.99)),
                             float(np.float32(0.99 * 0.95)))
    pa, pr = gae.compute_gae_plain(*args, 0.99, 0.95)
    torch.cuda.synchronize()
    assert torch.equal(adv, pa) and torch.equal(ret, pr)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_gae_kernel_takes_dones_off_4_byte_alignment(cuda, offset):
    """The kernel copies the dones' whole 4-byte words asynchronously and a row's
    bytes around them one by one: dones whose storage starts off a 4-byte
    boundary, at aligned and ragged widths."""
    for steps, envs in ((70, 64), (40, 4096 + 17)):
        r, d, v, nv, nd = _gae_args(np.random.default_rng(offset * envs), steps, envs, cuda, 0.1)
        shifted = torch.zeros(steps * envs + offset, dtype=torch.bool, device=cuda)
        d = shifted[offset:].view(steps, envs)
        d.copy_(torch.as_tensor(np.random.default_rng(offset).random((steps, envs)) < 0.1,
                                device=cuda))
        assert d.is_contiguous() and d.data_ptr() % 4 == offset % 4
        ka, kr = gae.compute_gae(r, d, v, nv, nd, 0.99, 0.95)
        pa, pr = gae.compute_gae_plain(r, d, v, nv, nd, 0.99, 0.95)
        torch.cuda.synchronize()
        assert torch.equal(ka, pa) and torch.equal(kr, pr)


def test_gae_kernel_rejects_what_it_does_not_take(cuda):
    r, d, v, nv, nd = _gae_args(np.random.default_rng(0), 8, 16, cuda)
    with pytest.raises(TypeError):
        gae.compute_gae(r, d, v.double(), nv, nd, 0.99, 0.95)
    with pytest.raises(TypeError):
        gae.compute_gae(r, d.float(), v, nv, nd, 0.99, 0.95)
    with pytest.raises(ValueError, match="contiguous"):
        gae.compute_gae(r.T.contiguous().T, d, v, nv, nd, 0.99, 0.95)
    with pytest.raises(ValueError):
        gae.compute_gae(r, d, v, nv[:3], nd, 0.99, 0.95)


@pytest.mark.parametrize("n,lead", [(1, (3,)), (2, (2, 2)), (1024, (10, 1)),
                                    (16384, (10, 1)), (16384, (10, 4)), (1 << 20, (2,))])
def test_mixbits_kernel_matches_plain(cuda, n, lead):
    gen = torch.Generator(device=cuda).manual_seed(n)
    consts = prng.draw_constants(lead, gen, device=cuda)
    before = prng.mixbits_permutation_launches
    k = prng.mixbits_permutation(consts, n)
    assert prng.mixbits_permutation_launches == before + 1
    p = prng.mixbits_permutation_plain(consts, n)
    torch.cuda.synchronize()
    assert k.dtype == torch.int32 and torch.equal(k, p)
    assert torch.equal(torch.sort(k, dim=-1).values,
                       torch.arange(n, dtype=torch.int32, device=cuda).expand(k.shape))
    with pytest.raises(TypeError):
        prng.mixbits_permutation(consts.to(torch.int32), n)


def test_selfplay_update_on_card_launches_all_seven_kernels(cuda):
    """Three scale-mode self-play updates on the card: every env step launches the
    multi-car env's transition (K5, K2, K4's pair test and the reward tail in
    ``car_step_and_query``'s block) once and its observation (K1, K3 and the
    observation row in ``raycast_walls_and_cars``'s block) once (the refresh that
    senses the merged state); each update launches K6 and K7 once. The narrow env
    kernels and the standalone K1, K2, K3, K4 and K5 kernels are off the path."""
    from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer
    from self_play_racing_tpu_torch.configs import self_play_config
    from self_play_racing_tpu_torch.envs import multi

    envs, steps, updates = 64, 32, 3
    cfg = self_play_config(num_envs=envs, num_steps=steps, num_minibatches=4, update_epochs=2,
                           total_timesteps=envs * steps * 4, opponent_per_env=True,
                           reset_envs_each_update=False, snapshot_freq=1)
    np.random.seed(1)
    pool = trk.make_track_pool(trk.gen_tracks(4, seed=1), 7.0, device=cuda)
    tr = SelfPlayTrainer(cfg, multi.MultiRacingConfig(num_agents=2),
                         trk.gather_tracks(pool, np.arange(envs) % 4))
    counters = [(multi, "observe_launches"), (multi, "transition_launches"),
                (geo, "rectangles_intersect_launches"), (gae, "compute_gae_launches"),
                (prng, "mixbits_permutation_launches"), (geo, "raycast_walls_launches"),
                (geo, "raycast_cars_launches"), (geo, "progress_and_collision_launches"),
                (dynamics, "car_update_launches"), (geo, "raycast_walls_and_cars_launches"),
                (dynamics, "car_step_and_query_launches")]
    before = [getattr(m, a) for m, a in counters]
    tr.train(num_updates=updates)
    after = [getattr(m, a) for m, a in counters]
    assert ([b - a for a, b in zip(before, after)]
            == [steps * updates] * 2 + [0] + [updates] * 2 + [0] * 6)
    assert tr.num_snapshots == 2 and tr.pool_games.sum() > 0
    assert all(bool(torch.isfinite(p).all()) for p in tr.runner.train.model.parameters())


def test_update_step_on_card_launches_the_learner_kernels(cuda):
    from self_play_racing_tpu_torch.agent.trainer import PPOTrainer
    from self_play_racing_tpu_torch.configs import base_config
    from self_play_racing_tpu_torch.envs import single as senv

    cfg = base_config(num_envs=64, num_steps=32, num_minibatches=4, update_epochs=2,
                      total_timesteps=64 * 32 * 2)
    np.random.seed(1)
    pool = trk.make_track_pool(trk.gen_tracks(4, seed=1), 7.0, device=cuda)
    tr = PPOTrainer(cfg, senv.RacingConfig(num_sensors=11),
                    trk.gather_tracks(pool, np.arange(64) % 4))
    before = (gae.compute_gae_launches, prng.mixbits_permutation_launches)
    tr.train(num_updates=2)
    assert (gae.compute_gae_launches, prng.mixbits_permutation_launches) == (
        before[0] + 2, before[1] + 2)
    assert all(bool(torch.isfinite(p).all()) for p in tr.runner.train.model.parameters())


def _sensing_case(cuda, rng, rows, cars, sensors, segs, offset):
    """Poses of ``cars`` cars a row (car 1 of every fourth row within 0.5 of car 0,
    so that each skips the other), sensor angles over +-pi/2, and segment rows
    [rows, S] ``offset`` floats into their storage."""
    fields = [_f32(rng, (rows, segs), lo, hi, cuda, offset)
              for lo, hi in ((-40, 40), (-40, 40), (-15, 15), (-15, 15))]
    if segs > 7:
        for t in fields:
            t[:, -7:] = 0.0  # zero-direction padding
    sx, sy, vx, vy = fields
    c = _shifted(vy * sx - vx * sy, offset)
    x, y = (_f32(rng, (rows, cars), -10, 10, cuda) for _ in range(2))
    ang = _f32(rng, (rows, cars), 0, 6.3, cuda)
    if cars > 1:
        x[::4, 1] = x[::4, 0] + 0.3
        y[::4, 1] = y[::4, 0] - 0.2
    rel = torch.linspace(-1.5707964, 1.5707964, sensors, device=cuda)
    return x, y, ang, rel, sx, sy, vx, vy, c


@pytest.mark.parametrize("cars,sensors", [(1, 11), (2, 11), (8, 11), (3, 7)])
@pytest.mark.parametrize("segs,offset", [(896, 0), (33, 1), (1023, 3)])
def test_raycast_walls_and_cars_kernel_matches_plain(cuda, cars, sensors, segs, offset):
    """The multi-car sensing at 1, 2, 3 and 8 cars (3 x 7 rays split a car across
    two warps), segment rows on and off 16-byte alignment, more rows than the card
    holds blocks at once, and cars inside each other's skip radius."""
    rng = np.random.default_rng(cars * 1000 + segs + offset)
    rows = ROWS_PAST_ONE_WAVE
    x, y, ang, rel, sx, sy, vx, vy, c = _sensing_case(cuda, rng, rows, cars, sensors, segs,
                                                      offset)
    before = geo.raycast_walls_and_cars_launches
    k = geo.raycast_walls_and_cars(x, y, ang, rel, sx, sy, vx, vy, c, 2.0, 1.0, 50.0)
    assert geo.raycast_walls_and_cars_launches == before + 1
    p = geo.raycast_walls_and_cars_plain(x, y, ang, rel, sx, sy, vx, vy, c, 2.0, 1.0, 50.0)
    # the K1 and K3 kernels on the rays and corners PyTorch forms
    world = ang[..., None] + rel
    ox, oy = x[..., None].expand(world.shape), y[..., None].expand(world.shape)
    dx, dy = torch.cos(world), torch.sin(world)
    wall = geo.raycast_walls(ox, oy, dx, dy, *(t[:, None, None, :] for t in (sx, sy, vx, vy)),
                             50.0, seg_c=c[:, None, None, :])
    ccx, ccy = geo.car_corners(x, y, ang, 2.0, 1.0)
    car = geo.raycast_cars(ox, oy, dx, dy, ccx[:, None, None], ccy[:, None, None],
                           x[:, None, None, :].contiguous(), y[:, None, None, :].contiguous(),
                           50.0)
    torch.cuda.synchronize()
    assert k.shape == (rows, cars, sensors)
    assert torch.equal(k, torch.minimum(wall, car))
    _assert_k1_close(k, p, 50.0)
    if cars > 1:
        assert 0.01 < float((car < 50.0).float().mean()) < 0.99  # rays do hit cars


@pytest.mark.parametrize("cars", [1, 2, 8])
@pytest.mark.parametrize("waypoints,offset", [(512, 0), (33, 1), (600, 3)])
def test_car_step_and_query_kernel_matches_plain(cuda, waypoints, offset, cars):
    """The transition at 1, 2 and 8 cars against waypoint rows [N, 1, W] (and, at one
    car, [N, W] as the single-car env passes them) on and off 16-byte alignment,
    with crashed cars and speeds above the clamp: every output bitwise equal to the
    plain version and to the K5 kernel, car_corners and the K2 kernel."""
    from self_play_racing_tpu_torch.ops.dynamics import DEFAULT_CAR

    rng = np.random.default_rng(waypoints * 10 + cars + offset)
    rows = ROWS_PAST_ONE_WAVE
    t = torch.linspace(0, 6.283, waypoints, device=cuda)
    radius = _f32(rng, (rows, 1, 1), 20, 40, cuda)
    wp_x = _shifted(radius * torch.cos(t) + _f32(rng, (rows, 1, waypoints), -1, 1, cuda), offset)
    wp_y = _shifted(radius * torch.sin(t) + _f32(rng, (rows, 1, waypoints), -1, 1, cuda), offset)
    nrm = _f32(rng, (rows, 1, waypoints), 0, 6.3, cuda)
    nx, ny = _shifted(torch.cos(nrm), offset), _shifted(torch.sin(nrm), offset)
    n_wp = torch.as_tensor(rng.integers(1, waypoints + 1, (rows, 1)), dtype=torch.int32,
                           device=cuda)
    width = _f32(rng, (rows, 1), 3, 9, cuda)
    shape = (rows, cars)
    f = lambda lo, hi: _f32(rng, shape, lo, hi, cuda)
    cars_in = (f(-35, 35), f(-35, 35), f(-7, 7), f(-35, 35), f(-35, 35),
               torch.as_tensor(rng.random(shape) < 0.2, device=cuda), f(-1, 1), f(0, 1))
    layouts = [(cars_in, (wp_x, wp_y, nx, ny, n_wp, width))]
    if cars == 1:  # the single-car env's layout: cars [N], rows [N, W]
        layouts.append(([a[:, 0] for a in cars_in],
                        [a.view(rows, waypoints) if a.ndim == 3 else a[:, 0]
                         for a in (wp_x, wp_y, nx, ny, n_wp, width)]))
    for car_args, wp_args in layouts:
        before = dynamics.car_step_and_query_launches
        k = dynamics.car_step_and_query(*car_args, 0.05, DEFAULT_CAR, *wp_args)
        assert dynamics.car_step_and_query_launches == before + 1
        p = dynamics.car_step_and_query_plain(*car_args, 0.05, DEFAULT_CAR, *wp_args)
        state = dynamics.car_update(*car_args, 0.05, DEFAULT_CAR)
        ccx, ccy = geo.car_corners(state[0], state[1], state[2], 2.0, 1.0)
        composed = (*state, ccx, ccy,
                    *geo.progress_and_collision(state[0], state[1], ccx, ccy, *wp_args))
        torch.cuda.synchronize()
        names = ("x", "y", "angle", "vx", "vy", "corners_x", "corners_y", "progress", "hit_wall")
        for name, a, b, c in zip(names, k, p, composed):
            assert a.shape == b.shape and torch.equal(a, b) and torch.equal(a, c), name
        assert 0 < int(k[8].sum()) < k[8].numel()


def test_envs_kernels_reject_what_they_do_not_take(cuda):
    from self_play_racing_tpu_torch.ops.dynamics import DEFAULT_CAR

    pose, seg, rel = (torch.zeros((2, 3), device=cuda), torch.zeros((2, 16), device=cuda),
                      torch.zeros(5, device=cuda))
    with pytest.raises(TypeError):
        geo.raycast_walls_and_cars(pose.double(), pose, pose, rel, *(seg,) * 5, 2.0, 1.0, 50.0)
    with pytest.raises(ValueError, match="contiguous"):
        seg_t = torch.zeros((16, 2), device=cuda).T
        geo.raycast_walls_and_cars(pose, pose, pose, rel, *(seg_t,) * 5, 2.0, 1.0, 50.0)
    with pytest.raises(ValueError):
        geo.raycast_walls_and_cars(pose, pose, pose, rel, *(seg[:1],) * 5, 2.0, 1.0, 50.0)
    wp = torch.zeros((2, 1, 16), device=cuda)
    cars = (*(pose,) * 5, pose.bool(), pose, pose)
    n_wp = torch.ones((2, 1), dtype=torch.int32, device=cuda)
    width = torch.ones((2, 1), device=cuda)
    with pytest.raises(TypeError):
        dynamics.car_step_and_query(*cars[:5], pose, *cars[6:], 0.05, DEFAULT_CAR, *(wp,) * 4,
                                    n_wp, width)
    with pytest.raises(TypeError):
        dynamics.car_step_and_query(*cars, 0.05, DEFAULT_CAR, *(wp,) * 4, n_wp.long(), width)
    with pytest.raises(ValueError, match="per waypoint row"):
        dynamics.car_step_and_query(*cars, 0.05, DEFAULT_CAR, *(wp,) * 4,
                                    torch.ones((2, 3), dtype=torch.int32, device=cuda), width)


def _contact_chain(cars, wp, scale):
    """The multi-car env's transition before the pair test moved into the kernel:
    the kernel without it, then K4, the mask, the sum and the velocity ladder."""
    from self_play_racing_tpu_torch.ops.dynamics import DEFAULT_CAR

    out = dynamics.car_step_and_query(*cars, 0.05, DEFAULT_CAR, *wp)
    a = cars[0].shape[-1]
    hits = geo.rectangles_intersect_pairs(out[5], out[6])
    num_hits = (hits & ~torch.eye(a, dtype=torch.bool, device=hits.device)).sum(dim=-1)
    nvx, nvy = out[3], out[4]
    for m in range(a - 1):
        more = num_hits > m
        nvx = torch.where(more, nvx * scale, nvx)
        nvy = torch.where(more, nvy * scale, nvy)
    return (*out[:3], nvx, nvy, *out[5:], num_hits.to(torch.int32))


@pytest.mark.parametrize("cars", [2, 3, 8, 33])
@pytest.mark.parametrize("waypoints,offset", [(512, 0), (33, 1)])
def test_car_step_and_query_with_contacts_matches_the_chain(cuda, waypoints, offset, cars):
    """The transition with the pair test at 2, 3, 8 and 33 cars a race (33: the
    pair loop's second stride of lanes, warps serving several cars), cars packed
    so that they touch, crashed cars included: every output bitwise equal to the
    chain it replaces and to the plain version, with cars touching one partner and
    (from 3 cars) several."""
    from self_play_racing_tpu_torch.ops.dynamics import DEFAULT_CAR

    rng = np.random.default_rng(waypoints * 100 + cars + offset)
    rows = 2048
    t = torch.linspace(0, 6.283, waypoints, device=cuda)
    radius = _f32(rng, (rows, 1, 1), 20, 40, cuda)
    wp_x = _shifted(radius * torch.cos(t) + _f32(rng, (rows, 1, waypoints), -1, 1, cuda), offset)
    wp_y = _shifted(radius * torch.sin(t) + _f32(rng, (rows, 1, waypoints), -1, 1, cuda), offset)
    nrm = _f32(rng, (rows, 1, waypoints), 0, 6.3, cuda)
    nx, ny = _shifted(torch.cos(nrm), offset), _shifted(torch.sin(nrm), offset)
    n_wp = torch.as_tensor(rng.integers(1, waypoints + 1, (rows, 1)), dtype=torch.int32,
                           device=cuda)
    width = _f32(rng, (rows, 1), 3, 9, cuda)
    shape = (rows, cars)
    spread = 1.5 + 0.25 * min(cars, 8)
    cx, cy = _f32(rng, (rows, 1), -30, 30, cuda), _f32(rng, (rows, 1), -30, 30, cuda)
    f = lambda lo, hi: _f32(rng, shape, lo, hi, cuda)
    car_args = ((cx + f(-spread, spread)).contiguous(), (cy + f(-spread, spread)).contiguous(),
                f(-7, 7), f(-35, 35), f(-35, 35),
                torch.as_tensor(rng.random(shape) < 0.2, device=cuda), f(-1, 1), f(0, 1))
    wp_args = (wp_x, wp_y, nx, ny, n_wp, width)
    before = dynamics.car_step_and_query_launches
    k = dynamics.car_step_and_query(*car_args, 0.05, DEFAULT_CAR, *wp_args,
                                    collision_speed_scale=0.92)
    assert dynamics.car_step_and_query_launches == before + 1
    p = dynamics.car_step_and_query_plain(*car_args, 0.05, DEFAULT_CAR, *wp_args,
                                          collision_speed_scale=0.92)
    chain = _contact_chain(car_args, wp_args, 0.92)
    torch.cuda.synchronize()
    names = ("x", "y", "angle", "vx", "vy", "corners_x", "corners_y", "progress", "hit_wall",
             "num_hits")
    assert len(k) == 10 and k[9].dtype == torch.int32
    for name, a, b, c in zip(names, k, p, chain):
        assert a.shape == b.shape and torch.equal(a, b) and torch.equal(a, c), name
    hits = k[9]
    assert int((hits == 1).sum()) > 0
    if cars > 2:
        assert int((hits >= 2).sum()) > 0


def test_car_step_and_query_refuses_pairs_unless_a_block_is_a_race(cuda):
    from self_play_racing_tpu_torch.ops.dynamics import DEFAULT_CAR

    pose = torch.zeros((2, 3), device=cuda)
    cars = (*(pose,) * 5, pose.bool(), pose, pose)
    per_car = torch.zeros((2, 3, 16), device=cuda)  # waypoint rows expanded per car
    before = dynamics.car_step_and_query_launches
    with pytest.raises(ValueError, match="one race"):
        dynamics.car_step_and_query(*cars, 0.05, DEFAULT_CAR, *(per_car,) * 4,
                                    torch.ones((2, 3), dtype=torch.int32, device=cuda),
                                    torch.ones((2, 3), device=cuda),
                                    collision_speed_scale=0.92)
    one = tuple(t[:, 0] for t in cars)
    with pytest.raises(ValueError, match="one race"):
        dynamics.car_step_and_query(*one, 0.05, DEFAULT_CAR,
                                    *(torch.zeros((2, 16), device=cuda),) * 4,
                                    torch.ones(2, dtype=torch.int32, device=cuda),
                                    torch.ones(2, device=cuda), collision_speed_scale=0.92)
    assert dynamics.car_step_and_query_launches == before


# ------------------------------------------------------------------ row ids

POOL_ROWS = 7


def _row_ids(rng, n, dev):
    """N ids into a pool of POOL_ROWS rows that repeat, skip rows 1 and 4, and come
    in no order."""
    used = [r for r in range(POOL_ROWS) if r % 3 != 1]
    return torch.as_tensor(rng.choice(used, n), dtype=torch.int32, device=dev)


def _gathered(ids, *fields):
    return [t.index_select(0, ids.long()) for t in fields]


@pytest.mark.parametrize("rays", [11, 22])
@pytest.mark.parametrize("segs,offset", [(768, 0), (896, 0), (33, 1), (1023, 3)])
def test_raycast_kernel_with_row_ids(cuda, segs, offset, rays):
    rng = np.random.default_rng(segs + rays + offset)
    n = ROWS_PAST_ONE_WAVE
    fields = [_f32(rng, (POOL_ROWS, 1, segs), lo, hi, cuda, offset)
              for lo, hi in ((-40, 40), (-40, 40), (-15, 15), (-15, 15))]
    if segs > 7:
        for t in fields:
            t[..., -7:] = 0.0
    sx, sy, vx, vy = fields
    c = _shifted(vy * sx - vx * sy, offset)
    ids = _row_ids(rng, n, cuda)
    ang = _f32(rng, (n, rays), 0, 6.3, cuda)
    ox, oy = (_f32(rng, (n, 1), -20, 20, cuda).expand(n, rays) for _ in range(2))
    rays_in = (ox, oy, torch.cos(ang), torch.sin(ang))
    before = geo.raycast_walls_launches
    k = geo.raycast_walls(*rays_in, sx, sy, vx, vy, 50.0, seg_c=c, row_ids=ids)
    assert geo.raycast_walls_launches == before + 1
    g = geo.raycast_walls(*rays_in, *_gathered(ids, sx, sy, vx, vy), 50.0,
                          seg_c=_gathered(ids, c)[0])
    p = geo.raycast_walls_plain(*rays_in, sx, sy, vx, vy, 50.0, seg_c=c, row_ids=ids)
    torch.cuda.synchronize()
    assert torch.equal(k, g)
    _assert_k1_close(k, p, 50.0)


@pytest.mark.parametrize("cars", [1, 2, 3, 8])
@pytest.mark.parametrize("segs,offset", [(768, 0), (896, 0), (1023, 3)])
def test_raycast_walls_and_cars_kernel_with_row_ids(cuda, cars, segs, offset):
    rng = np.random.default_rng(cars * 100 + segs + offset)
    n = ROWS_PAST_ONE_WAVE
    x, y, ang, rel, *_ = _sensing_case(cuda, rng, n, cars, 11, 8, 0)
    *_, sx, sy, vx, vy, c = _sensing_case(cuda, rng, POOL_ROWS, 1, 11, segs, offset)
    ids = _row_ids(rng, n, cuda)
    before = geo.raycast_walls_and_cars_launches
    k = geo.raycast_walls_and_cars(x, y, ang, rel, sx, sy, vx, vy, c, 2.0, 1.0, 50.0,
                                   row_ids=ids)
    assert geo.raycast_walls_and_cars_launches == before + 1
    g = geo.raycast_walls_and_cars(x, y, ang, rel, *_gathered(ids, sx, sy, vx, vy, c),
                                   2.0, 1.0, 50.0)
    p = geo.raycast_walls_and_cars_plain(x, y, ang, rel, sx, sy, vx, vy, c, 2.0, 1.0, 50.0,
                                         row_ids=ids)
    torch.cuda.synchronize()
    assert k.shape == (n, cars, 11) and torch.equal(k, g)
    _assert_k1_close(k, p, 50.0)


@pytest.mark.parametrize("cars,pairs", [(1, False), (2, False), (2, True), (3, False),
                                        (3, True), (8, False), (8, True)])
@pytest.mark.parametrize("waypoints,offset", [(384, 0), (512, 0), (600, 3)])
def test_car_step_and_query_kernel_with_row_ids(cuda, waypoints, offset, cars, pairs):
    """The transition reading waypoint rows [T, 1, W] by row id, one waypoint count
    and width per env: bitwise itself on the gathered rows and its plain version,
    with and without the pair test (at one car, also the single-car env's layout,
    cars [N] against rows [T, W])."""
    from self_play_racing_tpu_torch.ops.dynamics import DEFAULT_CAR

    rng = np.random.default_rng(waypoints * 10 + cars + offset + pairs)
    n = ROWS_PAST_ONE_WAVE
    t = torch.linspace(0, 6.283, waypoints, device=cuda)
    radius = _f32(rng, (POOL_ROWS, 1, 1), 20, 40, cuda)
    wp_x = _shifted(radius * torch.cos(t) + _f32(rng, (POOL_ROWS, 1, waypoints), -1, 1, cuda),
                    offset)
    wp_y = _shifted(radius * torch.sin(t) + _f32(rng, (POOL_ROWS, 1, waypoints), -1, 1, cuda),
                    offset)
    nrm = _f32(rng, (POOL_ROWS, 1, waypoints), 0, 6.3, cuda)
    nx, ny = _shifted(torch.cos(nrm), offset), _shifted(torch.sin(nrm), offset)
    ids = _row_ids(rng, n, cuda)
    n_wp = torch.as_tensor(rng.integers(1, waypoints + 1, (n, 1)), dtype=torch.int32,
                           device=cuda)
    width = _f32(rng, (n, 1), 3, 9, cuda)
    shape = (n, cars)
    spread = 1.5 + 0.25 * cars
    cx, cy = _f32(rng, (n, 1), -30, 30, cuda), _f32(rng, (n, 1), -30, 30, cuda)
    f = lambda lo, hi: _f32(rng, shape, lo, hi, cuda)  # noqa: E731
    car_args = [(cx + f(-spread, spread)).contiguous(), (cy + f(-spread, spread)).contiguous(),
                f(-7, 7), f(-35, 35), f(-35, 35),
                torch.as_tensor(rng.random(shape) < 0.2, device=cuda), f(-1, 1), f(0, 1)]
    layouts = [(car_args, [wp_x, wp_y, nx, ny], [n_wp, width])]
    if cars == 1:
        layouts.append(([a[:, 0] for a in car_args],
                        [a.view(POOL_ROWS, waypoints) for a in (wp_x, wp_y, nx, ny)],
                        [n_wp[:, 0], width[:, 0]]))
    kw = {"collision_speed_scale": 0.92} if pairs else {}
    for cars_in, rows, per_env in layouts:
        before = dynamics.car_step_and_query_launches
        k = dynamics.car_step_and_query(*cars_in, 0.05, DEFAULT_CAR, *rows, *per_env,
                                        row_ids=ids, **kw)
        assert dynamics.car_step_and_query_launches == before + 1
        g = dynamics.car_step_and_query(*cars_in, 0.05, DEFAULT_CAR,
                                        *_gathered(ids, *rows), *per_env, **kw)
        p = dynamics.car_step_and_query_plain(*cars_in, 0.05, DEFAULT_CAR, *rows, *per_env,
                                              row_ids=ids, **kw)
        torch.cuda.synchronize()
        assert len(k) == (10 if pairs else 9)
        for i, (a, b, c) in enumerate(zip(k, g, p)):
            assert a.shape == b.shape == c.shape and torch.equal(a, b) and torch.equal(a, c), i
        assert 0 < int(k[8].sum()) < k[8].numel()
        if pairs:
            assert int((k[9] >= 1).sum()) > 0


def test_envs_on_card_read_a_procgen_layout_as_gathered_rows(cuda):
    """A procedural pool built on the card (W 384, S 768), tiled and grouped over
    the envs: the single-car and self-play envs step bitwise as on the gathered
    rows, through the row-id kernels."""
    from self_play_racing_tpu_torch.envs import multi as menv
    from self_play_racing_tpu_torch.envs import procgen as pg
    from self_play_racing_tpu_torch.envs import single as senv

    pool = pg.gen_track_pool(torch.Generator(device=cuda).manual_seed(5), 8)
    assert (pool.wp_x.shape[-1], pool.seg_sx.shape[-1]) == (384, 768)
    n = 512
    gen = torch.Generator(device=cuda).manual_seed(1)
    for layout in (trk.tiled_pooled_tracks(pool, n),
                   trk.grouped_pooled_tracks(pool, [5, 0, 7, 2, 2, 6, 1, 3], n // 8)):
        gathered = trk.gather_tracks(pool, layout.ids)
        for env, cfg, kw in ((senv, senv.RacingConfig(num_sensors=11), {}),
                             (menv, menv.MultiRacingConfig(num_agents=2),
                              {"position_idx": torch.tensor([[1, 0]], device=cuda).expand(n, 2)})):
            s1, o1 = env.reset(cfg, gathered, **kw)
            s2, o2 = env.reset(cfg, layout, **kw)
            assert torch.equal(o1, o2)
            shape = (n, 2) if env is senv else (n, 2, 2)
            for _ in range(16):
                a = torch.rand(shape, generator=gen, device=cuda) * 2 - 1
                s1, o1, r1, *_ = env.step(cfg, gathered, s1, a)
                s2, o2, r2, *_ = env.step(cfg, layout, s2, a)
                assert torch.equal(o1, o2) and torch.equal(r1, r2)


def test_adapter_step_on_the_card_matches_the_cpu_adapter(cuda):
    """``RacingEnv`` at float32 on the card against the same adapter on the CPU,
    one step from the reset: its observation and transition kernels launch once each
    at a batch of one (the narrow K1 and ``car_step_and_query`` not at all), and the
    step returns the CPU's numbers
    within 1e-5 (the elementwise cos/sin/sqrt round differently on the card and in
    the CPU's math library)."""
    from self_play_racing_tpu_torch.envs import gym_adapter

    np.random.seed(1)
    cps = trk.gen_tracks(num_tracks=2, seed=1)
    kw = dict(num_sensors=11, track_pool=cps, track_id=0, track_width=7.0)
    card = gym_adapter.RacingEnv(**kw, device=cuda)
    cpu = gym_adapter.RacingEnv(**kw, dtype=torch.float32, device="cpu")
    assert card.track.wp_x.dtype == torch.float32
    card_obs, _ = card.reset()
    cpu_obs, _ = cpu.reset()
    np.testing.assert_allclose(card_obs, cpu_obs, rtol=0, atol=1e-5)
    geo.raycast_walls_launches = dynamics.car_step_and_query_launches = 0
    senv.observe_launches = senv.transition_launches = 0
    action = np.array([0.3, 0.8])
    got = card.step(action)
    want = cpu.step(action)
    assert (senv.observe_launches, senv.transition_launches) == (1, 1)
    assert (geo.raycast_walls_launches, dynamics.car_step_and_query_launches) == (0, 0)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert got[2:4] == want[2:4]
    for k in ("speed", "progress", "reward", "progress_delta"):
        np.testing.assert_allclose(got[4][k], want[4][k], rtol=1e-5, atol=1e-5, err_msg=k)
    with pytest.raises(TypeError):
        gym_adapter.RacingEnv(**kw, dtype=torch.float64, device=cuda).reset()


# ------------------------------------------- the update as CUDA graphs (ppo.py)

_COUNTERS = [(geo, "raycast_walls_launches"), (geo, "raycast_walls_and_cars_launches"),
             (dynamics, "car_step_and_query_launches"), (gae, "compute_gae_launches"),
             (prng, "mixbits_permutation_launches"), (geo, "raycast_walls_row_id_launches"),
             (geo, "raycast_walls_and_cars_row_id_launches"),
             (dynamics, "car_step_and_query_row_id_launches"),
             (menv, "observe_launches"), (menv, "transition_launches"),
             (menv, "observe_row_id_launches"), (menv, "transition_row_id_launches"),
             (senv, "observe_launches"), (senv, "transition_launches"),
             (senv, "observe_row_id_launches"), (senv, "transition_row_id_launches")]

GRAPH_CASES = {
    # name: (self-play, config overrides)
    "single": (False, dict()),
    "single_kl_exit": (False, dict(kl_target=1e-4)),
    "single_normalized": (False, dict(normalize_obs=True)),
    # the speed weight annealed each update, a tensor on the card that the captured
    # rollout's transition reads in place at every replay
    "single_annealed": (False, dict(anneal_speed_weight=True)),
    "selfplay_per_env": (True, dict(opponent_per_env=True, reset_envs_each_update=False)),
    "selfplay_shared_reset": (True, dict(opponent_per_env=False,
                                         reset_envs_each_update=True, kl_target=1e-3)),
}


def _graph_trainer(cuda, selfplay, overrides, eager):
    from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer
    from self_play_racing_tpu_torch.agent.trainer import PPOTrainer
    from self_play_racing_tpu_torch.configs import base_config, self_play_config
    from self_play_racing_tpu_torch.envs import multi
    from self_play_racing_tpu_torch.envs import single as senv

    envs, steps = 64, 16
    kw = dict(num_envs=envs, num_steps=steps, num_minibatches=4, update_epochs=2,
              total_timesteps=envs * steps * 8, **overrides)
    np.random.seed(1)
    pool = trk.make_track_pool(trk.gen_tracks(4, seed=1), 7.0, device=cuda)
    track = trk.tiled_pooled_tracks(pool, envs)
    if selfplay:
        cfg = self_play_config(snapshot_freq=1, **kw)
        return SelfPlayTrainer(cfg, multi.MultiRacingConfig(num_agents=2), track,
                               eager=eager)
    return PPOTrainer(base_config(**kw), senv.RacingConfig(num_sensors=11), track,
                      eager=eager)


def _learner_state(tr):
    params, mu, nu = tr.full_state()
    return ([t.clone() for t in params + mu + nu], tr.runner.train.opt_state.count,
            tr.runner.obs.clone(), tr.runner.done.clone())


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_update_is_the_eager_update_bitwise(cuda, case):
    """The update as CUDA graphs (the rollout step and the minibatch step captured
    once, replayed) against the same trainer run eagerly on the card, from one
    seed, over three updates, a resampled pool of another size, and a fourth
    update on it: every metric, the parameters, Adam moments and count and the
    final observations bitwise equal, and the launch counters equal (a replay
    adds what its capture counted). Self-play's rollout graph reads the pool's
    stacked snapshots in place and copies the opponent draw."""
    selfplay, overrides = GRAPH_CASES[case]
    runs = []
    for eager in (False, True):
        tr = _graph_trainer(cuda, selfplay, overrides, eager)
        metrics, counts = [], []
        for u in range(4):
            if u == 3:  # a resampled pool of another size: the graphs are captured again
                np.random.seed(2)
                pool = trk.make_track_pool(trk.gen_tracks(2, seed=2), 6.0, device=cuda)
                tr.set_track(trk.tiled_pooled_tracks(pool, tr.cfg.num_envs))
            before = [getattr(m, a) for m, a in _COUNTERS]
            tr.train(num_updates=1, on_update=lambda t, m: metrics.append(m))
            torch.cuda.synchronize()
            counts.append([getattr(m, a) - b for (m, a), b in zip(_COUNTERS, before)])
        graphs = tr.update_step.graphs
        assert (graphs is None) == eager
        if not eager:
            assert graphs.rollout is not None and graphs.minibatch_graph is not None
            if selfplay:  # the pool's snapshots, written in place, are read in place
                read = graphs.rollout.aux.tree["opp"]["params"]["actor"][0][0]
                assert read is tr.pool["params"]["actor"][0][0]
                assert ("opp", "idx") in graphs.rollout.aux.copied
        runs.append((metrics, counts, _learner_state(tr)))
    (gm, gc, gs), (em, ec, es) = runs
    assert gc == ec
    steps = 16
    env = menv if selfplay else senv
    for c in gc:
        assert c[_COUNTERS.index((env, "observe_launches"))] >= steps
        assert c[_COUNTERS.index((env, "transition_launches"))] == steps
        assert c[_COUNTERS.index((gae, "compute_gae_launches"))] == 1
        assert c[_COUNTERS.index((geo, "raycast_walls_launches"))] == 0
        assert c[_COUNTERS.index((dynamics, "car_step_and_query_launches"))] == 0
    for a, b in zip(gm, em):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if "kl_exit" in case or "reset" in case:
        assert any(m["kl_stopped"] for m in gm)
    assert gs[1] == es[1]
    for a, b in zip(gs[0] + list(gs[2:]), es[0] + list(es[2:])):
        assert torch.equal(a, b)


WORLD_ONE_CASES = ("single_kl_exit", "single_normalized", "selfplay_per_env")


@pytest.mark.parametrize("case", WORLD_ONE_CASES)
def test_world_one_nccl_update_is_graphed_and_bitwise(cuda, case):
    """A trainer sharded over an NCCL group of one runs its update as CUDA graphs,
    the collectives captured with the steps (the normalizer's in the rollout, the
    minibatch's all-reduce, the advantage moments' two in their own graph), and
    is bitwise that group's ``eager=True`` run and the graphed run without a
    group, over three updates and a fourth on a resampled pool: every metric, the
    parameters, Adam moments and count, the final observations; the launch
    counters equal; no replay synchronizes; the graphs report the memory they
    hold."""
    selfplay, overrides = GRAPH_CASES[case]
    dev = torch.device("cuda", torch.cuda.current_device())
    runs = {}
    for name in ("no group", "nccl", "nccl eager"):
        group = group_of_one(dev) if name != "no group" else contextlib.nullcontext()
        with group as mesh, chip_smoke.replays_without_sync() as replays:
            tr = _graph_trainer(dev, selfplay, overrides, eager=name == "nccl eager")
            if mesh is not None:
                assert mesh.capturable and mesh.world == 1
                tr.shard(mesh)
            metrics, counts = [], []
            for u in range(4):
                if u == 3:
                    np.random.seed(2)
                    pool = trk.make_track_pool(trk.gen_tracks(2, seed=2), 6.0, device=dev)
                    tr.set_track(trk.tiled_pooled_tracks(pool, tr.cfg.num_envs))
                before = [getattr(m, a) for m, a in _COUNTERS]
                tr.train(num_updates=1, on_update=lambda t, m: metrics.append(m))
                torch.cuda.synchronize()
                counts.append([getattr(m, a) - b for (m, a), b in zip(_COUNTERS, before)])
            graphs = tr.update_step.graphs
            if name == "nccl eager":
                assert graphs is None and replays[0] == 0
            else:
                mb = graphs.minibatch_graph
                assert graphs.rollout is not None and mb is not None
                assert mb.moments_step is not None
                assert replays[0] >= 4 * tr.cfg.num_steps
                held = graphs.memory()
                assert held["static_bytes"] > 0 and held["pool_bytes"] > 0
            runs[name] = (metrics, counts, _learner_state(tr))
    want_m, want_c, want_s = runs["no group"]
    for name in ("nccl", "nccl eager"):
        got_m, got_c, got_s = runs[name]
        assert got_c == want_c, name
        for a, b in zip(got_m, want_m):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        assert got_s[1] == want_s[1], name
        for a, b in zip(got_s[0] + list(got_s[2:]), want_s[0] + list(want_s[2:])):
            assert torch.equal(a, b), name
    if "kl_exit" in case:
        assert any(m["kl_stopped"] for m in want_m)


# ------------------- the evaluation, match and recorder loops as CUDA graphs

LOOP_STEPS = 300
LOOP_CASES = ("single", "multi", "match", "match_noise", "record_single", "record_multi",
              "record_match")


def _loop_call(case, dev):
    """``run(generator)`` for a ``LOOP_CASES`` case on a 4 x 2 grid (the recorders
    on one of its tracks), sampled, and whether the output is a trajectory."""
    from self_play_racing_tpu_torch import tournament
    from self_play_racing_tpu_torch.envs import multi
    from self_play_racing_tpu_torch.envs import single as senv
    from self_play_racing_tpu_torch.evaluate import load_policy_bundle
    from self_play_racing_tpu_torch.utils import metrics, viz

    grid, _, _ = metrics.build_eval_grid(4, 2, 42, device=dev)
    one = trk.gather_tracks(grid, [3])
    scfg, mcfg = senv.RacingConfig(num_sensors=11), multi.MultiRacingConfig(num_agents=2)
    single = load_policy_bundle(chip_smoke.MODEL, dev)
    shared = load_policy_bundle(chip_smoke.MULTI_MODEL, dev)
    bundles = [load_policy_bundle(p, dev) for p in chip_smoke.TOURNAMENT_MODELS[:2]]
    stacks = tournament.stack_bundles(bundles, mcfg.obs_dim)
    noise = torch.randn((LOOP_STEPS, 8, 2, 2), generator=torch.Generator(device=dev)
                        .manual_seed(9), device=dev)
    kw = dict(max_steps=LOOP_STEPS, deterministic=False)
    return {
        "single": lambda g: metrics.rollout_single(*single[:2], scfg, grid, g,
                                                   obs_norm=single[2], **kw),
        "multi": lambda g: metrics.rollout_multi(*shared[:2], mcfg, grid, g,
                                                 obs_norm=shared[2], **kw),
        "match": lambda g: metrics.rollout_match(*stacks, mcfg, grid, g, **kw),
        "match_noise": lambda g: metrics.rollout_match(*stacks, mcfg, grid, g, noise=noise,
                                                       **kw),
        "record_single": lambda g: viz.record_trajectory_single(
            *single[:2], scfg, one, g, obs_norm=single[2], **kw),
        "record_multi": lambda g: viz.record_trajectory_multi(
            *shared[:2], mcfg, one, g, obs_norm=shared[2], **kw),
        "record_match": lambda g: viz.record_trajectory_match(bundles, mcfg, one, g, **kw),
    }[case], case.startswith("record")


@pytest.mark.parametrize("case", LOOP_CASES)
def test_graphed_loop_is_the_eager_loop_bitwise(cuda, case):
    """``utils/metrics.py``'s loops replayed as CUDA graphs against the same calls
    with ``eager=True`` (``chip_smoke.eager_loops``): two calls from different
    seeds through one capture, each bitwise the eager call (accumulators, or the
    recorder's trimmed arrays), the caller's generator left where the eager loop
    leaves it, the launch counts equal, no replay synchronizing."""
    from self_play_racing_tpu_torch import _graph
    from self_play_racing_tpu_torch.utils import metrics

    run, traj = _loop_call(case, cuda)
    metrics.loop_graphs.clear()
    captures = metrics.loop_graphs.captures
    for seed in (1, 2):
        gens = [torch.Generator(device=cuda).manual_seed(seed) for _ in range(2)]
        outs, counts = [], []
        for gen, eager in zip(gens, (False, True)):
            before = _graph.launch_counts()
            with (chip_smoke.eager_loops() if eager else contextlib.nullcontext()), \
                    chip_smoke.replays_without_sync() as replays:
                outs.append(run(gen))
                torch.cuda.synchronize()
            after = _graph.launch_counts()
            counts.append({k: after[k] - before[k] for k in after})
            assert (replays[0] > 0) != eager
        (got, want), (g_gen, e_gen) = outs, gens
        assert sorted(got) == sorted(want)
        for k in want:
            same = np.array_equal(got[k], want[k]) if traj else torch.equal(got[k], want[k])
            assert same, (seed, k)
        assert torch.equal(g_gen.get_state(), e_gen.get_state())
        assert counts[0] == counts[1] and any(counts[0].values())
    assert metrics.loop_graphs.captures - captures == 1


# ------------------------- the multi-car env step as two kernels (envs/multi.py)

# more env rows than the card holds blocks at once, 626 of each of
# chip_smoke.crafted_state's row kinds; a multiple of the canonical pool's 16 tracks
ENV_STEP_ENVS = 5008


def _env_step_track(cuda, where):
    from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool

    pool = canonical_bench_pool(16, device=cuda)
    n = ENV_STEP_ENVS
    if where == "gathered":
        return trk.gather_tracks(pool, np.arange(n) % 16)
    if where == "tiled":
        return trk.tiled_pooled_tracks(pool, n)
    # blocks of envs on repeated, skipped and unordered pool rows
    return trk.grouped_pooled_tracks(pool, [5, 0, 7, 2, 2, 6, 1, 3, 15, 9, 9, 4, 11, 12, 0, 8],
                                     n // 16)


@pytest.mark.parametrize("cars", [1, 2, 3, 8])
@pytest.mark.parametrize("where", ["gathered", "tiled", "grouped"])
def test_multi_transition_kernel_is_its_plain_version_bitwise(cuda, cars, where):
    """``multi.transition``, one launch (the step, the track query, the pair test and
    the whole reward, termination and placement tail in ``car_step_and_query``'s
    block), against ``multi.transition_plain`` (the narrow kernel and PyTorch) on
    ``chip_smoke.crafted_state``: every output bitwise (-0.0 apart from 0.0), every
    branch of the tail taken, then 16 more steps in lockstep on random actions."""
    cfg = menv.MultiRacingConfig(num_agents=cars, num_sensors=11,
                                 max_steps=chip_smoke.CRAFTED_MAX_STEPS)
    track = _env_step_track(cuda, where)
    state, action = chip_smoke.crafted_state(track, cars, cfg.max_steps, seed=cars,
                                             device=cuda)
    before = (menv.transition_launches, menv.transition_row_id_launches)
    out = menv.transition(cfg, track, state, action)
    assert (menv.transition_launches, menv.transition_row_id_launches) == (
        before[0] + 1, before[1] + (where != "gathered"))
    plain = menv.transition_plain(cfg, track, state, action)
    torch.cuda.synchronize()
    assert chip_smoke.differing(chip_smoke.transition_fields(out),
                                chip_smoke.transition_fields(plain)) == {}
    if cars > 1:
        branches = chip_smoke.tail_branches(state, out)
        assert all(branches.values()), branches
    gen = torch.Generator(device=cuda).manual_seed(cars)
    state = out[0]
    for _ in range(16):
        action = torch.rand((ENV_STEP_ENVS, cars, 2), generator=gen, device=cuda) * 2.6 - 1.3
        out = menv.transition(cfg, track, state, action)
        plain = menv.transition_plain(cfg, track, state, action)
        assert chip_smoke.differing(chip_smoke.transition_fields(out),
                                    chip_smoke.transition_fields(plain)) == {}
        state = out[0]


@pytest.mark.parametrize("cars,sensors", [(1, 11), (2, 11), (3, 7), (8, 11)])
@pytest.mark.parametrize("where", ["gathered", "tiled", "grouped"])
@pytest.mark.parametrize("clamp", [False, True])
def test_multi_observe_kernel_is_its_plain_version_bitwise(cuda, cars, sensors, where, clamp):
    """``multi.observe``, one launch (the sensing and the whole observation row in
    ``raycast_walls_and_cars``'s block), against ``multi.observe_plain`` (the narrow
    kernel and PyTorch) on ``chip_smoke.crafted_state`` (3 x 7 rays split a car
    across two warps), the rays clamped to the range and not: bitwise."""
    cfg = menv.MultiRacingConfig(num_agents=cars, num_sensors=sensors,
                                 clamp_sensor_range=clamp)
    track = _env_step_track(cuda, where)
    state, _ = chip_smoke.crafted_state(track, cars, cfg.max_steps, seed=10 + cars,
                                        device=cuda)
    before = (menv.observe_launches, menv.observe_row_id_launches)
    got = menv.observe(cfg, track, state)
    assert (menv.observe_launches, menv.observe_row_id_launches) == (
        before[0] + 1, before[1] + (where != "gathered"))
    want = menv.observe_plain(cfg, track, state)
    torch.cuda.synchronize()
    assert got.shape == (ENV_STEP_ENVS, cars, cfg.obs_dim)
    assert chip_smoke.same_bits(got, want), int((got != want).sum())


def test_env_step_kernels_refuse_what_they_do_not_take(cuda):
    """No fallback: on what the kernels do not take the two functions raise before
    any launch, and count nothing."""
    cfg = menv.MultiRacingConfig(num_agents=2)
    track = _env_step_track(cuda, "tiled")
    state, action = chip_smoke.crafted_state(track, 2, cfg.max_steps, seed=0, device=cuda)
    counts = (menv.transition_launches, menv.observe_launches)
    wide = dataclasses.replace(state, **{f: getattr(state, f).double() for f in
                                         ("x", "y", "angle", "vx", "vy")})
    with pytest.raises(TypeError):
        menv.transition(cfg, track, wide, action)
    with pytest.raises(TypeError):
        menv.observe(cfg, track, wide)
    with pytest.raises(ValueError):
        menv.transition(cfg, track, state, action[..., :1])
    with pytest.raises(TypeError):
        menv.transition(cfg, track, dataclasses.replace(state, steps=state.steps.long()), action)
    short = trk.gather_tracks(trk.resolve(track), np.arange(16))
    with pytest.raises(ValueError):
        menv.transition(cfg, short, state, action)
    with pytest.raises(ValueError):
        menv.observe(cfg, short, state)
    assert (menv.transition_launches, menv.observe_launches) == counts


# ------------- the env step's kernels redesigned (csrc/multi_observe.cu, multi_transition.cu)

# real extents of the 16 rows: at and around the runs' boundaries (L = 28 at S = 896),
# a row of padding only (0) and the canonical pool's own (600, 660, 780)
_L = 28
EXTENTS = [1, _L - 1, _L, _L + 1, 23 * _L + 16, 896, 0, 600, 780, 2, 100, 31 * _L,
           32 * _L - 1, 450, 333, 660]


def _cut_pool(cuda, extents=None, segments=None, waypoints=None):
    """The canonical pool with row r's segments cut to its first extents[r] (the rest
    zero direction) and two zero-direction segments inside each row; or its fields
    cut to ``segments`` and ``waypoints`` columns, so that rows start off 16 bytes."""
    from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool

    pool = canonical_bench_pool(16, device=cuda)
    segs = {f: getattr(pool, f).clone() for f in ("seg_sx", "seg_sy", "seg_vx", "seg_vy",
                                                  "seg_c")}
    for r, e in enumerate(extents or []):
        for t in segs.values():
            t[r, e:] = 0.0
            if e >= 4:
                t[r, [e // 3, 3 * e // 4]] = 0.0
    wps = {f: getattr(pool, f) for f in ("wp_x", "wp_y", "nrm_x", "nrm_y")}
    if segments:
        segs = {f: t[:, :segments].contiguous() for f, t in segs.items()}
    if waypoints:
        wps = {f: t[:, :waypoints].contiguous() for f, t in wps.items()}
    return dataclasses.replace(pool, **segs, **wps)


def _layout(pool, where, n=ENV_STEP_ENVS):
    if where == "gathered":
        return trk.gather_tracks(pool, np.arange(n) % 16)
    if where == "tiled":
        return trk.tiled_pooled_tracks(pool, n)
    return trk.grouped_pooled_tracks(pool, [5, 0, 7, 2, 2, 6, 1, 3, 15, 9, 9, 4, 11, 12, 0, 8],
                                     n // 16)


def _observe_is_plain_and_shape(cfg, track, state):
    got = menv.observe(cfg, track, state)
    want = menv.observe_plain(cfg, track, state)
    model = chip_smoke.shape_model_observe(cfg, track, state)
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(got, want), int((got != want).sum())
    assert chip_smoke.same_bits(got, model), int((got != model).sum())


@pytest.mark.parametrize("cars,sensors", [(1, 11), (2, 11), (3, 7), (8, 11)])
@pytest.mark.parametrize("where", ["gathered", "tiled", "grouped"])
def test_redesigned_observe_at_the_real_extents_boundaries(cuda, cars, sensors, where):
    """``multi_observe`` on rows whose real extent E sits at the runs' boundaries (1,
    L - 1, L, L + 1, 23 L + 16, S), on a row of padding only and with zero-direction
    segments inside the rows, 1, 2, 3 and 8 cars (3 x 7: a ray group spans two
    cars), 5008 envs (more blocks than the card holds at once): bitwise its plain
    version (the narrow kernel and PyTorch) and the fold's shape model."""
    cfg = menv.MultiRacingConfig(num_agents=cars, num_sensors=sensors)
    track = _layout(_cut_pool(cuda, extents=EXTENTS), where)
    state, _ = chip_smoke.crafted_state(track, cars, cfg.max_steps, seed=20 + cars, device=cuda)
    _observe_is_plain_and_shape(cfg, track, state)


@pytest.mark.parametrize("cars", [1, 2, 3, 8])
@pytest.mark.parametrize("where", ["gathered", "tiled"])
def test_redesigned_env_step_on_rows_off_16_byte_alignment(cuda, cars, where):
    """Segment rows of 893 and waypoint rows of 509 floats (row r starts 4r bytes off
    16 for r = 1, 2, 3 mod 4): both kernels bitwise their plain versions, the
    observation its shape model, over 8 steps in lockstep."""
    cfg = menv.MultiRacingConfig(num_agents=cars, num_sensors=11,
                                 max_steps=chip_smoke.CRAFTED_MAX_STEPS)
    track = _layout(_cut_pool(cuda, segments=893, waypoints=509), where)
    state, action = chip_smoke.crafted_state(track, cars, cfg.max_steps, seed=cars,
                                             device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(cars)
    for _ in range(8):
        out = menv.transition(cfg, track, state, action)
        plain = menv.transition_plain(cfg, track, state, action)
        assert chip_smoke.differing(chip_smoke.transition_fields(out),
                                    chip_smoke.transition_fields(plain)) == {}
        state = out[0]
        _observe_is_plain_and_shape(cfg, track, state)
        action = torch.rand((ENV_STEP_ENVS, cars, 2), generator=gen, device=cuda) * 2.6 - 1.3


@pytest.mark.parametrize("where", ["gathered", "tiled"])
def test_redesigned_transition_far_off_the_track(cuda, where):
    """Cars at 1e9 (a padding waypoint at 1e8 is their nearest, so the search must
    visit the padding), at +-1e19, at infinity and at NaN: ``multi_transition``
    bitwise its plain version, which searches every waypoint."""
    cfg = menv.MultiRacingConfig(num_agents=2, num_sensors=11,
                                 max_steps=chip_smoke.CRAFTED_MAX_STEPS)
    track = _layout(_cut_pool(cuda), where)
    state, action = chip_smoke.crafted_state(track, 2, cfg.max_steps, seed=5, device=cuda)
    x, y = state.x.clone(), state.y.clone()
    x[::7, 0], y[::7, 0] = 1e9, -1e9
    x[::11, 1] = 1e19
    y[::13, 0] = -1e19
    x[::17, 1] = float("inf")
    y[::19, 0] = float("nan")
    state = dataclasses.replace(state, x=x, y=y)
    out = menv.transition(cfg, track, state, action)
    plain = menv.transition_plain(cfg, track, state, action)
    assert chip_smoke.differing(chip_smoke.transition_fields(out),
                                chip_smoke.transition_fields(plain)) == {}


@pytest.mark.parametrize("envs", [40, 200, 1024, 2048])
@pytest.mark.parametrize("cars", [2, 3])
def test_redesigned_env_step_at_fewer_envs(cuda, envs, cars):
    """At a match's 40 envs and an evaluation's 200 the env launches the first
    kernels (under ``OBSERVE_SMALL_BELOW`` and ``TRANSITION_SMALL_BELOW`` rows), at
    1024 the redesigned observation and the first transition, at 2048 both
    redesigned ones, as the small-launch counters show: every launch bitwise its
    plain version, the observation its shape model, over 8 steps in lockstep."""
    cfg = menv.MultiRacingConfig(num_agents=cars, num_sensors=11,
                                 max_steps=chip_smoke.CRAFTED_MAX_STEPS)
    track = _layout(_cut_pool(cuda), "gathered", n=envs)
    state, action = chip_smoke.crafted_state(track, cars, cfg.max_steps, seed=envs,
                                             device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(envs)
    small = (menv.observe_small_launches, menv.transition_small_launches)
    for _ in range(8):
        out = menv.transition(cfg, track, state, action)
        plain = menv.transition_plain(cfg, track, state, action)
        assert chip_smoke.differing(chip_smoke.transition_fields(out),
                                    chip_smoke.transition_fields(plain)) == {}
        state = out[0]
        _observe_is_plain_and_shape(cfg, track, state)
        action = torch.rand((envs, cars, 2), generator=gen, device=cuda) * 2.6 - 1.3
    assert (menv.observe_small_launches - small[0], menv.transition_small_launches - small[1]) \
        == (8 * (envs < _cuda.OBSERVE_SMALL_BELOW), 8 * (envs < _cuda.TRANSITION_SMALL_BELOW))


# ------------------------------------ the minibatch step's two kernels (ops/minibatch.py)

@pytest.mark.parametrize("rows", [65_536, 16_384, 4097, 1])
@pytest.mark.parametrize("own_moments", [False, True])
def test_ppo_head_kernels_match_plain(cuda, rows, own_moments):
    """``ppo_head``'s forward and backward launches against the plain composition
    and its autograd, on rows that take every branch (``chip_smoke.crafted_minibatch``),
    with the gradients from the loss at 1 and 0.7 (``chip_smoke.hold_head``: d/d mu and
    d/d v bitwise, the stats bitwise their transcription and within the stated
    tolerance of float64, clip_frac bitwise)."""
    if own_moments and rows == 1:
        pytest.skip("one row has no unbiased std")
    t = chip_smoke.head_tensors(
        chip_smoke.crafted_minibatch(rows, np.random.default_rng(rows)), cuda, own_moments)
    before = (mbops.ppo_head_launches, mbops.ppo_head_backward_launches)
    for g_loss in (1.0, 0.7):
        chip_smoke.hold_head(t, g_loss, f"{rows} rows")
    assert (mbops.ppo_head_launches - before[0],
            mbops.ppo_head_backward_launches - before[1]) == (2, 2)


def test_advantage_moments_kernel_matches_its_transcription(cuda):
    """``advantage_moments``' one launch at ``train scale``'s width, a rank's of two
    shards, units of 3 and of 1 and one-row minibatches
    (``chip_smoke.hold_moments``): bitwise the transcription, within the stated
    tolerance of the float64 moments, two launches bitwise alike."""
    before = mbops.advantage_moments_launches
    chip_smoke.hold_moments(cuda)
    assert mbops.advantage_moments_launches - before == 5
    _, inputs = chip_smoke.minibatch_inputs(
        chip_smoke.base_config(num_envs=1024, num_steps=64), cuda)
    adv, index = inputs[2].advantages, inputs[3]
    assert torch.equal(mbops.advantage_moments(adv, index), mbops.advantage_moments(adv, index))


@pytest.mark.parametrize("case", sorted(chip_smoke.TAIL_CASES))
@pytest.mark.parametrize("flat", [False, True])
def test_adam_tail_kernel_matches_plain(cuda, case, flat):
    """``adam_tail`` bitwise its plain version (parameters, moments, the stats row and
    the loop's counters) applied, clipped, masked by the KL exit and after it, on
    the gradients as tensors of their own and as views of one flat buffer (a
    group's ``_mean_over_group``)."""
    kl, stop, scale = chip_smoke.TAIL_CASES[case]
    state = chip_smoke.tail_state(cuda, 11)
    params, grads, mu, nu, bc1, bc2, loop = state
    if flat:
        buf = torch.cat([x.reshape(-1) for x in grads] + [torch.zeros(6, device=cuda)])
        at = np.cumsum([0] + [x.numel() for x in grads])
        grads = [buf[a:b].view_as(x) for a, b, x in zip(at[:-1], at[1:], grads)]
    before = mbops.adam_tail_launches
    got = chip_smoke.run_tail(mbops.adam_tail, (params, grads, mu, nu, bc1, bc2, loop),
                              kl, stop, scale, cuda)
    want = chip_smoke.run_tail(mbops.adam_tail_plain, state, kl, stop, scale, cuda)
    assert mbops.adam_tail_launches == before + 1
    assert all(chip_smoke.same_bits(a, b) for a, b in zip(got, want))
    moved = not stop and kl < 0.02
    assert all(torch.equal(a, b) for a, b in zip(got[:12], params)) != moved
    assert int(got[-4]) == 4 and int(got[-3]) == 2 + moved and bool(got[-2]) == (not moved)


def test_minibatch_kernels_reject_what_they_do_not_take(cuda):
    t = chip_smoke.head_tensors(chip_smoke.crafted_minibatch(64, np.random.default_rng(0)),
                                cuda)
    args = [t[k] for k in chip_smoke.HEAD_ARGS]
    before = (mbops.ppo_head_launches, mbops.advantage_moments_launches)
    with pytest.raises(TypeError, match="float32"):
        mbops.ppo_head(*[a.double() if a.is_floating_point() else a for a in args],
                       *chip_smoke.HEAD_COEFS)
    wide = torch.zeros((64, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mbops.ppo_head(wide[:, ::2], *args[1:], *chip_smoke.HEAD_COEFS)
    with pytest.raises(TypeError, match="int64"):
        mbops.ppo_head(*args[:-1], args[-1].int(), *chip_smoke.HEAD_COEFS)
    with pytest.raises(ValueError, match="moments"):
        mbops.ppo_head(*args[:-2], args[-2].reshape(-1), args[-1], *chip_smoke.HEAD_COEFS)
    adv = torch.zeros((8, 4), device=cuda)
    index = torch.zeros((3, 2), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        mbops.advantage_moments(adv.double(), index)
    with pytest.raises(ValueError, match="contiguous"):
        mbops.advantage_moments(torch.zeros((4, 8), device=cuda).t(), index)
    with pytest.raises(TypeError, match="int64"):
        mbops.advantage_moments(adv, index.int())
    assert (mbops.ppo_head_launches, mbops.advantage_moments_launches) == before
    params, grads, mu, nu, bc1, bc2, loop = chip_smoke.tail_state(cuda, 1)
    g_norm = torch.ones((), device=cuda)
    stats = [torch.zeros((), device=cuda) for _ in range(6)]
    lr = torch.tensor(1e-3, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        mbops.adam_tail([p.double() for p in params], [g.double() for g in grads],
                        [m.double() for m in mu], [v.double() for v in nu], g_norm, stats,
                        bc1, bc2, lr, loop, 0.5, 0.02)
    w = params[2]  # [64, 64]
    with pytest.raises(ValueError, match="contiguous"):
        mbops.adam_tail([w.t()], [grads[2].t()], [mu[2].t()], [nu[2].t()], g_norm, stats,
                        bc1, bc2, lr, loop, 0.5, 0.02)
    assert int(loop.i) == 0  # nothing launched


def test_update_with_the_learner_kernels_is_the_plain_update_bitwise(cuda):
    """One eager update (4 epochs x 4 minibatches of 4096 rows) with ``ppo_head``,
    ``advantage_moments`` and ``adam_tail``, against the same update with the head
    and the tail plain on the kernel's moments: parameters and Adam moments bitwise
    (the gradients are the composition's bits), clip_frac bitwise, the other stats
    within 1e-5 of their scale (the sums round otherwise); the head and tail
    launched once a minibatch step, the moments once."""
    from self_play_racing_tpu_torch.configs import base_config

    cfg = base_config(num_envs=256, num_steps=64, num_minibatches=4, update_epochs=4,
                      kl_target=float("inf"))
    kernels = chip_smoke.LEARNER + (chip_smoke.MOMENTS,)
    before = [getattr(mbops, f"{k}_launches") for k in kernels]
    got = chip_smoke.update_with(cfg, cuda, 4)
    after = [getattr(mbops, f"{k}_launches") for k in kernels]
    want = chip_smoke.update_with(cfg, cuda, 4, chip_smoke.plain_head_and_tail)
    assert [b - a for a, b in zip(before, after)] == [16] * 3 + [1]
    assert all(chip_smoke.same_bits(a, b) for a, b in zip(got[0], want[0]))
    assert got[1][0] == want[1][0]
    np.testing.assert_array_equal(got[1][1]["clip_frac"], want[1][1]["clip_frac"])
    for k in chip_smoke.STAT_KEYS:
        scale = max(float(np.abs(want[1][1][k]).max()), 1.0)
        np.testing.assert_allclose(got[1][1][k], want[1][1][k], rtol=0, atol=1e-5 * scale,
                                   err_msg=k)


# the redesigned minibatch kernels: the head's rows through the unit index, the tail's
# cluster. Rows: the self-play minibatch, a four-card rank's part, an odd count (units
# of 3 rows, a chunk's rows then read one by one)
UNIT_ROWS = [65_536, 16_384, 4095]


def _unit_head(cuda, rows, own_moments=False):
    block = 3 if rows % 2 else 64
    n_ids = rows // block
    rng = np.random.default_rng(rows)
    ids = rng.permutation(2 * n_ids)[:n_ids]
    return chip_smoke.unit_head_tensors(2 * n_ids, block, ids, rng, cuda, own_moments)


@pytest.mark.parametrize("rows", UNIT_ROWS)
@pytest.mark.parametrize("own_moments", [False, True])
def test_ppo_head_through_the_unit_index_matches_plain(cuda, rows, own_moments):
    """``ppo_head`` reading the actions, old log-probs, advantages, returns and old
    values through the minibatch's unit ids: against the plain version (the gather,
    then the composition and its autograd) as ``chip_smoke.hold_head`` holds it, with
    the gradients from the loss at 1 and 0.7, and bitwise (loss, stats and
    gradients) the kernel on the same rows gathered first."""
    t = _unit_head(cuda, rows, own_moments)
    before = (mbops.ppo_head_launches, mbops.ppo_head_backward_launches)
    for g_loss in (1.0, 0.7):
        chip_smoke.hold_head(t, g_loss, f"{rows} rows by unit id")
    gathered = {k: x for k, x in chip_smoke.gathered_rows(t).items() if k != "unit_ids"}
    by_id = chip_smoke.head_outputs(mbops.ppo_head, t, 0.7)
    assert all(chip_smoke.same_bits(a, b) for a, b in
               zip(by_id, chip_smoke.head_outputs(mbops.ppo_head, gathered, 0.7)))
    assert (mbops.ppo_head_launches - before[0],
            mbops.ppo_head_backward_launches - before[1]) == (4, 4)


@pytest.mark.parametrize("rows", [65_536, 4097])
@pytest.mark.parametrize("by_id", [False, True])
@pytest.mark.parametrize("used", ["pg", "v"])
def test_ppo_head_backward_with_one_upstream_gradient_absent(cuda, rows, by_id, used):
    """The head's backward takes one upstream gradient, the loss's; autograd asks it
    for one input's gradient alone (``mu`` for "pg", ``v`` for "v") where the other is
    not wanted. The asked gradient is bitwise the plain autograd's, from the loss
    and from the loss scaled by 0.25."""
    if by_id:
        t = _unit_head(cuda, 4095 if rows % 2 else rows)
    else:
        t = chip_smoke.head_tensors(
            chip_smoke.crafted_minibatch(rows, np.random.default_rng(rows)), cuda)
    wanted = t["mu"] if used == "pg" else t["v"]
    for scale in (1.0, 0.25):
        grads = []
        for head in (mbops.ppo_head, mbops.ppo_head_loss_plain):
            loss, _ = head(*(t[k] for k in chip_smoke.HEAD_ARGS), *chip_smoke.HEAD_COEFS,
                           t.get("unit_ids"))
            grads.append(torch.autograd.grad(loss * scale, wanted)[0])
        assert chip_smoke.same_bits(*grads)


def _tail_of_sizes(sizes, dev, seed):
    """``chip_smoke.tail_state`` with parameters of the given element counts."""
    gen = torch.Generator().manual_seed(seed)
    like = lambda n, s: (torch.randn(n, generator=gen) * s).to(dev)
    params = [like(n, 0.1) for n in sizes]
    grads = [like(n, 0.003) for n in sizes]
    mu = [like(n, 0.01) for n in sizes]
    nu = [like(n, 0.001).square() for n in sizes]
    return (params, grads, mu, nu) + chip_smoke.tail_state(dev, seed)[4:]


# parameter sets at the kernel's cluster of 16 blocks of 256, 4 elements a thread at a
# time: the (64, 64) policy's 12 tensors (a pass a block), one tensor of several passes
# a block, 32 with empty ones (shares that end inside tensors, 3 passes a block), 3
# elements (blocks with no share)
TAIL_SIZES = {"12 tensors": None, "one tensor": [40_001],
              "32 tensors": [(k * 977) % 3001 if k % 7 else 0 for k in range(32)],
              "3 elements": [2, 0, 1]}


@pytest.mark.parametrize("tensors", list(TAIL_SIZES))
def test_adam_tail_cluster_matches_plain(cuda, tensors):
    """``adam_tail`` as one thread block cluster bitwise its plain version in every
    ``TAIL_CASES`` case (applied, clipped, masked by the KL exit and after it), on 1,
    3, 12 and 32 tensors, the gradients as tensors and as views of one flat buffer."""
    sizes = TAIL_SIZES[tensors]
    state = (chip_smoke.tail_state(cuda, 13) if sizes is None
             else _tail_of_sizes(sizes, cuda, 13))
    params, grads, mu, nu, bc1, bc2, loop = state
    buf = torch.cat([x.reshape(-1) for x in grads] + [torch.zeros(6, device=cuda)])
    at = np.cumsum([0] + [x.numel() for x in grads])
    views = [buf[a:b].view_as(x) for a, b, x in zip(at[:-1], at[1:], grads)]
    for name, (kl, stop, scale) in chip_smoke.TAIL_CASES.items():
        want = chip_smoke.run_tail(mbops.adam_tail_plain, state, kl, stop, scale, cuda)
        for gs in (grads, views):
            got = chip_smoke.run_tail(mbops.adam_tail, (params, gs, mu, nu, bc1, bc2, loop),
                                      kl, stop, scale, cuda)
            assert all(chip_smoke.same_bits(a, b) for a, b in zip(got, want)), name


def test_adam_tail_graph_replays_advance_the_counters_once_each(cuda):
    """One ``adam_tail`` launch captured in a CUDA graph and replayed 16 times is 16
    eager steps of the plain version: parameters, moments, the 16 stats rows, and
    ``i == applied == 16`` (the cluster's counters written once a replay;
    ``chip_smoke.hold_tail_replays``)."""
    before = mbops.adam_tail_launches
    chip_smoke.hold_tail_replays(cuda)
    assert mbops.adam_tail_launches == before + 2  # the warm-up and the capture


# ----------------------------- the single-car env step as two launches (envs/single.py)

# 1280: where the tiled layout's transition takes several rows a block; 1320 to
# 1585: either side of the ends of the per-env observation's band of the multi-car
# plan (``_cuda.SINGLE_OBSERVE_MULTI_PLAN_ROWS``)
SINGLE_ROWS = [1, 16, 48, 200, 1280, 1320, 1321, 1584, 1585, 4096, ENV_STEP_ENVS]


def _single_track(cuda, rows, where):
    from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool

    pool = canonical_bench_pool(16, device=cuda)
    if where == "by row id":
        return chip_smoke.by_row_id(pool, rows)
    return trk.gather_tracks(pool, np.arange(rows) % 16)


def _single_case(cuda, rows, where, seed, **cfg_kw):
    cfg = senv.RacingConfig(num_sensors=11, max_steps=chip_smoke.CRAFTED_MAX_STEPS, **cfg_kw)
    track = _single_track(cuda, rows, where)
    state, action = chip_smoke.crafted_single_state(track, cfg.max_steps, seed=seed,
                                                    device=cuda)
    return cfg, track, state, action


@pytest.mark.parametrize("rows", SINGLE_ROWS)
@pytest.mark.parametrize("where", ["gathered", "by row id"])
@pytest.mark.parametrize("annealed", [False, True])
def test_single_transition_kernel_is_its_plain_version_bitwise(cuda, rows, where, annealed):
    """``single.transition``, one launch (``csrc/single_transition.cu``: a warp a
    row, on the tiled pool from ``SINGLE_TRANSITION_ROWS_FROM`` rows several), against
    ``single.transition_plain`` (the narrow ``car_step_and_query`` and PyTorch) on
    ``chip_smoke.crafted_single_state``, the speed weight the config's or a tensor
    on the card: every output bitwise (-0.0 apart from 0.0); every branch of the tail taken from 4096 rows; then 16 more steps in lockstep on
    random actions, the annealed weight rewritten in place between them."""
    cfg, track, state, action = _single_case(cuda, rows, where, seed=rows)
    sw = torch.tensor(5.3, device=cuda) if annealed else None
    before = (senv.transition_launches, senv.transition_row_id_launches,
              senv.transition_rows_launches, dynamics.car_step_and_query_launches)
    out = senv.transition(cfg, track, state, action, speed_weight=sw)
    by_rows = (isinstance(track, trk.TiledPooledTracks)
               and rows >= _cuda.SINGLE_TRANSITION_ROWS_FROM)  # rows a block on the tiled pool
    assert (senv.transition_launches, senv.transition_row_id_launches,
            senv.transition_rows_launches, dynamics.car_step_and_query_launches) == (
        before[0] + 1, before[1] + (where != "gathered"), before[2] + by_rows, before[3])
    plain = senv.transition_plain(cfg, track, state, action, speed_weight=sw)
    torch.cuda.synchronize()
    want = chip_smoke.single_transition_fields(plain)
    assert chip_smoke.differing(chip_smoke.single_transition_fields(out), want) == {}
    assert out[0].last_progress is out[0].car.progress
    if rows >= 4096:
        branches = chip_smoke.single_tail_branches(state, out)
        assert all(branches.values()), branches
    gen = torch.Generator(device=cuda).manual_seed(rows)
    state = out[0]
    for i in range(16):
        if annealed:
            sw.fill_(5.3 + 0.25 * i)
        action = torch.rand((rows, 2), generator=gen, device=cuda) * 2.6 - 1.3
        out = senv.transition(cfg, track, state, action, speed_weight=sw)
        plain = senv.transition_plain(cfg, track, state, action, speed_weight=sw)
        assert chip_smoke.differing(chip_smoke.single_transition_fields(out),
                                    chip_smoke.single_transition_fields(plain)) == {}
        state = out[0]


@pytest.mark.parametrize("rows", SINGLE_ROWS)
@pytest.mark.parametrize("where", ["gathered", "by row id"])
@pytest.mark.parametrize("clamp", [False, True])
def test_single_observe_kernel_is_its_plain_version_bitwise(cuda, rows, where, clamp):
    """``single.observe``, one launch (the multi-car observation at one car a row
    without its car pass, a row's rays in groups: ``single_observe_plan``; on
    per-env rows in its band the multi-car plan, a warp a row's 11 rays),
    against ``single.observe_plain`` (the narrow K1 and PyTorch) on the crafted
    states, every eighth car 70 m off its track facing it (walls beyond the range):
    bitwise, clamped to the range and not."""
    cfg, track, state, _ = _single_case(cuda, rows, where, seed=20 + rows,
                                        clamp_sensor_range=clamp)
    state = chip_smoke.single_off_track(track, state)
    before = (senv.observe_launches, senv.observe_row_id_launches, geo.raycast_walls_launches)
    got = senv.observe(cfg, track, state)
    assert (senv.observe_launches, senv.observe_row_id_launches,
            geo.raycast_walls_launches) == (before[0] + 1, before[1] + (where != "gathered"),
                                            before[2])
    want = senv.observe_plain(cfg, track, state)
    torch.cuda.synchronize()
    assert got.shape == (rows, cfg.obs_dim)
    assert chip_smoke.same_bits(got, want), int((got != want).sum())
    if rows >= 48 and not clamp:
        assert got[:, :11].max() > 1.0  # the reference's hits beyond the range stay


def test_single_env_step_kernels_refuse_what_they_do_not_take(cuda):
    """No fallback: on what the kernels do not take the two functions raise before
    any launch, and count nothing."""
    cfg, track, state, action = _single_case(cuda, 64, "by row id", seed=0)
    counts = (senv.transition_launches, senv.observe_launches)
    wide = dataclasses.replace(state, car=dataclasses.replace(state.car,
                                                              x=state.car.x.double()))
    with pytest.raises(TypeError):
        senv.transition(cfg, track, wide, action)
    with pytest.raises(TypeError):
        senv.observe(cfg, track, wide)
    with pytest.raises(ValueError):
        senv.transition(cfg, track, state, action[:, :1])
    with pytest.raises(TypeError):
        senv.transition(cfg, track, dataclasses.replace(state, steps=state.steps.long()), action)
    with pytest.raises(TypeError):
        senv.transition(cfg, track, state, action,
                        speed_weight=torch.tensor(5.0, dtype=torch.float64, device=cuda))
    short = trk.gather_tracks(trk.resolve(track), np.arange(16))
    with pytest.raises(ValueError):
        senv.transition(cfg, short, state, action)
    with pytest.raises(ValueError):
        senv.observe(cfg, short, state)
    assert (senv.transition_launches, senv.observe_launches) == counts


@pytest.mark.parametrize("rows", [16, 48, 80, 208, 4096, 5008])
def test_single_transition_rows_kernel_is_its_plain_version_bitwise(cuda, monkeypatch, rows):
    """The transition's kernel of several rows a block (the step and the tail a
    thread a car, the search a warp a car; forced at every width) on the tiled layout,
    the only one it takes (a block's rows 16 apart share one staged pool row): bitwise
    its plain version at widths whose residues' last blocks are part-filled (48: 3 of
    8 rows; 80: 5; 208: a second block of 5; 5008: a 40th of 1), the speed weight an
    annealed tensor, counted as its own; then 8 more steps in lockstep on random
    actions."""
    monkeypatch.setattr(_cuda, "SINGLE_TRANSITION_ROWS_FROM", 0)
    cfg, track, state, action = _single_case(cuda, rows, "by row id", seed=30 + rows)
    assert isinstance(track, trk.TiledPooledTracks)
    sw = torch.tensor(5.3, device=cuda)
    before = senv.transition_rows_launches
    gen = torch.Generator(device=cuda).manual_seed(rows)
    for i in range(9):
        out = senv.transition(cfg, track, state, action, speed_weight=sw)
        plain = senv.transition_plain(cfg, track, state, action, speed_weight=sw)
        assert chip_smoke.differing(chip_smoke.single_transition_fields(out),
                                    chip_smoke.single_transition_fields(plain)) == {}
        state = out[0]
        action = torch.rand((rows, 2), generator=gen, device=cuda) * 2.6 - 1.3
        sw.fill_(5.3 + 0.25 * i)
    assert senv.transition_rows_launches == before + 9


def test_single_transition_rows_kernel_refuses_rows_without_a_period(cuda):
    """The kernel of several rows a block serves only rows a period apart that share
    a pool row: its entry refuses a row period of 0 before any launch."""
    plan = _cuda.single_transition_rows_plan(512)
    args = (_cuda._ptr_array([None] * _cuda.SINGLE_TRANSITION_PTRS),
            _cuda.SINGLE_TRANSITION_PTRS,
            _cuda._float_array([0.0] * _cuda.SINGLE_TRANSITION_CONSTS),
            _cuda.SINGLE_TRANSITION_CONSTS, 16, 512, plan.threads, plan.smem, 100, 2,
            plan.rows_per_block)
    with pytest.raises(RuntimeError, match="invalid argument"):
        _cuda._call("single_transition", "single_transition_rows_f32",
                    torch.device("cuda", torch.cuda.current_device()), *args, 0, 0)


# ------------------------------ the minibatch step's actor and critic MLPs (ops/mlp.py)

@pytest.mark.parametrize("rows", list(chip_smoke.MLP_ROWS))
@pytest.mark.parametrize("dims", list(chip_smoke.MLP_TOWERS))
def test_mlp_kernels_match_plain(cuda, dims, rows):
    """The three MLP kernels (forward, the tiles' backward, the reduce) against the
    plain composition: mu, v and the 12 gradients within phase p's tolerance
    (``chip_smoke.hold_mlp``: max(1e-5 of each tensor's scale, 8 x the composition's
    own distance with the rows in two halves)), a second run bitwise the first, one
    launch of each kernel a run."""
    assert chip_smoke.hold_mlp(dims, rows, cuda, seed=rows)["ratio"] <= 1.0


@pytest.mark.parametrize("rows,block", list(chip_smoke.UNIT_BLOCKS.items()))
@pytest.mark.parametrize("obs_dim", [15, 19])
def test_mlp_kernels_through_the_unit_index_are_the_gathered_rows(cuda, rows, block,
                                                                  obs_dim):
    """The kernels reading the rollout's units through the minibatch's unit ids are
    bitwise the kernels on the gathered rows: mu, v and every gradient."""
    case = chip_smoke.mlp_case(obs_dim, (64, 64), rows, seed=rows)
    params, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, cuda)
    units, ids = chip_smoke.mlp_units(case, rows, block, cuda, seed=rows + 1)
    assert torch.equal(mbops.gather_units(units, ids), obs)
    got = chip_smoke.mlp_run(mlpops.actor_critic_mlp, params, leaves, units, g_mu, g_v, ids)
    want = chip_smoke.mlp_run(mlpops.actor_critic_mlp, params, leaves, obs, g_mu, g_v)
    assert all(chip_smoke.same_bits(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dims", list(chip_smoke.MLP_TOWERS))
def test_mlp_forward_is_row_invariant(cuda, dims):
    """The forward of a permutation of 4097 rows is the permutation of the forward,
    and row 0 alone is row 0 at 65,536 rows, bitwise (``chip_smoke.mlp_row_invariance``,
    as phase p runs it)."""
    chip_smoke.mlp_row_invariance(dims, cuda)


def test_mlp_kernels_in_a_graph_are_eager_bitwise(cuda):
    """The forward and both backward launches captured (through autograd) in a CUDA
    graph and replayed twice give the eager run's bits, and the counters count the
    capture's launches once."""
    case = chip_smoke.mlp_case(19, (64, 64), 4097, seed=5)
    params, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, cuda)
    eager = chip_smoke.mlp_run(mlpops.actor_critic_mlp, params, leaves, obs, g_mu, g_v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chip_smoke.mlp_run(mlpops.actor_critic_mlp, params, leaves, obs, g_mu, g_v)
    torch.cuda.current_stream().wait_stream(side)
    before = chip_smoke.mlp_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chip_smoke.mlp_run(mlpops.actor_critic_mlp, params, leaves, obs, g_mu, g_v)
    assert [b - a for a, b in zip(before, chip_smoke.mlp_counts())] == [1, 1, 1]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(chip_smoke.same_bits(a, b) for a, b in zip(out, eager))


def test_mlp_kernels_refuse_what_they_do_not_take(cuda):
    """No fallback: float64, non-contiguous tensors, hidden widths outside
    ``_cuda.MLP_HIDDEN`` and an obs_dim past a block's shared memory raise before any
    launch, the wrapper's least shared bytes being the kernel's
    (``chip_smoke.mlp_refusals``), and so do unit ids that are not int64."""
    chip_smoke.mlp_refusals(cuda)
    case = chip_smoke.mlp_case(19, (64, 64), 256, seed=0)
    params, _, obs, _, _ = chip_smoke.mlp_tensors(case, cuda)
    before = chip_smoke.mlp_counts()
    with pytest.raises(TypeError, match="float32"):
        mlpops.actor_critic_mlp(params, obs.double())
    with pytest.raises(TypeError, match="int64"):
        mlpops.actor_critic_mlp(params, obs.reshape(4, 64, 19),
                                torch.tensor([0, 1], dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="MLP|towers|three layers"):
        mlpops.actor_critic_mlp({"actor": params["actor"][:2], "critic": params["critic"]},
                                obs)
    assert chip_smoke.mlp_counts() == before


@pytest.mark.parametrize("cars", range(1, 9))
def test_mlp_backward_keeps_two_blocks_an_sm(cuda, cars):
    """Self-play's towers at 1 to 8 cars of 11 sensors (11 + 4 x cars inputs): the
    backward's launch plan keeps two blocks an SM, accumulating in shared memory to
    40 inputs and in its partial row from 41 (``scripts/mlp_backward_plans.py`` times
    both); the forward keeps two or more."""
    dims = (11 + 4 * cars, 64, 64)
    occupancy = chip_smoke.mlp_occupancy(dims)
    assert occupancy["backward_blocks_per_sm"] == 2
    assert occupancy["backward_accumulates_in_shared_memory"] == (dims[0] <= 40)
    assert occupancy["forward_blocks_per_sm"] >= 2
    assert occupancy["backward_shared_bytes"] >= _cuda.mlp_shared_bytes(*dims)


@pytest.mark.parametrize("dims", list(chip_smoke.MLP_TOWERS))
def test_grad_reduce_norm_is_within_tolerance(cuda, dims):
    """The reduce's global norm through ``actor_critic_mlp(..., norm)`` at 65,536 rows
    (``chip_smoke.hold_grad_norm``): within max(1e-5 x the float64 norm of the same
    flat, 8 x ``ppo.global_norm``'s distance from it), the 12 gradients bitwise the
    norm-less launch's, the norm-only mode over their flat bitwise the fused norm."""
    assert chip_smoke.hold_grad_norm(dims, 65_536, cuda, seed=dims[0])["ratio"] <= 1.0


def test_grad_reduce_norm_modes_agree_bitwise(cuda):
    """At the launch level, on train scale's partials: the fused launch's flat is
    bitwise the norm-less launch's, and the norm-only mode over that flat gives the
    fused norm's bits; the ticket's counter is 0 after each launch."""
    dims, n = (19, 64, 64), 65_536
    _, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(
        chip_smoke.mlp_case(dims[0], dims[1:], n, seed=3), cuda)
    w = [x.detach() for x in leaves]
    partial = torch.empty((_cuda.mlp_partial_rows(n), sum(x.numel() for x in w)),
                          device=cuda)
    _cuda.launch_mlp_backward(obs, None, w, g_mu, g_v, partial, n, dims)
    bare, fused = (torch.empty((partial.shape[1],), device=cuda) for _ in range(2))
    norm, only = torch.empty((), device=cuda), torch.empty((), device=cuda)
    _cuda.launch_mlp_grad_reduce(partial, bare)
    _cuda.launch_mlp_grad_reduce(partial, fused, norm)
    _cuda.launch_mlp_grad_norm(fused, only)
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(bare, fused) and chip_smoke.same_bits(norm, only)
    assert int(_cuda.grad_norm_ticket(cuda).item()) == 0
    assert torch.isfinite(norm) and float(norm) > 0.0


def test_grad_reduce_norm_graph_replays_are_bitwise(cuda):
    """The reduce with its norm captured in a CUDA graph: three replays bitwise the
    eager launch, the ticket's counter back at 0 after each
    (``chip_smoke.hold_norm_replays``)."""
    chip_smoke.hold_norm_replays(cuda, replays=3)


def test_grad_reduce_refuses_a_norm_it_cannot_write(cuda):
    """A norm on the CPU, of float64 or not 0-d is refused before any launch."""
    case = chip_smoke.mlp_case(19, (64, 64), 256, seed=0)
    params, _, obs, _, _ = chip_smoke.mlp_tensors(case, cuda)
    before = chip_smoke.mlp_counts()
    for norm in (torch.empty(()), torch.empty((), dtype=torch.float64, device=cuda),
                 torch.empty((1,), device=cuda)):
        with pytest.raises(ValueError, match="norm"):
            mlpops.actor_critic_mlp(params, obs, None, norm)
    assert chip_smoke.mlp_counts() == before


def test_update_launches_the_mlp_kernels_once_a_minibatch_step(cuda, monkeypatch):
    """One eager update (4 epochs x 4 minibatches) launches each MLP kernel once a
    minibatch step, as it launches the loss head and the tail; the global norm comes
    out of the reduce: no call of the ``global_norm`` composition and no norm-only
    launch in a minibatch step without a group."""
    from self_play_racing_tpu_torch.configs import base_config

    calls = []
    composition = tppo.global_norm
    monkeypatch.setattr(tppo, "global_norm", lambda *a: calls.append(1) or composition(*a))
    cfg = base_config(num_envs=256, num_steps=64, num_minibatches=4, update_epochs=4,
                      kl_target=float("inf"))
    before = chip_smoke.mlp_counts() + (mlpops.mlp_grad_norm_launches,)
    params, _ = chip_smoke.update_with(cfg, cuda, 4)
    after = chip_smoke.mlp_counts() + (mlpops.mlp_grad_norm_launches,)
    assert [b - a for a, b in zip(before, after)] == [16] * 3 + [0]
    assert not calls
    assert all(bool(torch.isfinite(p).all()) for p in params)


def test_train_scale_with_three_cars_launches_the_mlp_kernels(cuda, tmp_path, monkeypatch):
    """``train scale --agents 3`` (towers of 11 + 4 x 3 = 23 inputs) trains on the
    card through the MLP kernels: one launch of each a minibatch step, as the loss
    head's and the tail's, and a finite policy of 23 inputs saved."""
    from self_play_racing_tpu_torch import train as ttrain
    from self_play_racing_tpu_torch.evaluate import load_policy_bundle

    monkeypatch.chdir(tmp_path)
    before = chip_smoke.read_counts()
    tr = ttrain.main(["scale", "--num-envs", "64", "--total-timesteps", str(64 * 256 * 3),
                      "--num-updates", "1", "--agents", "3"])
    launches = {k: n - before[k] for k, n in chip_smoke.read_counts().items()}
    assert tr.env_cfg.num_agents == 3 and tr.env_cfg.obs_dim == 23
    want = chip_smoke.learner(launches, tr.cfg, 1)
    assert {k: launches[k] for k in want} == want and launches["mlp_forward"] > 0
    params, _, _ = load_policy_bundle("models/self_play_agent_scale_1B.npz", device="cpu")
    assert params["actor"][0][0].shape == (23, 64)
    assert all(bool(torch.isfinite(x).all()) for tower in params.values() for layer in tower
               for x in layer)


# ------------------------------ the rollout step's policy (ops/policy.py, csrc/policy.cu)

@pytest.mark.parametrize("rows", list(chip_smoke.POLICY_ROWS))
@pytest.mark.parametrize("dims", list(chip_smoke.POLICY_TOWERS))
def test_policy_act_matches_plain(cuda, dims, rows):
    """Kernel A against the composition (``chip_smoke.hold_policy_act``, as phase q
    runs it): mu and v within phase p's tolerance and bitwise ``mlp_forward``'s, the
    normaliser's row, the sample and its log-prob bitwise the composition on the
    kernel's mu, the buffers' other rows untouched, two runs and rows alone bitwise."""
    held = chip_smoke.hold_policy_act(dims, rows, cuda, seed=rows)
    assert held and all(e <= b for e, b in held)


@pytest.mark.parametrize("mode", list(chip_smoke.POOL_MODES))
@pytest.mark.parametrize("envs,seats", list(chip_smoke.POOL_SHAPES))
def test_pool_act_matches_plain(cuda, envs, seats, mode):
    """Kernel B in each member mode (an [envs] index of 5 members, a 0-d index, a
    member a seat) against the composition (``chip_smoke.hold_pool_act``): mu within
    phase p's tolerance; the sample, the uniform actions, the ``use_policy`` select and
    car 0 bitwise the composition on the kernel's mu, also through the env's entry
    points; two runs and envs alone bitwise."""
    held = chip_smoke.hold_pool_act((19, 64, 64), envs, seats, mode, cuda, seed=envs + seats)
    assert held and all(e <= b for e, b in held)


@pytest.mark.parametrize("envs,seats", [(4096, 1), (2048, 2), (512, 7)])
@pytest.mark.parametrize("dist", ["skewed", "all random", "two live", "runs"])
def test_pool_act_members_each_row_under_its_own(cuda, dist, envs, seats):
    """Kernel B on the per-env index at the members of ``chip_smoke.with_members``:
    one member on >= 80% of the envs, the empty pool's all-random index (no tower
    runs), two live members of five, members in runs absent from whole ranges. Mu
    bitwise ``mlp_forward``'s actor on each member's rows and within phase p's
    tolerance, the actions bitwise the composition on it (``hold_pool_act``)."""
    held = chip_smoke.hold_pool_act((19, 64, 64), envs, seats, "per env", cuda,
                                    seed=envs + seats, dist=dist)
    assert held and all(e <= b for e, b in held)


def test_policy_kernels_on_unaligned_tower_views_are_bitwise(cuda):
    """Every tower tensor a view one float past a 16-byte boundary: the kernels copy it
    a float at a time, bitwise their launches on aligned tensors
    (``chip_smoke.policy_offset_views``)."""
    chip_smoke.policy_offset_views(cuda)


def test_policy_kernels_in_a_graph_are_eager_bitwise(cuda):
    """Both kernels captured in a CUDA graph at the main path's shapes and replayed
    twice give their eager launches' bits (``chip_smoke.policy_graphs``)."""
    chip_smoke.policy_graphs(cuda)


def test_policy_kernels_refuse_what_they_do_not_take(cuda):
    """No fallback: float64, strided rows, other hidden widths, a float index and a
    noise of another shape raise before any launch (``chip_smoke.policy_refusals``)."""
    chip_smoke.policy_refusals(cuda)


@pytest.mark.parametrize("mode", ["single", "scale"])
def test_rollout_launches_the_policy_kernels_and_the_first_minibatch_ratio_is_one(
        cuda, tmp_path, monkeypatch, mode):
    """Two updates of ``train single|scale`` on the card: kernel A once a rollout
    step, kernel B once a self-play step, and each update's first minibatch
    recomputes the rollout's log-probs bitwise (approx_kl and clip_frac exactly 0)."""
    from self_play_racing_tpu_torch import train as ttrain

    monkeypatch.chdir(tmp_path)
    first = []
    before = chip_smoke.read_counts()
    with chip_smoke.minibatch_loops(2, first=first):
        tr = ttrain.main([mode, "--num-envs", "64", "--total-timesteps",
                          str(64 * 2048 * 2), "--num-updates", "2"])
    launches = {k: n - before[k] for k, n in chip_smoke.read_counts().items()}
    steps = 2 * tr.cfg.num_steps
    want = chip_smoke.policy(steps, selfplay=mode == "scale")
    assert {k: launches[k] for k in want} == want
    chip_smoke.first_minibatches_exact(first, f"train {mode}")


# ---------------------- the NEXT_STEP autoreset in the transition kernels (autoreset.cuh)

def _autoreset_track(pool, rows, where):
    if where == "gathered":
        return trk.gather_tracks(pool, np.arange(rows) % 16)
    return chip_smoke.by_row_id(pool, rows)


@pytest.mark.parametrize("rows", [16, 1279, 1280, 4096])
@pytest.mark.parametrize("where", ["gathered", "by row id"])
def test_single_transition_autoreset_matches_the_composition(cuda, rows, where):
    """``single.transition_autoreset`` (a warp a row; on the tiled layout from
    ``SINGLE_TRANSITION_ROWS_FROM`` rows the kernel of several rows a block) bitwise the
    composition, the plain mode and the PyTorch glue, in every output, buffer row,
    t + 1, with pending resets on none, some and all rows (``chip_smoke.autoreset_case``,
    which also counts one autoreset launch by the kernel the env picks)."""
    pool = canonical_bench_pool(16, device=cuda)
    track = _autoreset_track(pool, rows, where)
    for i, pending in enumerate(("none", "some", "all")):
        chip_smoke.autoreset_case("single", track, 1, rows, pending, None, cuda, seed=rows + i)


@pytest.mark.parametrize("rows", [16, 2047, 2048, 4096])
@pytest.mark.parametrize("cars", [1, 2])
def test_multi_transition_autoreset_matches_the_composition(cuda, rows, cars):
    """``multi.transition_autoreset`` (the first kernel under
    ``TRANSITION_SMALL_BELOW`` rows, the redesigned one from it) bitwise the
    composition, with the start grid's slots, seat 0's episode, the rollout's rows
    and the PFSP counts into ``extra`` (the pool's index one for all and per env),
    gathered and by row id."""
    pool = canonical_bench_pool(16, device=cuda)
    for where in ("gathered", "by row id"):
        track = _autoreset_track(pool, rows, where)
        for i, (pending, pfsp) in enumerate(
                (p, m) for p in ("none", "some", "all") for m in ("one", "per env")):
            chip_smoke.autoreset_case("multi", track, cars, rows, pending, pfsp, cuda,
                                      seed=rows + i)


@pytest.mark.parametrize("name", list(chip_smoke.AUTORESET_TIMED))
def test_transition_autoreset_graphed_is_eager(cuda, name):
    """Each entry's autoreset mode captured in a CUDA graph, replayed, bitwise its eager
    launch (``chip_smoke.autoreset_graphed``)."""
    kind, where, envs, cars = chip_smoke.AUTORESET_TIMED[name]
    pool = canonical_bench_pool(16, device=cuda)
    track = (trk.tiled_pooled_tracks(pool, envs) if where == "tiled"
             else trk.gather_tracks(pool, np.arange(envs) % 16))
    chip_smoke.autoreset_graphed(kind, track, cars, envs, cuda)
