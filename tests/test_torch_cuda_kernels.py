"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA card (the kernels have no CPU mode). On a machine with one
(``--noconftest``: the repo's conftest sets up JAX, which such a machine may lack):

  python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerance: K2 exact. K1 hit/no-hit identical and distances bitwise equal, except
rays that are near-ties (two hit ratios equal to within the rounding of the cross
products), which may differ by at most 2 ulp.
"""
import numpy as np
import pytest
import torch

from self_play_racing_tpu_torch.envs import track as trk
from self_play_racing_tpu_torch.ops import geometry as geo

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
