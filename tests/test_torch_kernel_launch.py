"""Launch plans of the row kernels K1 (wall raycast) and K2 (track query) and of the
envs' two kernels built on them (the multi-car sensing, K1 with K3's car pass; the
transition, K2 with K5's step), and what their wrappers refuse before any launch.
CPU only: the plans are plain Python (``ops/_cuda.py``), and the checks run before
the kernel is built, so a stub of the call that builds and launches it fails the
test if anything gets that far.
"""
import pytest
import torch

from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import geometry as geo


@pytest.mark.parametrize("rays_per_row,warps", [(11, 1), (22, 2)])
def test_raycast_plan_at_the_main_paths(rays_per_row, warps):
    """The single-car launch ([4096, 11] rays) and the self-play launch ([4096, 22]
    rays of two cars) against 896-segment rows: 11 rays a lane, one warp per 11
    rays of a row, the row's five fields staged once (18 KB, so that an H100 SM
    holds 12 rows at once)."""
    plan = _cuda.raycast_walls_plan(rays_per_row, 896)
    assert plan.rays_per_lane == 11 and plan.threads == 32 * warps
    assert plan.smem == 5 * (896 + 4) * 4 == 18_000


@pytest.mark.parametrize("segments", [1, 31, 33, 864, 896, 1023, 1024, 11_616])
def test_raycast_plan_stages_whole_runs(segments):
    """The stage holds each field padded to 32 runs of L = ceil(S/32) (the kernel
    zeroes the padding, so every lane takes L steps), plus up to 3 floats of
    alignment shift, rounded to 16 bytes."""
    plan = _cuda.raycast_walls_plan(11, segments)
    padded = 32 * -(-segments // 32)
    assert plan.smem == 5 * (padded + 4) * 4 <= _cuda.BLOCK_SMEM_LIMIT
    assert plan.smem % 16 == 0


@pytest.mark.parametrize("rays_per_row,rays_per_lane,warps", [
    (1, 1, 1), (3, 3, 1), (5, 6, 1), (12, 6, 2), (40, 11, 4), (100, 11, 8), (400, 11, 8)])
def test_raycast_plan_splits_a_row_into_warps(rays_per_row, rays_per_lane, warps):
    """The fewest warps that hold at most 11 rays a lane, as evenly as the kernel's
    instantiations allow; at most 8 warps a block, which then loop over the rest."""
    plan = _cuda.raycast_walls_plan(rays_per_row, 896)
    assert plan.rays_per_lane == rays_per_lane and plan.threads == 32 * warps
    assert plan.rays_per_lane in _cuda.K1_RAYS_PER_LANE_CHOICES


def test_raycast_plan_refuses_what_the_kernel_cannot_take():
    """Past 227 KB for the staged row, or without a segment, the plan refuses."""
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.raycast_walls_plan(11, 11_617)
    with pytest.raises(ValueError, match="segment"):
        _cuda.raycast_walls_plan(11, 0)


@pytest.mark.parametrize("cars,warps", [(1, 1), (2, 2), (8, 8), (20, 8)])
def test_progress_plan_at_the_main_paths(cars, warps):
    """A warp per car of a waypoint row (at most 8 a block), the row's two position
    fields staged once; 512 waypoints."""
    plan = _cuda.progress_collision_plan(cars, 4, 512)
    assert plan.threads == 32 * warps
    assert plan.smem == 2 * (512 + 4) * 4


def test_progress_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="31"):
        _cuda.progress_collision_plan(1, 32, 512)
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.progress_collision_plan(1, 4, 30_000)
    with pytest.raises(ValueError, match="waypoint"):
        _cuda.progress_collision_plan(1, 4, 0)
    assert _cuda.progress_collision_plan(1, 31, 20_000).smem <= _cuda.BLOCK_SMEM_LIMIT


@pytest.fixture
def no_launch(monkeypatch):
    """The wrappers' CUDA paths on CPU tensors, with a build-and-launch call that
    fails the test: every refusal must come before it."""
    def launched(*args, **kwargs):
        raise AssertionError("a kernel was launched")
    monkeypatch.setattr(_cuda, "_call", launched)


def _ray(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_raycast_wrapper_refuses_before_launch(no_launch):
    seg, ray = _ray(2, 16), _ray(2)
    with pytest.raises(TypeError):
        geo._raycast_walls_cuda(ray.double(), ray, ray, ray, *(seg.double(),) * 4, 50.0, None)
    with pytest.raises(ValueError, match="contiguous"):
        geo._raycast_walls_cuda(ray, ray, ray, ray, *(_ray(16, 2).T,) * 4, 50.0, None)
    with pytest.raises(ValueError, match="lead"):
        geo._raycast_walls_cuda(*(_ray(3),) * 4, *(seg,) * 4, 50.0, None)
    with pytest.raises(ValueError, match="differ in shape"):
        geo._raycast_walls_cuda(ray, ray, ray, ray, seg, seg, seg, _ray(2, 15), 50.0, None)
    with pytest.raises(ValueError, match="shared memory"):
        geo._raycast_walls_cuda(ray, ray, ray, ray, *(_ray(2, 11_617),) * 4, 50.0, None)


def test_progress_wrapper_refuses_before_launch(no_launch):
    ray, corners, wp = _ray(2), _ray(2, 4), _ray(2, 16)
    n_wp = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        geo._progress_and_collision_cuda(ray, ray, corners, corners, wp, wp, wp, wp,
                                         n_wp.long(), ray)
    with pytest.raises(TypeError):
        geo._progress_and_collision_cuda(ray.double(), ray, corners, corners, wp, wp, wp,
                                         wp, n_wp, ray)
    with pytest.raises(ValueError):
        geo._progress_and_collision_cuda(ray, ray, corners, corners, wp[:1], wp[:1], wp[:1],
                                         wp[:1], n_wp, ray)
    with pytest.raises(ValueError, match="contiguous"):
        geo._progress_and_collision_cuda(ray, ray, _ray(4, 2).T, corners, wp, wp, wp, wp,
                                         n_wp, ray)
    with pytest.raises(ValueError, match="31"):
        many = _ray(2, 32)
        geo._progress_and_collision_cuda(ray, ray, many, many, wp, wp, wp, wp, n_wp, ray)
    with pytest.raises(ValueError, match="shared memory"):
        big = _ray(2, 30_000)
        geo._progress_and_collision_cuda(ray, ray, corners, corners, big, big, big, big,
                                         n_wp, ray)


@pytest.mark.parametrize("launcher", ["raycast_walls", "progress_and_collision"])
def test_launchers_refuse_before_launch(no_launch, launcher):
    """The launchers take their plan themselves, so a direct call refuses too."""
    t = _ray(1)
    if launcher == "raycast_walls":
        with pytest.raises(ValueError, match="shared memory"):
            _cuda.launch_raycast_walls(*(t,) * 10, 1, 11, 11_617, 50.0)
    else:
        with pytest.raises(ValueError, match="31"):
            _cuda.launch_progress_and_collision(*(t,) * 12, 1, 1, 32, 512)


@pytest.mark.parametrize("cars,threads", [(1, 32), (2, 64), (3, 96), (8, 256)])
def test_walls_and_cars_plan_stages_the_cars_beside_the_row(cars, threads):
    """K1's plan for the A x 11 rays of a row (a warp per car at 11 sensors), with
    the row's cars, 18 floats each, beside its 18,000-byte segment stage."""
    plan = _cuda.raycast_walls_and_cars_plan(cars, 11, 896)
    walls = _cuda.raycast_walls_plan(cars * 11, 896)
    assert (plan.threads, plan.rays_per_lane) == (walls.threads, walls.rays_per_lane)
    assert plan.threads == threads and plan.rays_per_lane == 11
    assert plan.smem == 18_000 + 18 * 4 * cars
    assert _cuda.raycast_walls_and_cars_plan(3, 7, 896).rays_per_lane == 11  # 21 rays


def test_walls_and_cars_plan_refuses_what_the_kernel_cannot_take():
    """Where the segment row fits but the row and its cars do not, and where the
    segment row alone does not fit, the plan refuses."""
    assert _cuda.raycast_walls_plan(10, 11_584).smem == 231_760
    assert _cuda.raycast_walls_and_cars_plan(1, 10, 11_584).smem == 231_832
    with pytest.raises(ValueError, match="10 cars"):
        _cuda.raycast_walls_and_cars_plan(10, 1, 11_584)
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.raycast_walls_and_cars_plan(1, 11, 11_617)
    with pytest.raises(ValueError, match="segment"):
        _cuda.raycast_walls_and_cars_plan(2, 11, 0)


@pytest.mark.parametrize("cars,warps", [(1, 1), (2, 2), (8, 8), (20, 8)])
def test_step_query_plan_is_k2s_with_four_corners(cars, warps):
    plan = _cuda.car_step_query_plan(cars, 512)
    assert plan == _cuda.progress_collision_plan(cars, 4, 512)
    assert plan.threads == 32 * warps and plan.smem == 2 * (512 + 4) * 4
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.car_step_query_plan(cars, 30_000)
    with pytest.raises(ValueError, match="waypoint"):
        _cuda.car_step_query_plan(cars, 0)


def test_walls_and_cars_wrapper_refuses_before_launch(no_launch):
    pose, rel, seg = _ray(2, 3), _ray(5), _ray(2, 16)
    with pytest.raises(TypeError):
        geo._raycast_walls_and_cars_cuda(pose.double(), pose, pose, rel, *(seg,) * 5, 2.0,
                                         1.0, 50.0)
    with pytest.raises(ValueError, match="contiguous"):
        geo._raycast_walls_and_cars_cuda(pose, pose, pose, rel, *(_ray(16, 2).T,) * 5, 2.0,
                                         1.0, 50.0)
    with pytest.raises(ValueError, match="P\\+\\(S,\\)"):
        geo._raycast_walls_and_cars_cuda(pose, pose, pose, rel, *(_ray(3, 16),) * 5, 2.0,
                                         1.0, 50.0)
    with pytest.raises(ValueError, match="poses"):
        geo._raycast_walls_and_cars_cuda(pose, pose, _ray(2, 4), rel, *(seg,) * 5, 2.0, 1.0,
                                         50.0)
    with pytest.raises(ValueError, match="shared memory"):
        big = _ray(2, 11_617)
        geo._raycast_walls_and_cars_cuda(pose, pose, pose, rel, *(big,) * 5, 2.0, 1.0, 50.0)


def test_step_query_wrapper_refuses_before_launch(no_launch):
    from self_play_racing_tpu_torch.ops import dynamics

    cars = [_ray(2, 3)] * 5 + [torch.zeros((2, 3), dtype=torch.bool)] + [_ray(2, 3)] * 2
    wp = [_ray(2, 1, 16)] * 4
    n_wp, width = torch.ones((2, 1), dtype=torch.int32), _ray(2, 1)
    spec = dynamics.DEFAULT_CAR

    def call(cars=cars, wp=wp, n_wp=n_wp, width=width):
        dynamics._car_step_and_query_cuda(*cars, 0.05, spec, *wp, n_wp, width)

    with pytest.raises(TypeError, match="crashed"):
        call(cars=cars[:5] + [_ray(2, 3)] + cars[6:])
    with pytest.raises(TypeError):
        call(cars=[t.double() if t.dtype == torch.float32 else t for t in cars])
    with pytest.raises(TypeError, match="n_wp"):
        call(n_wp=n_wp.long())
    with pytest.raises(ValueError, match="per waypoint row"):
        call(width=_ray(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        call(wp=[_ray(16, 1, 2).transpose(0, 2)] * 4)
    with pytest.raises(ValueError, match="lead"):
        call(wp=[_ray(3, 1, 16)] * 4, n_wp=torch.ones((3, 1), dtype=torch.int32),
             width=_ray(3, 1))
    with pytest.raises(ValueError, match="shared memory"):
        call(wp=[_ray(2, 1, 30_000)] * 4)


def test_envs_launchers_refuse_before_launch(no_launch):
    t = _ray(1)
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.launch_raycast_walls_and_cars(*(t,) * 10, 1, 1, 11, 11_617, 2.0, 1.0, 50.0)
    with pytest.raises(ValueError, match="waypoint"):
        _cuda.launch_car_step_and_query(*(t,) * 23, 1, 1, 0, [0.0] * 10)


@pytest.mark.parametrize("cars,warps", [(2, 2), (3, 3), (8, 8), (33, 8)])
def test_step_query_plan_with_the_pair_test_holds_the_cars(cars, warps):
    """The pair test keeps each car's corners and stepped velocity, 10 floats, in
    shared memory beside the staged row; the threads stay K2's."""
    plan = _cuda.car_step_query_plan(cars, 512, True)
    assert plan.threads == 32 * warps
    assert plan.smem == 2 * (512 + 4) * 4 + 10 * 4 * cars


def test_step_query_plan_refuses_pairs_it_cannot_hold():
    """A row that fits alone but not with its cars' pair test is refused."""
    assert _cuda.car_step_query_plan(1, 28_000).smem <= _cuda.BLOCK_SMEM_LIMIT
    with pytest.raises(ValueError, match="pair test of 400 cars"):
        _cuda.car_step_query_plan(400, 28_000, True)
    assert _cuda.car_step_query_plan(400, 512, True).smem <= _cuda.BLOCK_SMEM_LIMIT


def test_step_query_wrapper_refuses_pairs_unless_a_block_is_a_race(no_launch):
    from self_play_racing_tpu_torch.ops import dynamics

    spec = dynamics.DEFAULT_CAR
    n_wp = torch.ones((2, 1), dtype=torch.int32)
    cars = [_ray(2, 3)] * 5 + [torch.zeros((2, 3), dtype=torch.bool)] + [_ray(2, 3)] * 2
    # waypoint rows expanded per car: a block would hold one car of a race
    with pytest.raises(ValueError, match="one race"):
        dynamics._car_step_and_query_cuda(*cars, 0.05, spec, *[_ray(2, 3, 16)] * 4,
                                          torch.ones((2, 3), dtype=torch.int32),
                                          _ray(2, 3), collision_speed_scale=0.92)
    # the single-car env's layout, cars [N] against rows [N, W]
    one = [t[:, 0] for t in cars]
    with pytest.raises(ValueError, match="one race"):
        dynamics._car_step_and_query_cuda(*one, 0.05, spec, *[_ray(2, 16)] * 4, n_wp[:, 0],
                                          _ray(2), collision_speed_scale=0.92)
    with pytest.raises(ValueError, match="pair test"):
        dynamics._car_step_and_query_cuda(*[t[:, :1].expand(2, 400) for t in cars], 0.05,
                                          spec, *[_ray(2, 1, 28_000)] * 4, n_wp, _ray(2, 1),
                                          collision_speed_scale=0.92)


def test_step_query_launcher_with_pairs_refuses_before_launch(no_launch):
    t = _ray(1)
    with pytest.raises(ValueError, match="pair test"):
        _cuda.launch_car_step_and_query(*(t,) * 23, 1, 400, 28_000, [0.0] * 10,
                                        num_hits=t.int(), collision_scale=0.92)


def _pool(num_tracks=4):
    from self_play_racing_tpu_torch.envs import track as trk

    return trk, trk.make_track_pool(trk.gen_tracks(num_tracks, seed=1), 7.0, device="cpu")


@pytest.mark.parametrize("ids,error,match", [
    ([0, 4], ValueError, r"\[0, 4\)"), ([-1, 0], ValueError, r"\[0, 4\)"),
    ([0.0, 1.0], TypeError, "integers"), ([True, False], TypeError, "integers"),
    ([[0, 1]], ValueError, "one axis")])
def test_layouts_refuse_bad_ids_when_built(ids, error, match):
    """The capacity layouts check their track ids once, on the host, when they are
    built: integers on one axis in [0, T). The kernels then read the ids without a
    check (a check there would read the device on every step)."""
    trk, pool = _pool()
    with pytest.raises(error, match=match):
        trk.pooled_tracks(pool, ids)
    with pytest.raises(error, match=match):
        trk.grouped_pooled_tracks(pool, ids, 2)
    with pytest.raises(error, match=match):
        trk.pooled_tracks(pool, torch.as_tensor(ids))
    layout = trk.pooled_tracks(pool, torch.tensor([3, 0, 3], dtype=torch.int64))
    assert layout.ids.dtype == torch.int32 and layout.ids.tolist() == [3, 0, 3]
    with pytest.raises(ValueError, match="block_envs"):
        trk.grouped_pooled_tracks(pool, [0, 1], 0)


def test_wrappers_refuse_bad_row_ids_before_launch(no_launch):
    """With row ids the segment and waypoint fields are a pool's rows (T of them,
    here 3) read by N = 2 envs: the ids must be int32 on one contiguous axis, and
    the shapes must fit N, not T."""
    from self_play_racing_tpu_torch.ops import dynamics

    ids = torch.tensor([2, 0], dtype=torch.int32)
    ray, seg = _ray(2, 11), _ray(3, 1, 16)
    for bad, error in ((ids.long(), TypeError), (torch.tensor([[2, 0]], dtype=torch.int32),
                                                 ValueError)):
        with pytest.raises(error, match="row ids"):
            geo._raycast_walls_cuda(ray, ray, ray, ray, *(seg,) * 4, 50.0, None, bad)
    with pytest.raises(ValueError, match="lead"):
        geo._raycast_walls_cuda(*(_ray(3, 11),) * 4, *(seg,) * 4, 50.0, None, ids)

    pose, rel, pool = _ray(2, 3), _ray(5), _ray(3, 16)
    with pytest.raises(TypeError, match="row ids"):
        geo._raycast_walls_and_cars_cuda(pose, pose, pose, rel, *(pool,) * 5, 2.0, 1.0, 50.0,
                                         ids.long())
    with pytest.raises(ValueError, match="pool shape"):
        geo._raycast_walls_and_cars_cuda(_ray(3, 3), _ray(3, 3), _ray(3, 3), rel,
                                         *(pool,) * 5, 2.0, 1.0, 50.0, ids)

    cars = [_ray(2, 3)] * 5 + [torch.zeros((2, 3), dtype=torch.bool)] + [_ray(2, 3)] * 2
    wp = [_ray(3, 1, 16)] * 4
    n_wp, width = torch.ones((2, 1), dtype=torch.int32), _ray(2, 1)
    spec = dynamics.DEFAULT_CAR
    with pytest.raises(TypeError, match="row ids"):
        dynamics._car_step_and_query_cuda(*cars, 0.05, spec, *wp, n_wp, width,
                                          row_ids=ids.long())
    with pytest.raises(ValueError, match="per waypoint row"):  # one per env, not per pool row
        dynamics._car_step_and_query_cuda(*cars, 0.05, spec, *wp,
                                          torch.ones((3, 1), dtype=torch.int32), _ray(3, 1),
                                          row_ids=ids)
    with pytest.raises(ValueError, match="one race"):
        dynamics._car_step_and_query_cuda(*cars, 0.05, spec, *[_ray(3, 3, 16)] * 4,
                                          torch.ones((2, 3), dtype=torch.int32), _ray(2, 3),
                                          collision_speed_scale=0.92, row_ids=ids)


def test_row_id_launch_reaches_the_kernel_with_the_ids(monkeypatch):
    """What the wrappers pass to a kernel with row ids: the ids' pointer in the
    C signature's slot, and the env count (not the pool's) as the rows."""
    import contextlib

    calls = []
    monkeypatch.setattr(_cuda, "_call", lambda stem, fn, dev, *args: calls.append((fn, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    ids = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    seg = _ray(3, 1, 16)
    geo._raycast_walls_cuda(*(_ray(4, 11),) * 4, *(seg,) * 4, 50.0, None, ids)
    fn, args = calls[-1]
    assert fn == "raycast_walls_f32" and args[9] == ids.data_ptr() and args[11] == 4
    assert len(args) + 2 == len(_cuda._SIGNATURES[fn])
    pose, pool = _ray(4, 2), _ray(3, 16)
    geo._raycast_walls_and_cars_cuda(pose, pose, pose, _ray(11), *(pool,) * 5, 2.0, 1.0,
                                     50.0, ids)
    fn, args = calls[-1]
    assert args[9] == ids.data_ptr() and args[11] == 4
    assert len(args) + 2 == len(_cuda._SIGNATURES[fn])
    from self_play_racing_tpu_torch.ops import dynamics

    cars = [_ray(4, 2)] * 5 + [torch.zeros((4, 2), dtype=torch.bool)] + [_ray(4, 2)] * 2
    dynamics._car_step_and_query_cuda(*cars, 0.05, dynamics.DEFAULT_CAR,
                                      *[_ray(3, 1, 16)] * 4,
                                      torch.ones((4, 1), dtype=torch.int32), _ray(4, 1),
                                      collision_speed_scale=0.92, row_ids=ids)
    fn, args = calls[-1]
    assert args[12] == ids.data_ptr() and args[25:27] == (4, 2)
    assert len(args) + 2 == len(_cuda._SIGNATURES[fn])
