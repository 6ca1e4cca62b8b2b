"""The sums the loss head and the advantage moments take on the card
(``csrc/ppo_head.cu``), transcribed in numpy and held on the CPU to the tolerance the
kernels state.

``chip_smoke.head_sums_model`` transcribes the head's forward past its rows: each
block's float64 shuffle tree and its warps in order, the last block's thread t over
the blocks' partials t, t + kThreads, ..., the block's tree again, and the stats in
float32 as the kernel forms them. ``chip_smoke.moments_model`` transcribes the
moments launch: each thread's walk over a minibatch's flat rows (``moment_order``;
row r is unit ``ids[r // block]``, offset ``r % block``), the float64 sums of the rows'
deviations from the minibatch's first row and of their squares by each block's tree and
the cluster's blocks in order. chip_smoke.py phase n holds the kernels to these
transcriptions bitwise on the card; here they are held:

- the head's stats on ``chip_smoke.crafted_minibatch`` at 65,536, 16,384, 4097 and 1
  rows within ``ops/minibatch.py``'s rule of the float64 sums: max(``SUM_REL_FLOOR``
  x mean(|x|), ``SUM_CONTROL_FACTOR`` x |PyTorch's float32 mean - the float64 mean|),
  the loss on its three terms, clip_frac exactly count x float32(1 / n) (PyTorch's
  float32 mean on the card), and a first minibatch's approx_kl and clip_frac exactly 0;
- the moments at 1 and 2 data shards, units of 64, 4 and 1 rows, within the same rule
  (the std on the float64 std) of jitted JAX's ``adv.mean()`` and
  ``adv.std(ddof=1)``, of the float64 moments and of the plain table; the walk takes
  every row of a minibatch once, each thread its rows in order; one-row minibatches
  give (x, NaN) as the plain version does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.configs import base_config
from self_play_racing_tpu_torch.ops import minibatch as mbops

HEAD_ROWS = (65_536, 16_384, 4097, 1)


@pytest.mark.parametrize("rows", HEAD_ROWS)
def test_head_sums_are_within_the_tolerance_of_float64(rows):
    case = chip_smoke.crafted_minibatch(rows, np.random.default_rng(rows))
    t = chip_smoke.head_tensors(case, "cpu")
    values = chip_smoke.head_row_values(t)
    stats = chip_smoke.head_sums_model(values, case["log_std"])
    assert stats.dtype == np.float32 and stats.shape == (6,)
    for k, s, (ref, bound) in zip(chip_smoke.STAT_KEYS, stats,
                                  chip_smoke.head_stat_bounds(values, t)):
        assert abs(float(s) - ref) <= bound, (k, float(s), ref, bound)
    count = int(values[3].sum())
    f32 = np.float32
    assert stats[5] == f32(f32(count) * (f32(1.0) / f32(rows)))
    if rows & (rows - 1) == 0:  # 1 / n exact: the CPU's float32 mean divides alike
        assert stats[5] == torch.as_tensor(values[3]).mean().item()
    # the transcription's means sit at least as close to float64 as PyTorch's own
    for j, k in ((0, 4), (1, 1)):
        ref = values[j].astype(np.float64).mean()
        assert abs(float(stats[k]) - ref) <= abs(float(torch.as_tensor(values[j]).mean()) - ref) \
            + abs(ref) * 2.0 ** -24


def test_a_first_minibatchs_approx_kl_and_clip_frac_are_exactly_zero():
    """Recomputed from the rollout's own parameters every row's log-ratio is +0 (so
    -log_ratio is -0) and no row clips: the sums give exactly 0 for both."""
    n = 65_536
    rng = np.random.default_rng(1)
    values = [np.full(n, -0.0, np.float32), rng.normal(size=n).astype(np.float32),
              rng.random(n).astype(np.float32), np.zeros(n, np.float32)]
    stats = chip_smoke.head_sums_model(values, np.array([-0.5, -0.9], np.float32))
    assert stats[4] == 0.0 and stats[5] == 0.0


@pytest.mark.parametrize("n", [65_536, 32_768, 4097, 384, 1])
def test_moment_order_takes_every_row_of_a_minibatch_once(n):
    """Each of the moments kernel's threads takes its rows in increasing order, and the
    cluster's threads together take each of a minibatch's rows once."""
    _, threads, cluster = chip_smoke.head_sums_shape()
    threads *= cluster
    order = chip_smoke.moment_order(n, threads)
    taken = order[order >= 0]
    assert sorted(taken.tolist()) == list(range(n))
    for t in range(min(threads, n)):
        rows = order[:, t][order[:, t] >= 0]
        assert (np.diff(rows) > 0).all() and rows[0] == t


def _moments_case(data_shards: int, block: int, seed: int):
    """Advantages as the rollout's units [D * n_units, block] (mean 3, std 2) and the
    update's minibatch index, at ``block``-row units and ``data_shards`` shards."""
    cfg = base_config(num_envs=128, num_steps=32, update_epochs=2, shuffle_block_size=block,
                      data_shards=data_shards)
    got_block, n_units, _ = tppo.minibatch_layout(cfg)
    assert got_block == block
    rng = np.random.default_rng(seed)
    adv = (3.0 + 2.0 * rng.normal(size=(data_shards * n_units, block))).astype(np.float32)
    gen = torch.Generator().manual_seed(seed)
    perms = torch.stack([torch.stack([torch.randperm(n_units, generator=gen)
                                      for _ in range(data_shards)])
                         for _ in range(cfg.update_epochs)])
    return cfg, adv, tppo.minibatch_index(cfg, perms).numpy()


@pytest.mark.parametrize("block", [64, 4, 1])
@pytest.mark.parametrize("data_shards", [1, 2])
def test_moments_transcription_is_within_the_tolerance_of_jax(data_shards, block):
    cfg, adv, index = _moments_case(data_shards, block, 7 * block + data_shards)
    model = chip_smoke.moments_model(adv, index)
    rows = adv[index].reshape(index.shape[0], -1)
    assert rows.shape[1] == cfg.minibatch_size
    jmean, jstd = jax.jit(lambda a: (a.mean(axis=1), a.std(axis=1, ddof=1)))(jnp.asarray(rows))
    plain = mbops.advantage_moments_plain(torch.as_tensor(adv), torch.as_tensor(index)).numpy()
    for i in range(index.shape[0]):
        for j, (bound, jax_value) in enumerate(((chip_smoke.sum_bound, jmean), (chip_smoke.std_bound, jstd))):
            ref, tol = bound(rows[i], float(plain[i, j]))
            got = float(model[i, j])
            assert abs(got - ref) <= tol, (i, j, got, ref, tol)
            assert abs(got - float(jax_value[i])) <= tol, (i, j, got, float(jax_value[i]), tol)
            assert abs(got - float(plain[i, j])) <= tol, (i, j, got, float(plain[i, j]), tol)


def test_one_row_minibatches_give_the_row_and_nan():
    adv = np.array([[1.5], [-2.25], [0.0]], np.float32)
    index = np.array([[2], [0], [1]])
    model = chip_smoke.moments_model(adv, index)
    plain = mbops.advantage_moments_plain(torch.as_tensor(adv), torch.as_tensor(index)).numpy()
    np.testing.assert_array_equal(model[:, 0], adv[index[:, 0], 0])
    np.testing.assert_array_equal(plain[:, 0], model[:, 0])
    assert np.isnan(model[:, 1]).all() and np.isnan(plain[:, 1]).all()
    assert mbops.advantage_moments_launches == 0
