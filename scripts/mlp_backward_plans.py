#!/usr/bin/env python3
"""Which shared-memory layout the MLP backward should take, on the card.

  python scripts/mlp_backward_plans.py [--rows N] [--out FILE]

``mlp_backward_f32`` (``csrc/mlp_towers.cu``) accumulates each block's weight
gradients in shared memory or in its row of the partials (device memory), with two
tiles of observations (the next one prefetched) or one. Its ``plan`` takes the first
of these, in that order, that keeps ``kBackwardBlocksPerSm`` blocks an SM, else the
first that fits a block. This script builds the source with the backward forced to
each layout (``shared`` or ``partial``, 2 or 1 tiles: the first from there that fits
a block), beside the source as it is (``plan``) and the FFMA kernels it replaced
(``parent``: ``mlp_variants.parent_mlp_source``), and times each backward in turns
(in order, then in reverse order) in a CUDA graph (``chip_smoke.graph_ms``) at
``--rows`` rows (default 65,536) on ``chip_smoke.mlp_case``'s inputs, at self-play's
towers of 1 to 8 cars of 11 sensors (11 + 4 x cars inputs: one car's are the
single-car towers' 15) on (64, 64) and at (19, 128, 128). Each
layout's gradients (the backward, then ``mlp_grad_reduce_f32``) must equal the
source's bit for bit: the sums and their order are the same wherever they
accumulate. Prints each layout's blocks an SM and times, and one JSON line with the
card's name and power limit; ``--out`` also writes it to a file. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import mlp_variants  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402

TOWERS = tuple((11 + 4 * cars, 64, 64) for cars in range(1, 9)) + ((19, 128, 128),)
# the lines whose numbers a forced build changes: the occupancy the plan aims for
# (1: the first layout that fits a block), and where its loops over the layouts start
BLOCKS = "constexpr int kBackwardBlocksPerSm = 2;"
SHARED = "for (int shared = 1; shared >= 0 && !p.backward_nbuf; --shared) {"
NBUF = "for (int nbuf = 2; nbuf >= 1 && !p.backward_nbuf; --nbuf) {\n                if (4LL * L.backward_floats"


def forced(text: str, shared: int, nbuf: int) -> str:
    for anchor in (BLOCKS, SHARED, NBUF):
        if text.count(anchor) != 1:
            raise RuntimeError(f"csrc/mlp_towers.cu: anchor found {text.count(anchor)} "
                               f"times: {anchor!r}")
    return (text.replace(BLOCKS, BLOCKS.replace("= 2", "= 1"))
            .replace(SHARED, SHARED.replace("shared = 1", f"shared = {shared}"))
            .replace(NBUF, NBUF.replace("nbuf = 2", f"nbuf = {nbuf}")))


def backward_calls(lib, obs, w, g_mu, g_v, n: int, dims):
    """(the backward, the reduce) of ``lib`` on the current stream, and the reduced
    gradients' buffer."""
    params = sum(x.numel() for x in w)
    partial = torch.empty((mlp_variants.lib_partial_rows(lib, n), params), device=obs.device)
    flat = torch.empty((params,), device=obs.device)
    ptrs, block, units = _cuda._mlp_inputs(obs, None, w)
    table = _cuda._ptr_array(ptrs + [g_mu, g_v, partial])
    stream = lambda: torch.cuda.current_stream(obs.device).cuda_stream

    def check(err, fn):
        if err:
            raise RuntimeError(f"{fn}: cudaError {err}")

    def backward():
        check(lib.mlp_backward_f32(table, _cuda.MLP_INPUTS + 3, n, block, units, *dims,
                                   obs.device.index, stream()), "mlp_backward_f32")

    def reduce():
        check(lib.mlp_grad_reduce_f32(_cuda._ptr(partial), _cuda._ptr(flat), partial.shape[0],
                                      partial.shape[1], obs.device.index, stream()),
              "mlp_grad_reduce_f32")

    return backward, reduce, flat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=65_536)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mlp_backward_plans: no CUDA device", file=sys.stderr)
        return 1
    dev, card, n = torch.device("cuda", 0), chip_smoke.card_line(), args.rows
    text = (_cuda.CSRC_DIR / "mlp_towers.cu").read_text()
    parent = mlp_variants.parent_mlp_source()
    sources = {"plan": text}
    for shared, place in ((1, "shared"), (0, "partial")):
        for nbuf in (2, 1):
            sources[f"{place}_{nbuf}_tiles"] = forced(text, shared, nbuf)
    if parent is not None:
        sources["parent"] = parent
    else:
        print(f"no source of {mlp_variants.PARENT_MLP}: the FFMA kernels are not timed")
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        jobs = {k: pool.submit(mlp_variants.build_mlp_lib, t, k) for k, t in sources.items()}
        libs = {k: f.result() for k, f in jobs.items()}
    result = {"card": card, "rows": n, "towers": {}}
    for dims in TOWERS:
        case = chip_smoke.mlp_case(dims[0], dims[1:], n, seed=7)
        _, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, dev)
        w = [x.detach() for x in leaves]
        calls = {k: backward_calls(lib, obs, w, g_mu, g_v, n, dims) for k, lib in libs.items()}
        for backward, reduce, _ in calls.values():
            backward()
            reduce()
        torch.cuda.synchronize()
        want = calls["plan"][2].view(torch.int32)
        for key, (_, _, flat) in calls.items():
            if key != "parent" and not torch.equal(flat.view(torch.int32), want):
                raise AssertionError(f"{dims}: the {key} layout's gradients differ from the "
                                     f"plan's")
        times = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):
            for key in order:
                times[key].append(chip_smoke.graph_ms(calls[key][0]) * 1e3)
        blocks = {k: libs[k].mlp_blocks_per_sm(*dims, 1) for k in sources if k != "parent"}
        label = "x".join(map(str, dims))
        result["towers"][label] = {"backward_us": times, "blocks_per_sm": blocks}
        for key, us in times.items():
            print(f"{label} {key}: backward {us[0]:.2f}, {us[1]:.2f} us in a graph"
                  + (f", {blocks[key]} blocks an SM" if key in blocks else ""))
    print(f"card: {card}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
