#!/usr/bin/env python3
"""What the global norm costs in ``mlp_grad_reduce``'s launch, on the card.

  python scripts/grad_norm_variants.py [--rows N] [--out FILE]

Builds ``csrc/mlp_towers.cu`` with the last block's sum of the blocks' squares
(``mlp_grad_reduce_kernel``'s tail, after the ticket) written each of these ways,
beside the source as it is (``port``: the squares staged in shared memory by all
the block's threads, 256 at a time, then one thread adds them one after another in
block-index order):

- ``ticket``: no sum: the last block writes sqrtf of block 0's square alone (the
  norm wrong): the ticket, the fence and the lane tree without the tail's sum;
- ``staged_vector``: the port's order and bits, the one thread reading the staged
  squares four at a time (``float4``), so its loads run ahead of its adds;
- ``tree``: thread t adds squares t, t + 256, ... in order, then a shuffle tree over
  each warp's lanes and the 8 warps in order (another fixed order: other bits).

Each is timed in a CUDA graph of 20 launches (``chip_smoke.graph_ms``) in turns (in
order, then in reverse order) at ``--rows`` rows (default 65,536) of train scale's
towers (19, 64, 64) on ``chip_smoke.mlp_case``'s inputs: the reduce with its norm
over the backward's partials, and the norm-only mode over the flat; beside the
reduce without the norm and its launch floor. Every variant's flat is bitwise the
port's; the norms of the variants in the port's order bitwise the port's, the tree's
within phase p's rule (``chip_smoke.norm_bound``). Prints the times and one JSON line
with the card's name and power limit; ``--out`` also writes it to a file. Needs a
CUDA card.
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
from self_play_racing_tpu_torch.agent import ppo  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402

TAIL_START = "    // the last block: every other block's square is in the L2 (read past the L1)\n"
TAIL_END = "    if (tid == 0) *norm = sqrtf(total);\n}\n"
TAILS = {
    "ticket": """    if (threadIdx.x == 0 && threadIdx.y == 0) *norm = sqrtf(__ldcg(block_sq));
}
""",
    "staged_vector": """    __threadfence();
    const int tid = g * kReduceLanes + lane;
    float total = 0.0f;
    for (unsigned b0 = 0; b0 < gridDim.x; b0 += kGroups * kReduceLanes) {
        if (b0 + tid < gridDim.x) stage[tid] = __ldcg(block_sq + b0 + tid);
        __syncthreads();
        if (tid == 0) {
            const unsigned m = gridDim.x - b0 < kGroups * kReduceLanes
                ? gridDim.x - b0 : kGroups * kReduceLanes;
            const float4* q = reinterpret_cast<const float4*>(stage);
            unsigned i = 0;
#pragma unroll 8
            for (; i + 4 <= m; i += 4) {
                const float4 f = q[i / 4];
                total += f.x;
                total += f.y;
                total += f.z;
                total += f.w;
            }
            for (; i < m; ++i) total += stage[i];
        }
        __syncthreads();
    }
    if (tid == 0) *norm = sqrtf(total);
}
""",
    "tree": """    __threadfence();
    const int tid = g * kReduceLanes + lane;
    float v = 0.0f;
    for (unsigned b = tid; b < gridDim.x; b += kGroups * kReduceLanes) v += __ldcg(block_sq + b);
#pragma unroll
    for (int o = kReduceLanes / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) stage[g] = v;
    __syncthreads();
    if (tid == 0) {
        float total = stage[0];
        for (int i = 1; i < kGroups; ++i) total += stage[i];
        *norm = sqrtf(total);
    }
}
""",
}


def variant(text: str, name: str) -> str:
    if name == "port":
        return text
    if text.count(TAIL_START) != 1 or text.count(TAIL_END) != 1:
        raise RuntimeError("csrc/mlp_towers.cu: the reduce's tail anchors are not found once")
    head, rest = text.split(TAIL_START)
    _, tail = rest.split(TAIL_END)
    return head + TAIL_START + TAILS[name] + tail


def calls(lib, partial, flat, norm, ticket):
    """(fused, norm-only, without the norm) launches of ``lib``'s reduce."""
    dev = partial.device
    block_sq = torch.empty((_cuda.mlp_grad_norm_blocks(partial.shape[1]),), device=dev)

    def call(fn, *args):
        err = getattr(lib, fn)(*args, dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{fn}: cudaError {err}")

    p, f, n, b, t = (_cuda._ptr(x) for x in (partial, flat, norm, block_sq, ticket))
    rows, params = partial.shape
    return (lambda: call("mlp_grad_reduce_norm_f32", p, f, n, b, t, rows, params),
            lambda: call("mlp_grad_reduce_norm_f32", f, None, n, b, t, 1, params),
            lambda: call("mlp_grad_reduce_f32", p, f, rows, params))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=65_536)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_norm_variants: no CUDA device", file=sys.stderr)
        return 1
    dev, card, n, dims = torch.device("cuda", 0), chip_smoke.card_line(), args.rows, (19, 64, 64)
    text = (_cuda.CSRC_DIR / "mlp_towers.cu").read_text()
    names = ("port", "ticket", "staged_vector", "tree")
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
        jobs = {k: pool.submit(mlp_variants.build_mlp_lib, variant(text, k), k) for k in names}
        libs = {k: f.result() for k, f in jobs.items()}
    _, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(
        chip_smoke.mlp_case(dims[0], dims[1:], n, seed=7), dev)
    w = [x.detach() for x in leaves]
    partial = torch.empty((_cuda.mlp_partial_rows(n), sum(x.numel() for x in w)), device=dev)
    _cuda.launch_mlp_backward(obs, None, w, g_mu, g_v, partial, n, dims)
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    out, runs = {}, {}
    for k, lib in libs.items():
        flat, norm = torch.empty((partial.shape[1],), device=dev), torch.empty((), device=dev)
        only = torch.empty((), device=dev)
        fused, norm_only, bare = calls(lib, partial, flat, norm, ticket)
        fused()
        _, just_norm, _ = calls(lib, partial, flat, only, ticket)
        just_norm()
        torch.cuda.synchronize()
        out[k] = (flat.clone(), norm.clone(), only.clone())
        runs[k] = (fused, norm_only, bare)
    want = out["port"]
    views, at = [], 0
    for x in w:
        views.append(want[0][at:at + x.numel()].view_as(x))
        at += x.numel()
    n64, bound = chip_smoke.norm_bound(want[0], ppo.global_norm(views))
    checks = {}
    for k, (flat, norm, only) in out.items():
        if not chip_smoke.same_bits(flat, want[0]):
            raise AssertionError(f"{k}: the flat differs from the port's")
        same = chip_smoke.same_bits(norm, want[1]) and chip_smoke.same_bits(only, norm)
        err = abs(float(norm) - n64)
        if k in ("port", "staged_vector") and not same:
            raise AssertionError(f"{k}: the norm's bits differ from the port's")
        if k == "tree" and not (err <= bound and chip_smoke.same_bits(only, norm)):
            raise AssertionError(f"tree: the norm {float(norm)!r} beyond the rule")
        checks[k] = {"norm": float(norm), "bitwise_the_port": same, "error": err,
                     "bound": bound}
        print(f"{k}: norm {float(norm)!r}, bitwise the port's {same}, error {err:.3e} "
              f"(bound {bound:.3e})")
    one, one_out = torch.zeros((1, 1), device=dev), torch.empty((1,), device=dev)
    times = {f"{k}.{mode}": [] for k in names for mode in ("fused", "norm_only")}
    times["port.without_norm"], times["launch_floor"] = [], []
    order = [(f"{k}.{mode}", runs[k][i]) for k in names
             for i, mode in enumerate(("fused", "norm_only"))]
    order += [("port.without_norm", runs["port"][2]),
              ("launch_floor", lambda: _cuda.launch_mlp_grad_reduce(one, one_out))]
    for seq in (order, order[::-1]):
        for key, fn in seq:
            times[key].append(chip_smoke.graph_ms(fn) * 1e3)
    for key, us in times.items():
        print(f"{key}: {us[0]:.2f}, {us[1]:.2f} us in a graph")
    print(f"card: {card}")
    line = json.dumps({"card": card, "rows": n, "towers": list(dims), "us_in_a_graph": times,
                       "checks": checks})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
