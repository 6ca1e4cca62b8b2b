#!/usr/bin/env python3
"""What holds the MLP kernels back, on the card.

  python scripts/mlp_kernel_split.py [--kernels parent new] [--rows N] [--out FILE]
      [--rates]

Builds stripped variants of ``mlp_forward_f32`` and ``mlp_backward_f32`` (the source
compiled with an early exit at one split point, ``-DMLP_SPLIT_STOP=k``) and times
them in turns in CUDA graphs of 20 launches (``chip_smoke.graph_ms``: median of 21
replays, CUDA events) at ``--rows`` (default 65,536: a minibatch of ``train scale``
and ``train single``) rows, towers (19, 64, 64), (15, 64, 64) and (19, 128, 128), on
``chip_smoke.mlp_case``'s inputs. Two sources:

- ``parent``: the FFMA kernels these replaced (``mlp_variants.parent_mlp_source``: commit
  ``mlp_variants.PARENT_MLP``), a block a tower and a 128-row tile;
- ``new``: the port's ``csrc/mlp_towers.cu``, the products on the tensor cores.

The split points, each variant everything before it:

  forward:  staged    - the weights and the tile's observations in shared memory;
            layer1    - and the first hidden layer;
            layer2    - and the second;
            full      - the kernel (the last layers, mu and v written).
  backward: staged    - as above;
            recompute - and the tile's forward, the hidden layers;
            g3_w3     - and the last layer's gradient g3, W3's and b3's gradients;
            w2_grad   - and g2, W2's and b2's gradients;
            g1        - and g1 (in the new kernel W2's gradient comes after g1,
                        so this is g1 without W2's and b2's gradients there);
            full      - the kernel (W1's and b1's gradients).

The port's kernels are also timed each without one part (its marginal cost; the
outputs are wrong): forward no_tanh (the hidden layers' tanh left out); backward
no_dw (the tensor-core weight gradients h1^T g2 and x^T g1 left out), no_tanh,
no_narrow (W3's gradient and the bias sums), no_g1 (the product g2 W2^T).

``--rates`` also builds ``scripts/mma_tf32_rate.cu`` and prints the card's rates
for what the products issue: mma.sync.m16n8k8 TF32 back to back, the same with the B
operand split first, and FFMA, at 4, 8 and 16 warps an SM.

Every variant of a source is timed twice, in order and then in reverse order, and
each source's full forward is held to the plain composition within phase p's
tolerance first. Prints each variant's registers (``-Xptxas -v``), a summary, and one
JSON line with the card's name and power limit; ``--out`` also writes it to a file.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import mlp_variants  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402
from self_play_racing_tpu_torch.ops import mlp as mlpops  # noqa: E402

TOWERS = ((19, 64, 64), (15, 64, 64), (19, 128, 128))
FORWARD = (("staged", 0), ("layer1", 1), ("layer2", 2), ("full", 99))
BACKWARD = (("staged", 10), ("recompute", 11), ("g3_w3", 12), ("w2_grad", 13), ("g1", 14),
            ("full", 99))
# the port's kernels also without one part each (its marginal cost; the outputs wrong)
FORWARD_NEW = (("no_tanh", 3),)
BACKWARD_NEW = (("no_dw", 20), ("no_tanh", 21), ("no_narrow", 22), ("no_g1", 23))
STOP = "#ifndef MLP_SPLIT_STOP\n#define MLP_SPLIT_STOP 99\n#endif\n"
# what a stripped variant of the port's kernels computed, kept (``sink(v, out)`` at
# its split points) so that the compiler does not drop it
SINK = """template <int NJ>
__device__ __forceinline__ void sink(const float (&v)[NJ][4], float* out) {
    float s = 0.0f;
    for (int j = 0; j < NJ; ++j)
        for (int e = 0; e < 4; ++e) s += v[j][e];
    if (s == 1234.5f) *out = s;
}
"""

# the parent's split points: (anchor, replacement), applied in order, each anchor
# found once (the port's source marks its own with "// split: <kernel> <name>" lines)
PARENT_EDITS = [
        ("    hidden_forward(L, s);\n    const int r = threadIdx.x;",
         "    if (MLP_SPLIT_STOP == 0) { if (threadIdx.x == 0) out[row0 * O] = s[L.x + 1]; return; }\n"
         "    hidden_forward(L, s);\n"
         "    if (MLP_SPLIT_STOP < 10) {\n"
         "        if (threadIdx.x == 0) out[row0 * O] = s[MLP_SPLIT_STOP == 1 ? L.a1 : L.a2];\n"
         "        return;\n    }\n"
         "    const int r = threadIdx.x;"),
        ("    __syncthreads();\n    tile_times<H2>(a1, W + L.w2, H1,",
         "    __syncthreads();\n    if (MLP_SPLIT_STOP == 1) return;\n"
         "    tile_times<H2>(a1, W + L.w2, H1,"),
        ("    hidden_forward(L, s);\n    tower_gradients<H1, H2, O, kTanhOut>(L, g3, s, part);",
         "    if (MLP_SPLIT_STOP == 10) { if (threadIdx.x == 0) part[0] = s[L.x + 1] + g3[0]; return; }\n"
         "    hidden_forward(L, s);\n"
         "    if (MLP_SPLIT_STOP == 11) { if (threadIdx.x == 0) part[0] = s[L.a2] + g3[0]; return; }\n"
         "    tower_gradients<H1, H2, O, kTanhOut>(L, g3, s, part);"),
        ("    __syncthreads();\n    // g2 = (g3 W3^T) * (1 - h2^2), in place of row r's h2",
         "    __syncthreads();\n    if (MLP_SPLIT_STOP == 12) return;\n"
         "    // g2 = (g3 W3^T) * (1 - h2^2), in place of row r's h2"),
        ("    row_sums<H2>(a2, part + L.b2);\n    __syncthreads();",
         "    row_sums<H2>(a2, part + L.b2);\n    __syncthreads();\n"
         "    if (MLP_SPLIT_STOP == 13) return;"),
        ("    __syncthreads();\n    // W1's and b1's gradients: x^T g1 and the sum of g1",
         "    __syncthreads();\n    if (MLP_SPLIT_STOP == 14) return;\n"
         "    // W1's and b1's gradients: x^T g1 and the sum of g1"),
]


def patched(text: str, source: str) -> str:
    if source == "new":
        out = []
        for line in text.splitlines(keepends=True):
            found = re.match(r"(\s*)// split: (\w+) (\w+)(.*)\n", line)
            if found:
                indent, kind, name, tail = found.groups()
                kinds = {"forward": [FORWARD + FORWARD_NEW], "backward": [BACKWARD + BACKWARD_NEW],
                         "any": [FORWARD + FORWARD_NEW, BACKWARD + BACKWARD_NEW]}[kind]
                cond = " || ".join(f"MLP_SPLIT_STOP == {dict(v)[name]}" for v in kinds)
                out.append(f"{indent}if ({cond}){tail.strip() or ' return;'}\n")
            else:
                out.append(line)
        return STOP + SINK + "".join(out)
    for anchor, replacement in PARENT_EDITS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{source}: anchor found {text.count(anchor)} times: {anchor!r}")
        text = text.replace(anchor, replacement)
    return STOP + text


def sources(kinds) -> dict:
    out = {}
    for kind in kinds:
        if kind == "new":
            out[kind] = (_cuda.CSRC_DIR / "mlp_towers.cu").read_text()
        else:
            text = mlp_variants.parent_mlp_source()
            if text is None:
                raise RuntimeError(f"no source of {mlp_variants.PARENT_MLP}: unpack `git archive "
                                   f"{mlp_variants.PARENT_MLP}` into scratch_checkout/"
                                   f"{mlp_variants.PARENT_MLP}/")
            out[kind] = text
    return out


def build_all(texts: dict) -> dict:
    """Every (source, stop) variant's library, built in parallel."""
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=16) as pool:
        for kind, text in texts.items():
            code = patched(text, kind)
            stops = FORWARD + BACKWARD + (FORWARD_NEW + BACKWARD_NEW if kind == "new" else ())
            for stop in sorted({s for _, s in stops}):
                jobs[kind, stop] = pool.submit(mlp_variants.build_mlp_lib, code,
                                               f"{kind}_{stop}", (f"MLP_SPLIT_STOP={stop}",))
        return {k: f.result() for k, f in jobs.items()}


def registers(report: str) -> dict:
    regs = chip_smoke.kernel_registers(report, "mlp_")
    return {("forward" if "forward" in k else "backward" if "backward" in k else "reduce")
            + re.sub(r".*ILi(\d+)ELi(\d+)E.*", r"_\1_\2", k): v for k, v in regs.items()}


def rates(dev) -> dict:
    """``scripts/mma_tf32_rate.cu``: mma.sync.m16n8k8 TF32 back to back (8 independent
    accumulators a warp), the same with each B fragment split first (by cvt.rna, by
    the same rounding on the integer view, and by that for hi alone), and FFMA (16
    chains a thread), at 4, 8 and 16 warps an SM over 132 SMs: TFLOP/s (an m16n8k8
    2,048 operations, an FFMA 2), the best of 5 runs."""
    import ctypes
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mma_tf32_rate.cu")
    out = os.path.join(tempfile.mkdtemp(prefix="mma_rate_"), "rate.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.rate_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    buf = torch.zeros((1024,), device=dev)
    iters, result = 4096, {}
    for kind, name in enumerate(("mma", "mma_split_b", "ffma", "mma_split_b_int",
                                 "mma_split_b_hi_only")):
        for warps in (4, 8, 16):
            blocks, threads = 132 * warps // 4, 128
            launch = lambda: lib.rate_launch(kind, blocks, threads, iters, buf.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream)
            launch()
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                launch()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            ops = (blocks * threads * iters * 16 * 2 if kind == 2
                   else blocks * threads // 32 * iters * 8 * 2048)
            result[f"{name}_{warps}_warps_an_sm"] = ops / best / 1e12
            print(f"rate {name} at {warps} warps an SM: {ops / best / 1e12:.1f} TFLOP/s")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", nargs="*", default=["parent", "new"],
                    choices=["parent", "new"])
    ap.add_argument("--rows", type=int, default=65_536)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rates", action="store_true",
                    help="also time scripts/mma_tf32_rate.cu (the tensor cores' and FFMA's "
                         "rates)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mlp_kernel_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    libs = build_all(sources(args.kernels))
    result = {"card": card, "rows": args.rows, "registers": {}, "towers": {},
              "rates": rates(dev) if args.rates else None}
    for (kind, stop), lib in libs.items():
        result["registers"][f"{kind}_{stop}"] = registers(lib.report)
    n = args.rows
    for dims in TOWERS:
        case = chip_smoke.mlp_case(dims[0], dims[1:], n, seed=7)
        params, leaves, obs, g_mu, g_v = chip_smoke.mlp_tensors(case, dev)
        w = [x.detach() for x in leaves]
        with torch.no_grad():
            mu_p, v_p = mlpops.actor_critic_mlp_plain(params, obs)
        bounds = chip_smoke.mlp_bounds([mu_p, v_p], [mu_p, v_p])
        calls = []
        for kind in args.kernels:
            extra = kind == "new"
            for part, stops in (("forward", FORWARD + (FORWARD_NEW if extra else ())),
                                ("backward", BACKWARD + (BACKWARD_NEW if extra else ()))):
                for name, stop in stops:
                    mu, v = torch.empty((n, 2), device=dev), torch.empty((n,), device=dev)
                    fwd, bwd, _ = mlp_variants.mlp_lib_calls(libs[kind, stop], obs, None, w, mu,
                                                           v, g_mu, g_v, n, dims)
                    if part == "forward" and name == "full":
                        fwd()
                        torch.cuda.synchronize()
                        errs = chip_smoke.mlp_errors([mu, v], [mu_p, v_p])
                        if not all(e <= b for e, b in zip(errs, bounds)):
                            raise AssertionError(f"{kind} {dims}: forward beyond the "
                                                 f"tolerance {errs} {bounds}")
                    calls.append((f"{kind}.{part}.{name}", fwd if part == "forward" else bwd))
        times = {k: [] for k, _ in calls}
        for order in (calls, calls[::-1]):
            for key, fn in order:
                times[key].append(chip_smoke.graph_ms(fn) * 1e3)
        label = "x".join(map(str, dims))
        result["towers"][label] = times
        for key, us in times.items():
            print(f"{label} {key}: {us[0]:.2f}, {us[1]:.2f} us in a graph")
    print(f"card: {card}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
