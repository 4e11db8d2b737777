#!/usr/bin/env python3
"""How far the K2 kernels' bf16-query-over-float32-pool recipe lands from
the float32 one, with exact products: the recipe the Hopper body runs on
the tensor cores (K, V and P split into bf16 halves, x = hi + lo;
S = q K_hi + q K_lo, O = P_hi V_hi + P_lo V_hi + P_hi V_lo) emulated in
float64 on the CPU, against attention computed in float64 from the same
bf16 query and float32 K / V, both rounded to bf16.

Run from the root of a checkout: ``python3 tools/f32pool_recipe.py``.
Prints the share of outputs that differ, and the count past one bf16 ulp
measured at each output's own magnitude and at least at 2^-8 of its
row's largest (the rule ``chip_smoke.held_f32pool`` and the GPU tests
apply to the kernel), with the row-relative magnitude of the outputs
past the first. Needs only PyTorch.
"""
import argparse

import torch


def bf16(x):
    return x.to(torch.bfloat16).double()


def split(x):
    hi = bf16(x)
    return hi, bf16(x - hi)


def past_one_ulp(got, ref, floor):
    """Outputs of ``got`` more than one bf16 ulp from ``ref`` (both bf16
    values), the ulp taken at the larger magnitude and at least at
    ``floor``."""
    _, e = torch.frexp(torch.maximum(torch.maximum(got.abs(), ref.abs()),
                                     floor))
    return (got - ref).abs() > torch.ldexp(torch.ones_like(got), e - 8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vectors", type=int, default=2048)
    ap.add_argument("--positions", type=int, default=700)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    g = torch.Generator().manual_seed(args.seed)
    n, L, D = args.vectors, args.positions, args.head_dim
    q = bf16(torch.randn(n, D, generator=g))
    k = torch.randn(L, D, generator=g).double()
    v = torch.randn(L, D, generator=g).double()
    scale = D ** -0.5
    ref = torch.softmax(q @ k.T * scale, -1) @ v
    k_hi, k_lo = split(k)
    v_hi, v_lo = split(v)
    s = (q @ k_hi.T + q @ k_lo.T) * scale
    p = torch.exp(s - s.max(-1, keepdim=True).values).float().double()
    p_hi, p_lo = split(p)
    out = (p_hi @ v_hi + p_lo @ v_hi + p_hi @ v_lo) / p.sum(-1, keepdim=True)
    got, want = bf16(out), bf16(ref)
    row = want.abs().amax(-1, keepdim=True).expand_as(want)
    own = past_one_ulp(got, want, torch.zeros_like(want))
    floored = past_one_ulp(got, want, row * 2.0 ** -8)
    print(f"{n} vectors x {L} positions, D {D}: "
          f"{float((got != want).double().mean()):.4%} of outputs differ; "
          f"{int(own.sum())} past one ulp of their own magnitude "
          f"({float(own.double().mean()):.4%}), the largest of them at "
          f"{float((want.abs() / row)[own].max()) if own.any() else 0:.2e}"
          f" of its row's largest; {int(floored.sum())} past one ulp with "
          "the 2^-8 row floor; relative error before rounding "
          f"{float((out - ref).norm() / ref.norm()):.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
