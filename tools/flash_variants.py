#!/usr/bin/env python3
"""Time versions of the flash-attention kernels against each other in
one process on one GPU: each argument is a ``csrc`` directory (this
checkout's ``paddle_tpu_torch/csrc``, or a copy with a change, or a
parent commit's unpacked with ``git archive``).

Run from the root of a checkout:

    python3 tools/flash_variants.py OLD/csrc paddle_tpu_torch/csrc

Each directory's ``flash_attention_fwd``, ``flash_attention_bwd``,
``flashmask_fwd`` and ``flashmask_bwd`` sources are built by ``nvcc``
into their own libraries under ``build/flash_variants/<i>/`` (with
``-Xptxas -v``: registers and spills of each Hopper kernel are
printed), loaded with ctypes, and run on the same bfloat16 inputs: K1f,
K1dq and K1dkv at ``chip_smoke.py``'s phase-2 shape (B 2, L 4096, 32 / 8
heads, D 128, causal) and K6f, K6dq and K6dkv at phase 15's 16k row of
8 documents. Versions are timed in turns, first to last and back (A B
B A), with ``chip_smoke.time_ms``; cards and neighbours differ between
calls, so only versions timed in one run compare. Every version's
outputs are held against the first's: equal to the bit, or their
largest row-relative difference.
"""
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "flashmask_fwd",
           "flashmask_bwd")


def build(dirs, _build):
    """Compile every source of every directory at once; print ptxas's
    registers and spills of the Hopper kernels."""
    procs = []
    for i, d in enumerate(dirs):
        out = os.path.join(os.path.dirname(HERE), "build", "flash_variants",
                           str(i))
        os.makedirs(out, exist_ok=True)
        for name in SOURCES:
            cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-I", d, "-o", os.path.join(out, f"lib{name}.so"),
                   os.path.join(d, f"{name}.cu")]
            procs.append((i, name, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = [{} for _ in dirs]
    for i, name, out, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {dirs[i]}/{name}.cu:\n{log}")
        lines = log.splitlines()
        for j, line in enumerate(lines):
            kern = re.search(r"(\w+_tma_kernel)ILi(\d+)ENS0_\d+(\w+?)EE",
                             line)
            if "Compiling entry" in line and kern:
                info = [re.sub(r".*: *", "", x).strip()
                        for x in lines[j + 1:j + 4]
                        if "spill" in x or "registers" in x]
                print(f"  [{i}] {kern[1]}<{kern[2]}, {kern[3]}>: "
                      + "; ".join(info), flush=True)
        libs[i][name] = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
    return libs


def bind(lib):
    """argtypes of the four entry points (see their .cu files)."""
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib["flash_attention_fwd"].ptt_flash_attention_fwd.argtypes = \
        [ptr] * 5 + [i32] * 6 + tail
    lib["flash_attention_bwd"].ptt_flash_attention_dq.argtypes = \
        [ptr] * 7 + [i32] * 6 + tail
    lib["flash_attention_bwd"].ptt_flash_attention_dkv.argtypes = \
        [ptr] * 8 + [i32] * 6 + tail
    lib["flashmask_fwd"].ptt_flashmask_fwd.argtypes = \
        [ptr] * 8 + [i32] * 7 + tail
    lib["flashmask_bwd"].ptt_flashmask_dq.argtypes = \
        [ptr] * 10 + [i32] * 7 + tail
    lib["flashmask_bwd"].ptt_flashmask_dkv.argtypes = \
        [ptr] * 11 + [i32] * 7 + tail


def main(argv):
    import torch
    if not torch.cuda.is_available() or not argv:
        print("flash_variants: needs a CUDA device and csrc directories",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(HERE))
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flashmask as fm

    print(cs.card_line(), flush=True)
    libs = build(argv, _build)
    for lib in libs:
        bind(lib)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)

    def rnd(*sh):
        return torch.randn(*sh, generator=g, device="cuda").bfloat16()

    B, L, H, Hkv, D = (cs.ATTN[k] for k in ("B", "L", "H", "Hkv", "D"))
    L6, docs = cs.FLASHMASK_ROW["L"], cs.FLASHMASK_ROW["docs"]
    scale = D ** -0.5
    st = torch.cuda.current_stream().cuda_stream
    P = lambda t: t.data_ptr()  # noqa: E731
    # K1 at phase 2's shape
    q, k, v, do = rnd(B, L, H, D), rnd(B, L, Hkv, D), rnd(B, L, Hkv, D), \
        rnd(B, L, H, D)
    o, lse = torch.empty_like(q), torch.empty(B, H, L, device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    # K6 at phase 15's 16k row
    q6, k6, v6, do6 = rnd(1, L6, H, D), rnd(1, L6, Hkv, D), \
        rnd(1, L6, Hkv, D), rnd(1, L6, H, D)
    idx = torch.from_numpy(cs.doc_bounds([L6 // docs] * docs)).cuda()[
        None, None, :, None].contiguous()
    start, end = fm.flashmask_bounds(idx, L6, H, Hkv)
    tiles = torch.empty(1, (L6 + 63) // 64, 2, dtype=torch.int32,
                        device="cuda")
    o6, lse6 = torch.empty_like(q6), torch.empty(1, H, L6, device="cuda")
    dq6, dk6, dv6 = torch.empty_like(q6), torch.empty_like(k6), \
        torch.empty_like(v6)
    # lse and delta of the backward passes: from the first version
    f = libs[0]
    assert f["flash_attention_fwd"].ptt_flash_attention_fwd(
        P(q), P(k), P(v), P(o), P(lse), B, L, L, H, Hkv, D, scale, 1, 1,
        st) == 0
    assert f["flashmask_fwd"].ptt_flashmask_fwd(
        P(q6), P(k6), P(v6), P(start), P(end), P(tiles), P(o6), P(lse6), 1,
        L6, L6, H, Hkv, 1, D, scale, 1, 1, st) == 0
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    delta6 = (do6.float() * o6.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    lse_k1, lse_k6 = lse.clone(), lse6.clone()

    def kernels(lib):
        a, m = lib["flash_attention_bwd"], lib["flashmask_bwd"]
        a1 = (P(q), P(k), P(v), P(do), P(lse_k1), P(delta))
        a6 = (P(q6), P(k6), P(v6), P(do6), P(lse_k6), P(delta6), P(start),
              P(end), P(tiles))
        d1 = (B, L, L, H, Hkv, D, scale, 1, 1, st)
        d6 = (1, L6, L6, H, Hkv, 1, D, scale, 1, 1, st)
        return {
            "K1f": (lambda: lib["flash_attention_fwd"]
                    .ptt_flash_attention_fwd(P(q), P(k), P(v), P(o), P(lse),
                                             *d1), (o,)),
            "K1dq": (lambda: a.ptt_flash_attention_dq(*a1, P(dq), *d1),
                     (dq,)),
            "K1dkv": (lambda: a.ptt_flash_attention_dkv(*a1, P(dk), P(dv),
                                                        *d1), (dk, dv)),
            "K6f": (lambda: lib["flashmask_fwd"].ptt_flashmask_fwd(
                P(q6), P(k6), P(v6), P(start), P(end), P(tiles), P(o6),
                P(lse6), *d6), (o6,)),
            "K6dq": (lambda: m.ptt_flashmask_dq(*a6, P(dq6), *d6), (dq6,)),
            "K6dkv": (lambda: m.ptt_flashmask_dkv(*a6, P(dk6), P(dv6), *d6),
                      (dk6, dv6))}

    runs = [kernels(lib) for lib in libs]
    first = {}
    fast = dict(reps=20, rounds=5, warmup=3)
    order = list(range(len(argv))) + list(reversed(range(len(argv))))
    for i in order:
        times = []
        for name, (fn, outs) in runs[i].items():
            assert fn() == 0, f"[{i}] {name} refused its launch"
            torch.cuda.synchronize()
            got = [x.clone() for x in outs]
            ref = first.setdefault(name, got)
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            diff = "same bits" if same else "row_rel_err %.2e" % max(
                cs.row_rel_err(a, b) for a, b in zip(got, ref))
            times.append(f"{name} {cs.time_ms(torch, fn, **fast):.4f} "
                         f"({diff})")
        print(f"[{i}] {argv[i]}: " + ", ".join(times) + " ms", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
