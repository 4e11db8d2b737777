#!/usr/bin/env python3
"""Time versions of the Hopper kernels against each other in one process
on one GPU: each argument is a ``csrc`` directory (this checkout's
``paddle_tpu_torch/csrc``, or a copy with a change, or a parent commit's
unpacked with ``git archive``).

Run from the root of a checkout:

    python3 tools/flash_variants.py OLD/csrc paddle_tpu_torch/csrc
    python3 tools/flash_variants.py --only moe OLD/csrc paddle_tpu_torch/csrc
    python3 tools/flash_variants.py --only k3 OLD/csrc paddle_tpu_torch/csrc
    python3 tools/flash_variants.py --only paged OLD/csrc paddle_tpu_torch/csrc
    python3 tools/flash_variants.py --only lora OLD/csrc paddle_tpu_torch/csrc
    python3 tools/flash_variants.py --sweep paddle_tpu_torch/csrc
    python3 tools/flash_variants.py --only k3 --sweep paddle_tpu_torch/csrc

Each directory's ``flash_attention_fwd``, ``flash_attention_bwd``,
``flashmask_fwd``, ``flashmask_bwd`` and ``moe_gmm`` sources (``--only
flash`` or ``--only moe``: one family) are built by ``nvcc`` into their
own libraries under ``build/flash_variants/<i>/`` (with ``-Xptxas -v``:
registers and spills of each Hopper kernel are printed), loaded with
ctypes, and run on the same bfloat16 inputs: K1f, K1dq and K1dkv at
``chip_smoke.py``'s phase-2 shape (B 2, L 4096, 32 / 8 heads, D 128,
causal), K6f, K6dq and K6dkv at phase 15's 16k row of 8 documents, and
the MoE grouped matmuls at ``MOE_BWD_TIMED`` (DeepSeek-MoE-16B widths,
2 x 4096 tokens, top-6 of 64 experts): the forward's gather + swiglu,
scatter, gather gmm (the backward's recompute) and gmm on sorted rows
(K5), then the backward's transposed gather (``dh``), transposed gmm on
sorted rows (K5's d(lhs)), transposed scatter (``dx``) and tgmm for
d(down) and d(gate_up); and the four forward modes at ``MOE_TIMED``
(the 136-row prefill tick). ``--only k3``: the fused decode-tick
projections (``norm_matmul`` K3a into q/k/v and into gate/up,
``matmul_residual`` K3b from the O-projection and from swiglu into the
down-projection) at Llama-3-8B and Qwen2-7B widths and R = 8, 136 and
512 rows, through either entry point: a tree with
``decode_gemm_sm90.cuh`` has the Hopper entry points, an older one the
``mma.sync`` body's (K splits chosen as its wrapper chose them); where
every tree has the Hopper entry points, also GPT's four calls
(``GPTConfig()``: ``ln`` + beta + bias into q/k/v 1024 -> 3072 and fc1
1024 -> 4096, ``act=None`` + bias from out_proj 1024 -> 1024,
``gelu_tanh`` + bias into fc2 4096 -> 1024) at 4, 8 and 136 rows; each
K3 output is held against its plain version at ``K3_RTOL`` row-relative
(the run fails otherwise). ``--only k3 --sweep DIR`` builds one tree
once per ``K3_SWEEP`` entry (the shape rule as it stands, the stream-K
body everywhere, the split body wherever it takes the rows, the split
body aiming at 64 or 128 blocks, or in 64-column tiles) and times every
K3 case on each, in turns: the measurement behind the rule. ``--only
paged``: the paged attention kernels, cold (their pools copied past the
50 MB L2 and taken in turn, as ``chip_smoke.py``'s phase 2 times them):
K2r at both of phase 2's ticks (``RAGGED_TICKS``: 7 decode rows + a
128-row chunk, and one row a slot) and its chunk alone (``PAGED_CHUNKS``),
K2v (T 5) and K2d at phase 7's shape (``PAGED["generate"]``), and K2d at
contexts of 64 (one stage an item: a call's fixed cost), Llama-3-8B's 32
/ 8 heads, and, where every tree takes int8 pools, the two ticks, K2v
and K2d again on int8 pools (the bf16 pools quantized), through either
tree's entry points (a tree with ``paged_attention_sm90.cuh`` takes the
Hopper body's scratch and counters; an older one its own split count, as
its wrapper chose it); and, where every tree takes a bfloat16 q over
float32 pools (dtype code 2, GPT's ``*_f32pool`` mode), that mode at
GPT's shapes (16 / 16 heads, D 64, BS 16): K2r at phase 2's two GPT
ticks and its tree tick (``RAGGED_TREE["gpt"]``, BRANCH_TREE), K2d, K2v
(T 5) and K2v's tree mode (T 8) at phase 7's shape, each driven as its
tree's wrapper drove it (the FMA bodies' split count and scratch where
dtype 2 still runs them, the Hopper body's otherwise); their outputs are
held against the first version's by ``chip_smoke.held_f32pool``'s rule
(within one bf16 ulp, the share that differs printed) and, row by row,
against their plain versions. Versions
are timed in turns, first to last
and back (A B B A), with ``chip_smoke.time_ms``; cards and neighbours
differ between calls, so only versions timed in one run compare. Every
version's outputs are held against the first's: equal to the bit, or
their largest row-relative difference.

``--only lora``: K4's float32 modes as the multi-LoRA delta calls them
(``ops/lora.ragged_delta``), the gather gmm into the rank (``lora_gmm``,
d 4096 to rank 16) and the scatter gmm out of it (``lora_scatter_gmm``,
rank 16 to 4096 columns), at ``LORA_CASES``: the 136-row tick over 9
groups and over 3 (phase 21's ``max_adapters=2``) and a pure tick's 8
rows, cold (the stacks copied past the 50 MB L2 and taken in turn).
Each version is held to the plain versions at 1e-4 row-relative (the
run fails otherwise); bits are not compared across versions, whose sum
orders differ.

``--sweep DIR`` builds one ``csrc`` directory twice, with the bf16
forward modes' threshold ``PTT_MOE_SM90_MIN_ROWS`` at 1 (the Hopper body
at every size) and past any size (the ``mma.sync`` body), and times the
four forward modes of both at DeepSeek-MoE-16B widths over
``SWEEP_ROWS`` mean rows a group (A B B A at each), the crossover that
sets the threshold.
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FAMILIES = {"flash": ("flash_attention_fwd", "flash_attention_bwd",
                      "flashmask_fwd", "flashmask_bwd"),
            "moe": ("moe_gmm",),
            "k3": ("norm_matmul", "matmul_residual"),
            "paged": ("ragged_paged_attention", "paged_decode_attention"),
            "lora": ("moe_gmm",)}
K3_ROWS = (8, 136, 512)
K3_WIDTHS = {"llama": (4096, 1024, 14336),    # d, k / v width, ffn
             "qwen2": (3584, 512, 18944)}
K3_GPT = (1024, 4096)                          # GPTConfig(): d, ffn
K3_GPT_ROWS = (4, 8, 136)
K3_RTOL = 2e-2      # a K3 output against its plain version, row-relative
# --only k3 --sweep: the shape rule's bounds a build of one tree moves
# (csrc/decode_gemm_small_sm90.cuh) to time both bodies on every case, and
# the split body's other block targets and tile width
K3_SWEEP = {"rule": [],
            "stream_k": ["-DPTT_DG_SPLIT_MAX_WEIGHTS=0"],
            "split_k": ["-DPTT_DG_SPLIT_MAX_WEIGHTS=1000000000000"],
            "split_k 64 blocks": ["-DPTT_DG_SPLIT_BLOCKS=64"],
            "split_k 128 blocks": ["-DPTT_DG_SPLIT_BLOCKS=128"],
            "split_k bn64": ["-DPTT_DG_SPLIT_BN=64"]}
SWEEP_ROWS = (8, 16, 24, 32, 48, 64, 128, 256, 768)
# --only paged: the prefill chunk of phase 2's tick alone (slot 7, context
# 513) and in slot 0 (context 2048): rows a slot
PAGED_CHUNKS = {"chunk 513": [0] * 7 + [128], "chunk 2048": [128] + [0] * 7}
SWEEP_BODIES = {"sm90": 1, "mma.sync": 1 << 30}
# --only lora: (rows, groups) of each case
LORA_CASES = {"tick e9": (136, 9), "tick e3": (136, 3), "pure e9": (8, 9)}
LORA_RTOL = 1e-4
# --only paged, the f32-pool cases: each one's plain version's output
PLAIN = {}


def kernel_name(line):
    """``name<arguments>`` of a Hopper kernel in a ptxas line, or None."""
    k = re.search(r"(\w+_tma_kernel)ILi(\d+)ENS0_\d+(\w+?)EE", line)
    if k:
        return f"{k[1]}<{k[2]}, {k[3]}>"
    k = re.search(r"decode_gemm_splitILi(\d)ELi(\d+)ELi(\d)ELb(\d)E", line)
    if k:   # row groups, tile width, prologue, rows from the pre-pass
        return (f"decode_gemm_split<{k[1]}, {k[2]}, {k[3]}, "
                f"{'true' if k[4] == '1' else 'false'}>")
    k = re.search(r"dg90\d+(?:_GLOBAL__N_1\d+)?decode_gemmILi(\d)ELi(\d)"
                  r"ELb(\d)E", line)
    if k:   # row groups, prologue, rows from the pre-pass
        return f"decode_gemm<{k[1]}, {k[2]}, {'true' if k[3] == '1' else 'false'}>"
    k = re.search(r"paged_attention_kernelILi(\d+)E((?:L[bi]\d+E)*)", line)
    if k:   # head_dim, then the pool kind (or int8 pools), the tree mode
        args = [("true" if v == "1" else "false") if t == "b" else v
                for t, v in re.findall(r"L([bi])(\d+)E", k[2])]
        return f"paged_attention_kernel<{', '.join([k[1]] + args)}>"
    k = re.search(r"moe_lora\d+(moe_gmm_[a-z_]+?)(?:ILi(\d+)E)?E", line)
    if k:   # the float32 LoRA bodies (split_k: its chunk depth)
        return k[1] + (f"<{k[2]}>" if k[2] else "")
    k = re.search(r"moe90\d+(\w+?_kernel)(?:I(\w+?)E)?E", line)
    if k:   # Lb1 / Li128: a bool / an int template argument
        args = re.findall(r"L([bi])(\d+)E", (k[2] or "") + "E")
        return k[1] + ("<" + ", ".join(
            ("true" if v == "1" else "false") if t == "b" else v
            for t, v in args) + ">" if args else "")
    return None


def build(dirs, _build, sources, flags=None):
    """Compile every source of every directory at once (``flags[i]``:
    extra nvcc flags of directory i); print ptxas's registers and spills
    of the Hopper kernels."""
    procs = []
    for i, d in enumerate(dirs):
        out = os.path.join(os.path.dirname(HERE), "build", "flash_variants",
                           str(i))
        os.makedirs(out, exist_ok=True)
        for name in sources:
            cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   *(flags[i] if flags else []),
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
            if "C7514" in line or "C7512" in line:
                print(f"  [{i}] {name}: {line.strip()}", flush=True)
            kern = kernel_name(line)
            if "Compiling entry" in line and kern:
                info = [re.sub(r".*: *", "", x).strip()
                        for x in lines[j + 1:j + 4]
                        if "spill" in x or "registers" in x]
                print(f"  [{i}] {kern}: " + "; ".join(info), flush=True)
        libs[i][name] = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
    return libs


def bind(lib, d):
    """argtypes of the entry points (see their .cu files of ``d``)."""
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if "norm_matmul" in lib:
        lib["sm90"] = os.path.exists(os.path.join(d, "decode_gemm_sm90.cuh"))
        nm, mr = lib["norm_matmul"].ptt_norm_matmul, \
            lib["matmul_residual"].ptt_matmul_residual
        if lib["sm90"]:
            i64 = ctypes.c_longlong
            nm.argtypes = [ptr] * 15 + [i64] * 2 + [i32] * 7 + \
                [ctypes.c_float, i32, ptr]
            mr.argtypes = [ptr] * 9 + [i64] * 3 + [i32] * 5 + [ptr]
        else:
            nm.argtypes = [ptr] * 10 + [i32] * 7 + [ctypes.c_float, i32, ptr]
            mr.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    if "ragged_paged_attention" in lib:
        lib["sm90"] = os.path.exists(
            os.path.join(d, "paged_attention_sm90.cuh"))
        with open(os.path.join(d, "ragged_paged_attention.cu")) as f:
            lib["q8"] = "const void* ks" in f.read()   # int8 pools
        n = 1 if lib["sm90"] else 0   # the counters and NB arguments
        n8 = 2 if lib["q8"] else 0    # the scale pointers
        with open(os.path.join(d, "ragged_paged_attention.cu")) as f:
            text = f.read()
        # a bf16 q over f32 pools (dtype 2), and whether the FMA body runs it
        lib["f32"] = "dtype == 2" in text
        lib["f32_fma"] = "dispatch_d<__nv_bfloat16, float>" in text
        r = lib["ragged_paged_attention"]
        r.ptt_ragged_paged_attention.argtypes = \
            [ptr] * (9 + n + n8) + [i32] * (9 + n) + tail[:1] + tail[2:]
        bits = ctypes.POINTER(ctypes.c_uint32)
        if hasattr(r, "ptt_ragged_paged_attention_tree"):
            r.ptt_ragged_paged_attention_tree.argtypes = \
                r.ptt_ragged_paged_attention.argtypes + [bits, i32, ptr]
        m = lib["paged_decode_attention"]
        for fn in (m.ptt_paged_decode_attention,
                   m.ptt_paged_verify_attention):
            fn.argtypes = [ptr] * (7 + n + n8) + [i32] * (8 + n) + \
                tail[:1] + tail[2:]
        if hasattr(m, "ptt_paged_verify_attention_tree"):
            m.ptt_paged_verify_attention_tree.argtypes = \
                m.ptt_paged_verify_attention.argtypes + [bits]
    if "moe_gmm" in lib:
        g = lib["moe_gmm"]
        for fn in (g.ptt_moe_gmm, g.ptt_moe_gather_gmm_swiglu,
                   g.ptt_moe_scatter_gmm):
            fn.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib["moe_gmm"].ptt_moe_gmm_t.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib["moe_gmm"].ptt_moe_tgmm.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    if "flash_attention_fwd" not in lib:
        return
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


def flash_kernels(torch, cs, fm, libs, rnd, P, st):
    """K1 at phase 2's shape and K6 at phase 15's 16k row: per version,
    {name: (launch, outputs)}."""
    B, L, H, Hkv, D = (cs.ATTN[k] for k in ("B", "L", "H", "Hkv", "D"))
    L6, docs = cs.FLASHMASK_ROW["L"], cs.FLASHMASK_ROW["docs"]
    scale = D ** -0.5
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
        # the launches take the tensors' addresses when they run, so the
        # tensors live as long as the launches do
        a1 = lambda: (P(q), P(k), P(v), P(do), P(lse_k1),  # noqa: E731
                      P(delta))
        a6 = lambda: (P(q6), P(k6), P(v6), P(do6), P(lse_k6),  # noqa: E731
                      P(delta6), P(start), P(end), P(tiles))
        d1 = (B, L, L, H, Hkv, D, scale, 1, 1, st)
        d6 = (1, L6, L6, H, Hkv, 1, D, scale, 1, 1, st)
        return {
            "K1f": (lambda: lib["flash_attention_fwd"]
                    .ptt_flash_attention_fwd(P(q), P(k), P(v), P(o), P(lse),
                                             *d1), (o,)),
            "K1dq": (lambda: a.ptt_flash_attention_dq(*a1(), P(dq), *d1),
                     (dq,)),
            "K1dkv": (lambda: a.ptt_flash_attention_dkv(*a1(), P(dk), P(dv),
                                                        *d1), (dk, dv)),
            "K6f": (lambda: lib["flashmask_fwd"].ptt_flashmask_fwd(
                P(q6), P(k6), P(v6), P(start), P(end), P(tiles), P(o6),
                P(lse6), *d6), (o6,)),
            "K6dq": (lambda: m.ptt_flashmask_dq(*a6(), P(dq6), *d6),
                     (dq6,)),
            "K6dkv": (lambda: m.ptt_flashmask_dkv(*a6(), P(dk6), P(dv6),
                                                  *d6), (dk6, dv6))}

    return [kernels(lib) for lib in libs]


def forward_modes(torch, cs, rnd, P, st, c, seed, tag=""):
    """The bf16 forward modes at MoE widths ``c`` on random top-k routing:
    ``lib -> {name: (launch, outputs)}`` (gather + swiglu, scatter, the
    gather gmm and the gmm on sorted rows; ``tag`` ends each name)."""
    tokens, d, f, e, k = (c[n] for n in ("tokens", "d", "f", "e", "k"))
    m = tokens * k
    order, src, gs = cs.moe_routing(torch, tokens, e, k, "random", seed)
    gu, dn = 0.02 * rnd(e, d, 2 * f), 0.02 * rnd(e, f, d)
    x, h = rnd(tokens, d), rnd(m, f)
    xs = x[src.long()].contiguous()
    hs, ys, gg, gl = (torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
                      for n in (f, d, 2 * f, 2 * f))

    def kernels(lib):
        g = lib["moe_gmm"]
        return {
            "swiglu" + tag: (lambda: g.ptt_moe_gather_gmm_swiglu(
                P(x), P(src), P(gu), P(gs), P(hs), m, d, f, e, 1, st),
                (hs,)),
            "scatter" + tag: (lambda: g.ptt_moe_scatter_gmm(
                P(h), P(dn), P(gs), P(order), P(ys), m, f, d, e, 1, st),
                (ys,)),
            "gather" + tag: (lambda: g.ptt_moe_gmm(
                P(x), P(src), P(gu), P(gs), P(gg), m, d, 2 * f, e, 1, st),
                (gg,)),
            "sorted" + tag: (lambda: g.ptt_moe_gmm(
                P(xs), None, P(gu), P(gs), P(gl), m, d, 2 * f, e, 1, st),
                (gl,))}
    return kernels


def moe_kernels(torch, cs, libs, rnd, P, st):
    """The MoE forward's and backward's bf16 modes at MOE_BWD_TIMED and
    the forward's at MOE_TIMED (the prefill tick), as phase 2 runs them:
    per version, {name: (launch, outputs)}."""
    c = cs.MOE_BWD[cs.MOE_BWD_TIMED]
    fwd = forward_modes(torch, cs, rnd, P, st, c, 19)
    tick = forward_modes(torch, cs, rnd, P, st, cs.MOE[cs.MOE_TIMED], 17,
                         " prefill")
    tokens, d, f, e, k = (c[n] for n in ("tokens", "d", "f", "e", "k"))
    m = tokens * k
    order, src, gs = cs.moe_routing(torch, tokens, e, k, "random", 19)
    gu, dn = 0.02 * rnd(e, d, 2 * f), 0.02 * rnd(e, f, d)
    x, h = rnd(tokens, d), rnd(m, f)
    dpair, dgu = 0.02 * rnd(m, d), 0.02 * rnd(m, 2 * f)
    ds = dpair[order.long()].contiguous()
    xs = x[src.long()].contiguous()
    dh, dl, dx = (torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
                  for n in (f, f, d))
    wdn, wgu = (torch.empty(e, a, b, device="cuda", dtype=torch.bfloat16)
                for a, b in ((f, d), (d, 2 * f)))

    def kernels(lib):
        g = lib["moe_gmm"]
        out = fwd(lib)
        out.update({
            "gmm_t gather": (lambda: g.ptt_moe_gmm_t(
                P(dpair), P(order), P(dn), P(gs), None, P(dh), m, d, f, e, 1,
                st), (dh,)),
            "gmm_t sorted": (lambda: g.ptt_moe_gmm_t(
                P(ds), None, P(dn), P(gs), None, P(dl), m, d, f, e, 1, st),
                (dl,)),
            "scatter_gmm_t": (lambda: g.ptt_moe_gmm_t(
                P(dgu), None, P(gu), P(gs), P(order), P(dx), m, 2 * f, d, e,
                1, st), (dx,)),
            "tgmm d(down)": (lambda: g.ptt_moe_tgmm(
                P(h), P(ds), P(gs), P(wdn), m, f, d, e, 1, st), (wdn,)),
            "tgmm d(gate_up)": (lambda: g.ptt_moe_tgmm(
                P(xs), P(dgu), P(gs), P(wgu), m, d, 2 * f, e, 1, st),
                (wgu,))})
        out.update(tick(lib))
        return out

    return [kernels(lib) for lib in libs]


def lora_kernels(torch, cs, libs, P, st):
    """K4's float32 LoRA modes at LORA_CASES, as ``chip_smoke.check_lora``
    times them: per version, {name: (launch, outputs)}; each case's plain
    outputs go to PLAIN. The stacks' copies are clones of one draw, so a
    call reads cold bytes and gives the same values whichever it takes."""
    from paddle_tpu_torch.ops import lora
    from paddle_tpu_torch.ops.kernels import moe_gmm as mg
    t = cs.LORA_TICK
    d, rank, out = t["d"], t["rank"], t["outs"][0]
    rp = lora.padded_rank(rank)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 22)
    cases = {}
    for tag, (R, G) in LORA_CASES.items():
        used = t["used"] if G == t["groups"] else tuple(range(G))
        ra = torch.from_numpy(cs.lora_routing("tick", R, G, used,
                                              22)).cuda()
        A, B = cs.lora_stacks(torch, g, G, d, rank, out)[0]
        copies = max(3, -(-int(100e6) // (4 * G * rp * (d + out))))
        stacks = [(A, B)] + [(A.clone(), B.clone())
                             for _ in range(copies - 1)]
        x = torch.randn(R, d, generator=g, device="cuda")
        order, sizes = lora.sort_rows(ra, G)
        ax = mg.plain_gather_gmm(x, order, A, sizes)
        PLAIN[f"lora_gmm {tag}"] = ax
        PLAIN[f"lora_scatter_gmm {tag}"] = mg.plain_scatter_gmm(
            ax, B, sizes, order)
        cases[tag] = dict(R=R, G=G, x=x, order=order, sizes=sizes, ax=ax,
                          stacks=stacks, turn=[0])

    def pick(c):
        c["turn"][0] += 1
        return c["stacks"][c["turn"][0] % len(c["stacks"])]

    def kernels(lib):
        gl = lib["moe_gmm"]
        res = {}
        for tag, c in cases.items():
            R, G = c["R"], c["G"]
            ya = torch.empty(R, rp, device="cuda")
            yb = torch.empty(R, out, device="cuda")
            res[f"lora_gmm {tag}"] = (
                lambda c=c, ya=ya, R=R, G=G: gl.ptt_moe_gmm(
                    P(c["x"]), P(c["order"]), P(pick(c)[0]), P(c["sizes"]),
                    P(ya), R, d, rp, G, 0, st), (ya,))
            res[f"lora_scatter_gmm {tag}"] = (
                lambda c=c, yb=yb, R=R, G=G: gl.ptt_moe_scatter_gmm(
                    P(c["ax"]), P(pick(c)[1]), P(c["sizes"]), P(c["order"]),
                    P(yb), R, rp, out, G, 0, st), (yb,))
        return res

    return [kernels(lib) for lib in libs]


def mma_splits(torch, rows, k, widths):
    """K splits of the mma.sync body, as its wrapper chose them: enough
    for two blocks an SM over (row tiles x 128-column tiles), at most 8
    and at least 512 of K a split."""
    tiles = sum(-(-n // 128) for n in widths)
    rt = 16 if rows <= 16 else (48 if -(-rows // 48) * 48 <
                                -(-rows // 64) * 64 else 64)
    blocks = -(-rows // rt) * tiles
    want = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    return 1 if blocks >= want else max(1, min(-(-want // blocks), k // 512,
                                              8))


def k3_kernels(torch, cs, libs, rnd, P, st):
    """K3a and K3b, bf16: rms without biases (what every body takes) at
    K3_WIDTHS and K3_ROWS, and, where every tree has the Hopper entry
    points, GPT's four calls (``ln`` + beta + bias into q/k/v and fc1,
    ``act=None`` + bias from out_proj, ``gelu_tanh`` + bias into fc2) at
    K3_GPT_ROWS; each case's plain version kept in PLAIN. Per version,
    {name: (launch, outputs)}."""
    from paddle_tpu_torch.ops.kernels import decode_fused as df
    f32 = dict(device="cuda", dtype=torch.float32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ws = torch.empty(sms * 4 * 32 * 128 * 4, **f32)   # any body's partials
    flags = torch.zeros(1 << 16, device="cuda", dtype=torch.int32)
    rows = torch.empty(max(K3_ROWS + K3_GPT_ROWS) * max(
        [w[2] for w in K3_WIDTHS.values()] + [K3_GPT[1]]),
        device="cuda", dtype=torch.bfloat16)   # any scratch
    cases = []   # name, kind, a, b, weights, act, K, beta, biases
    for model, (d, kv, ffn) in K3_WIDTHS.items():
        gamma = 1 + 0.1 * rnd(d)
        qkv = [0.02 * rnd(d, n) for n in (d, kv, kv)]
        gu = [0.02 * rnd(d, ffn) for _ in range(2)]
        wo, wd = 0.02 * rnd(d, d), 0.02 * rnd(ffn, d)
        for r in K3_ROWS:
            x, res, g, u = rnd(r, d), rnd(r, d), rnd(r, ffn), rnd(r, ffn)
            for tag, w3 in (("qkv", qkv), ("gate/up", gu)):
                cases.append((f"K3a {tag} {model} R={r}", "nm", x, gamma,
                              w3, None, d, None, None))
            cases.append((f"K3b o {model} R={r}", "mr", [x], res, [wo],
                          None, d, None, None))
            cases.append((f"K3b down {model} R={r}", "mr", [g, u], res,
                          [wd], "swiglu", ffn, None, None))
    if all(lib["sm90"] for lib in libs):
        d, ffn = K3_GPT
        gamma, beta = 1 + 0.1 * rnd(d), 0.1 * rnd(d)
        wq, w1 = 0.02 * rnd(d, 3 * d), 0.02 * rnd(d, ffn)
        wo, w2 = 0.02 * rnd(d, d), 0.02 * rnd(ffn, d)
        bq, b1, bo, b2 = (0.1 * rnd(n) for n in (3 * d, ffn, d, d))
        for r in K3_GPT_ROWS:
            x, res, g = rnd(r, d), rnd(r, d), rnd(r, ffn)
            cases += [(f"K3a qkv gpt R={r}", "nm", x, gamma, [wq], None, d,
                       beta, [bq]),
                      (f"K3a fc1 gpt R={r}", "nm", x, gamma, [w1], None, d,
                       beta, [b1]),
                      (f"K3b out_proj gpt R={r}", "mr", [x], res, [wo], None,
                       d, None, [bo]),
                      (f"K3b fc2 gpt R={r}", "mr", [g], res, [w2],
                       "gelu_tanh", ffn, None, [b2])]
    for name, kind, a, b, w, fn_act, k, beta, bias in cases:
        if kind == "nm":
            eps = 1e-5 if beta is not None else 1e-6
            PLAIN[name] = df.plain_norm_matmul(
                a, b, beta, w, bias or [None] * len(w), eps=eps,
                kind="ln" if beta is not None else "rms")[0]
        else:
            PLAIN[name] = df.plain_matmul_residual(
                a, w[0], bias[0] if bias else None, b, act=fn_act)
    acts = {None: 0, "swiglu": 1, "gelu_tanh": 2}

    def ptrs(ts):   # three pointers, None past the tensors
        return [P(t) for t in ts] + [None] * (3 - len(ts))

    # every address is taken as the launch runs: a tensor referenced only
    # by an address taken here would be freed when this function returns
    # and its memory handed to the next allocation
    def call(lib, kind, a, b, w, fn_act, k, beta, bias):
        r = a.shape[0] if kind == "nm" else b.shape[0]
        widths = [t.shape[1] for t in w]
        outs = [torch.empty(r, n, device="cuda", dtype=torch.bfloat16)
                for n in widths]
        bias = bias or []
        ns = widths + [0] * (3 - len(w))
        ln = beta is not None
        if lib["sm90"]:
            if kind == "nm":
                return (lambda: lib["norm_matmul"].ptt_norm_matmul(
                    P(a), P(b), P(beta) if ln else None, *ptrs(w),
                    *ptrs(bias), *ptrs(outs), P(rows), P(ws), P(flags),
                    ws.numel(), flags.numel(), r, k, *ns, len(w), int(ln),
                    1e-5 if ln else 1e-6, 1, st)), outs
            return (lambda: lib["matmul_residual"].ptt_matmul_residual(
                P(a[0]), P(a[-1]) if fn_act == "swiglu" else None, P(w[0]),
                ptrs(bias)[0], P(b), P(outs[0]), P(rows), P(ws), P(flags),
                rows.numel(), ws.numel(), flags.numel(), r, k, ns[0],
                acts[fn_act], 1, st)), outs
        n_split = mma_splits(torch, r, k, widths)
        part = torch.empty(n_split * r * sum(widths), **f32)
        if kind == "nm":
            return (lambda: lib["norm_matmul"].ptt_norm_matmul(
                P(a), P(b), *ptrs(w), *ptrs(outs), P(rows), P(part), r, k,
                *ns, len(w), n_split, 1e-6, 1, st)), outs
        return (lambda: lib["matmul_residual"].ptt_matmul_residual(
            P(a[0]), P(a[-1]) if fn_act else None, P(w[0]), None, P(b),
            P(outs[0]), P(part), r, k, ns[0], 1 if fn_act else 0, n_split, 1,
            st)), outs

    return [{name: call(lib, *rest) for name, *rest in cases}
            for lib in libs]


def paged_kernels(torch, cs, libs, rnd, P, st):
    """K2r at phase 2's two ticks, K2v and K2d at phase 7's shape, bf16,
    32 / 8 heads, D 128, BS 16, cold: per version, {name: (launch,
    outputs)}. The pools are copies of one pool (so every copy gives the
    same outputs), enough to fill twice the L2, taken in turn. Where every
    version takes int8 pools, the same cases again on int8 pools (the
    bf16 pools quantized)."""
    H, Hkv, D, BS = 32, 8, 128, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    i32 = dict(device="cuda", dtype=torch.int32)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)

    from paddle_tpu_torch.ops.paged_cache import kv_quantize
    int8 = all(lib["q8"] for lib in libs)

    def pools_for(S, MB):
        NB = 1 + S * MB
        k, v = rnd(NB, BS, Hkv, D), rnd(NB, BS, Hkv, D)
        copies = max(3, -(-int(100e6) // (2 * k.numel() * 2)))
        perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
        tables = perm[:S * MB].reshape(S, MB).to(torch.int32).contiguous()
        return [(k, v)] + [(k.clone(), v.clone()) for _ in range(copies - 1)
                           ], tables, NB

    def int8_pools(pools):
        """(data, scale) pairs of the first pool, quantized, as many
        copies as fill twice the L2 (a position-head is D + 4 bytes)."""
        (k, v), n = pools[0], pools[0][0].numel()
        kq, vq = kv_quantize(k), kv_quantize(v)
        copies = max(3, -(-int(100e6) // (2 * (n + 4 * n // D))))
        return [(kq, vq)] + [(tuple(x.clone() for x in kq),
                              tuple(x.clone() for x in vq))
                             for _ in range(copies - 1)]

    # the Hopper body's scratch: a split record (64 query vectors) a block
    # (two an SM at most) and one a (slot, kv head); its counters (zeros)
    records = 2 * sms + 8 * Hkv
    part = torch.empty(records * 64 * (D + 2), device="cuda")
    cnt = torch.zeros(8 * Hkv + 2, **i32)
    cases = []
    S, MB = 8, 128
    pools, tables, NB = pools_for(S, MB)
    ctx = torch.tensor([b + 1 for b in (2047, 1500, 900, 300, 64, 1024,
                                        1800, 512)], **i32)
    # phase 2's two ticks, and the prefill chunk alone at its context and
    # at 2048 (a tile's stages at 64 live rows)
    ticks = dict(cs.RAGGED_TICKS, **PAGED_CHUNKS)
    for tick, q_lens in ticks.items():
        R = sum(q_lens)
        q = rnd(R, H, D)
        starts = torch.tensor([0] + list(np.cumsum(q_lens)[:-1]), **i32)
        cases.append((f"K2r {tick} tick", "ragged", q, pools, tables, ctx,
                      (torch.tensor(q_lens, **i32), starts, max(q_lens)),
                      NB))
        if int8 and tick in cs.RAGGED_TICKS:
            cases.append((f"K2r {tick} tick int8", "ragged", q,
                          int8_pools(pools), tables, ctx, cases[-1][6], NB))
    c = cs.PAGED["generate"]
    pools, tables, NB = pools_for(c["S"], c["MB"])
    lens = torch.tensor(c["lens"], **i32)
    for name, T in (("K2v", cs.PAGED_T), ("K2d", 1)):
        cases.append((f"{name} generate", name, rnd(c["S"], T, H, D), pools,
                      tables, lens, (), NB))
        if int8:
            cases.append((f"{name} generate int8", name, cases[-1][2],
                          int8_pools(pools), tables, lens, (), NB))
    # K2d at one stage an item: a call's fixed cost
    pools, tables, NB = pools_for(c["S"], c["MB"])
    cases.append(("K2d one stage", "K2d", rnd(c["S"], 1, H, D), pools,
                  tables, torch.full((c["S"],), 64, **i32), (), NB))

    def call(lib, kind, q, pools, tables, ctx, extra, NB):
        out = torch.empty_like(q)
        turn = iter(range(1 << 30))
        S, MB = tables.shape
        scale = D ** -0.5
        new = lib["sm90"]
        reach = MB * BS

        def pool():
            """(k, v, k scale, v scale) of the next pool (scales None for
            bf16); a tree without int8 pools takes no scale arguments."""
            kp, vp = pools[next(turn) % len(pools)]
            if isinstance(kp, tuple):
                return kp[0], vp[0], P(kp[1]), P(vp[1])
            return (kp, vp) + ((None, None) if lib["q8"] else ())

        if kind == "ragged":
            ql, starts, w_max = extra
            fn = lib["ragged_paged_attention"].ptt_ragged_paged_attention
            R = q.shape[0]
            n_split = records if new else min(8, -(-reach // 256))
            old_part = None if new else torch.empty(
                n_split * R * H * (D + 2), device="cuda")

            def go():
                kp, vp, *sc = pool()
                head = (P(q), P(kp), P(vp), *sc, P(tables), P(ctx), P(ql),
                        P(starts), P(out))
                if new:
                    return fn(*head, P(part), P(cnt), R, S, H, Hkv, D, BS,
                              MB, NB, w_max, n_split, scale, 1, st)
                return fn(*head, P(old_part), R, S, H, Hkv, D, BS, MB,
                          w_max, n_split, scale, 1, st)
            return go, (out,)
        m = lib["paged_decode_attention"]
        fn = m.ptt_paged_verify_attention if kind == "K2v" else \
            m.ptt_paged_decode_attention
        T = q.shape[1]
        n_split = records if new else max(1, min(
            16, reach // 64, -(-8 * sms // (S * Hkv))))
        old_part = None if new else torch.empty(
            n_split * q.numel() // D * (D + 2), device="cuda")

        def go():
            kp, vp, *sc = pool()
            head = (P(q), P(kp), P(vp), *sc, P(tables), P(ctx), P(out))
            if new:
                return fn(*head, P(part), P(cnt), S, T, H, Hkv, D, BS, MB,
                          NB, n_split, scale, 1, st)
            return fn(*head, P(old_part), S, T, H, Hkv, D, BS, MB, n_split,
                      scale, 1, st)
        return go, (out,)

    return [{name: call(lib, *rest) for name, *rest in cases}
            for lib in libs]


def paged_f32_kernels(torch, cs, libs, P, st):
    """The bf16-q-over-f32-pool mode (dtype code 2) at GPT's shapes (16 /
    16 heads, D 64, BS 16), cold: K2r at phase 2's GPT ticks and its tree
    tick, K2d, K2v and K2v's tree mode at phase 7's shape; per version,
    {name: (launch, outputs)}. Each tree's entry points are driven as its
    wrapper drove them: the FMA bodies' split count and scratch where
    they run dtype 2, the Hopper body's scratch otherwise."""
    H = Hkv = cs.GPT_HEADS
    D, BS = 64, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    i32 = dict(device="cuda", dtype=torch.int32)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 17)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device="cuda")  # noqa
    part = torch.empty(2 * sms * 64 * (D + 2), device="cuda")
    cnt = torch.zeros(8 * Hkv, **i32)
    scale = D ** -0.5

    def pools_for(S, MB):
        NB = 1 + S * MB
        k, v = rnd(NB, BS, Hkv, D), rnd(NB, BS, Hkv, D)
        copies = max(3, -(-int(100e6) // (2 * k.numel() * 4)))
        perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
        tables = perm[:S * MB].reshape(S, MB).to(torch.int32).contiguous()
        return [(k, v)] + [(k.clone(), v.clone()) for _ in range(copies - 1)
                           ], tables, NB

    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import \
        tree_ancestor_bits

    def tree_arg(tree):
        bits = tree_ancestor_bits(tree)
        return (ctypes.c_uint32 * len(bits))(*bits), len(bits)

    cases = []
    S, MB = 8, cs.RAGGED["gpt"]["MB"]
    pools, tables, NB = pools_for(S, MB)
    ctx = torch.tensor([b + 1 for b in cs.RAGGED["gpt"]["base"]], **i32)
    for tick, q_lens in cs.RAGGED_TICKS.items():
        q = rnd(sum(q_lens), H, D).bfloat16()
        starts = torch.tensor([0] + list(np.cumsum(q_lens)[:-1]), **i32)
        cases.append((f"K2r gpt {tick} tick f32pool", "ragged", q, pools,
                      tables, ctx, (torch.tensor(q_lens, **i32), starts,
                                    max(q_lens), None), NB))
    t = cs.RAGGED_TREE["gpt"]
    tctx = torch.tensor([b + 1 for b in t["base"]], **i32)
    q = rnd(sum(t["q_lens"]), H, D).bfloat16()
    starts = torch.tensor([0] + list(np.cumsum(t["q_lens"])[:-1]), **i32)
    cases.append(("K2r gpt tree tick f32pool", "ragged", q, pools, tables,
                  tctx, (torch.tensor(t["q_lens"], **i32), starts,
                         max(t["q_lens"]),
                         (*tree_arg(cs.BRANCH_TREE),
                          torch.tensor(t["flags"], **i32))), NB))
    from paddle_tpu_torch.ops.kernels import paged_attention as pda
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    for name, _, q, pl, tb, cx, (ql, st0, _, tree), _ in cases:
        PLAIN[name] = rpa.plain_ragged_paged_attention(
            q, *pl[0], tb, cx, ql, st0,
            tree_anc=cs.BRANCH_TREE if tree else None,
            tree_slots=tree[2] if tree else None)
    c = cs.PAGED["generate"]
    pools, tables, NB = pools_for(c["S"], c["MB"])
    lens = torch.tensor(c["lens"], **i32)
    for name, T, tree in (("K2d", 1, None), ("K2v", cs.PAGED_T, None),
                          ("K2v tree", len(cs.BRANCH_TREE) + 1,
                           cs.BRANCH_TREE)):
        q = rnd(c["S"], T, H, D).bfloat16()
        cases.append((f"{name} gpt generate f32pool", name, q, pools,
                      tables, lens, tree and tree_arg(tree), NB))
        PLAIN[cases[-1][0]] = pda.plain_paged_verify_attention(
            q, *pools[0], tables, lens, tree_anc=tree)

    def call(lib, kind, q, pools, tables, ctx, extra, NB):
        out = torch.empty_like(q)
        turn = iter(range(1 << 30))
        S, MB = tables.shape
        fma = lib["f32_fma"]
        reach = MB * BS

        def pool():
            kp, vp = pools[next(turn) % len(pools)]
            return kp, vp, None, None

        if kind == "ragged":
            ql, starts, w_max, tree = extra
            r = lib["ragged_paged_attention"]
            fn = r.ptt_ragged_paged_attention_tree if tree else \
                r.ptt_ragged_paged_attention
            R = q.shape[0]
            n_split = min(8, -(-reach // 256)) if fma else 2 * sms
            p_, c_ = (torch.empty(n_split * R * H * (D + 2), device="cuda"),
                      None) if fma else (part, cnt)
            def go():
                # the flags' address taken here: the tensor outlives the
                # set-up only through this closure
                tail = (tree[0], tree[1], P(tree[2])) if tree else ()
                kp, vp, ks, vs = pool()
                return fn(P(q), P(kp), P(vp), ks, vs, P(tables), P(ctx),
                          P(ql), P(starts), P(out), P(p_),
                          c_ if c_ is None else P(c_), R, S, H, Hkv, D, BS,
                          MB, NB, w_max, n_split, scale, 2, st, *tail)
            return go, (out,)
        m = lib["paged_decode_attention"]
        fn = m.ptt_paged_verify_attention_tree if extra else \
            m.ptt_paged_verify_attention if kind == "K2v" else \
            m.ptt_paged_decode_attention
        T = q.shape[1]
        n_split = max(1, min(16, reach // 64, -(-8 * sms // (S * Hkv)))) \
            if fma else 2 * sms
        p_, c_ = (torch.empty(n_split * q.numel() // D * (D + 2),
                              device="cuda"), None) if fma else (part, cnt)
        tail = (extra[0],) if extra else ()

        def go():
            kp, vp, ks, vs = pool()
            return fn(P(q), P(kp), P(vp), ks, vs, P(tables), P(ctx), P(out),
                      P(p_), c_ if c_ is None else P(c_), S, T, H, Hkv, D,
                      BS, MB, NB, n_split, scale, 2, st, *tail)
        return go, (out,)

    return [{name: call(lib, *rest) for name, *rest in cases}
            for lib in libs]


def sweep(torch, cs, libs, names, rnd, P, st, fast):
    """The forward modes of each library (the two bodies) at DeepSeek
    widths over SWEEP_ROWS mean rows a group, A B B A at each size."""
    c0 = cs.MOE_BWD[cs.MOE_BWD_TIMED]
    for rows in SWEEP_ROWS:
        tokens = -(-rows * c0["e"] // c0["k"])
        c = dict(c0, tokens=tokens)
        mean = -(-tokens * c["k"] // c["e"])
        per = forward_modes(torch, cs, rnd, P, st, c, 23)
        runs = [per(lib) for lib in libs]
        times = {}
        for i in list(range(len(libs))) + list(reversed(range(len(libs)))):
            for name, (fn, outs) in runs[i].items():
                assert fn() == 0, f"{names[i]} {name} refused its launch"
                times.setdefault(name, []).append(
                    (i, cs.time_ms(torch, fn, **fast)))
        ref = {n: [x.clone() for x in o] for n, (_, o) in runs[0].items()}
        for name in runs[0]:
            torch.cuda.synchronize()
            runs[1][name][0]()
            torch.cuda.synchronize()
            err = max(cs.row_rel_err(a, b)
                      for a, b in zip(runs[1][name][1], ref[name]))
            ms = ", ".join(f"{names[i]} {t:.4f}" for i, t in times[name])
            print(f"sweep: {tokens * c['k']} rows, {mean} a group: {name} "
                  f"{ms} ms (row_rel_err {err:.2e})", flush=True)
        del runs, per
        torch.cuda.empty_cache()


def main(argv):
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(FAMILIES))
    ap.add_argument("--sweep", action="store_true",
                    help="time the forward modes' two bodies (one dir)")
    ap.add_argument("dirs", nargs="+")
    args = ap.parse_args(argv)
    if args.sweep and len(args.dirs) != 1:
        ap.error("--sweep takes one csrc directory")
    if not torch.cuda.is_available():
        print("flash_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(HERE))
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flashmask as fm

    k3_sweep = args.sweep and args.only == "k3"
    families = ["k3"] if k3_sweep else ["moe"] if args.sweep else \
        [args.only] if args.only else sorted(FAMILIES)
    print(cs.card_line(), flush=True)
    dirs, flags = args.dirs, None
    if k3_sweep:
        dirs = dirs * len(K3_SWEEP)
        flags = list(K3_SWEEP.values())
        args.dirs = [f"{args.dirs[0]} ({v})" for v in K3_SWEEP]
        args.sweep = False
    elif args.sweep:
        dirs = dirs * len(SWEEP_BODIES)
        flags = [[f"-DPTT_MOE_SM90_MIN_ROWS={v}"]
                 for v in SWEEP_BODIES.values()]
    libs = build(dirs, _build,
                 [n for fam in families for n in FAMILIES[fam]], flags)
    for lib, d in zip(libs, dirs):
        bind(lib, d)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)

    def rnd(*sh):
        return torch.randn(*sh, generator=g, device="cuda").bfloat16()

    st = torch.cuda.current_stream().cuda_stream
    P = lambda t: t.data_ptr()  # noqa: E731
    fast = dict(reps=20, rounds=5, warmup=3)
    if args.sweep:
        sweep(torch, cs, libs, list(SWEEP_BODIES), rnd, P, st, fast)
        print(cs.card_line(), flush=True)
        return 0
    runs = [{} for _ in libs]
    for fam in families:
        per = {"flash": lambda: flash_kernels(torch, cs, fm, libs, rnd, P,
                                              st),
               "moe": lambda: moe_kernels(torch, cs, libs, rnd, P, st),
               "k3": lambda: k3_kernels(torch, cs, libs, rnd, P, st),
               "paged": lambda: paged_kernels(torch, cs, libs, rnd, P,
                                              st),
               "lora": lambda: lora_kernels(torch, cs, libs, P, st)}[fam]()
        for run, ks in zip(runs, per):
            run.update(ks)
        if fam == "paged" and all(lib["f32"] for lib in libs):
            for run, ks in zip(runs, paged_f32_kernels(torch, cs, libs, P,
                                                        st)):
                run.update(ks)
    first, failed = {}, []
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
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
            if name in PLAIN:
                err = cs.row_rel_err(got[0], PLAIN[name])
                diff += ", against plain row_rel_err %.2e" % err
                limit = LORA_RTOL if name.startswith("lora") else \
                    K3_RTOL if name.startswith("K3") else None
                if limit is not None and not err <= limit:
                    failed.append(f"[{i}] {name}")
                    diff += " FAIL"
            if not same and name.endswith("f32pool"):
                fails = []
                cs.held_f32pool(torch, got[0], ref[0].float(),
                                f"[{i}] {name} vs [{order[0]}]", fails)
                diff += "; " + ("FAIL: " if fails else "") + \
                    "one-ulp rule against the first version"
            times.append(f"{name} {cs.time_ms(torch, fn, **fast):.4f} "
                         f"({diff})")
        print(f"[{i}] {args.dirs[i]}: " + ", ".join(times) + " ms",
              flush=True)
    print(cs.card_line(), flush=True)
    if failed:
        print(f"flash_variants: off the plain versions: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
