"""The PyTorch port's CUDA kernels against their plain PyTorch versions on
the card. Every test here needs a CUDA device and skips itself without
one (the kernels have no CPU mode). The file imports neither ``jax`` nor
``paddle_tpu``, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Tolerances: float32 1e-4 (the same products summed in another order);
bfloat16 2e-2 (one rounding of the output, plus activations rounded to
bfloat16 at the same places as the plain version; the flash forward
rounds P against a running row max where the plain version uses the
final one, a difference well inside that bound). The flash attention
outputs are also held row by row, scale-free, at ``ROW_RTOL``: a dropped
tile or a shifted causal edge moves whole rows by far more. Lengths
cross the bf16 kernels' 128-row tiles and wrap their rings, and two
launches of the forward, of dq or of dk/dv must agree to the bit. The MoE
grouped matmuls (K4's forward and transposed modes, K5's gmm, d(lhs) and
tgmm) are held at the same tolerances, the backward's modes also at
group sizes, widths and expert counts that cross the bf16 kernels' 128 x
256 tiles, and to the bit between two launches; the attention kernels at the
GQA groups of the MoE families: 1 (DeepSeek, 16 / 16 heads) and 7
(Qwen2-57B, 28 / 4). The MoE dispatch's gradients on the card (fused and
sorted paths) are held against the same dispatch run through the plain
versions. The FlashMask kernels (K6f, K6dq, K6dkv) are held the same way
at the reference's six mask layouts, on fully-masked rows (exact zeros),
against K1 where no column is masked, and through
``flashmask_attention``'s gradients against the CPU path. The paged
attention kernels (K2r, K2d, K2v) are also held on int8 pools, where
their plain versions keep float32 through both products: float32 at
1e-4, bfloat16 at 2e-2 (the output's rounding; the Hopper body's P V
takes P as two bf16 halves); an int8 pool at the address a bf16 pool of
its shape once had gets its own tensor map. K2v's and K2r's token-tree
modes are held against the plain versions' masks (K2r's flagged windows
beside an unflagged 128-row chunk in one launch), a chain tree equals
the linear kernel bit for bit, and a float32 speculative engine on the
card streams the tokens of the same engine run through the plain
versions. A bfloat16 query over float32 pools (GPT's serving mode) runs
K2r, K2d and K2v's Hopper body with float32 pages split into bfloat16
hi + lo halves, at head_dim 64 and 128, linear and tree, at GPT's tick
and generate() shapes: held against the plain versions at 2e-2, against
the float32 kernels on the widened query with the output rounded (within
one bfloat16 ulp, under 2 % of outputs differing), and to the bit
between two calls. K4's float32 gather and scatter modes as the LoRA
delta calls them (a tick's rows of Llama-3-8B's width over 9 adapter
groups at rank 16; every row in the null group, a group of one row, rank
4 in stacks padded to 8, a 128-row chunk in one group, 3 groups, ranks
64 and 72 on either side of the split-K and wide-scatter bodies' bound,
the widths of Qwen2-7B, DeepSeek-MoE and GPT, a short last K slice) are
held against their plain versions and the reference's einsum, count as
the LoRA launches, give an exact-zero null delta and the same delta to
the bit for a row with or without the others, and raise where K4 cannot
take the shapes; the library's float32 body rule is pinned on both
sides of each bound, and two calls and a CUDA graph's replay agree to
the bit. K3a / K3b run two bfloat16 bodies chosen by the shape alone:
every mode at GPT's four widths at 1, 4, 8, 136 rows (the split body)
and 300 (the stream-K body), a K whose last cluster block gets fewer and
shorter slices, GPT's four calls replayed from a CUDA graph, and
Llama-3-8B's and Qwen2-7B's four calls on the stream-K body at 1, 8 and
136 rows are held against the plain versions at 2e-2 and to the bit
between two calls; the Python body rule is pinned to the library's. K1's
non-causal mode is held at BERT-base's shapes (L 512 and 128, one query
row against 37 and 200 keys), a tiny BERT under AMP O1 on the card against
its CPU run, and ``GradScaler`` skips a step with an inf gradient."""
from unittest import mock

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import lora
from paddle_tpu_torch.ops import paged_cache as tpc
from paddle_tpu_torch.ops.kernels import decode_fused as df
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import flashmask as fm
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.ops.kernels import moe_gmm as mg
from paddle_tpu_torch.ops.kernels import paged_attention as pda
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
ROW_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _rows_close(got, ref, dtype):
    """Elementwise at TOL, and each row (the last axis) within ROW_RTOL
    of its reference's norm; rows under a tenth of the median nonzero
    row norm (cancellations, as dq's first row) are measured against
    that tenth."""
    g, r = got.float(), ref.float()
    torch.testing.assert_close(g, r, **TOL[dtype])
    den = r.norm(dim=-1)
    live = den[den > 0]     # rows no column reaches are zero
    den = den.clamp_min(0.1 * float(live.median()) if live.numel() else 1.0)
    rel = float(((g - r).norm(dim=-1) / den).max())
    assert rel <= ROW_RTOL[dtype], rel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ragged_case(rng, base, q_lens, H, Hkv, D, BS, MB, dtype, dev):
    S = len(base)
    NB = 1 + S * MB
    tables = np.zeros((S, MB), np.int32)
    alloc = tpc.BlockAllocator(NB)
    for s in range(S):
        n = tpc.blocks_for(base[s] + q_lens[s], BS)
        tables[s, :n] = alloc.alloc(n)
    R = sum(q_lens)
    starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)  # noqa
    return (f(R, H, D), f(NB, BS, Hkv, D), f(NB, BS, Hkv, D), i32(tables),
            i32(np.asarray(base) + 1), i32(q_lens), i32(starts)), starts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_size,head_dim,mb", [
    (8, 64, 8), (16, 128, 8), (32, 128, 8), (16, 128, 64), (8, 128, 64)])
def test_ragged_paged_attention(cuda, dtype, block_size, head_dim, mb):
    """Decode rows, a multi-block chunk and a short window; the last
    case reaches far enough to split contexts across blocks."""
    rng = np.random.RandomState(block_size + head_dim + mb)
    reach = block_size * mb
    base = [0, reach // 3, reach - 1, 5]
    q_lens = [1, 2 * block_size, 1, 3]
    args, starts = _ragged_case(rng, base, q_lens, 8, 2, head_dim,
                                block_size, mb, getattr(torch, dtype), cuda)
    n0 = launch_counts["ragged_paged_attention"]
    got = rpa.ragged_paged_attention(*args, max(q_lens))
    want = rpa.plain_ragged_paged_attention(*args)
    assert launch_counts["ragged_paged_attention"] == n0 + 1
    _rows_close(got, want, dtype)


def _live(out, q_lens, starts):
    """The rows of ``out`` that belong to a slot (the kernel leaves the
    others unwritten)."""
    return torch.cat([out[s0:s0 + n] for s0, n in zip(starts, q_lens)])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8_float32",
                                  "int8_bfloat16", "f32pool"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_ragged_paged_attention_pad_rows_are_zero(cuda, mode, head_dim):
    """A serving tick at its static width: rows past every slot's
    (``r > sum(q_lens)``, memory that held NaN just before) come out
    zero in every body and pool mode (the FMA body, the Hopper body's
    bf16, int8 and float32-pool instances), as in the plain version;
    the live rows still match it."""
    rng = np.random.RandomState(head_dim)
    base, q_lens = [40, 0, 100, 7], [1, 24, 1, 5]
    dtype = torch.float32 if mode in ("float32", "int8_float32") \
        else torch.bfloat16
    args, starts = _ragged_case(rng, base, q_lens, 8, 2, head_dim, 16, 16,
                                dtype, cuda)
    q, kp, vp = args[:3]
    if mode.startswith("int8"):
        kp, vp = _int8(kp.float()), _int8(vp.float())
    elif mode == "f32pool":
        kp, vp = kp.float(), vp.float()
    live_r = sum(q_lens)
    r = live_r + 19
    qp = torch.cat([q, torch.from_numpy(rng.randn(
        r - live_r, *q.shape[1:]).astype(np.float32)).to(cuda, dtype)])
    torch.full((4 * qp.numel(),), float("nan"), device=cuda)   # freed: dirty
    got = rpa.ragged_paged_attention(qp, kp, vp, *args[3:], max(q_lens))
    want = rpa.plain_ragged_paged_attention(qp, kp, vp, *args[3:])
    assert torch.equal(got[live_r:], torch.zeros_like(got[live_r:]))
    assert torch.equal(want[live_r:], got[live_r:])
    _rows_close(got[:live_r], want[:live_r], "float32"
                if dtype == torch.float32 else "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 4, 7])
def test_ragged_paged_attention_edges(cuda, dtype, rep):
    """A 128-row prefill chunk at context 600 (past 512: tiles of many
    stages), a slot of no rows (every tile dead), decode rows whose
    context ends on a page boundary and one position past it, a window
    of 5 starting on a boundary, and a decode row at context 2000 (the
    bfloat16 body's splits), at GQA groups 1, 4 and 7; rows held
    elementwise and row by row."""
    rng = np.random.RandomState(70 + rep)
    base = [599, 300, 639, 640, 159, 1999]
    q_lens = [128, 0, 1, 1, 5, 1]
    args, starts = _ragged_case(rng, base, q_lens, 2 * rep, 2, 128, 16,
                                128, getattr(torch, dtype), cuda)
    got = rpa.ragged_paged_attention(*args, max(q_lens))
    want = rpa.plain_ragged_paged_attention(*args)
    _rows_close(_live(got, q_lens, starts), _live(want, q_lens, starts),
                dtype)


@pytest.mark.gpu
def test_ragged_paged_attention_bf16_splits_are_deterministic(cuda):
    """Two launches of the bfloat16 body over split decode rows give the
    same bits (the splits are merged in split order), and leave the
    scratch's arrival counters at zero."""
    rng = np.random.RandomState(9)
    base, q_lens = [2047, 1023, 100, 511], [1, 3, 1, 1]
    args, _ = _ragged_case(rng, base, q_lens, 32, 8, 128, 16, 128,
                           torch.bfloat16, cuda)
    a = rpa.ragged_paged_attention(*args, max(q_lens))
    b = rpa.ragged_paged_attention(*args, max(q_lens))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    stream = torch.cuda.current_stream().cuda_stream
    _, counters = rpa._SCRATCH[(args[0].device, stream)]
    assert int(counters.abs().sum()) == 0


def _paged_case(seed, lens, T, rep, D, BS, MB, dtype, dev, Hkv=2):
    """Pools, a random permutation of blocks as the slots' tables and a
    window of T query tokens per slot."""
    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(lens)
    NB = 1 + S * MB
    f = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa
    perm = torch.randperm(NB - 1, generator=g, device=dev) + 1
    tables = perm[:S * MB].reshape(S, MB).to(torch.int32).contiguous()
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    return (f(S, T, Hkv * rep, D), f(NB, BS, Hkv, D), f(NB, BS, Hkv, D),
            tables, ctx)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,block_size,mb", [
    (64, 8, 8), (128, 16, 8), (128, 32, 8), (64, 32, 64), (128, 16, 128)])
@pytest.mark.parametrize("rep,T", [(1, 1), (4, 1), (8, 1), (1, 8), (4, 5),
                                   (8, 8), (4, 3), (7, 1), (7, 5)])
def test_paged_decode_and_verify_attention(cuda, dtype, head_dim,
                                           block_size, mb, rep, T):
    """K2v (and K2d at T = 1) against the plain versions: contexts of 1,
    BS, BS + 1 and MB * BS - T + 1 (the window ends at the table's
    reach); the long tables split the context over blocks."""
    lens = [1, block_size, block_size + 1, mb * block_size - T + 1]
    q, kp, vp, tables, ctx = _paged_case(
        head_dim + block_size + rep + T, lens, T, rep, head_dim, block_size,
        mb, getattr(torch, dtype), cuda)
    n0 = dict(launch_counts)
    got = pda.paged_verify_attention(q, kp, vp, tables, ctx)
    want = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx)
    assert launch_counts["paged_verify_attention"] == \
        n0["paged_verify_attention"] + 1
    _rows_close(got, want, dtype)
    if T == 1:
        got1 = pda.paged_decode_attention(q[:, 0], kp, vp, tables, ctx)
        assert launch_counts["paged_decode_attention"] == \
            n0["paged_decode_attention"] + 1
        _rows_close(got1, want[:, 0], dtype)


@pytest.mark.gpu
def test_paged_attention_empty_context_writes_zero(cuda):
    """A query that sees no position writes 0: window token 0 of a slot
    with context 0, and the decode row of that slot (no block read at
    all), also when the context is split over blocks."""
    q, kp, vp, tables, ctx = _paged_case(3, [0, 5], 3, 4, 128, 16, 16,
                                         torch.float32, cuda)
    got = pda.paged_verify_attention(q, kp, vp, tables, ctx)
    assert torch.equal(got[0, 0], torch.zeros_like(got[0, 0]))
    want = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx)
    torch.testing.assert_close(got[:, 1:], want[:, 1:], **TOL["float32"])
    one = pda.paged_decode_attention(q[:, 0].contiguous(), kp, vp, tables,
                                     ctx)
    assert torch.equal(one[0], torch.zeros_like(one[0]))
    torch.testing.assert_close(one[1], want[1, 0], **TOL["float32"])


@pytest.mark.gpu
def test_paged_attention_empty_context_writes_zero_bf16(cuda):
    """The bfloat16 body as the test above: window token 0 of a slot
    with context 0 and its decode row write 0 (the decode row reads no
    page: its item has no stage), beside a slot whose context is split."""
    q, kp, vp, tables, ctx = _paged_case(4, [0, 600], 3, 4, 128, 16, 40,
                                         torch.bfloat16, cuda)
    got = pda.paged_verify_attention(q, kp, vp, tables, ctx)
    assert torch.equal(got[0, 0], torch.zeros_like(got[0, 0]))
    want = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx)
    _rows_close(got[:, 1:], want[:, 1:], "bfloat16")
    one = pda.paged_decode_attention(q[:, 0].contiguous(), kp, vp, tables,
                                     ctx)
    assert torch.equal(one[0], torch.zeros_like(one[0]))
    want1 = pda.plain_paged_decode_attention(q[:, 0].contiguous(), kp, vp,
                                             tables, ctx)
    _rows_close(one[1:], want1[1:], "bfloat16")


def _int8(pool):
    """A floating pool quantized into an int8 QuantKV (the write path's
    quantization)."""
    return tpc.QuantKV(*tpc.kv_quantize(pool))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# (16, 64, 64, 1): GPT's serving on int8 pools (16 / 16 heads of 64,
# tables of 64 blocks)
@pytest.mark.parametrize("block_size,head_dim,mb,rep", [
    (8, 64, 8, 4), (16, 128, 8, 1), (32, 128, 8, 4), (16, 128, 128, 7),
    (8, 128, 64, 4), (16, 64, 128, 2), (16, 64, 64, 1)])
def test_ragged_paged_attention_int8(cuda, dtype, block_size, head_dim, mb,
                                     rep):
    """K2r on int8 pools (the float32 body reads int8 pages with their
    scales; bfloat16 runs the Hopper body's int8 mode): a 2-page chunk,
    decode rows at the reach's edge, a window, a slot of no rows and a
    long decode row (splits), held elementwise and row by row; the
    launch counts as ragged_paged_attention_int8."""
    rng = np.random.RandomState(300 + block_size + head_dim + mb + rep)
    reach = block_size * mb
    base = [0, reach // 3, reach - 1, 5, 7, reach - 40]
    q_lens = [1, 2 * block_size, 1, 3, 0, 1]
    args, starts = _ragged_case(rng, base, q_lens, 2 * rep, 2, head_dim,
                                block_size, mb, getattr(torch, dtype), cuda)
    q, kp, vp = args[:3]
    k8, v8 = _int8(kp.float()), _int8(vp.float())
    n0 = dict(launch_counts)
    got = rpa.ragged_paged_attention(q, k8, v8, *args[3:], max(q_lens))
    want = rpa.plain_ragged_paged_attention(q, k8, v8, *args[3:])
    assert launch_counts["ragged_paged_attention_int8"] == \
        n0["ragged_paged_attention_int8"] + 1
    assert launch_counts["ragged_paged_attention"] == \
        n0["ragged_paged_attention"]
    _rows_close(_live(got, q_lens, starts), _live(want, q_lens, starts),
                dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,block_size,mb", [
    (64, 8, 8), (128, 16, 8), (128, 32, 8), (64, 32, 64), (128, 16, 128)])
@pytest.mark.parametrize("rep,T", [(1, 1), (4, 1), (7, 1), (4, 5), (8, 8),
                                   (7, 5)])
def test_paged_decode_and_verify_attention_int8(cuda, dtype, head_dim,
                                                block_size, mb, rep, T):
    """K2v (and K2d at T = 1) on int8 pools against the plain versions'
    float32 recipe, at the contexts of the floating test."""
    lens = [1, block_size, block_size + 1, mb * block_size - T + 1]
    q, kp, vp, tables, ctx = _paged_case(
        500 + head_dim + block_size + rep + T, lens, T, rep, head_dim,
        block_size, mb, getattr(torch, dtype), cuda)
    k8, v8 = _int8(kp.float()), _int8(vp.float())
    n0 = dict(launch_counts)
    got = pda.paged_verify_attention(q, k8, v8, tables, ctx)
    want = pda.plain_paged_verify_attention(q, k8, v8, tables, ctx)
    assert launch_counts["paged_verify_attention_int8"] == \
        n0["paged_verify_attention_int8"] + 1
    _rows_close(got, want, dtype)
    if T == 1:
        got1 = pda.paged_decode_attention(q[:, 0], k8, v8, tables, ctx)
        assert launch_counts["paged_decode_attention_int8"] == \
            n0["paged_decode_attention_int8"] + 1
        assert launch_counts["paged_decode_attention"] == \
            n0["paged_decode_attention"]
        _rows_close(got1, want[:, 0], dtype)


@pytest.mark.gpu
def test_int8_bf16_body_is_deterministic_and_writes_zero(cuda):
    """The Hopper body's int8 mode: two launches over split decode rows
    give the same bits and leave the arrival counters at zero; a window
    token that sees no position, and the decode row of that slot, write
    0."""
    q, kp, vp, tables, ctx = _paged_case(6, [0, 1500, 700], 3, 4, 128, 16,
                                         128, torch.bfloat16, cuda)
    k8, v8 = _int8(kp.float()), _int8(vp.float())
    a = pda.paged_verify_attention(q, k8, v8, tables, ctx)
    b = pda.paged_verify_attention(q, k8, v8, tables, ctx)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a[0, 0], torch.zeros_like(a[0, 0]))
    _rows_close(a[:, 1:], pda.plain_paged_verify_attention(
        q, k8, v8, tables, ctx)[:, 1:], "bfloat16")
    one = pda.paged_decode_attention(q[:, 0].contiguous(), k8, v8, tables,
                                     ctx)
    assert torch.equal(one[0], torch.zeros_like(one[0]))
    stream = torch.cuda.current_stream().cuda_stream
    _, counters = rpa._SCRATCH[(q.device, stream)]
    assert int(counters.abs().sum()) == 0


@pytest.mark.gpu
def test_int8_pool_at_a_bf16_pools_address_gets_its_own_map(cuda):
    """The Hopper body keeps its pools' tensor maps by address, shape and
    element type: an int8 pool placed where a bf16 pool of the same
    shape was (one buffer, viewed both ways) is read as int8."""
    NB, BS, Hkv, D, S, MB = 33, 16, 2, 128, 4, 8
    g = torch.Generator(device=cuda).manual_seed(8)
    bufs = [torch.empty(NB * BS * Hkv * D * 2, dtype=torch.uint8,
                        device=cuda) for _ in "kv"]
    bf = [b.view(torch.bfloat16).view(NB, BS, Hkv, D) for b in bufs]
    for t in bf:
        t.copy_(torch.randn(NB, BS, Hkv, D, generator=g, device=cuda))
    q = torch.randn(S, 8, D, generator=g, device=cuda).bfloat16()
    perm = torch.randperm(NB - 1, generator=g, device=cuda) + 1
    tables = perm[:S * MB].reshape(S, MB).to(torch.int32).contiguous()
    ctx = torch.tensor([1, 17, 100, 128], dtype=torch.int32, device=cuda)
    got = pda.paged_decode_attention(q, bf[0], bf[1], tables, ctx)
    _rows_close(got, pda.plain_paged_decode_attention(
        q, bf[0], bf[1], tables, ctx), "bfloat16")
    pools = []
    for b in bufs:      # int8 data at the bf16 pool's address
        data, scale = tpc.kv_quantize(torch.randn(
            NB, BS, Hkv, D, generator=g, device=cuda))
        view = b[:data.numel()].view(torch.int8).view(NB, BS, Hkv, D)
        view.copy_(data)
        assert view.data_ptr() == b.data_ptr()
        pools.append(tpc.QuantKV(view, scale))
    torch.cuda.synchronize()
    got = pda.paged_decode_attention(q, pools[0], pools[1], tables, ctx)
    _rows_close(got, pda.plain_paged_decode_attention(
        q, pools[0], pools[1], tables, ctx), "bfloat16")


@pytest.mark.gpu
def test_int8_wrappers_refuse_mixed_and_malformed_pools(cuda):
    q = torch.zeros(2, 8, 128, device=cuda, dtype=torch.bfloat16)
    fp = torch.zeros(5, 16, 2, 128, device=cuda, dtype=torch.bfloat16)
    k8 = _int8(fp.float())
    tables = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    ctx = torch.ones(2, dtype=torch.int32, device=cuda)
    ql = torch.ones(2, dtype=torch.int32, device=cuda)
    starts = torch.arange(2, dtype=torch.int32, device=cuda)
    for kp, vp, exc, match in (
            (k8, fp, TypeError, "mixed pools"),
            (fp, k8, TypeError, "mixed pools"),
            (k8, tpc.QuantKV(k8.data, k8.scale.double()), TypeError,
             "float32 scales"),
            (k8, tpc.QuantKV(k8.data, k8.scale[:, :8]), ValueError,
             r"\[NB, BS, Hkv\]"),
            (k8, tpc.QuantKV(k8.data, k8.scale.transpose(0, 1)
                             .contiguous().transpose(0, 1)), ValueError,
             "contiguous")):
        with pytest.raises(exc, match=match):
            pda.paged_decode_attention(q, kp, vp, tables, ctx)
        with pytest.raises(exc, match=match):
            rpa.ragged_paged_attention(q, kp, vp, tables, ctx, ql, starts,
                                       1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [3, 40, 128])
def test_norm_matmul(cuda, dtype, rows):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(rows)
    x = torch.randn(rows, 256, generator=g, device=cuda).to(dt)
    gamma = torch.randn(256, generator=g, device=cuda).to(dt)
    ws = [(0.05 * torch.randn(256, n, generator=g, device=cuda)).to(dt)
          for n in (256, 64, 96)]
    n0 = launch_counts["norm_matmul"]
    kw = dict(eps=1e-6, kind="rms")
    for a, b in zip(df.norm_matmul(x, gamma, None, ws, [None] * 3, **kw),
                    df.plain_norm_matmul(x, gamma, None, ws, [None] * 3,
                                         **kw)):
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])
    assert launch_counts["norm_matmul"] == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [3, 40, 128])
def test_matmul_residual(cuda, dtype, rows):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(rows + 1)
    res = torch.randn(rows, 256, generator=g, device=cuda).to(dt)
    gu = [torch.randn(rows, 320, generator=g, device=cuda).to(dt)
          for _ in range(2)]
    w = (0.05 * torch.randn(320, 256, generator=g, device=cuda)).to(dt)
    bias = torch.randn(256, generator=g, device=cuda).to(dt)
    n0 = launch_counts["matmul_residual"]
    for act, xs in ((None, gu[:1]), ("swiglu", gu)):
        for b in (None, bias):
            torch.testing.assert_close(
                df.matmul_residual(xs, w, b, res, act=act).float(),
                df.plain_matmul_residual(xs, w, b, res, act=act).float(),
                **TOL[dtype])
    assert launch_counts["matmul_residual"] == n0 + 4


# Every mode of K3a / K3b at the rows of a decode tick (1, 8), the
# prefill tick (136: three of the bf16 body's m64 row groups), and past
# its 256-row blocks (300: two blocks of three groups; 1024: four of
# four), over K = 320 (five 64-deep slices) and widths that end inside a
# 128-column tile and inside its second 64-column box.
K3_ROWS = [1, 8, 136, 300, 1024]
NORM_MODES = {   # kind, beta, widths, biases
    "rms": ("rms", False, (256, 64, 96), (False, False, False)),
    "rms_bias": ("rms", False, (256, 64, 96), (True, False, True)),
    "ln": ("ln", False, (200,), (False,)),
    "ln_beta_bias": ("ln", True, (384, 200), (True, True)),
}


def _k3_inputs(seed, dt, dev, *shapes):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*s, generator=g, device=dev).to(dt) for s in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", K3_ROWS)
@pytest.mark.parametrize("mode", list(NORM_MODES))
def test_norm_matmul_modes(cuda, dtype, rows, mode):
    """Each mode against its plain version, row by row; two calls give
    the same bits (the stream-K partials are summed in order of K); the
    launch count moves by one a call."""
    kind, has_beta, widths, has_bias = NORM_MODES[mode]
    dt, d = getattr(torch, dtype), 320
    x, gamma, beta = _k3_inputs(rows, dt, cuda, (rows, d), (d,), (d,))
    x, gamma, beta = x + 0.5, 1 + 0.1 * gamma, 0.1 * beta if has_beta \
        else None
    ws = [0.05 * w for w in _k3_inputs(rows + 1, dt, cuda,
                                       *[(d, n) for n in widths])]
    bs = [b if hb else None for b, hb in zip(
        _k3_inputs(rows + 2, dt, cuda, *[(n,) for n in widths]), has_bias)]
    kw = dict(eps=1e-5, kind=kind)
    n0 = launch_counts["norm_matmul"]
    got = df.norm_matmul(x, gamma, beta, ws, bs, **kw)
    again = df.norm_matmul(x, gamma, beta, ws, bs, **kw)
    assert launch_counts["norm_matmul"] == n0 + 2
    for a, b, c in zip(got, df.plain_norm_matmul(x, gamma, beta, ws, bs,
                                                 **kw), again):
        _rows_close(a, b, dtype)
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", K3_ROWS)
@pytest.mark.parametrize("act", [None, "swiglu", "gelu_tanh"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_matmul_residual_modes(cuda, dtype, rows, act, with_bias):
    dt, k, n = getattr(torch, dtype), 320, 200
    gate, up, res, w, b = _k3_inputs(rows + 3, dt, cuda, (rows, k),
                                     (rows, k), (rows, n), (k, n), (n,))
    xs = [gate, up] if act == "swiglu" else [gate]
    w, b = 0.05 * w, b if with_bias else None
    n0 = launch_counts["matmul_residual"]
    got = df.matmul_residual(xs, w, b, res, act=act)
    again = df.matmul_residual(xs, w, b, res, act=act)
    assert launch_counts["matmul_residual"] == n0 + 2
    _rows_close(got, df.plain_matmul_residual(xs, w, b, res, act=act),
                dtype)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [5, 70, 300])
def test_split_k_paths(cuda, rows):
    """Few column tiles over a long K, both bfloat16 bodies' split of K:
    at 5 and 70 rows the split body gives each 128-column tile a
    cluster of 8 blocks of 4 slices, summed over distributed shared memory in
    rank order; at 300 rows the stream-K body cuts each segment of 32
    slices into pieces of MIN_PER = 4 slices on as many blocks, and the
    first piece sums the others' float32 partials in order of K (every
    mode's epilogue after either)."""
    assert df.body(rows, 2048, [64, 128]) == (
        "split_k" if rows <= 192 else "stream_k")
    bf = torch.bfloat16
    x, gamma, beta, res = _k3_inputs(7 + rows, bf, cuda, (rows, 2048),
                                     (2048,), (2048,), (rows, 64))
    ws = [0.03 * w for w in _k3_inputs(8 + rows, bf, cuda, (2048, 64),
                                       (2048, 128))]
    bias, b1 = _k3_inputs(9 + rows, bf, cuda, (64,), (128,))
    for kind, bt in (("rms", None), ("ln", beta)):
        kw = dict(eps=1e-6, kind=kind)
        got = df.norm_matmul(x, gamma, bt, ws, [None, b1], **kw)
        for a, b, c in zip(got, df.plain_norm_matmul(x, gamma, bt, ws,
                                                     [None, b1], **kw),
                           df.norm_matmul(x, gamma, bt, ws, [None, b1],
                                          **kw)):
            _rows_close(a, b, "bfloat16")
            assert torch.equal(a, c)
    w = 0.03 * _k3_inputs(10 + rows, bf, cuda, (2048, 64))[0]
    for act, xs in ((None, [x]), ("swiglu", [x, x.flip(0).contiguous()]),
                    ("gelu_tanh", [x])):
        got = df.matmul_residual(xs, w, bias, res, act=act)
        _rows_close(got, df.plain_matmul_residual(xs, w, bias, res,
                                                  act=act), "bfloat16")
        assert torch.equal(got, df.matmul_residual(xs, w, bias, res,
                                                   act=act))


# GPT's four K3 calls (paddle_tpu_torch/models/gpt.py: LayerNorm + beta
# into q/k/v and into the first MLP linear, each with its bias; the output
# projection and tanh-gelu into the second MLP linear, each + bias +
# residual) at generate()'s 4 rows, the decode tick's 1 and 8, the
# prefill tick's 136 (the split body) and 300 (two row blocks: the
# stream-K body); every mode of both kernels at those widths.
GPT_K3_ROWS = [1, 4, 8, 136, 300]
GPT_K3A_WIDTHS = {"qkv": (1024, 3072), "fc1": (1024, 4096)}
GPT_K3B_WIDTHS = {"out_proj": (1024, 1024), "fc2": (4096, 1024)}


def _gpt_k3a(seed, rows, d, n, mode, dev):
    kind, has_beta, _, _ = NORM_MODES[mode]
    x, gamma, beta, w, b = _k3_inputs(seed, torch.bfloat16, dev, (rows, d),
                                      (d,), (d,), (d, n), (n,))
    has_bias = mode in ("rms_bias", "ln_beta_bias")
    return (x + 0.5, 1 + 0.1 * gamma, 0.1 * beta if has_beta else None,
            [0.03 * w], [b if has_bias else None],
            dict(eps=1e-5, kind=kind))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", GPT_K3_ROWS)
@pytest.mark.parametrize("case", list(GPT_K3A_WIDTHS))
@pytest.mark.parametrize("mode", list(NORM_MODES))
def test_norm_matmul_at_gpt_widths(cuda, rows, case, mode):
    """K3a at GPT's widths: row by row against the plain version, two
    calls to the bit, one launch a call, on the body the shape rule
    names."""
    d, n = GPT_K3A_WIDTHS[case]
    assert df.body(rows, d, [n]) == ("split_k" if rows <= 192
                                     else "stream_k")
    x, gamma, beta, ws, bs, kw = _gpt_k3a(rows + 20, rows, d, n, mode, cuda)
    n0 = launch_counts["norm_matmul"]
    (got,) = df.norm_matmul(x, gamma, beta, ws, bs, **kw)
    (again,) = df.norm_matmul(x, gamma, beta, ws, bs, **kw)
    assert launch_counts["norm_matmul"] == n0 + 2
    _rows_close(got, df.plain_norm_matmul(x, gamma, beta, ws, bs, **kw)[0],
                "bfloat16")
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", GPT_K3_ROWS)
@pytest.mark.parametrize("case", list(GPT_K3B_WIDTHS))
@pytest.mark.parametrize("act", [None, "swiglu", "gelu_tanh"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_matmul_residual_at_gpt_widths(cuda, rows, case, act, with_bias):
    """K3b at GPT's widths, held as K3a's."""
    k, n = GPT_K3B_WIDTHS[case]
    assert df.body(rows, k, [n]) == ("split_k" if rows <= 192
                                     else "stream_k")
    gate, up, res, w, b = _k3_inputs(rows + 30, torch.bfloat16, cuda,
                                     (rows, k), (rows, k), (rows, n),
                                     (k, n), (n,))
    xs = [gate, up] if act == "swiglu" else [gate]
    w, b = 0.03 * w, b if with_bias else None
    n0 = launch_counts["matmul_residual"]
    got = df.matmul_residual(xs, w, b, res, act=act)
    again = df.matmul_residual(xs, w, b, res, act=act)
    assert launch_counts["matmul_residual"] == n0 + 2
    _rows_close(got, df.plain_matmul_residual(xs, w, b, res, act=act),
                "bfloat16")
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [3, 136])
@pytest.mark.parametrize("k", [1384, 1000, 4040])
def test_split_body_short_last_slice(cuda, rows, k):
    """The split body where K's slices do not fill the cluster evenly: at
    K 1384 (22 slices, the last 40 deep) each of a tile's 8 blocks takes
    3 slices and the last block 1, at K 1000 (16 slices) 2 each, the last
    short, at K 4040 (64 slices, the last 8 deep) 8 each, and K3a's norm
    pre-pass reads a row past 2048 in passes; K3a (ln + beta, two
    projections, biases) and K3b (gelu + bias) against their plain
    versions, to the bit on a second call."""
    assert df.split_config(k, [1024]) == (128, 8, 64)
    assert df.body(rows, k, [1024, 512]) == "split_k"
    x, gamma, beta, res = _k3_inputs(k + rows, torch.bfloat16, cuda,
                                     (rows, k), (k,), (k,), (rows, 1024))
    ws = [0.03 * w for w in _k3_inputs(k + 1, torch.bfloat16, cuda,
                                       (k, 1024), (k, 512))]
    bs = _k3_inputs(k + 2, torch.bfloat16, cuda, (1024,), (512,))
    kw = dict(eps=1e-5, kind="ln")
    got = df.norm_matmul(x, gamma, beta, ws, bs, **kw)
    for a, b, c in zip(got, df.plain_norm_matmul(x, gamma, beta, ws, bs,
                                                 **kw),
                       df.norm_matmul(x, gamma, beta, ws, bs, **kw)):
        _rows_close(a, b, "bfloat16")
        assert torch.equal(a, c)
    w = 0.03 * _k3_inputs(k + 3, torch.bfloat16, cuda, (k, 1024))[0]
    got = df.matmul_residual([x], w, bs[0], res, act="gelu_tanh")
    _rows_close(got, df.plain_matmul_residual([x], w, bs[0], res,
                                              act="gelu_tanh"), "bfloat16")
    assert torch.equal(got, df.matmul_residual([x], w, bs[0], res,
                                               act="gelu_tanh"))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 136])
def test_gpt_k3_graph_replay_equals_eager(cuda, rows):
    """GPT's four K3 calls captured in a CUDA graph: the replay, its
    inputs rewritten in place after the capture, equals the eager calls
    on the new inputs to the bit."""
    bf = torch.bfloat16
    x, res, g = _k3_inputs(rows, bf, cuda, (rows, 1024), (rows, 1024),
                           (rows, 4096))
    params = _k3_inputs(rows + 1, bf, cuda, (1024,), (1024,), (1024, 3072),
                        (3072,), (1024, 4096), (4096,), (1024, 1024),
                        (1024,), (4096, 1024), (1024,))
    gamma, beta, wq, bq, w1, b1, wo, bo, w2, b2 = params
    kw = dict(eps=1e-5, kind="ln")

    def layer():
        (qkv,) = df.norm_matmul(x, gamma, beta, [wq], [bq], **kw)
        (h,) = df.norm_matmul(res, gamma, beta, [w1], [b1], **kw)
        return (qkv, h, df.matmul_residual([x], wo, bo, res),
                df.matmul_residual([g], w2, b2, res, act="gelu_tanh"))

    first = layer()
    assert all(torch.equal(a, b) for a, b in zip(first, layer()))
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        layer()                     # warm-up on the side stream
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = layer()
    for dst, src in zip((x, res, g), _k3_inputs(rows + 2, bf, cuda,
                                                (rows, 1024), (rows, 1024),
                                                (rows, 4096))):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    eager = layer()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
    assert not torch.equal(captured[0], first[0])


# each model's four K3 calls a decoder layer: (K3a q/k/v, K3a gate/up or
# fc1, K3b o_proj, K3b down or fc2) as (K, widths)
K3_MODEL_CALLS = {
    "gpt": ((1024, [3072]), (1024, [4096]), (1024, [1024]), (4096, [1024])),
    "llama3_8b": ((4096, [4096, 1024, 1024]), (4096, [14336, 14336]),
                  (4096, [4096]), (14336, [4096])),
    "qwen2_7b": ((3584, [3584, 512, 512]), (3584, [18944, 18944]),
                 (3584, [3584]), (18944, [3584]))}


@pytest.mark.gpu
def test_decode_gemm_body_rule(cuda):
    """The Python rule (``df.body``, ``df.split_config``) equals the
    library's (``ptt_decode_gemm_body``) over rows, depths and widths on
    both sides of each bound; GPT's four calls take the split body at
    generate()'s 4 rows, the decode tick's 8 and the prefill tick's 136
    (128-column tiles: q/k/v over clusters of 4, fc1 of 3, out_proj and
    fc2 of 8), Llama-3-8B's and
    Qwen2-7B's the stream-K body at every width."""
    top = df.SPLIT_MAX_WEIGHTS
    shapes = [(k, w) for calls in K3_MODEL_CALLS.values() for k, w in calls]
    shapes += [(320, [256, 64, 96]), (320, [200]), (2048, [64, 128]),
               (1384, [1024, 512]), (8, [8]), (64, [top // 64]),
               (64, [top // 64 + 8]), (1024, [top // 1024 - 8, 8]),
               (1024, [top // 1024, 8]), (72, [8, 8, 8]),
               (65536, [64]), (256, [33000])]
    for r in (1, 4, 8, 64, 65, 136, 192, 193, 300):
        for k, w in shapes:
            want = df.body(r, k, w)
            assert df._c_body(r, k, w) == (
                want, df.split_config(k, w) if want == "split_k" else None)
    split = {"gpt": ((128, 4, 96), (128, 3, 96), (128, 8, 64),
                     (128, 8, 64))}
    for model, calls in K3_MODEL_CALLS.items():
        for r in (4, 8, 136):
            for i, (k, w) in enumerate(calls):
                body, cfg = df._c_body(r, k, w)
                assert body == ("split_k" if model == "gpt"
                                else "stream_k"), (model, r, k, w)
                if model == "gpt":
                    assert cfg == split["gpt"][i]
        assert {df.body(300, k, w) for k, w in calls} == {"stream_k"}


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 136])
@pytest.mark.parametrize("model", ["llama3_8b", "qwen2_7b"])
def test_stream_k_body_at_llama_and_qwen2_widths(cuda, rows, model):
    """The stream-K body at the rows the split body now takes at small
    widths: Llama-3-8B's and Qwen2-7B's four calls (rms, no biases;
    swiglu into down) against their plain versions, to the bit on a
    second call."""
    bf = torch.bfloat16
    (kq, wq), (kg, wg), (ko, wo), (kd, wd) = K3_MODEL_CALLS[model]
    x, gamma, res, gate, up = _k3_inputs(rows + 40, bf, cuda, (rows, kq),
                                         (kq,), (rows, kq), (rows, kd),
                                         (rows, kd))
    gamma = 1 + 0.1 * gamma
    kw = dict(eps=1e-6, kind="rms")
    for widths in (wq, wg):
        ws = [0.02 * w for w in _k3_inputs(rows + 41, bf, cuda,
                                           *[(kq, n) for n in widths])]
        assert df.body(rows, kq, widths) == "stream_k"
        got = df.norm_matmul(x, gamma, None, ws, [None] * len(ws), **kw)
        for a, b, c in zip(got, df.plain_norm_matmul(
                x, gamma, None, ws, [None] * len(ws), **kw),
                df.norm_matmul(x, gamma, None, ws, [None] * len(ws), **kw)):
            _rows_close(a, b, "bfloat16")
            assert torch.equal(a, c)
        del ws
    for k, xs, act in ((ko, [x], None), (kd, [gate, up], "swiglu")):
        w = 0.02 * _k3_inputs(rows + 42, bf, cuda, (k, kq))[0]
        assert df.body(rows, k, [kq]) == "stream_k"
        got = df.matmul_residual(xs, w, None, res, act=act)
        _rows_close(got, df.plain_matmul_residual(xs, w, None, res,
                                                  act=act), "bfloat16")
        assert torch.equal(got, df.matmul_residual(xs, w, None, res,
                                                   act=act))


def _attn_case(seed, B, lq, lk, H, Hkv, D, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa
    return f(B, lq, H, D), f(B, lk, Hkv, D), f(B, lk, Hkv, D), f(B, lq, H, D)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim,rep", [(64, 1), (64, 4), (128, 1),
                                          (128, 4), (128, 7)])
@pytest.mark.parametrize("lq,lk", [(200, 200), (64, 64), (100, 230),
                                   (129, 129), (1, 300), (300, 130),
                                   (1100, 1100)])
def test_flash_attention_kernels(cuda, dtype, causal, head_dim, rep, lq,
                                 lk):
    """K1f, K1dq and K1dkv each against its plain version on the same
    inputs; lengths off the 64-row tile and the bf16 forward's 128-row
    tile exercise the tail masks, lq != lk the top-left causal mask (one
    query row sees one column or all of them; Lq > Lk), L 1100 wraps
    the forward's 2-slot kv ring several times, and rep 7 is
    Qwen2-57B's GQA group (28 / 4 heads)."""
    q, k, v, do = _attn_case(head_dim + rep + lq, 2, lq, lk, 2 * rep, 2,
                             head_dim, getattr(torch, dtype), cuda)
    scale = head_dim ** -0.5
    n0 = dict(launch_counts)
    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
    o_p, lse_p = fa.plain_flash_attention_fwd(q, k, v, scale, causal)
    _rows_close(o, o_p, dtype)
    torch.testing.assert_close(lse, lse_p, **TOL[dtype])
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse_p, delta, scale, causal)
    # one causal query row sees column 0 alone: dS = P (dP - delta) is 0,
    # so dq and dk are 0 in exact arithmetic and both sides hold rounding
    # noise, which a row-relative check would divide by itself; they are
    # held elementwise, dv (P^T dO, nonzero) row by row
    zero = causal and lq == 1
    rows_or_elems = (lambda a, b: torch.testing.assert_close(  # noqa: E731
        a.float(), b.float(), **TOL[dtype])) if zero else \
        (lambda a, b: _rows_close(a, b, dtype))  # noqa: E731
    rows_or_elems(fa.flash_attention_dq(*args),
                  fa.plain_flash_attention_dq(*args))
    dk, dv = fa.flash_attention_dkv(*args)
    dk_p, dv_p = fa.plain_flash_attention_dkv(*args)
    rows_or_elems(dk, dk_p)
    _rows_close(dv, dv_p, dtype)
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert launch_counts[name] == n0[name] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_forward_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same o and lse to the bit
    (the forward uses no atomics; its walk and sums have one order)."""
    q, k, v, _ = _attn_case(8, 2, 1000, 1000, 8, 2, 128,
                            getattr(torch, dtype), cuda)
    first = fa.flash_attention_fwd(q, k, v, 0.1, True)
    again = fa.flash_attention_fwd(q, k, v, 0.1, True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_is_deterministic(cuda, dtype):
    """Two launches of dq and of dk/dv on the same inputs give the same
    gradients to the bit: two passes, no atomics, one walk order (the
    dk/dv block sums its GQA group itself)."""
    q, k, v, do = _attn_case(12, 2, 1000, 1000, 8, 2, 128,
                             getattr(torch, dtype), cuda)
    o, lse = fa.plain_flash_attention_fwd(q, k, v, 0.1, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, 0.1, True)
    assert torch.equal(fa.flash_attention_dq(*args),
                       fa.flash_attention_dq(*args))
    first, again = fa.flash_attention_dkv(*args), fa.flash_attention_dkv(
        *args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,lq,lk", [(32, 512, 512), (32, 128, 128),
                                     (2, 1, 37), (2, 1, 200)])
def test_flash_attention_at_bert_shapes(cuda, dtype, b, lq, lk):
    """K1 non-causal at BERT-base's attention (12 / 12 heads of 64):
    pretraining's L 512, the fine-tune's L 128 (one 128-row q tile a
    head), and one query row against a cache of 37 and of 200 keys, as
    ``MultiHeadAttention``'s cached decoding reads them; each pass
    against its plain version."""
    q, k, v, do = _attn_case(b + lq + lk, b, lq, lk, 12, 12, 64,
                             getattr(torch, dtype), cuda)
    o, lse = fa.flash_attention_fwd(q, k, v, 0.125, False)
    o_p, lse_p = fa.plain_flash_attention_fwd(q, k, v, 0.125, False)
    _rows_close(o, o_p, dtype)
    torch.testing.assert_close(lse, lse_p, **TOL[dtype])
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse_p, delta, 0.125, False)
    _rows_close(fa.flash_attention_dq(*args),
                fa.plain_flash_attention_dq(*args), dtype)
    for a, b_ in zip(fa.flash_attention_dkv(*args),
                     fa.plain_flash_attention_dkv(*args)):
        _rows_close(a, b_, dtype)


def _tiny_bert(dev):
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification)
    cfg = BertConfig.tiny(vocab=96, hidden=128, layers=2, heads=2)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return BertForSequenceClassification(cfg, device=dev, seed=3)


@pytest.mark.gpu
def test_tiny_bert_o1_on_the_card_matches_its_cpu_run(cuda):
    """A tiny BERT (2 layers, 2 heads of 64) under ``auto_cast`` O1 in
    bfloat16: unmasked on the card (K1 in bf16, 2 forwards) against the
    same weights on the CPU (the plain K1), logits within 5e-2 and the
    loss within 2e-2 relative (bf16 products summed in other orders);
    logits in bfloat16 (the classifier is a white ``linear``), every
    gradient finite and float32."""
    from paddle_tpu_torch import amp
    cpu = _tiny_bert("cpu")
    gpu = _tiny_bert(cuda)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 96, (4, 64)))
    labels = torch.tensor([0, 1, 1, 0])
    out = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        n0 = dict(launch_counts)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(ids.to(dev))
            loss = model(ids.to(dev), labels=labels.to(dev))
        loss.backward()
        launched = launch_counts["flash_attention_fwd"] - n0[
            "flash_attention_fwd"]
        assert launched == (4 if dev == cuda else 0)
        assert logits.dtype == torch.bfloat16      # linear is white
        assert all(p.grad.dtype == torch.float32
                   and torch.isfinite(p.grad).all()
                   for p in model.parameters())
        out.append((logits.detach().cpu(), float(loss.detach())))
    torch.testing.assert_close(out[1][0], out[0][0], atol=5e-2, rtol=5e-2)
    assert abs(out[1][1] - out[0][1]) <= 2e-2 * abs(out[0][1])


@pytest.mark.gpu
def test_grad_scaler_skips_a_step_with_an_inf_gradient(cuda):
    """``GradScaler`` on the card: a gradient holding an inf skips the
    step and halves the scale; a finite one steps by the unscaled
    gradient, in float32 and in bfloat16 (whose check is not fused)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import SGD
    p = torch.nn.Parameter(torch.ones(4, device=cuda))
    opt = SGD(0.5, parameters=[p])
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    p.grad = torch.tensor([1.0, float("inf"), 1.0, 1.0], device=cuda)
    scaler.step(opt)
    scaler.update()
    assert torch.equal(p.detach(), torch.ones(4, device=cuda))
    assert scaler.get_init_loss_scaling() == 4.0
    p.grad = None
    scaler.scale((p * torch.arange(4.0, device=cuda)).sum()).backward()
    scaler.step(opt)
    scaler.update()
    torch.testing.assert_close(p.detach(), 1 - 0.5 * torch.arange(
        4.0, device=cuda))
    q = torch.nn.Parameter(torch.ones(4, device=cuda, dtype=torch.bfloat16))
    opt = SGD(0.5, parameters=[q])
    q.grad = torch.tensor([1.0, 1.0, float("nan"), 1.0], device=cuda,
                          dtype=torch.bfloat16)
    scaler.step(opt)
    scaler.update()
    assert torch.equal(q.detach(), torch.ones_like(q))
    assert scaler.get_init_loss_scaling() == 2.0
    q.grad = torch.full((4,), 2.0, device=cuda, dtype=torch.bfloat16)
    scaler.step(opt)
    scaler.update()
    assert torch.equal(q.detach(), torch.full_like(q, 0.5))


@pytest.mark.gpu
def test_flash_attention_autograd_matches_plain_path(cuda):
    """The autograd Function through the kernels on the card against the
    same Function on CPU copies (the plain versions), float32."""
    q, k, v, do = _attn_case(5, 2, 130, 130, 8, 2, 64, torch.float32, cuda)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention(*leaves, 0.125, causal=True)
        o.backward(do.to(dev))
        outs.append([o.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **TOL["float32"])


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        df.norm_matmul(x, x[0], None, [torch.zeros(
            12, 8, device=cuda, dtype=torch.bfloat16)], [None], eps=1e-6,
            kind="rms")
    h = torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        df.matmul_residual([h], torch.zeros(16, 12, device=cuda,
                                            dtype=torch.bfloat16), None,
                           torch.zeros(4, 12, device=cuda,
                                       dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="aligned"):
        big = torch.zeros(5, 16, device=cuda, dtype=torch.bfloat16)
        df.matmul_residual([big.reshape(-1)[4:68].reshape(4, 16)],
                           torch.zeros(16, 16, device=cuda,
                                       dtype=torch.bfloat16), None, h)
    with pytest.raises(ValueError, match=r"want \(16,\)"):
        df.matmul_residual([h], torch.zeros(16, 16, device=cuda,
                                            dtype=torch.bfloat16),
                           torch.zeros(8, device=cuda,
                                       dtype=torch.bfloat16), h)
    with pytest.raises(TypeError, match="float32 or"):
        h16 = torch.zeros(4, 8, device=cuda, dtype=torch.float16)
        df.matmul_residual([h16], torch.zeros(8, 8, device=cuda,
                                              dtype=torch.float16), None,
                           h16)
    q = torch.zeros(2, 4, 96, device=cuda)
    pool = torch.zeros(3, 8, 2, 96, device=cuda)
    i32 = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        rpa.ragged_paged_attention(q, pool, pool, i32.reshape(1, 1), i32,
                                   i32, i32, 1)
    qa = torch.zeros(1, 8, 4, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(qa, qa, qa, 0.1, True)

    # K2d / K2v: head_dim, block size, a linear window's length
    # (MAX_WINDOW at most), group width (64 at most), dtypes, int32
    # metadata and contiguity
    def paged(T=1, rep=4, D=128, BS=16, dt=torch.float32, pool_dt=None,
              lens_dt=torch.int32):
        q = torch.zeros(2, T, 2 * rep, D, device=cuda, dtype=dt)
        pool = torch.zeros(5, BS, 2, D, device=cuda, dtype=pool_dt or dt)
        tables = torch.ones(2, 2, dtype=torch.int32, device=cuda)
        return q, pool, pool, tables, torch.ones(2, dtype=lens_dt,
                                                 device=cuda)
    for kw, exc, match in (
            (dict(D=96), ValueError, "head_dim"),
            (dict(BS=12), ValueError, "block_size"),
            (dict(T=pda.MAX_WINDOW + 1, rep=1), ValueError, "window"),
            (dict(T=1, rep=65), ValueError, "whole group"),
            (dict(dt=torch.float16), TypeError, "float32 or"),
            (dict(pool_dt=torch.bfloat16), TypeError, "share"),
            (dict(lens_dt=torch.int64), TypeError, "int32")):
        args = paged(**kw)
        with pytest.raises(exc, match=match):
            pda.paged_verify_attention(*args)
        if args[0].shape[1] == 1:
            with pytest.raises(exc, match=match):
                pda.paged_decode_attention(args[0][:, 0], *args[1:])
    q, kp, vp, tables, ctx = paged(T=2)
    with pytest.raises(ValueError, match="contiguous"):
        pda.paged_verify_attention(q.transpose(1, 2), kp, vp, tables, ctx)
    with pytest.raises(ValueError, match="want \\[S, H, D\\]"):
        pda.paged_decode_attention(q, kp, vp, tables, ctx)
    qa = torch.zeros(1, 8, 3, 64, device=cuda)
    with pytest.raises(ValueError, match="whole group"):
        fa.flash_attention_fwd(qa, qa[:, :, :2].contiguous(),
                               qa[:, :, :2].contiguous(), 0.1, True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,kv_heads", [(16, 16), (28, 4)])
def test_attention_kernels_at_moe_groups(cuda, dtype, heads, kv_heads):
    """K2r, K2d and K2v at GQA group 1 and 7 (head_dim 128, BS 16)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(heads)
    base, q_lens = [0, 300, 1000, 17], [1, 40, 1, 5]
    args, _ = _ragged_case(rng, base, q_lens, heads, kv_heads, 128, 16,
                           80, dt, cuda)
    _rows_close(rpa.ragged_paged_attention(*args, max(q_lens)),
                rpa.plain_ragged_paged_attention(*args), dtype)
    lens = [1, 16, 17, 70 * 16 - 4]
    for T in (1, 5):
        q, kp, vp, tables, ctx = _paged_case(
            heads + T, lens, T, heads // kv_heads, 128, 16, 70, dt, cuda,
            Hkv=kv_heads)
        want = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx)
        _rows_close(pda.paged_verify_attention(q, kp, vp, tables, ctx),
                    want, dtype)
        if T == 1:
            _rows_close(pda.paged_decode_attention(q[:, 0], kp, vp, tables,
                                                   ctx), want[:, 0], dtype)


def _moe_case(routing, s, d, f, e, k, dt, dev, seed=0):
    """x, gate_up, down and a stable expert-major sort of top-k picks:
    ``(order, src_rows, group_sizes)`` as int32 tensors. ``routing`` may
    be a tuple of the e group sizes (summing to s * k), dealt to the
    pairs in a random order."""
    rng = np.random.RandomState(seed)
    if isinstance(routing, tuple):       # explicit group sizes
        flat = rng.permutation(np.repeat(np.arange(e), routing))
    elif routing == "one":               # every pair to one expert
        flat = np.full(s * k, e // 2)
    elif routing == "sparse":            # most groups empty
        flat = rng.choice([1, e - 1], s * k)
    elif routing == "single":            # a group of one row
        flat = rng.randint(0, e - 1, s * k)
        flat[s * k // 2] = e - 1
    else:
        flat = rng.randint(0, e, s * k)
    order = np.argsort(flat, kind="stable")
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa
    f32 = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.randn(*sh).astype(np.float32)).to(dev, dt)
    return (f32(s, d), 0.1 * f32(e, d, 2 * f), 0.1 * f32(e, f, d),
            i32(order), i32(order // k),
            i32(np.bincount(flat, minlength=e)))


_EDGE_SIZES = (1, 63, 64, 65, 0, 127, 129, 257)
# the bf16 forward modes run the Hopper body from T_SM90 mean rows a
# group (ceil(m / e)) on, the mma.sync body below it
T_SM90 = mg.SM90_MIN_ROWS
# _EDGE_SIZES and a ninth group that lifts the mean to 128 rows a group;
# the same edges around the Hopper body's 128-row tiles
_EDGE_PAST = _EDGE_SIZES + (9 * 128 - sum(_EDGE_SIZES),)
_EDGE_128 = (1, 127, 128, 129, 0, 255, 257, 513)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routing,s,d,f,e,k", [
    ("random", 8, 64, 96, 8, 2), ("random", 40, 128, 64, 16, 6),
    ("random", 300, 64, 136, 4, 2), ("one", 24, 64, 96, 8, 2),
    ("sparse", 64, 64, 96, 64, 6), ("single", 16, 128, 64, 8, 2),
    (_EDGE_PAST, sum(_EDGE_PAST), 64, 96, 9, 1),
    (_EDGE_128, sum(_EDGE_128), 72, 136, 8, 1),
    ("one", 512, 64, 96, 8, 2), ("sparse", 256 * T_SM90, 64, 96, 1024, 4),
    ("random", 512, 1432, 136, 4, 2), ("single", 256, 128, 64, 8, 4),
    ("random", 4 * T_SM90 - 4, 128, 192, 8, 2),
    ("random", 4 * T_SM90, 128, 192, 8, 2)])
def test_moe_gmm_modes(cuda, dtype, routing, s, d, f, e, k):
    """The three modes against their plain versions: few rows a group,
    top-6 over 16 experts, groups over 64 rows (several chunks a
    block), every pair to one expert, most groups empty, a group of one
    row; then, at T_SM90 mean rows a group or more (bf16: the Hopper body),
    the backward test's groups of 1, 63, 64, 65, 0, 127, 129 and 257
    rows and the same edges around 128-row tiles (K 72), every pair to
    one expert, 1024 experts of which two are routed to, f 136 (a partial
    swiglu tile of 8 columns, a gmm width of 272) with d 1432 (a
    scatter width and a depth that are no multiple of 64 or 256), a
    group of one row; and one routing on each side of T_SM90 at the same
    widths (T_SM90 - 1: the mma.sync body, T_SM90: the Hopper body)."""
    x, gu, dn, order, src, gs = _moe_case(routing, s, d, f, e, k,
                                          getattr(torch, dtype), cuda)
    assert mg._lib().ptt_moe_gmm_sm90_min_rows() == T_SM90
    n0 = dict(launch_counts)
    h = mg.gather_gmm_swiglu(x, src, gu, gs)
    h_ref = mg.plain_gather_gmm_swiglu(x, src, gu, gs)
    _rows_close(h, h_ref, dtype)
    ys = mg.scatter_gmm(h_ref, dn, gs, order)
    _rows_close(ys, mg.plain_scatter_gmm(h_ref, dn, gs, order), dtype)
    _rows_close(mg.gather_gmm(x, src, gu, gs),
                mg.plain_gather_gmm(x, src, gu, gs), dtype)
    xs = x[src.long()].contiguous()
    _rows_close(mg.gather_gmm(xs, None, dn.transpose(1, 2).contiguous(),
                              gs),
                mg.plain_gather_gmm(xs, None, dn.transpose(1, 2), gs),
                dtype)
    for name, n in (("moe_gather_gmm_swiglu", 1), ("moe_scatter_gmm", 1),
                    ("moe_gmm", 2)):
        assert launch_counts[name] == n0[name] + n


@pytest.mark.gpu
def test_moe_gmm_rows_past_the_groups_are_zero(cuda):
    x = torch.randn(20, 16, device=cuda)
    w = torch.randn(3, 16, 8, device=cuda)
    gs = torch.tensor([4, 0, 9], dtype=torch.int32, device=cuda)
    out = mg.gather_gmm(x, None, w, gs)
    torch.testing.assert_close(out, mg.plain_gather_gmm(x, None, w, gs),
                               **TOL["float32"])
    assert not out[13:].any()


@pytest.mark.gpu
def test_moe_gmm_refuses_what_the_kernel_does_not_take(cuda):
    def case(d=16, n=16, e=4, dt=torch.bfloat16, w_dt=None,
             gs_dt=torch.int32):
        x = torch.zeros(8, d, device=cuda, dtype=dt)
        w = torch.zeros(e, d, n, device=cuda, dtype=w_dt or dt)
        gs = torch.zeros(e, device=cuda, dtype=gs_dt)
        return x, w, gs
    for kw, exc, match in (
            (dict(d=12), ValueError, "multiples of 8"),
            (dict(n=12), ValueError, "multiples of 8"),
            (dict(dt=torch.float16), TypeError, "float32 or"),
            (dict(w_dt=torch.float32), TypeError, "rhs dtype"),
            (dict(gs_dt=torch.int64), TypeError, "int32"),
            (dict(e=mg.MAX_EXPERTS + 1), ValueError, "experts")):
        x, w, gs = case(**kw)
        with pytest.raises(exc, match=match):
            mg.gather_gmm(x, None, w, gs)
    x, w, gs = case()
    with pytest.raises(ValueError, match=r"and \[e, N, K\]"):
        mg.gather_gmm(x, None, w[:, :, :8].contiguous(), gs,
                      transpose_rhs=True)
    with pytest.raises(ValueError, match="multiples of 8"):
        mg.scatter_gmm(x, torch.zeros(4, 12, 16, device=cuda,
                                      dtype=x.dtype), gs,
                       torch.arange(8, dtype=torch.int32, device=cuda),
                       transpose_rhs=True)
    with pytest.raises(TypeError, match="int32"):
        mg.tgmm(x, x, gs.long(), 4)
    with pytest.raises(ValueError, match="num_groups"):
        mg.tgmm(x, x, gs, 5)
    with pytest.raises(ValueError, match="multiples of 8"):
        mg.tgmm(x[:, :12].contiguous(), x, gs, 4)
    with pytest.raises(TypeError, match="out_dtype"):
        mg.gather_gmm(x, None, w, gs, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="swiglu|multiples of 8"):
        mg.gather_gmm_swiglu(x, None, w[:, :, :8].contiguous(), gs)
    with pytest.raises(ValueError, match="dst_rows"):
        mg.scatter_gmm(x, w, gs, torch.zeros(3, dtype=torch.int32,
                                             device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routing,s,d,f,e,k", [
    ("random", 8, 64, 96, 8, 2), ("random", 40, 128, 64, 16, 6),
    ("random", 300, 64, 136, 4, 2), ("one", 24, 64, 96, 8, 2),
    ("sparse", 64, 64, 96, 64, 6), ("single", 16, 128, 64, 8, 2),
    (_EDGE_SIZES, sum(_EDGE_SIZES), 64, 96, 8, 1),
    (_EDGE_SIZES, sum(_EDGE_SIZES), 72, 136, 8, 1),
    ("random", 300, 72, 136, 1, 2), ("sparse", 64, 64, 96, 1024, 6),
    ("random", 1, 64, 96, 8, 1)])
def test_moe_gmm_backward_modes(cuda, dtype, routing, s, d, f, e, k):
    """The backward's modes against their plain versions: the
    transposed gather (``dh``), the transposed gmm on sorted rows (K5's
    d(lhs)), the transposed scatter (``dx``) and tgmm for both weight
    gradients, over the routings of the forward test (tgmm's empty
    groups must come out zero), and across the bf16 kernels' tile edges:
    groups of 1, 63, 64, 65, 0, 127, 129 and 257 rows (unaligned starts,
    an empty and a one-row group, every group with non-empty
    neighbours), K 72 and N 136 (no multiple of 64 or 128), one expert,
    1024 experts of which two are routed to, and a single row."""
    dt = getattr(torch, dtype)
    x, gu, dn, order, src, gs = _moe_case(routing, s, d, f, e, k, dt, cuda)
    m = s * k
    g = torch.Generator(device=cuda).manual_seed(s + e)
    dpair = torch.randn(m, d, generator=g, device=cuda).to(dt)
    dgu = torch.randn(m, 2 * f, generator=g, device=cuda).to(dt)
    h = torch.randn(m, f, generator=g, device=cuda).to(dt)
    xs = x[src.long()].contiguous()
    n0 = dict(launch_counts)
    _rows_close(mg.gather_gmm(dpair, order, dn, gs, transpose_rhs=True),
                mg.plain_gather_gmm(dpair, order, dn, gs,
                                    transpose_rhs=True), dtype)
    ds = dpair[order.long()].contiguous()
    _rows_close(mg.gather_gmm(ds, None, dn, gs, transpose_rhs=True),
                mg.plain_gather_gmm(ds, None, dn, gs, transpose_rhs=True),
                dtype)
    _rows_close(mg.scatter_gmm(dgu, gu, gs, order, transpose_rhs=True),
                mg.plain_scatter_gmm(dgu, gu, gs, order,
                                     transpose_rhs=True), dtype)
    for lhs, dy in ((h, ds), (xs, dgu)):
        got = mg.tgmm(lhs, dy, gs, e)
        _rows_close(got, mg.plain_tgmm(lhs, dy, gs, e), dtype)
        assert not got[gs == 0].any()
    for name, n in (("moe_gmm_t", 2), ("moe_scatter_gmm_t", 1),
                    ("moe_tgmm", 2)):
        assert launch_counts[name] == n0[name] + n


@pytest.mark.gpu
def test_moe_backward_modes_are_deterministic(cuda):
    """Two launches of each transposed mode and of tgmm give the same
    bits in bf16 (no atomics; each output tile sums its rows in one
    block, in order), at groups that span several row tiles."""
    dt = torch.bfloat16
    x, gu, dn, order, src, gs = _moe_case("random", 512, 256, 192, 8, 2,
                                          dt, cuda, seed=3)
    m = 1024
    g = torch.Generator(device=cuda).manual_seed(5)
    dpair = torch.randn(m, 256, generator=g, device=cuda).to(dt)
    dgu = torch.randn(m, 384, generator=g, device=cuda).to(dt)
    ds = dpair[order.long()].contiguous()
    xs = x[src.long()].contiguous()
    for fn in (lambda: mg.gather_gmm(dpair, order, dn, gs,
                                     transpose_rhs=True),
               lambda: mg.gather_gmm(ds, None, dn, gs, transpose_rhs=True),
               lambda: mg.scatter_gmm(dgu, gu, gs, order,
                                      transpose_rhs=True),
               lambda: mg.tgmm(xs, dgu, gs, 8)):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(a, b)


_FWD_MODES = ("swiglu", "scatter", "gather", "sorted")


def _forward_mode(mode, x, src, gu, dn, gs, order, h):
    """``(kernel, plain)`` calls of one forward mode: gather + swiglu
    (``x`` at ``src``), scatter (``h`` to ``order``), the plain gather
    gmm, and K5's gmm on the sorted rows ``x[src]``."""
    if mode == "swiglu":
        return (lambda: mg.gather_gmm_swiglu(x, src, gu, gs),
                lambda: mg.plain_gather_gmm_swiglu(x, src, gu, gs))
    if mode == "scatter":
        return (lambda: mg.scatter_gmm(h, dn, gs, order),
                lambda: mg.plain_scatter_gmm(h, dn, gs, order))
    if mode == "gather":
        return (lambda: mg.gather_gmm(x, src, gu, gs),
                lambda: mg.plain_gather_gmm(x, src, gu, gs))
    xs = x[src.long()].contiguous()
    return (lambda: mg.gather_gmm(xs, None, gu, gs),
            lambda: mg.plain_gather_gmm(xs, None, gu, gs))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", _FWD_MODES)
def test_moe_forward_modes_are_deterministic(cuda, mode):
    """Two launches of each bf16 forward mode on the Hopper body give the
    same bits, at groups that span several row tiles (128 rows a
    group)."""
    dt = torch.bfloat16
    x, gu, dn, order, src, gs = _moe_case("random", 512, 256, 192, 8, 2,
                                          dt, cuda, seed=7)
    h = torch.randn(1024, 192, device=cuda).to(dt)
    kern, _ = _forward_mode(mode, x, src, gu, dn, gs, order, h)
    a, b = kern(), kern()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", _FWD_MODES)
def test_moe_forward_modes_do_not_read_past_the_groups(cuda, mode):
    """The bf16 forward modes on the Hopper body with 137 rows past the
    groups' sum (more than a 128-row tile; the last group ends inside a
    tile): those rows come out zero, and NaN in the rows only they would
    read (the sorted and scatter inputs past the sum, the x rows that
    only their src_rows name) does not leak into any output."""
    dt = torch.bfloat16
    m, e, past = 1124, 8, 137
    x, gu, dn, order, src, _ = _moe_case("random", m, 128, 136, e, 1, dt,
                                         cuda, seed=9)
    used = m - past
    gs = torch.full((e,), used // e, dtype=torch.int32, device=cuda)
    gs[0] += used - int(gs.sum())
    # rows past the groups gather x rows [used, m), which hold NaN
    src = torch.cat([torch.randperm(used, device=cuda),
                     torch.arange(used, m, device=cuda)]).to(torch.int32)
    x[used:] = float("nan")
    h = torch.randn(m, 136, device=cuda).to(dt)
    h[used:] = float("nan")
    kern, plain = _forward_mode(mode, x, src, gu, dn, gs, order, h)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    past_rows = order[used:].long() if mode == "scatter" else slice(used, m)
    assert not got[past_rows].any()
    _rows_close(got, want, "bfloat16")


@pytest.mark.gpu
def test_moe_backward_modes_do_not_read_past_the_groups(cuda):
    """Rows past the groups' sum: the transposed modes write them as
    zeros, and tgmm never reads them (NaN there changes nothing)."""
    x = torch.randn(20, 16, device=cuda)
    dy = torch.randn(20, 24, device=cuda)
    w = torch.randn(3, 24, 16, device=cuda)
    gs = torch.tensor([4, 0, 9], dtype=torch.int32, device=cuda)
    out = mg.gather_gmm(x, None, w, gs, transpose_rhs=True)
    torch.testing.assert_close(
        out, mg.plain_gather_gmm(x, None, w, gs, transpose_rhs=True),
        **TOL["float32"])
    assert not out[13:].any()
    for dt in (torch.float32, torch.bfloat16):
        xn, dn = x.clone().to(dt), dy.clone().to(dt)
        xn[13:], dn[13:] = float("nan"), float("nan")
        got = mg.tgmm(xn, dn, gs, 3)
        assert torch.isfinite(got.float()).all() and not got[1].any()
        torch.testing.assert_close(
            got.float(), mg.plain_tgmm(xn[:13], dn[:13], gs, 3).float(),
            **TOL["float32" if dt == torch.float32 else "bfloat16"])


def _plain_gmm_patches():
    return [mock.patch.object(mg, n, getattr(mg, "plain_" + n))
            for n in ("gather_gmm_swiglu", "scatter_gmm", "gather_gmm",
                      "tgmm")]


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_moe_block_gradients_on_the_card(cuda, fused):
    """A DeepSeek-MoE block on the card, float32: the output and the
    gradients of x, the router and both expert stacks through the kernels
    equal those through the plain versions, and every expert that
    received pairs has a non-zero gradient (the sorted path's grouped
    matmuls carry their gradient on the card)."""
    from paddle_tpu_torch.models.deepseek_moe import (DeepseekMoeBlock,
                                                      DeepseekMoeConfig)
    cfg = DeepseekMoeConfig.tiny(hidden=64, moe_ffn=32, experts=8, topk=2)
    cfg.dropless, cfg.moe_fused_gmm = True, fused
    torch.manual_seed(0)
    block = DeepseekMoeBlock(cfg, device=cuda)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x0 = torch.randn(2, 24, 64, device=cuda)

    def run():
        block.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        y, aux = block(x)
        (y.pow(2).sum() + aux).backward()
        return [y.detach(), x.grad] + [p.grad for p in block.parameters()]

    n0 = dict(launch_counts)
    got = run()
    want = ("moe_gather_gmm_swiglu", "moe_scatter_gmm", "moe_gmm_t",
            "moe_scatter_gmm_t") if fused else ("moe_gmm", "moe_gmm_t")
    for name in want + ("moe_tgmm",):
        assert launch_counts[name] > n0[name], name
    patches = _plain_gmm_patches()
    for p in patches:
        p.start()
    try:
        ref = run()
    finally:
        for p in patches:
            p.stop()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **TOL["float32"])
    probs = torch.softmax(block.gate(x0.reshape(-1, 64)).float(), -1)
    hit = torch.zeros(8, dtype=torch.bool, device=cuda)
    hit[torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :2]
        .reshape(-1)] = True
    for grad in (block.experts.gate_up_proj.grad,
                 block.experts.down_proj.grad):
        assert bool((grad.flatten(1).abs().amax(1) > 0)[hit].all())


# ---------------------------------------------------------------- K6

# the six mask layouts of the reference's FlashMask tests:
# (B, H, Hkv, Hm, bounds, causal)
FLASHMASK_LAYOUTS = [(2, 4, 2, 2, 1, True), (2, 4, 2, 1, 2, True),
                     (1, 4, 4, 4, 2, False), (2, 8, 4, 2, 2, True),
                     (1, 8, 4, 8, 2, True), (2, 4, 2, 4, 1, True)]


def _document_bounds(rng, L, n_docs, bounds):
    """Per-column bounds of a document mask: the columns of a document
    ending at row e hide rows [e, L), so a token sees its own document."""
    cuts = np.sort(rng.choice(np.arange(16, L - 16), n_docs - 1,
                              replace=False))
    edges = np.concatenate([[0], cuts, [L]])
    start = np.zeros(L, np.int64)
    end = np.full(L, L, np.int64)
    for a, b in zip(edges[:-1], edges[1:]):
        start[a:b] = b
    return np.stack([start, end], -1)[..., :bounds]


def _flashmask_case(layout, L, D, dtype, dev, seed=0):
    B, H, Hkv, Hm, bounds, causal = layout
    q, k, v, do = _attn_case(seed + L + D, B, L, L, H, Hkv, D, dtype, dev)
    rng = np.random.RandomState(seed)
    idx = np.stack([np.stack([_document_bounds(rng, L, 4, bounds)
                              for _ in range(Hm)]) for _ in range(B)])
    start, end = fm.flashmask_bounds(torch.from_numpy(idx), L, H, Hkv,
                                     device=dev)
    return q, k, v, do, start, end, causal


def _flashmask_held(q, k, v, do, start, end, causal, dtype):
    """K6f, K6dq and K6dkv against their plain versions (the backward
    passes on the plain forward's lse and delta), and K6f's tile summary
    against the plain one."""
    scale = q.shape[-1] ** -0.5
    o, lse, tiles = fm.flashmask_fwd(q, k, v, start, end, scale, causal)
    o_p, lse_p = fm.plain_flashmask_fwd(q, k, v, start, end, scale, causal)
    _rows_close(o, o_p, dtype)
    torch.testing.assert_close(lse, lse_p, **TOL[dtype])
    assert torch.equal(tiles, fm.plain_flashmask_tiles(start, end))
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse_p, delta, start, end, scale, causal)
    dq = fm.flashmask_dq(*args, tiles=tiles)
    _rows_close(dq, fm.plain_flashmask_dq(*args), dtype)
    for a, b in zip(fm.flashmask_dkv(*args, tiles=tiles),
                    fm.plain_flashmask_dkv(*args)):
        _rows_close(a, b, dtype)
    return o, lse, dq


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("L", [256, 1000])
@pytest.mark.parametrize("layout", FLASHMASK_LAYOUTS,
                         ids=lambda t: "-".join(map(str, t)))
def test_flashmask_kernels(cuda, dtype, head_dim, L, layout):
    """K6f, K6dq and K6dkv each against its plain version at the
    reference's six mask layouts (distinct document bounds per batch row
    and mask head; Hm above, at and below Hkv); L 1000 has a tail tile
    and document edges off the 64-row tiles. Each launches once."""
    case = _flashmask_case(layout, L, head_dim, getattr(torch, dtype), cuda)
    n0 = dict(launch_counts)
    _flashmask_held(*case, dtype)
    for name in ("flashmask_fwd", "flashmask_dq", "flashmask_dkv"):
        assert launch_counts[name] == n0[name] + 1
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert launch_counts[name] == n0[name]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flashmask_fully_masked_rows(cuda, dtype):
    """Rows [128, 256) hidden on every column: o and dq exactly 0 there,
    lse NEG_INF, and the other rows as the plain version's."""
    q, k, v, do = _attn_case(1, 1, 256, 256, 2, 2, 64,
                             getattr(torch, dtype), cuda)
    start = torch.full((1, 256), 128, dtype=torch.int32, device=cuda)
    end = torch.full_like(start, 256)
    o, lse, dq = _flashmask_held(q, k, v, do, start, end, False, dtype)
    assert bool((o[:, 128:] == 0).all()) and bool((o[:, :128] != 0).any())
    assert bool((lse[..., 128:] == fa.NEG_INF).all())
    assert bool((dq[:, 128:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flashmask_documents_split_kv_tiles(cuda, dtype, head_dim, causal):
    """Document edges at 64 mod 128 and off every tile (100, 192, 500,
    640): 128-column kv tiles hold two documents, one live half or a
    partly masked column range, and the kernels still give the plain
    versions' results."""
    L, H, Hkv = 700, 4, 2
    q, k, v, do = _attn_case(9 + head_dim, 1, L, L, H, Hkv, head_dim,
                             getattr(torch, dtype), cuda)
    edges = np.array([0, 100, 192, 500, 640, L])
    start = np.zeros(L, np.int64)
    for a, b in zip(edges[:-1], edges[1:]):
        start[a:b] = b
    idx = torch.from_numpy(start.astype(np.int32))[None, None, :, None]
    start, end = fm.flashmask_bounds(idx, L, H, Hkv, device=cuda)
    n0 = dict(launch_counts)
    _flashmask_held(q, k, v, do, start, end, causal, dtype)
    assert launch_counts["flashmask_fwd"] == n0["flashmask_fwd"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_flashmask_kv_tile_halves_with_different_dead_ranges(
        cuda, dtype, head_dim):
    """Documents of 192 rows: a 128-column kv tile holds the last 64
    columns of one document and the first 64 of the next, so its two
    64-column halves hide different ranges of q tiles and the dk/dv
    block may skip only their intersection. dq, dk and dv equal the
    plain versions'."""
    L, H, Hkv = 960, 4, 2
    q, k, v, do = _attn_case(21 + head_dim, 1, L, L, H, Hkv, head_dim,
                             getattr(torch, dtype), cuda)
    start = np.repeat(np.arange(192, L + 1, 192), 192).astype(np.int32)
    idx = torch.from_numpy(start)[None, None, :, None]
    start, end = fm.flashmask_bounds(idx, L, H, Hkv, device=cuda)
    n0 = dict(launch_counts)
    _flashmask_held(q, k, v, do, start, end, True, dtype)
    assert launch_counts["flashmask_dkv"] == n0["flashmask_dkv"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flashmask_backward_is_deterministic(cuda, dtype):
    """K6dq and K6dkv twice on the same inputs under a document mask:
    the same gradients to the bit."""
    case = _flashmask_case(FLASHMASK_LAYOUTS[3], 1000, 128,
                           getattr(torch, dtype), cuda)
    q, k, v, do, start, end, causal = case
    o, lse, tiles = fm.flashmask_fwd(q, k, v, start, end, 0.1, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, start, end, 0.1, causal)
    assert torch.equal(fm.flashmask_dq(*args, tiles=tiles),
                       fm.flashmask_dq(*args, tiles=tiles))
    first = fm.flashmask_dkv(*args, tiles=tiles)
    again = fm.flashmask_dkv(*args, tiles=tiles)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flashmask_without_masked_columns_is_k1(cuda, dtype, causal):
    """start = Lq on every column hides nothing: K6 gives K1's forward,
    lse and gradients on the same inputs."""
    q, k, v, do = _attn_case(2, 2, 200, 200, 8, 2, 128,
                             getattr(torch, dtype), cuda)
    idx = torch.full((2, 1, 200, 1), 200, dtype=torch.int32)
    start, end = fm.flashmask_bounds(idx, 200, 8, 2, device=cuda)
    scale = 128 ** -0.5
    o6, lse6, tiles = fm.flashmask_fwd(q, k, v, start, end, scale, causal)
    o1, lse1 = fa.flash_attention_fwd(q, k, v, scale, causal)
    _rows_close(o6, o1, dtype)
    torch.testing.assert_close(lse6, lse1, **TOL[dtype])
    delta = (do.float() * o1.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse1, delta)
    _rows_close(fm.flashmask_dq(*args, start, end, scale, causal,
                                tiles=tiles),
                fa.flash_attention_dq(*args, scale, causal), dtype)
    for a, b in zip(fm.flashmask_dkv(*args, start, end, scale, causal,
                                     tiles=tiles),
                    fa.flash_attention_dkv(*args, scale, causal)):
        _rows_close(a, b, dtype)


@pytest.mark.gpu
def test_flashmask_attention_gradients_on_the_card(cuda):
    """``nn.functional.flashmask_attention`` on the card, float32: the
    output and the q, k and v gradients (through K6's autograd Function)
    equal the same call on CPU copies (the plain versions), and each
    leaf's gradient arrives, finite and nonzero."""
    from paddle_tpu_torch.nn import functional as F
    q, k, v, do = _attn_case(3, 2, 300, 300, 8, 2, 64, torch.float32, cuda)
    rng = np.random.RandomState(3)
    idx = torch.from_numpy(np.stack([
        np.stack([_document_bounds(rng, 300, 3, 2) for _ in range(4)])
        for _ in range(2)]).astype(np.int32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        n0 = dict(launch_counts)
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o = F.flashmask_attention(*leaves, startend_row_indices=idx,
                                  causal=True)
        o.backward(do.to(dev))
        outs.append([o.detach().cpu()] + [t.grad.cpu() for t in leaves])
        launched = {n: launch_counts[n] - n0[n] for n in launch_counts}
        want = 1 if dev.type == "cuda" else 0
        assert [launched[n] for n in ("flashmask_fwd", "flashmask_dq",
                                      "flashmask_dkv")] == [want] * 3
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **TOL["float32"])
    for grad in outs[0][1:]:
        assert bool(torch.isfinite(grad).all()) and bool(grad.abs().max() > 0)


@pytest.mark.gpu
def test_flashmask_refuses_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 64, 4, 96, device=cuda)
    start = torch.zeros(1, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fm.flashmask_fwd(q, q, q, start, start, 0.1, True)
    q = torch.zeros(1, 64, 4, 64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        fm.flashmask_fwd(q, q, q, start.long(), start.long(), 0.1, True)
    with pytest.raises(ValueError, match="do not divide"):
        three = torch.zeros(3, 64, dtype=torch.int32, device=cuda)
        fm.flashmask_fwd(q, q, q, three, three, 0.1, True)
    with pytest.raises(ValueError, match="Lk"):
        fm.flashmask_fwd(q, q, q, start[:, :32].contiguous(),
                         start[:, :32].contiguous(), 0.1, True)
    with pytest.raises(ValueError, match="is on cpu"):
        fm.flashmask_fwd(q, q, q, start.cpu(), start.cpu(), 0.1, True)
    lse = torch.zeros(1, 4, 64, device=cuda)
    bwd = (q, q, q, q, lse, lse, start, start, 0.1, True)
    with pytest.raises(ValueError, match="tiles"):
        fm.flashmask_dq(*bwd, tiles=torch.zeros(1, 2, 2, dtype=torch.int32,
                                                device=cuda))
    with pytest.raises(ValueError, match="tiles"):
        fm.flashmask_dkv(*bwd, tiles=torch.zeros(1, 1, 2, device=cuda))
    with pytest.raises(ValueError, match="bounds 1 or 2"):
        fm.flashmask_bounds(torch.zeros(1, 1, 64, 3, dtype=torch.int32),
                            64, 4, 4)
    with pytest.raises(ValueError, match="must divide"):
        fm.flashmask_bounds(torch.zeros(1, 3, 64, 1, dtype=torch.int32),
                            64, 4, 4)


# K2v's token-tree mode: BRANCHY's spine 1-3-5-7 and branch 2-4-6 (T 8);
# TREE32 a seeded tree of 31 drafts (T 32, the 32 ancestor bits)
BRANCHY = (0, 0, 1, 2, 3, 4, 5)
TREE32 = tuple(int(np.random.RandomState(32).randint(0, k + 1))
               for k in range(31))


def _tree_case(seed, tree, rep, block_size, mb, dtype, pool, dev):
    T = len(tree) + 1
    lens = [1, block_size, block_size + 1, mb * block_size - T + 1]
    q, kp, vp, tables, ctx = _paged_case(seed, lens, T, rep, 128,
                                         block_size, mb,
                                         getattr(torch, dtype), dev)
    if pool == "int8":
        kp, vp = _int8(kp.float()), _int8(vp.float())
    return q, kp, vp, tables, ctx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("rep", [1, 4, 7])
@pytest.mark.parametrize("block_size,mb", [(8, 8), (16, 8), (32, 8),
                                           (16, 64)])
def test_paged_verify_tree_attention(cuda, dtype, pool, rep, block_size, mb):
    """K2v's tree mode against the plain version's tree mask: float32 (the
    FMA body), bfloat16 (the Hopper body) and int8 pools (both bodies' int8
    modes), GQA groups 1, 4 and 7, block sizes 8, 16 and 32, contexts of 1,
    BS, BS + 1 and one whose window ends at the table's reach; the long
    table splits the context. A tree launch counts as
    paged_verify_attention_tree(_int8), never as the linear K2v."""
    q, kp, vp, tables, ctx = _tree_case(700 + rep + block_size + mb, BRANCHY,
                                        rep, block_size, mb, dtype, pool,
                                        cuda)
    sfx = "_int8" if pool == "int8" else ""
    n0 = dict(launch_counts)
    got = pda.paged_verify_attention(q, kp, vp, tables, ctx,
                                     tree_anc=BRANCHY)
    assert launch_counts["paged_verify_attention_tree" + sfx] == \
        n0["paged_verify_attention_tree" + sfx] + 1
    assert launch_counts["paged_verify_attention" + sfx] == \
        n0["paged_verify_attention" + sfx]
    want = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx,
                                            tree_anc=BRANCHY)
    _rows_close(got, want, dtype)
    lin = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx)
    assert not torch.allclose(got.float(), lin.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("rep,T", [(1, 4), (4, 5), (7, 8), (4, 16)])
def test_chain_tree_equals_linear_verify_bitwise(cuda, dtype, pool, rep, T):
    """A chain tree's mask is the linear bound: the tree mode's output
    equals linear K2v's bit for bit, in both bodies and on int8 pools,
    over a split context too."""
    chain = tuple(range(T - 1))
    q, kp, vp, tables, ctx = _tree_case(800 + rep + T, chain, rep, 16, 64,
                                        dtype, pool, cuda)
    lin = pda.paged_verify_attention(q, kp, vp, tables, ctx, tree_anc=None)
    tree = pda.paged_verify_attention(q, kp, vp, tables, ctx,
                                      tree_anc=chain)
    assert torch.equal(lin, tree)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rep", [("bfloat16", 1), ("bfloat16", 4),
                                       ("bfloat16", 7), ("float32", 1),
                                       ("float32", 2)])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_paged_verify_tree_of_31_drafts(cuda, dtype, rep, pool):
    """The largest tree (31 drafts, T 32: every ancestor bit): both
    bodies take it at any group, in several tiles of 64 query vectors."""
    q, kp, vp, tables, ctx = _tree_case(900 + rep, TREE32, rep, 16, 8,
                                        dtype, pool, cuda)
    got = pda.paged_verify_attention(q, kp, vp, tables, ctx,
                                     tree_anc=TREE32)
    want = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx,
                                            tree_anc=TREE32)
    _rows_close(got, want, dtype)


@pytest.mark.gpu
def test_paged_verify_tree_refusals(cuda):
    """What the derived limits refuse: a tree past 31 drafts (the 32
    ancestor bits) in either body, and a linear window past MAX_WINDOW
    rows; a 31-draft tree at group 4 in the float32 body (two tiles) and
    a linear window of 33 rows run and match the plain versions."""
    q, kp, vp, tables, ctx = _tree_case(5, TREE32, 4, 16, 8, "float32", "fp",
                                        cuda)
    _rows_close(pda.paged_verify_attention(q, kp, vp, tables, ctx,
                                           tree_anc=TREE32),
                pda.plain_paged_verify_attention(q, kp, vp, tables, ctx,
                                                 tree_anc=TREE32), "float32")
    q33 = torch.cat([q, q[:, :1]], 1)
    for dt in (torch.float32, torch.bfloat16):
        args = (q33.to(dt), kp.to(dt), vp.to(dt), tables, ctx)
        with pytest.raises(ValueError, match="31 draft nodes"):
            pda.paged_verify_attention(*args, tree_anc=TREE32 + (0,))
        _rows_close(pda.paged_verify_attention(*args, tree_anc=None),
                    pda.plain_paged_verify_attention(*args),
                    "float32" if dt == torch.float32 else "bfloat16")
    big = torch.zeros(1, pda.MAX_WINDOW + 1, 8, 128, device=cuda,
                      dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"window of {pda.MAX_WINDOW + 1}"):
        pda.paged_verify_attention(big, kp.bfloat16(), vp.bfloat16(),
                                   tables[:1], ctx[:1])


# K2v's chunk window: the per-width engine's chunk step, T = prefill_chunk
# rows of one slot (and two slots, as a window of more than one tile is
# never split)
CHUNK_MODES = {   # q dtype, pool kind, heads, kv heads, head dim
    "bf16": ("bfloat16", "fp", 32, 8, 128),
    "int8": ("bfloat16", "int8", 32, 8, 128),
    "f32": ("float32", "fp", 32, 8, 128),
    "f32_int8": ("float32", "int8", 32, 8, 128),
    "gpt_f32pool": ("bfloat16", "f32pool", 16, 16, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(CHUNK_MODES))
@pytest.mark.parametrize("T", [1, 8, 33, 64, 128, 256, 512,
                               pda.MAX_WINDOW])
def test_paged_verify_chunk_window(cuda, mode, T):
    """K2v's linear window at T up to MAX_WINDOW rows against the plain
    version: contexts starting mid block, on a block boundary and deep in
    the table, over bfloat16, int8 and float32 pools, a float32 q (the
    FMA body's tiles of 64 / group rows, its context splits merged a tile
    at a time) and GPT's bfloat16 q over float32 pools at D 64; counted
    as the linear K2v of its pool, and the same bits on a second call.
    The tables reach at least 1024 positions and past the deepest
    window's end."""
    dtype, pool, h, hkv, d = CHUNK_MODES[mode]
    lens = [5, 16, 700]
    q, kp, vp, tables, ctx = _paged_case(
        1000 + T + len(mode), lens, T, h // hkv, d, 16,
        max(64, -(-(lens[-1] + T) // 16)), torch.float32, cuda, Hkv=hkv)
    q = q.to(getattr(torch, dtype))
    if pool == "int8":
        kp, vp = _int8(kp), _int8(vp)
    elif pool == "fp":
        kp, vp = kp.to(q.dtype), vp.to(q.dtype)
    name = "paged_verify_attention" + {"int8": "_int8", "fp": "",
                                       "f32pool": "_f32pool"}[pool]
    n0 = dict(launch_counts)
    got = pda.paged_verify_attention(q, kp, vp, tables, ctx)
    assert launch_counts[name] == n0[name] + 1
    want = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx)
    _rows_close(got, want, dtype)
    assert torch.equal(got, pda.paged_verify_attention(q, kp, vp, tables,
                                                       ctx))
    if pool == "f32pool":
        _within_one_ulp(got, pda.paged_verify_attention(
            q.float(), kp, vp, tables, ctx), f"chunk window T {T}")


# K2r's per-slot tree mode: tree windows beside an unflagged 128-row chunk
# and an unflagged trickle slot in one launch


def _ragged_tree_case(seed, tree, rep, block_size, dtype, pool, dev):
    """Slots: tree windows at contexts 1, BS + 1 and one ending at the
    table's reach (a split context), a 128-row chunk at context 600, an
    8-row trickle slot and a slot of no rows; the windows are flagged."""
    T = len(tree) + 1
    mb = 1024 // block_size
    base = [0, block_size, 1024 - T, 599, 40, 7]
    q_lens = [T, T, T, 128, 8, 0]
    flags = [1, 1, 1, 0, 0, 1]
    rng = np.random.RandomState(seed)
    args, starts = _ragged_case(rng, base, q_lens, 2 * rep, 2, 128,
                                block_size, mb, getattr(torch, dtype), dev)
    if pool == "int8":
        args = args[:1] + (_int8(args[1].float()), _int8(args[2].float())) \
            + args[3:]
    return args, starts, q_lens, torch.tensor(flags, dtype=torch.int32,
                                              device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("rep", [1, 4, 7])
@pytest.mark.parametrize("block_size", [8, 16, 32])
def test_ragged_tree_attention(cuda, dtype, pool, rep, block_size):
    """K2r's tree mode against the plain version's per-slot tree mask:
    float32 (the FMA body), bfloat16 (the Hopper body) and int8 pools
    (both bodies' int8 modes), GQA groups 1, 4 and 7, block sizes 8, 16
    and 32, with a split context and a 128-row chunk in the launch. A
    tree launch counts as ragged_paged_attention_tree(_int8), never as
    linear K2r; the unflagged slots' rows are linear K2r's."""
    args, starts, q_lens, flags = _ragged_tree_case(
        1000 + rep + block_size, BRANCHY, rep, block_size, dtype, pool, cuda)
    sfx = "_int8" if pool == "int8" else ""
    n0 = dict(launch_counts)
    got = rpa.ragged_paged_attention(*args, max(q_lens), tree_anc=BRANCHY,
                                     tree_slots=flags, tree_rows=8)
    assert launch_counts["ragged_paged_attention_tree" + sfx] == \
        n0["ragged_paged_attention_tree" + sfx] + 1
    assert launch_counts["ragged_paged_attention" + sfx] == \
        n0["ragged_paged_attention" + sfx]
    want = rpa.plain_ragged_paged_attention(*args, tree_anc=BRANCHY,
                                            tree_slots=flags)
    _rows_close(_live(got, q_lens, starts), _live(want, q_lens, starts),
                dtype)
    lin = rpa.ragged_paged_attention(*args, max(q_lens))
    for s in (3, 4):            # the chunk and the trickle slot: linear
        s0, n = int(starts[s]), q_lens[s]
        assert torch.equal(got[s0:s0 + n], lin[s0:s0 + n])
    s0 = int(starts[0])
    assert not torch.allclose(got[s0:s0 + 8].float(),
                              lin[s0:s0 + 8].float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("rep", [1, 4, 7])
def test_chain_tree_equals_linear_ragged_bitwise(cuda, dtype, pool, rep):
    """A chain tree's mask is the linear bound: K2r's tree mode equals
    linear K2r bit for bit, in both bodies and on int8 pools, with a
    split context and a chunk in the launch."""
    chain = (0, 1, 2, 3, 4, 5, 6)
    args, starts, q_lens, flags = _ragged_tree_case(
        1100 + rep, chain, rep, 16, dtype, pool, cuda)
    lin = rpa.ragged_paged_attention(*args, max(q_lens))
    tree = rpa.ragged_paged_attention(*args, max(q_lens), tree_anc=chain,
                                      tree_slots=flags, tree_rows=8)
    assert torch.equal(_live(lin, q_lens, starts),
                       _live(tree, q_lens, starts))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("rep", [1, 4, 7])
def test_ragged_tree_of_31_drafts(cuda, dtype, pool, rep):
    """The largest tree (31 drafts, T 32: every ancestor bit) in K2r,
    beside the chunk: both bodies take it at any group, in tiles."""
    args, starts, q_lens, flags = _ragged_tree_case(
        1200 + rep, TREE32, rep, 16, dtype, pool, cuda)
    got = rpa.ragged_paged_attention(*args, max(q_lens), tree_anc=TREE32,
                                     tree_slots=flags, tree_rows=32)
    want = rpa.plain_ragged_paged_attention(*args, tree_anc=TREE32,
                                            tree_slots=flags)
    _rows_close(_live(got, q_lens, starts), _live(want, q_lens, starts),
                dtype)


@pytest.mark.gpu
def test_ragged_tree_refusals(cuda):
    """A bound of the flagged slots' rows past the tree's nodes (the
    default, w_max, with the chunk flagged or every slot flagged; an
    explicit tree_rows), a tree past 31 drafts, and flags that are not an
    int32 [S] on q's device."""
    args, starts, q_lens, flags = _ragged_tree_case(
        7, BRANCHY, 4, 16, "bfloat16", "fp", cuda)
    w = max(q_lens)
    on_chunk = flags.clone()
    on_chunk[3] = 1
    with pytest.raises(ValueError, match="tree slot has 128 rows"):
        rpa.ragged_paged_attention(*args, w, tree_anc=BRANCHY,
                                   tree_slots=on_chunk)
    with pytest.raises(ValueError, match="tree slot has 128 rows"):
        rpa.ragged_paged_attention(*args, w, tree_anc=BRANCHY)
    with pytest.raises(ValueError, match="tree slot has 9 rows"):
        rpa.ragged_paged_attention(*args, w, tree_anc=BRANCHY,
                                   tree_slots=flags, tree_rows=9)
    with pytest.raises(ValueError, match="31 draft nodes"):
        rpa.ragged_paged_attention(*args, w, tree_anc=TREE32 + (0,),
                                   tree_slots=flags)
    for bad in (flags.long(), flags.cpu(), flags[:5]):
        with pytest.raises(ValueError, match="tree_slots"):
            rpa.ragged_paged_attention(*args, w, tree_anc=BRANCHY,
                                       tree_slots=bad, tree_rows=8)


def _plain_serving_patches():
    """Route the serving path's kernels (K2r, K2d, K2v, K3a, K3b) to their
    plain versions, with the engine's and generate()'s CUDA graphs off
    (the plain versions read values back, which a capture cannot)."""
    from paddle_tpu_torch.generation import GenerationMixin
    from paddle_tpu_torch.inference import ServingEngine
    def plain_attn(q, k_pool, v_pool, tables, ctx, q_lens, starts, w_max,
                   sm_scale=None, tree_anc=None, tree_slots=None,
                   tree_rows=None):
        return rpa.plain_ragged_paged_attention(
            q, k_pool, v_pool, tables, ctx, q_lens, starts,
            sm_scale=sm_scale, tree_anc=tree_anc, tree_slots=tree_slots,
            tree_rows=tree_rows)
    return [mock.patch.object(ServingEngine, "cuda_graphs", False),
            mock.patch.object(GenerationMixin, "cuda_graphs", False),
            mock.patch.object(rpa, "ragged_paged_attention", plain_attn),
            mock.patch.object(df, "norm_matmul", df.plain_norm_matmul),
            mock.patch.object(df, "matmul_residual",
                              df.plain_matmul_residual)] + [
        mock.patch.object(pda, n, getattr(pda, "plain_" + n))
        for n in ("paged_decode_attention", "paged_verify_attention")]


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["tree", "self_draft"])
def test_speculative_engine_on_the_card(cuda, spec):
    """A float32 tiny Llama served speculatively on the card (a branching
    tree through K2r's tree mode; the model drafting for itself through
    K2d, so windows are accepted) gives the token streams of the same
    engine run through the plain versions."""
    from paddle_tpu_torch.inference import ServingConfig, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(vocab=512, hidden=256,
                                              heads=4, kv_heads=2),
                             device=cuda, seed=3)
    rng = np.random.RandomState(4)
    motif = rng.randint(1, 512, 8).tolist()
    prompts = [motif * 4 + rng.randint(1, 512, n).tolist()
               for n in (3, 40, 150, 9)]
    kw = dict(num_speculative_tokens=7, spec_tree=BRANCHY) \
        if spec == "tree" else dict(num_speculative_tokens=4,
                                    drafter="model")

    def serve():
        eng = ServingEngine(model, ServingConfig(
            num_slots=3, block_size=16, max_model_len=512,
            prefill_chunk=128, **kw), device=cuda,
            draft_model=model if spec == "self_draft" else None)
        out = eng.serve(prompts, max_new_tokens=24)
        st = eng.stats()
        eng.shutdown()
        return out, st

    n0 = dict(launch_counts)
    got, st = serve()
    want_counter = "ragged_paged_attention_tree" if spec == "tree" \
        else "paged_decode_attention"
    assert launch_counts[want_counter] > n0[want_counter]
    for p in _plain_serving_patches():
        p.start()
    try:
        want, st_p = serve()
    finally:
        mock.patch.stopall()
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert st["spec_tokens_accepted"] == st_p["spec_tokens_accepted"]
    if spec == "self_draft":
        assert st["spec_mean_accepted_len"] > 1.0


# K2 with a bfloat16 query over float32 pools (GPT's pools stay float32
# under a bfloat16 model): the Hopper body with K, V and P as bfloat16 hi +
# lo halves; launches counted as *_f32pool. Besides the plain version at
# bfloat16's tolerance, each output is held against the float32 kernel on
# the widened query, rounded: within one bfloat16 ulp, and under
# F32POOL_DIFFER of them differing at all (the split recipe is ~2^-16
# relative, so a rounding of the two lands apart in well under 1 % of
# outputs; rounding K, V or P once, ~2^-9, moves most of them). An output
# under 2^-8 of its row's largest is a cancellation: its ulp is taken at
# that floor (the exact hi / lo recipe, emulated in float64 by
# tools/f32pool_recipe.py, puts ~0.04 % of outputs, all under 2^-10 of
# their row's largest, past one ulp of their own magnitude, and none past
# it with the floor)
F32POOL_DIFFER = 0.02


def _f32pool(q, kp, vp):
    """A case's query in bfloat16 over its pools in float32."""
    return q.to(torch.bfloat16), kp.float(), vp.float()


def _within_one_ulp(got, wide, what):
    """``got`` (bfloat16) within one bfloat16 ulp of ``wide`` (the float32
    kernel's output on the widened query) rounded, each element at the
    larger of the two magnitudes and of 2^-8 of its row's largest, with
    under F32POOL_DIFFER of the elements differing; the share that
    differs is printed."""
    g, r = got.float(), wide.to(torch.bfloat16).float()
    # the ulp of the larger of the two, and at least of 2^-8 of the row's
    # largest (a cancellation: rounding is not relative to it)
    floor = r.abs().amax(-1, keepdim=True) * 2.0 ** -8
    _, e = torch.frexp(torch.maximum(torch.maximum(g.abs(), r.abs()), floor))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)     # 8 significant bits
    over = int(((g - r).abs() > ulp).sum())
    share = float((g != r).float().mean())
    print(f"{what}: {share:.4%} of {g.numel()} outputs differ from the "
          f"float32 kernel's, rounded; {over} by more than one ulp")
    assert over == 0, f"{what}: {over} outputs off by more than one ulp"
    assert share < F32POOL_DIFFER, f"{what}: {share:.4%} differ"


def _f32pool_ragged(args, q_lens, starts, tree=None, flags=None, rows=8):
    """K2r in the f32-pool mode on ``args`` (bfloat16 q over float32
    pools): launched once and counted as such, held against the plain
    version, within one ulp of the float32 kernel on the widened q, and
    equal to the bit on a second call."""
    name = "ragged_paged_attention" + ("_tree" if tree else "")
    kw = dict(tree_anc=tree, tree_slots=flags, tree_rows=rows) if tree \
        else {}
    n0 = dict(launch_counts)
    got = rpa.ragged_paged_attention(*args, max(q_lens), **kw)
    assert got.dtype == torch.bfloat16
    assert launch_counts[name + "_f32pool"] == n0[name + "_f32pool"] + 1
    assert all(launch_counts[k] == n0[k] for k in n0
               if k != name + "_f32pool")
    want = rpa.plain_ragged_paged_attention(
        *args, tree_anc=tree, tree_slots=flags if tree else None)
    live = lambda o: _live(o, q_lens, starts)  # noqa: E731
    _rows_close(live(got), live(want), "bfloat16")
    wide = rpa.ragged_paged_attention(args[0].float(), *args[1:],
                                      max(q_lens), **kw)
    _within_one_ulp(live(got), live(wide), name)
    again = rpa.ragged_paged_attention(*args, max(q_lens), **kw)
    assert torch.equal(live(got), live(again))


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("tree", [None, BRANCHY])
def test_ragged_attention_bf16_query_over_f32_pools(cuda, head_dim, rep,
                                                    tree):
    """K2r's f32-pool mode, linear and with the per-slot tree mask: three
    flagged T-8 windows (one past a 1000-position context, split), a
    128-row chunk and a trickle window unflagged, a slot of no rows; held
    against the plain version at bfloat16's tolerance, within one ulp of
    the float32 kernel on the widened q, rounded, and bit for bit across
    two calls; counted as ragged_paged_attention(_tree)_f32pool only."""
    rng = np.random.RandomState(1300 + head_dim + rep)
    base = [5, 300, 1000, 600, 16, 40]
    q_lens = [8, 8, 8, 128, 8, 0]
    flags = torch.tensor([1, 1, 1, 0, 0, 1], dtype=torch.int32,
                         device=cuda)
    args, starts = _ragged_case(rng, base, q_lens, 2 * rep, 2, head_dim, 16,
                                72, torch.float32, cuda)
    _f32pool_ragged(_f32pool(*args[:3]) + args[3:], q_lens, starts, tree,
                    flags)


@pytest.mark.gpu
@pytest.mark.parametrize("block_size", [8, 16, 32])
@pytest.mark.parametrize("tick", ["prefill", "decode"])
def test_ragged_attention_f32_pools_at_gpt_tick(cuda, block_size, tick):
    """GPT's serving tick (16 / 16 heads, D 64, contexts to 960 within its
    1024 positions): 7 decode rows + a 128-row prefill chunk, and one row
    a slot, at block sizes 8, 16 and 32."""
    rng = np.random.RandomState(1500 + block_size)
    base = [959, 700, 500, 300, 64, 900, 800, 512]
    q_lens = [1] * 7 + [128] if tick == "prefill" else [1] * 8
    args, starts = _ragged_case(rng, base, q_lens, 16, 16, 64, block_size,
                                1024 // block_size, torch.float32, cuda)
    _f32pool_ragged(_f32pool(*args[:3]) + args[3:], q_lens, starts)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
def test_ragged_attention_f32_pools_split_contexts(cuda, head_dim):
    """Two decode rows at 4000-position contexts and a 3-row window at
    3000: few items, so every slot is split over many blocks and merged
    by the last split in the same launch; the scratch's counters are
    left at zero."""
    rng = np.random.RandomState(1600 + head_dim)
    base, q_lens = [3999, 4000, 2999], [1, 1, 3]
    args, starts = _ragged_case(rng, base, q_lens, 16, 16, head_dim, 16,
                                256, torch.float32, cuda)
    _f32pool_ragged(_f32pool(*args[:3]) + args[3:], q_lens, starts)
    stream = torch.cuda.current_stream().cuda_stream
    _, counters = rpa._SCRATCH[(args[0].device, stream)]
    assert int(counters.abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("rep,T,tree", [(1, 1, None), (4, 1, None),
                                        (1, 5, None), (4, 5, None),
                                        (1, 8, BRANCHY), (4, 8, BRANCHY),
                                        (8, 9, None)])
def test_paged_attention_bf16_query_over_f32_pools(cuda, head_dim, rep, T,
                                                   tree):
    """K2d (T 1) and K2v (linear, the tree mode at T 8, and T 9 at group
    8: two tiles a window) in the f32-pool mode: contexts of 1, BS, BS +
    1 and one whose window ends at the table's reach, a long table that
    splits the context; held against the plain versions, within one ulp
    of the float32 kernels on the widened q, rounded, and bit for bit
    across two calls; counted as *_f32pool."""
    mb, bs = 64, 16
    lens = [1, bs, bs + 1, mb * bs - T + 1]
    q, kp, vp, tables, ctx = _paged_case(1400 + head_dim + rep + T, lens, T,
                                         rep, head_dim, bs, mb,
                                         torch.float32, cuda)
    q, kp, vp = _f32pool(q, kp, vp)
    if T == 1:
        def kern(x):
            return pda.paged_decode_attention(x[:, 0], kp, vp, tables, ctx)
        want = pda.plain_paged_decode_attention(q[:, 0], kp, vp, tables,
                                                ctx)
        name = "paged_decode_attention"
    else:
        def kern(x):
            return pda.paged_verify_attention(x, kp, vp, tables, ctx,
                                              tree_anc=tree)
        want = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx,
                                                tree_anc=tree)
        name = "paged_verify_attention" + ("_tree" if tree else "")
    n0 = dict(launch_counts)
    got = kern(q)
    assert got.dtype == torch.bfloat16
    assert launch_counts[name + "_f32pool"] == n0[name + "_f32pool"] + 1
    assert all(launch_counts[k] == n0[k] for k in n0
               if k != name + "_f32pool")
    _rows_close(got, want, "bfloat16")
    if T * rep <= 64:   # the float32 body's bound
        _within_one_ulp(got, kern(q.float()), name)
    assert torch.equal(got, kern(q))


@pytest.mark.gpu
@pytest.mark.parametrize("block_size", [8, 16, 32])
@pytest.mark.parametrize("T,tree", [(1, None), (5, None),
                                    (8, (0, 0, 1, 2, 3, 4, 5))])
def test_paged_attention_f32_pools_at_gpt_generate(cuda, block_size, T,
                                                   tree):
    """GPT's generate() shapes (16 / 16 heads, D 64): 4 slots of a
    512-token prompt and 64 new tokens (contexts 513..576, tables of 37
    blocks of 16, as many positions at BS 8 and 32), K2d, K2v at T 5 and
    the tree mode at T 8."""
    mb = 37 * 16 // block_size
    lens = [513, 528, 549, 576]
    q, kp, vp, tables, ctx = _paged_case(1700 + block_size + T, lens, T, 1,
                                         64, block_size, mb, torch.float32,
                                         cuda, Hkv=16)
    q, kp, vp = _f32pool(q, kp, vp)
    if T == 1:
        got = pda.paged_decode_attention(q[:, 0], kp, vp, tables, ctx)
        want = pda.plain_paged_decode_attention(q[:, 0], kp, vp, tables,
                                                ctx)
        wide = pda.paged_decode_attention(q[:, 0].float(), kp, vp, tables,
                                          ctx)
        again = pda.paged_decode_attention(q[:, 0], kp, vp, tables, ctx)
    else:
        got, wide, again = (pda.paged_verify_attention(
            x, kp, vp, tables, ctx, tree_anc=tree)
            for x in (q, q.float(), q))
        want = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx,
                                                tree_anc=tree)
    _rows_close(got, want, "bfloat16")
    _within_one_ulp(got, wide, f"T {T} BS {block_size}")
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_bf16_query_over_f32_pools_refusals(cuda):
    """Every other dtype mismatch still raises, and so do more slots than
    the Hopper body's shared tables hold; a window of T 9 at group 8 (past
    the float32 body's T x group bound) runs, in two tiles, and matches
    the plain version."""
    q, kp, vp, tables, ctx = _paged_case(5, [3, 20], 2, 4, 64, 16, 4,
                                         torch.float32, cuda)
    bq = q.to(torch.bfloat16)
    for args in ((q, kp.to(torch.bfloat16), vp.to(torch.bfloat16)),
                 (bq, kp.half(), vp.half()), (bq, kp, vp.to(torch.bfloat16)),
                 (q.half(), kp, vp)):
        with pytest.raises(TypeError):
            pda.paged_verify_attention(*args, tables, ctx)
    q9, kp9, vp9, t9, c9 = _paged_case(6, [3, 20], 9, 8, 64, 16, 4,
                                       torch.float32, cuda)
    q9, kp9, vp9 = _f32pool(q9, kp9, vp9)
    _rows_close(pda.paged_verify_attention(q9, kp9, vp9, t9, c9),
                pda.plain_paged_verify_attention(q9, kp9, vp9, t9, c9),
                "bfloat16")
    n = rpa.SM90_MAX_SLOTS + 1
    many = torch.ones(n, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=f"{n} slots"):
        pda.paged_decode_attention(
            torch.zeros(n, 8, 64, device=cuda, dtype=torch.bfloat16), kp,
            vp, many[:, None].contiguous(), many)
    with pytest.raises(ValueError, match=f"{n} slots"):
        rpa.ragged_paged_attention(
            torch.zeros(n, 8, 64, device=cuda, dtype=torch.bfloat16), kp,
            vp, many[:, None].contiguous(), many, many,
            torch.arange(n, dtype=torch.int32, device=cuda), 1)


@pytest.mark.gpu
def test_sm90_blocks_per_sm_is_the_compiled_one(cuda):
    """The wrapper sizes the Hopper body's split records by its blocks an
    SM; each instance's Cfg::BLOCKS, read from the library, is the
    wrapper's: one for float32 pools at head_dim 128, two otherwise."""
    from paddle_tpu_torch.ops.kernels import _build
    fn = _build.load("ragged_paged_attention") \
        .ptt_paged_attention_blocks_per_sm
    for code, int8 in ((1, 0), (1, 1), (rpa.F32_POOL, 0)):
        for d in (64, 128):
            assert fn(code, int8, d) == rpa.sm90_blocks_per_sm(code, d), \
                (code, int8, d)
    assert fn(rpa.F32_POOL, 1, 64) == 0 and fn(0, 0, 64) == 0


# the LoRA delta's K4 calls (float32, ops/lora.py): a tick's packed rows at
# Llama-3-8B's width over max_adapters + 1 = 9 groups, rank 16, to q's 4096
# and k's 1024 columns; edges: every row in the null group, a group of one
# row, rank 4 in stacks padded to 8; the bodies' edges: one group holding
# a 128-row prefill chunk, 3 groups (max_adapters 2), rank 64 (the split-K
# and wide-scatter bodies' bound), rank 72 (past it: moe_gmm_fma), and the
# widths of Qwen2-7B (3584), DeepSeek-MoE (2048) and GPT (1024), and a
# depth of 200 whose last K slice is short (8 slices of 28: 196 + 4)
_LORA_USED = (0, 1, 3, 5, 8)


def _lora_case(kind, rows, d, rank, out, dev, groups=9, seed=0):
    """Packed rows, each row's stack row, and stacks as the adapter pool
    holds them (row 0 and the padded rank zero). ``chunk``: a 128-row
    prefill chunk under the last adapter, the other rows over the
    rest."""
    rng = np.random.RandomState(seed)
    used = _LORA_USED if groups == 9 else tuple(range(groups))
    if kind == "null":
        ra = np.zeros(rows, np.int64)
    elif kind == "single":
        ra = rng.choice([0, 2], rows)
        ra[rows // 2] = groups - 1
    elif kind == "chunk":
        ra = rng.choice(used[:-1], rows)
        ra[rows - 128:] = groups - 1
    else:
        ra = rng.choice(used, rows)
    rp = lora.padded_rank(rank)
    A = np.zeros((groups, d, rp), np.float32)
    B = np.zeros((groups, rp, out), np.float32)
    A[1:, :, :rank] = 0.05 * rng.randn(groups - 1, d, rank)
    B[1:, :rank] = 0.05 * rng.randn(groups - 1, rank, out)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(rng.randn(rows, d).astype(np.float32)), t(ra), t(A), t(B)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,rows,d,rank,out,groups", [
    ("tick", 136, 4096, 16, 4096, 9), ("tick", 136, 4096, 16, 1024, 9),
    ("tick", 8, 4096, 16, 4096, 9), ("null", 136, 4096, 16, 4096, 9),
    ("single", 136, 4096, 16, 1024, 9), ("tick", 136, 4096, 4, 4096, 9),
    ("tick", 40, 64, 4, 96, 9), ("chunk", 136, 4096, 16, 4096, 9),
    ("tick", 136, 4096, 16, 4096, 3), ("tick", 136, 4096, 64, 1024, 9),
    ("tick", 136, 4096, 72, 1024, 9), ("tick", 136, 3584, 16, 512, 9),
    ("tick", 136, 2048, 16, 2048, 9), ("tick", 136, 1024, 16, 3072, 9),
    ("tick", 40, 200, 8, 96, 9)])
def test_lora_delta_k4_modes(cuda, kind, rows, d, rank, out, groups):
    """The sort (stable order and group sizes, as numpy's), K4's gather and
    scatter modes against their plain versions, the whole delta against
    the reference's einsum at the unpadded rank, counted as the LoRA
    launches (MoE's untouched); the null group's delta is exactly zero,
    and a row's delta is the same to the bit with or without the other
    rows (batched == solo)."""
    x, ra, A, B = _lora_case(kind, rows, d, rank, out, cuda, groups)
    G = A.shape[0]
    order, sizes = lora.sort_rows(ra, G)
    np.testing.assert_array_equal(
        order.cpu().numpy(), np.argsort(ra.cpu().numpy(), kind="stable"))
    np.testing.assert_array_equal(sizes.cpu().numpy(), np.bincount(
        ra.cpu().numpy(), minlength=G))
    n0 = dict(launch_counts)
    ax = mg.gather_gmm(x, order, A, sizes, count="lora_gmm")
    ax_ref = mg.plain_gather_gmm(x, order, A, sizes)
    _rows_close(ax, ax_ref, "float32")
    y = mg.scatter_gmm(ax_ref, B, sizes, order, count="lora_scatter_gmm")
    _rows_close(y, mg.plain_scatter_gmm(ax_ref, B, sizes, order), "float32")
    delta = lora.ragged_delta(x, ra, A, B)
    _rows_close(delta, lora.plain_ragged_delta(x, ra, A[:, :, :rank],
                                               B[:, :rank]), "float32")
    assert launch_counts["lora_gmm"] == n0["lora_gmm"] + 2
    assert launch_counts["lora_scatter_gmm"] == n0["lora_scatter_gmm"] + 2
    for name in ("moe_gmm", "moe_scatter_gmm"):
        assert launch_counts[name] == n0[name]
    null = (ra == 0).nonzero()[:, 0]
    assert not delta[null].any()
    for g in ra.unique():
        sub = (ra == g).nonzero()[:, 0]
        alone = lora.ragged_delta(x[sub].contiguous(), ra[sub], A, B)
        assert torch.equal(alone, delta[sub]), int(g)
    assert torch.equal(lora.ragged_delta(x, ra, A, B), delta)


@pytest.mark.gpu
def test_moe_gmm_f32_body_rule(cuda):
    """The float32 body a call takes, as the library reports it, on both
    sides of each bound: the gather or plain gmm takes the split-K body up
    to N 64, the scatter the wide-scatter body up to K 64, and swiglu,
    the transposed modes and everything past the bounds moe_gmm_fma;
    the rows and group count never change it."""
    body = mg.f32_body
    top_n, top_k = mg.F32_SPLIT_K_MAX_N, mg.F32_WIDE_MAX_K
    assert (top_n, top_k) == (64, 64)
    for m, e in ((1, 1), (8, 9), (136, 3), (4096, 1024)):
        assert body("gmm", m, 4096, 8, e) == "split_k"
        assert body("gmm", m, 4096, top_n, e) == "split_k"
        assert body("gmm", m, 4096, top_n + 8, e) == "fma"
        assert body("gmm", m, 8, top_n + 8, e) == "fma"
        assert body("scatter", m, 8, 4096, e) == "wide_scatter"
        assert body("scatter", m, top_k, 14336, e) == "wide_scatter"
        assert body("scatter", m, top_k + 8, 4096, e) == "fma"
        assert body("scatter", m, 4096, 16, e) == "fma"
        assert body("swiglu", m, 64, 16, e) == "fma"
        assert body("transposed", m, 16, 16, e) == "fma"


@pytest.mark.gpu
def test_lora_k4_modes_repeat_and_replay_to_the_bit(cuda):
    """Both float32 LoRA modes give the same bits on two eager calls and
    on a CUDA graph's replay of a captured call, its inputs rewritten in
    place between capture and replay."""
    x, ra, A, B = _lora_case("tick", 136, 4096, 16, 4096, cuda, seed=3)
    order, sizes = lora.sort_rows(ra, A.shape[0])

    def delta():
        ax = mg.gather_gmm(x, order, A, sizes, count="lora_gmm")
        return ax, mg.scatter_gmm(ax, B, sizes, order,
                                  count="lora_scatter_gmm")

    first = delta()
    assert all(torch.equal(a, b) for a, b in zip(first, delta()))
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        delta()                     # warm-up on the side stream
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = delta()
    x2, _, A2, B2 = _lora_case("tick", 136, 4096, 16, 4096, cuda, seed=4)
    for dst, src in ((x, x2), (A, A2), (B, B2)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    eager = delta()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
    assert not torch.equal(captured[1], first[1])


@pytest.mark.gpu
def test_lora_delta_raises_where_k4_cannot_take_it(cuda):
    """An unpadded rank off a multiple of 8 and a width off one raise on
    the card; nothing falls back to the plain versions."""
    x, ra, A, B = _lora_case("tick", 16, 64, 4, 96, cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        lora.ragged_delta(x, ra, A[:, :, :4].contiguous(),
                          B[:, :4].contiguous())
    with pytest.raises(ValueError, match="multiples of 8"):
        lora.ragged_delta(x[:, :60].contiguous(), ra,
                          A[:, :60].contiguous(), B)


def _tiny_llama(layers=2, seed=3, dtype="bfloat16"):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(vocab=512, hidden=256, layers=layers, heads=4,
                           kv_heads=2, ffn=512)
    cfg.dtype = dtype
    return LlamaForCausalLM(cfg, device="cuda", seed=seed)


@pytest.mark.gpu
@pytest.mark.parametrize("interval", [1, 2])
def test_recompute_replays_k1_and_keeps_the_gradients(cuda, interval):
    """With ``config.recompute`` the backward replays K1f for each
    recomputed layer, and the loss and every gradient equal the run
    without recompute bit for bit (the kernels are deterministic)."""
    model = _tiny_llama(layers=3).train()
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 512, (2, 256))).to(cuda)
    labels = torch.roll(ids, -1, 1)
    runs = []
    for on in (False, True):
        model.config.recompute = on
        model.config.recompute_interval = interval
        model.zero_grad(set_to_none=True)
        for k in launch_counts:
            launch_counts[k] = 0
        loss = model(ids, labels=labels)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach(), {n: p.grad.clone()
                                     for n, p in model.named_parameters()},
                     dict(launch_counts)))
    (l0, g0, k0), (l1, g1, k1) = runs
    replayed = len(range(0, 3, interval))
    assert k0["flash_attention_fwd"] == 3
    assert k1["flash_attention_fwd"] == 3 + replayed
    assert k1["flash_attention_dq"] == k1["flash_attention_dkv"] == 3
    assert torch.equal(l0, l1)
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", ["beam_search", "group_beam_search"])
def test_beam_on_the_card_matches_its_cpu_run(cuda, strategy, dtype):
    """Beam search on a tiny model on the card against its CPU run (the
    dense cache path: the reference's plain recipe on either device). In
    float32 the tokens are the CPU run's and the scores within 1e-4. In
    bf16 the two devices round the products apart, so a near tie among
    the 2K candidates may pick another hypothesis: each card hypothesis,
    scored again by the CPU model (one dense forward, summed
    log-probabilities over the length penalty), must be as good as the
    CPU run's own within 2e-2, and the card's score that rescoring's."""
    model = _tiny_llama(dtype=dtype).eval()
    kw = dict(decode_strategy=strategy, num_beams=4, max_new_tokens=8,
              length_penalty=1.0)
    if strategy == "group_beam_search":
        kw.update(num_beam_groups=2, diversity_rate=0.5)
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 512, (2, 16)))
    got, score = model.generate(ids.to(cuda), **kw)
    cpu = model.to("cpu")
    want, want_score = cpu.generate(ids, **kw)
    if dtype == "float32":
        assert torch.equal(got.cpu(), want)
        torch.testing.assert_close(score.cpu(), want_score, rtol=1e-4,
                                   atol=1e-4)
        return
    with torch.no_grad():
        logits = cpu(torch.cat([ids, got.cpu()], 1))
    logp = torch.log_softmax(logits[:, 15:-1].float(), -1)
    rescored = torch.gather(logp, -1, got.cpu()[..., None])[..., 0].sum(1) \
        / 8.0
    torch.testing.assert_close(score.cpu(), rescored, rtol=2e-2, atol=2e-2)
    if strategy == "beam_search":       # group scores carry the penalty
        assert bool((rescored >= want_score - 2e-2 * want_score.abs()
                     - 2e-2).all()), (rescored, want_score)
