"""K3a / K3b — the fused decode-tick kernels (``csrc/norm_matmul.cu``,
``csrc/matmul_residual.cu``) and their plain PyTorch versions. In
bfloat16 both run one of two Hopper bodies, chosen by the shape alone
(:func:`body`): the split body of ``csrc/decode_gemm_small_sm90.cuh``
(a column tile a thread-block cluster, K split over its blocks) for at
most 192 rows over small weights (GPT's widths), the stream-K body of
``csrc/decode_gemm_sm90.cuh`` otherwise (Llama-3-8B's and Qwen2-7B's).

Counterpart of ``paddle_tpu/ops/pallas/decode_fused.py``:

- :func:`norm_matmul` — a norm over ``[..., d]`` rows (``kind="rms"``,
  or ``"ln"`` with an optional ``beta``) fused into 1..3 projections
  ``[d, n_i]`` that share the normalised rows (q/k/v, or the MLP's
  gate/up), each with an optional bias. The normalised activation never
  reaches device memory.
- :func:`matmul_residual` — ``residual + act(xs) @ w (+ b)`` with act
  ``None`` (the O-projection), ``"swiglu"`` (``silu(g) * u`` into the
  down-projection) or ``"gelu_tanh"`` (GPT's second MLP linear). On the
  card the activation runs once an element into a per-stream scratch of
  ``[R, K]`` rows that the projection reads (kept out of the product's
  column tiles, which would each redo it).

The plain versions are op for op the reference's ``_xla_norm_matmul`` /
``_xla_matmul_residual`` (the unfused module path), so a CPU model with
fusion on is bitwise the same model with fusion off. CPU tensors take
the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from ...incubate.nn.functional import swiglu
from ...nn.functional.activation import gelu
from ...nn.functional.norm import layer_norm, rms_norm
from ...monitor.accounting import declares
from . import _build, held, launch_counts, no_backward

__all__ = ["norm_matmul", "matmul_residual", "plain_norm_matmul",
           "plain_matmul_residual", "body", "split_config", "BODIES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"rms": 0, "ln": 1}
_ACTS = {None: 0, "swiglu": 1, "gelu_tanh": 2}
# the Hopper body's schedule (csrc/decode_gemm_sm90.cuh): 128-column
# tiles, row blocks of at most MAX_MG x 64 rows, MAX_MG flags a segment,
# and a workspace of MAX_MG x 16 x 128 float4 partials a block (one block
# an SM at most)
_BN, _MAX_MG = 128, 3
_LIBS = {}
_SCRATCH = {}
# the bodies of a bfloat16 call, by the code ptt_decode_gemm_body returns,
# and the rule's bounds (csrc/decode_gemm_small_sm90.cuh: body_of,
# split_of): the split body takes one row block over at most
# SPLIT_MAX_WEIGHTS weight elements in SPLIT_BN-column tiles; its
# clusters hold at most SPLIT_MAX blocks, SPLIT_BLOCKS blocks a call at
# most where the split is above 1
BODIES = ("stream_k", "split_k")
SPLIT_MAX_ROWS = _MAX_MG * 64
SPLIT_MAX_WEIGHTS = 1 << 23
SPLIT_BN, SPLIT_MAX, SPLIT_BLOCKS = 128, 8, 96
_BK = 64


def split_config(k, widths):
    """``(column tile, blocks a cluster, blocks)`` of the split body for
    a reduction ``k`` over ``widths``: the largest split (at most
    SPLIT_MAX) that gives every block a 64-deep slice and keeps the
    blocks within SPLIT_BLOCKS. The mirror of ``split_of`` in
    ``csrc/decode_gemm_small_sm90.cuh``."""
    tiles = sum(-(-int(n) // SPLIT_BN) for n in widths)
    nk = -(-int(k) // _BK)
    split = max([1] + [s for s in range(2, SPLIT_MAX + 1)
                       if tiles * s <= SPLIT_BLOCKS
                       and -(-nk // -(-nk // s)) == s])
    return SPLIT_BN, split, tiles * split


def body(r, k, widths):
    """The bfloat16 body a K3a call of ``r`` rows over ``k = d`` into
    ``widths`` (K3b: ``[n]``) takes, one of :data:`BODIES`: ``"split_k"``
    for one row block (``r <= 192``) over at most SPLIT_MAX_WEIGHTS
    weight elements, ``"stream_k"`` otherwise. A function of the shape
    alone, the mirror of ``body_of`` in
    ``csrc/decode_gemm_small_sm90.cuh`` (:func:`_c_body` asks the
    library); needs neither the library nor a device."""
    weights = sum(int(k) * int(n) for n in widths)
    return BODIES[int(r) <= SPLIT_MAX_ROWS
                  and weights <= SPLIT_MAX_WEIGHTS]


def _c_body(r, k, widths):
    """``(body, split_config)`` as the built library reports them
    (``ptt_decode_gemm_body``; the split config None for the stream-K
    body)."""
    ns = list(widths) + [0] * (3 - len(widths))
    cfg = (ctypes.c_int * 3)()
    code = _lib("norm_matmul").ptt_decode_gemm_body(r, k, *ns, len(widths),
                                                    cfg)
    if code < 0:
        raise ValueError(f"no body for {r} rows, k {k}, widths {widths}")
    return BODIES[code], (tuple(cfg) if code else None)


def plain_norm_matmul(x, gamma, beta, ws, bs, *, eps, kind):
    """The unfused recipe of ``_xla_norm_matmul``: the norm of the
    module path (:func:`~paddle_tpu_torch.nn.functional.rms_norm` or
    :func:`~paddle_tpu_torch.nn.functional.layer_norm`: statistics in
    float32, the normalised rows cast to the activation dtype BEFORE the
    gamma multiply, then beta), then each ``y @ w (+ b)``."""
    if kind == "rms":
        if beta is not None:
            raise ValueError("beta belongs to kind='ln'")
        y = rms_norm(x, gamma, eps)
    elif kind == "ln":
        y = layer_norm(x, x.shape[-1], gamma, beta, eps)
    else:
        raise ValueError(f"kind {kind!r}: 'rms' or 'ln'")
    return tuple(y @ w + b if b is not None else y @ w
                 for w, b in zip(ws, bs))


def plain_matmul_residual(xs, w, b, residual, *, act=None):
    """The unfused recipe of ``_xla_matmul_residual``: the activation,
    the projection, the bias, then ``residual + y`` in the decoder
    layer's order."""
    if act == "swiglu":
        xin = swiglu(xs[0], xs[1])
    elif act == "gelu_tanh":
        xin = gelu(xs[0], approximate=True)
    elif act is None:
        xin = xs[0]
    else:
        raise ValueError(f"act {act!r}: None, 'swiglu' or 'gelu_tanh'")
    y = xin @ w + b if b is not None else xin @ w
    return residual + y


def _lib(name):
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.load(name)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "norm_matmul":
            fn = lib.ptt_norm_matmul
            fn.argtypes = [ptr] * 15 + [i64] * 2 + [i32] * 7 \
                + [ctypes.c_float, i32, ptr]
            lib.ptt_decode_gemm_body.argtypes = [i32] * 6 + [ptr]
            lib.ptt_decode_gemm_body.restype = ctypes.c_int
        else:
            fn = lib.ptt_matmul_residual
            fn.argtypes = [ptr] * 9 + [i64] * 3 + [i32] * 5 + [ptr]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


class _Scratch:
    """The bfloat16 bodies' scratch for one stream of one device: the
    workspace (the stream-K partials, one slot a block, one block an SM
    at most; the split body's normalised K3a rows), the segments' flags
    (zeros; each call leaves them zero), K3a's row statistics and K3b's
    activated rows. Calls on one stream run one after another, so they
    share it."""

    def __init__(self, device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        mk = dict(device=device)
        self.ws = torch.empty(sms * _MAX_MG * 16 * 128 * 4,
                              dtype=torch.float32, **mk)
        self.flags = torch.zeros(0, dtype=torch.int32, **mk)
        self.stats = torch.empty(0, dtype=torch.float32, **mk)
        self.rows = torch.empty(0, dtype=torch.bfloat16, **mk)

    def take(self, rows, col_tiles, stats=0, act=0, ws=0):
        """Grow the flags to ``rows`` rows over ``col_tiles`` column
        tiles, the statistics to ``stats`` floats, the activated rows to
        ``act`` elements and the workspace to ``ws`` floats (K3a's
        normalised rows on the split body)."""
        n = col_tiles * -(-rows // (_MAX_MG * 64)) * _MAX_MG
        if self.ws.numel() < ws:
            self.ws = torch.empty(ws, device=self.ws.device,
                                  dtype=torch.float32)
        if self.flags.numel() < n:
            self.flags = torch.zeros(n, device=self.ws.device,
                                     dtype=torch.int32)
        if self.stats.numel() < stats:
            self.stats = torch.empty(stats, device=self.ws.device,
                                     dtype=torch.float32)
        if self.rows.numel() < act:
            self.rows = torch.empty(act, device=self.ws.device,
                                    dtype=torch.bfloat16)
        return self


def _scratch(device, stream, rows, widths, **need):
    """The scratch of ``stream`` (a handle) on ``device``, grown to
    ``need`` (see :meth:`_Scratch.take`)."""
    s = _SCRATCH.get((device, stream))
    if s is None:
        s = _SCRATCH[(device, stream)] = _Scratch(device)
    s.take(rows, sum(-(-int(n) // _BN) for n in widths), **need)
    held(s.ws, s.flags, s.stats, s.rows)    # a graph keeps what it captured
    return s


def _check_same(ref, named):
    for name, t in named:
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, input on "
                             f"{ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from the "
                            f"input's {ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref.dtype not in _DTYPES:
        raise TypeError(f"dtype {ref.dtype}: the kernels take float32 or "
                        "bfloat16")


def _check_bf16(dims, tensors):
    """The bfloat16 body reads by TMA and in 16-byte vectors: every row
    width a multiple of 8, every base pointer 16-byte aligned."""
    if any(int(n) % 8 for n in dims):
        raise ValueError(f"bfloat16 kernels need dims that are multiples "
                         f"of 8, got {tuple(int(n) for n in dims)}")
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("bfloat16 kernels need 16-byte aligned tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _vector(name, t, n):
    if t is not None and t.shape != (n,):
        raise ValueError(f"{name} {tuple(t.shape)}, want ({n},)")


def _norm_matmul_work(x, gamma, beta, ws, bs, *, eps, kind):
    """One K3a call's bound: the rows, gamma (and beta), the weights,
    the biases and the outputs moved once; the projections' and the
    norm's operations."""
    d = x.shape[-1]
    r = x.numel() // d
    n = sum(int(w.shape[1]) for w in ws)
    nbytes = x.element_size() * (
        x.numel() + d * (1 if beta is None else 2)
        + sum(w.numel() for w in ws) + r * n
        + sum(b.numel() for b in bs if b is not None))
    return ("norm_matmul", 2 * r * d * n + (6 if kind == "ln" else 4) * r * d,
            nbytes)


def _matmul_residual_work(xs, w, b, residual, *, act=None):
    """One K3b call's bound: the inputs, the weight, the residual read
    and the output written, the bias; the projection's and the
    activation's operations."""
    k, n = int(w.shape[0]), int(w.shape[1])
    r = residual.numel() // n
    nbytes = residual.element_size() * (
        sum(x.numel() for x in xs) + w.numel() + 2 * r * n
        + (0 if b is None else n))
    return ("matmul_residual", 2 * r * k * n + (4 * r * k if act else 0),
            nbytes)


@no_backward("norm_matmul (K3a)")
@declares(_norm_matmul_work)
def norm_matmul(x, gamma, beta, ws, bs, *, eps, kind):
    """Fused norm -> 1..3 projections. ``x`` ``[..., d]``, ``gamma`` and
    ``beta`` (``kind="ln"`` only; None for none) ``[d]``, ``ws`` a list of
    ``[d, n_i]`` weights and ``bs`` their biases ``[n_i]`` (None
    entries allowed). Returns a tuple of ``[..., n_i]``."""
    ws, bs = list(ws), list(bs)
    if kind not in _KINDS:
        raise ValueError(f"kind {kind!r}: 'rms' or 'ln'")
    if beta is not None and kind != "ln":
        raise ValueError("beta belongs to kind='ln'")
    if not 1 <= len(ws) <= 3 or len(bs) != len(ws):
        raise ValueError(f"norm_matmul takes 1..3 weights and as many "
                         f"biases, got {len(ws)} and {len(bs)}")
    if x.device.type == "cpu":
        return plain_norm_matmul(x, gamma, beta, ws, bs, eps=eps, kind=kind)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    _check_same(x2, [("x", x2), ("gamma", gamma), ("beta", beta)]
                + [(f"w{i}", w) for i, w in enumerate(ws)]
                + [(f"b{i}", b) for i, b in enumerate(bs)])
    _vector("gamma", gamma, d)
    _vector("beta", beta, d)
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.dim() != 2 or w.shape[0] != d:
            raise ValueError(f"w{i} {tuple(w.shape)}, want [{d}, n]")
        _vector(f"b{i}", b, w.shape[1])
    r = x2.shape[0]
    widths = [w.shape[1] for w in ws]
    outs = [torch.empty(r, n, device=x.device, dtype=x.dtype)
            for n in widths]
    if r == 0:
        return tuple(o.reshape(*x.shape[:-1], o.shape[1]) for o in outs)
    ptr = [w.data_ptr() for w in ws] + [None] * (3 - len(ws))
    bptr = [_ptr(b) for b in bs] + [None] * (3 - len(ws))
    optr = [o.data_ptr() for o in outs] + [None] * (3 - len(ws))
    ns = widths + [0] * (3 - len(ws))
    sc, stream = None, torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        _check_bf16([d] + widths, [x2, gamma, beta, *ws, *bs])
        sc = _scratch(x.device, stream, r, widths, stats=2 * r,
                      ws=-(-r * d // 2))
    rc = _lib("norm_matmul").ptt_norm_matmul(
        x2.data_ptr(), gamma.data_ptr(), _ptr(beta), *ptr, *bptr, *optr,
        *_scratch_args(sc, "stats"), r, d, *ns, len(ws), _KINDS[kind],
        float(eps), _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"norm_matmul kernel launch failed "
                           f"(cudaError {rc})")
    launch_counts["norm_matmul"] += 1
    return tuple(o.reshape(*x.shape[:-1], o.shape[1]) for o in outs)


def _scratch_args(sc, first):
    """The bfloat16 body's scratch (nulls for float32): the pointers of
    ``first`` (``"stats"``, K3a's, or ``"rows"``, K3b's), the partials
    and the flags, then the capacities (the rows' first)."""
    rows = first == "rows"
    if sc is None:
        return [None] * 3 + [0] * (3 if rows else 2)
    head = getattr(sc, first)
    caps = [sc.ws.numel(), sc.flags.numel()]
    return [head.data_ptr(), sc.ws.data_ptr(), sc.flags.data_ptr()] + (
        [head.numel()] + caps if rows else caps)


@no_backward("matmul_residual (K3b)")
@declares(_matmul_residual_work)
def matmul_residual(xs, w, b, residual, *, act=None):
    """Fused ``residual + act(xs) @ w (+ b)``; ``xs`` holds one input
    ``[..., K]`` (act None or ``"gelu_tanh"``) or two (act ``"swiglu"``:
    gate, up)."""
    if act not in _ACTS:
        raise ValueError(f"act {act!r}: None, 'swiglu' or 'gelu_tanh'")
    xs = list(xs)
    want = 2 if act == "swiglu" else 1
    if len(xs) != want:
        raise ValueError(f"act {act!r} takes {want} inputs, got {len(xs)}")
    if residual.device.type == "cpu":
        return plain_matmul_residual(xs, w, b, residual, act=act)
    if residual.device.type != "cuda":
        raise ValueError(f"unsupported device {residual.device}")
    k = xs[0].shape[-1]
    n = w.shape[-1]
    x2 = [x.reshape(-1, k) for x in xs]
    res2 = residual.reshape(-1, n)
    _check_same(res2, [(f"x{i}", x) for i, x in enumerate(x2)]
                + [("w", w), ("bias", b), ("residual", res2)])
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w {tuple(w.shape)}, want [{k}, n]")
    _vector("bias", b, n)
    r = res2.shape[0]
    if any(x.shape[0] != r for x in x2):
        raise ValueError("inputs and residual must have the same rows")
    out = torch.empty_like(res2)
    if r == 0:
        return out.reshape(residual.shape)
    sc, stream = None, torch.cuda.current_stream(res2.device).cuda_stream
    if res2.dtype == torch.bfloat16:
        _check_bf16([k, n], [*x2, w, b, res2])
        sc = _scratch(res2.device, stream, r, [n], act=r * k if act else 0)
    rc = _lib("matmul_residual").ptt_matmul_residual(
        x2[0].data_ptr(), x2[1].data_ptr() if act == "swiglu" else None,
        w.data_ptr(), _ptr(b), res2.data_ptr(), out.data_ptr(),
        *_scratch_args(sc, "rows"), r, k, n, _ACTS[act],
        _DTYPES[res2.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"matmul_residual kernel launch failed "
                           f"(cudaError {rc})")
    launch_counts["matmul_residual"] += 1
    return out.reshape(residual.shape)
