"""The PyTorch port's prefix cache against the JAX package on the CPU.

The content-addressed ``BlockAllocator`` runs a seeded random sequence of
``alloc`` / ``ref`` / ``free`` / ``publish`` / ``lookup`` /
``unpublish_all`` beside the reference's and must hand out the same ids,
evict the same blocks (``on_evict`` calls) and keep the same counts; the
chain hashes are the reference's byte for byte; a ``HostKVTier`` sequence
keeps the reference's bytes, drops and LRU order; export, then import, is
a byte round trip on bfloat16, float32 and int8 pools (data and scales),
written in place, and ``copy_blocks`` leaves its source untouched. The
engine, with weights crossed from a seeded reference model by
``load_jax_params``, serves shared-prefix traffic with the cache on
exactly as the reference engine does with it on (tokens and the
``prefix_*``, ``cow_copies``, ``cache_evictions`` and ``cached_blocks``
counters; Llama on float32 and int8 pools, GPT, n-gram speculation) and
as it does itself with the cache off; a full-prompt hit copies the shared
block and leaves the published bytes unchanged; a pool under pressure
evicts and drains clean.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import paged_cache as jpc
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.ops import paged_cache as pc

# the reference fixtures' shapes and engine (tests/test_prefix_cache.py)
LLAMA = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
GPT = dict(vocab=96, hidden=64, layers=2, heads=4)
CORE = dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8)
# the reference's features the port has no slice for yet, off
REF_ONLY = dict(health=False, min_prefill_bucket=8, async_depth=0)
COUNTERS = ("prefix_blocks_reused", "prefix_tokens_reused",
            "prefix_hit_rate", "cow_copies", "cache_evictions",
            "cached_blocks", "free_blocks", "reserved_blocks",
            "tokens_total", "requests_completed")


def _pair(jcfg_cls, jcls, tcfg_cls, tcls, shape, seed):
    paddle.seed(seed)
    ref = jcls(jcfg_cls.tiny(**shape))
    ref.eval()
    port = tcls(tcfg_cls.tiny(**shape), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port.eval()


@pytest.fixture(scope="module")
def llama():
    return _pair(JaxLlamaConfig, JaxLlama, LlamaConfig, LlamaForCausalLM,
                 LLAMA, 7)


@pytest.fixture(scope="module")
def gpt():
    return _pair(JaxGPTConfig, JaxGPT, GPTConfig, GPTForCausalLM, GPT, 3)


def _engines(pair, **kw):
    ref, port = pair
    return (JaxServingEngine(ref, JaxServingConfig(**dict(CORE, **kw),
                                                   **REF_ONLY)),
            ServingEngine(port, ServingConfig(**dict(CORE, **kw)),
                          device="cpu"))


def _assert_equal(a, b, tag):
    assert len(a) == len(b), tag
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{tag} request {i}")


def _assert_counters(got, want, keys=COUNTERS):
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


# ------------------------------------------------------------ the allocator


def test_allocator_sequence_matches_reference():
    rng = np.random.RandomState(0)
    mine, want = pc.BlockAllocator(17), jpc.BlockAllocator(17)
    ev_mine, ev_want = [], []
    mine.on_evict = lambda b, h: ev_mine.append((b, h))
    want.on_evict = lambda b, h: ev_want.append((b, h))
    live = {}                           # block -> our references
    tag = [0]
    for step in range(600):
        op = rng.randint(6)
        if op == 0 and mine.free_blocks:
            n = min(1 + rng.randint(3), mine.free_blocks)
            got = mine.alloc(n)
            assert got == want.alloc(n)
            for b in got:
                live[b] = live.get(b, 0) + 1
        elif op == 1 and live:
            b = sorted(live)[rng.randint(len(live))]
            mine.free([b])
            want.free([b])
            live[b] -= 1
            if not live[b]:
                del live[b]
        elif op == 2 and live:
            b = sorted(live)[rng.randint(len(live))]
            tag[0] += 1
            h = pc.chain_hashes(b"prop", [tag[0] % 40] * 4, 4)[0]
            assert mine.publish(b, h) == want.publish(b, h)
        elif op == 3:
            h = pc.chain_hashes(b"prop", [rng.randint(40)] * 4, 4)[0]
            b = mine.lookup(h)
            assert b == want.lookup(h)
            if b is not None:
                assert mine.ref(b) == want.ref(b)
                live[b] = live.get(b, 0) + 1
        elif op == 4 and live:
            b = sorted(live)[rng.randint(len(live))]
            assert mine.refcount(b) == want.refcount(b)
            assert mine.is_shared(b) == want.is_shared(b)
        elif op == 5 and step % 97 == 0:
            assert mine.unpublish_all() == want.unpublish_all()
        assert (mine.free_blocks, mine.cached_blocks, mine.evictions) == \
            (want.free_blocks, want.cached_blocks, want.evictions)
        if step % 50 == 0:
            assert mine.check_leaks(list(live))
    assert ev_mine == ev_want and ev_mine
    for b in list(live):
        mine.free([b] * live[b])
    assert mine.check_leaks([])
    b = mine.alloc(1)
    mine.free(b)
    with pytest.raises(ValueError, match="double free"):
        mine.free(b)


def test_chain_hashes_match_reference_bytes():
    rng = np.random.RandomState(1)
    for bs in (4, 8, 16):
        toks = rng.randint(0, 50000, 5 * bs + 3)
        seed = rng.bytes(16)
        mine = pc.chain_hashes(seed, toks, bs)
        assert mine == jpc.chain_hashes(seed, toks, bs)
        assert len(mine) == 5 and all(len(h) == 16 for h in mine)
        assert list(pc.prompt_block_hashes(seed, toks, bs)) == \
            list(jpc.prompt_block_hashes(seed, toks, bs))
    # the chain commits to the whole prefix
    a = pc.chain_hashes(b"s", [1, 2, 3, 4, 5, 6, 7, 8], 4)
    b = pc.chain_hashes(b"s", [9, 2, 3, 4, 5, 6, 7, 8], 4)
    assert a[1] != b[1]


def test_host_tier_sequence_matches_reference():
    rng = np.random.RandomState(2)
    mine, want = pc.HostKVTier(300), jpc.HostKVTier(300)
    pay = [(torch.zeros(4), torch.zeros(4))]
    for _ in range(200):
        op = rng.randint(5)
        key = (("pub", "victim")[rng.randint(2)], int(rng.randint(8)))
        if op <= 1:
            n = int(rng.randint(1, 160)) * (1 if rng.rand() < 0.95 else 3)
            assert mine.put(key, pay, n) == want.put(key, pay, n)
        elif op == 2:
            assert (mine.get(key) is None) == (want.get(key) is None)
        elif op == 3:
            restore = bool(rng.randint(2))
            assert (mine.pop(key, restore) is None) == \
                (want.pop(key, restore) is None)
        elif rng.rand() < 0.1:
            assert mine.purge_published() == want.purge_published()
        assert list(mine._items) == list(want._items)
        assert (mine.bytes_used, mine.drops, mine.spills, mine.restores,
                len(mine)) == (want.bytes_used, want.drops, want.spills,
                               want.restores, len(want))
    with pytest.raises(ValueError, match="positive"):
        pc.HostKVTier(0)


# ------------------------------------------------------------- block moves


def _pools(dtype, rng, nb=7, bs=8, h=2, d=16):
    pools = [pc.init_pool(nb, bs, h, d, dtype, "cpu") for _ in range(2)]
    tables = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    for kp, vp in pools:
        k = torch.from_numpy(rng.randn(1, 3 * bs, h, d).astype(np.float32))
        v = torch.from_numpy(rng.randn(1, 3 * bs, h, d).astype(np.float32))
        pc.write_prefill(kp, vp, tables, k, v)
    return pools


def _tensors(pools):
    for pair in pools:
        for p in pair:
            yield from ((p.data, p.scale) if isinstance(p, pc.QuantKV)
                        else (p,))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, "int8"])
def test_export_import_round_trip_in_place(dtype):
    rng = np.random.RandomState(4)
    src = _pools(dtype, rng)
    before = [t.clone() for t in _tensors(src)]
    host = pc.payload_rows(pc.payload_to_host(
        pc.export_blocks(src, [1, 2, 3, 0, 0])), 3)
    assert all(t.device.type == "cpu" for t in _tensors(host))
    n = pc.payload_nbytes(host)
    assert n == sum(t.numel() * t.element_size() for t in _tensors(host))
    assert all(torch.equal(a, b) for a, b in zip(before, _tensors(src)))
    dst = [pc.init_pool(7, 8, 2, 16, dtype, "cpu") for _ in range(2)]
    ptrs = [t.data_ptr() for t in _tensors(dst)]
    # into other ids, through the pad the reference's fixed width needs
    out = pc.import_blocks(dst, [4, 6, 5, 0, 0],
                           pc.payload_pad(host, 5))
    assert out is dst and [t.data_ptr() for t in _tensors(dst)] == ptrs
    for a, b in zip(_tensors(src), _tensors(dst)):
        assert torch.equal(a[[1, 2, 3]], b[[4, 6, 5]])
    # copy-on-write: the copy equals its source, which is untouched
    pc.copy_blocks(dst, 6, 2)
    for a, b in zip(before, _tensors(dst)):
        assert torch.equal(b[2], b[6]) and torch.equal(b[6], a[2])
    assert [t.data_ptr() for t in _tensors(dst)] == ptrs
    if dtype == "int8":
        with pytest.raises(TypeError, match="non-quantized"):
            pc.import_blocks(dst, [1],
                             [(torch.zeros(1, 8, 2, 16),) * 2] * 2)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_export_payload_equals_reference(dtype):
    """The port gathers the live blocks only; after ``payload_rows`` the
    reference's fixed-width gather is the same payload."""
    import jax.numpy as jnp
    rng = np.random.RandomState(5)
    jd = jnp.float32 if dtype == "float32" else "int8"
    td = torch.float32 if dtype == "float32" else "int8"
    tables = np.array([[2, 3, 5]], np.int32)
    k = rng.randn(1, 24, 2, 16).astype(np.float32)
    v = rng.randn(1, 24, 2, 16).astype(np.float32)
    jpools = [jpc.write_prefill(*jpc.init_pool(7, 8, 2, 16, jd),
                                jnp.asarray(tables), jnp.asarray(k),
                                jnp.asarray(v)) for _ in range(2)]
    tpools = [pc.write_prefill(*pc.init_pool(7, 8, 2, 16, td, "cpu"),
                               torch.from_numpy(tables), torch.from_numpy(k),
                               torch.from_numpy(v)) for _ in range(2)]
    want = jpc.payload_rows(jpc.payload_to_host(jpc.export_blocks(
        jpools, jnp.asarray(np.array([2, 3, 5, 0, 0], np.int32)))), 3)
    got = pc.payload_to_host(pc.export_blocks(tpools, [2, 3, 5]))
    assert pc.payload_nbytes(got) == jpc.payload_nbytes(want)
    for (gk, gv), (wk, wv) in zip(got, want):
        for g, w in ((gk, wk), (gv, wv)):
            if dtype == "int8":
                np.testing.assert_array_equal(g.data.numpy(), w.data)
                np.testing.assert_array_equal(g.scale.numpy(), w.scale)
            else:
                np.testing.assert_array_equal(g.numpy(), w)


# -------------------------------------------------------------- the engine


def _shared_prefix_prompts(rng, vocab=128, prefix_len=24, tails=(5, 9, 3)):
    sysp = rng.randint(1, vocab, (prefix_len,))
    return [np.concatenate([sysp, rng.randint(1, vocab, (t,))])
            for t in tails]


def _twice(eng, prompts, new):
    out = eng.serve([p.copy() for p in prompts], max_new_tokens=new)
    out += eng.serve([p.copy() for p in prompts], max_new_tokens=new)
    st = eng.stats()
    assert eng.shutdown()
    return out, st


def _motif_prompts(rng):
    pattern = rng.randint(1, 128, (8,))
    sysp = np.tile(pattern, 3)              # repetitive: drafts hit
    return [np.concatenate([sysp, rng.randint(1, 128, (t,))])
            for t in (4, 7)]


ENGINE_CASES = {
    # fixture, engine config, prompts, new tokens (the reference's
    # test_prefix_reuse_and_exactness_shared_system_prompt,
    # test_prefix_exactness_gpt, _int8 and _with_speculative)
    "llama": ("llama", {}, 0, 6),
    "gpt": ("gpt", {}, 2, 4),
    "int8": ("llama", dict(kv_cache_dtype="int8"), 9, 4),
    "ngram": ("llama", dict(num_speculative_tokens=3), "motif", 8),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_shared_prefix_reuse_matches_reference(request, case):
    fixture, kw, seed, new = ENGINE_CASES[case]
    pair = request.getfixturevalue(fixture)
    vocab = pair[0].config.vocab_size
    prompts = _motif_prompts(np.random.RandomState(4)) if seed == "motif" \
        else _shared_prefix_prompts(np.random.RandomState(seed), vocab)
    jeng, eng = _engines(pair, **kw)
    want, st_want = _twice(jeng, prompts, new)
    got, st = _twice(eng, prompts, new)
    _, cold_eng = _engines(pair, enable_prefix_cache=False, **kw)
    cold, st_cold = _twice(cold_eng, prompts, new)
    _assert_equal(want, got, f"{case} port vs reference")
    _assert_equal(cold, got, f"{case} cache on vs off")
    _assert_counters(st, st_want)
    assert st["prefix_blocks_reused"] > 0 and st["prefix_tokens_reused"] > 0
    assert 0.0 < st["prefix_hit_rate"] < 1.0 and st["cached_blocks"] > 0
    assert st["prefix_cache_enabled"] is True
    assert st_cold["prefix_tokens_reused"] == 0
    assert st_cold["prefix_cache_enabled"] is False
    assert st_cold["cached_blocks"] == 0
    if case == "ngram":
        keys = ("spec_tokens_proposed", "spec_tokens_accepted")
        assert {k: st[k] for k in keys} == {k: st_want[k] for k in keys}


def test_full_prompt_hit_copies_and_keeps_the_published_bytes(llama):
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 128, (16,))         # two full blocks
    jeng, eng = _engines(llama, num_slots=1)
    (r1,) = eng.serve([prompt.copy()], max_new_tokens=4)
    assert eng.stats()["cow_copies"] == 0
    shared = [eng._alloc.lookup(h)
              for h in pc.chain_hashes(eng._fp, prompt, eng._bs)]
    assert all(b is not None for b in shared)
    ptrs = [t.data_ptr() for t in _tensors(eng._pools)]
    before = [t[shared].clone() for t in _tensors(eng._pools)]
    (r2,) = eng.serve([prompt.copy()], max_new_tokens=4)
    st = eng.stats()
    assert eng.shutdown()
    want = jeng.serve([prompt.copy()] * 1, max_new_tokens=4)
    want += jeng.serve([prompt.copy()], max_new_tokens=4)
    st_want = jeng.stats()
    _assert_equal(want, [r1, r2], "full-prompt hit port vs reference")
    _assert_counters(st, st_want)
    assert st["cow_copies"] == 1 and st["prefix_tokens_reused"] == 15
    for a, t in zip(before, _tensors(eng._pools)):
        assert torch.equal(a, t[shared])
    # the copy and every other pool write land in place
    assert [t.data_ptr() for t in _tensors(eng._pools)] == ptrs


def test_eviction_under_pressure_matches_reference(llama):
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 128, (17,)) for _ in range(6)]
    kw = dict(num_slots=1, max_model_len=48, num_blocks=9)
    jeng, eng = _engines(llama, **kw)
    got = [eng.serve([p.copy()], max_new_tokens=4)[0] for p in prompts]
    want = [jeng.serve([p.copy()], max_new_tokens=4)[0] for p in prompts]
    st, st_want = eng.stats(), jeng.stats()
    assert eng.shutdown()
    _assert_equal(want, got, "eviction port vs reference")
    _assert_counters(st, st_want)
    assert st["cache_evictions"] > 0 and st["requests_completed"] == 6
    assert st["free_blocks"] == 8 and st["reserved_blocks"] == 0


def test_scheduler_property_with_prefix_cache(llama):
    """Shared prefixes under slot and block pressure: every request once,
    streamed == returned, the reference's tokens, the pool drained."""
    ref, port = llama
    rng = np.random.RandomState(1)
    sysp = rng.randint(1, 128, (16,))
    lens, news = [3, 18, 6, 17, 20, 2, 19, 5], [4, 7, 1, 5, 3, 8, 2, 6]
    prompts = [np.concatenate([sysp, rng.randint(1, 128, (n,))])
               if n >= 16 else rng.randint(1, 128, (n,)) for n in lens]
    kw = dict(num_slots=2, block_size=8, max_model_len=48, num_blocks=15,
              prefill_chunk=8)
    streamed = {}
    eng = ServingEngine(port, ServingConfig(**kw), device="cpu",
                        stream_callback=lambda rid, t: streamed.setdefault(
                            rid, []).append(t))
    jeng = JaxServingEngine(ref, JaxServingConfig(**kw, **REF_ONLY))
    rids = [eng.submit(p.copy(), mn) for p, mn in zip(prompts, news)]
    jrids = [jeng.submit(p.copy(), mn) for p, mn in zip(prompts, news)]
    done, jdone = eng.run(), jeng.run()
    st, st_want = eng.stats(), jeng.stats()
    assert eng.shutdown()
    _assert_equal([jdone[r] for r in jrids], [done[r] for r in rids],
                  "scheduler property port vs reference")
    _assert_counters(st, st_want)
    for rid, mn in zip(rids, news):
        assert 1 <= len(done[rid]) <= mn
        assert streamed[rid] == list(done[rid])
    assert st["active"] == 0 and st["queued"] == 0
    assert st["free_blocks"] == 14


def test_published_overlap_and_purge(llama):
    rng = np.random.RandomState(7)
    prompt = rng.randint(1, 128, (30,))
    jeng, eng = _engines(llama)
    for e in (eng, jeng):
        e.serve([prompt.copy()], max_new_tokens=3)
    hashes = list(pc.prompt_block_hashes(eng._fp, prompt, eng._bs))
    jhashes = list(jpc.prompt_block_hashes(jeng._fp, prompt, jeng._bs))
    assert eng.published_overlap(hashes) == \
        jeng.published_overlap(jhashes) == 3
    assert eng.purge_published() == jeng.purge_published()
    assert eng.published_overlap(hashes) == 0
    assert eng.stats()["cached_blocks"] == 0
    assert eng.shutdown()
    _, off = _engines(llama, enable_prefix_cache=False)
    assert off.published_overlap(hashes) == 0
