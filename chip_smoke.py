#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` (nvcc, one
   process per source, all at once);
2. hold each kernel against its plain PyTorch version in bfloat16 and
   float32 — the serving kernels at the serving path's shapes
   (Llama-3-8B widths; K3a / K3b also at Qwen2-7B's with q/k/v biases
   and at GPT's defaults with LayerNorm + beta + bias and tanh-gelu +
   bias, each case also row by row, Llama's and GPT's also at a pure
   decode tick's 8 rows and generate()'s 4, each case's bf16 body
   logged), the ragged kernel at two ticks of 8
   slots with contexts up to 2048 (7 decode rows + a 128-row prefill
   chunk, and one row a slot), the paged decode / verify kernels at
   phase 7's (4 slots, 32 / 8 heads, D 128, tables of 37 blocks,
   contexts 513..576, a window of 5) and at 8 slots with contexts up to
   2048, each also row by row and timed cold (pools copied past the L2,
   taken in turn), the flash-attention forward / dq / dk-dv kernels at
   the training run's shape (B 2, L 4096, 32 / 8 heads, D 128), the
   ragged, decode and verify kernels again at the MoE families' GQA
   groups (16 / 16 and 28 / 4 heads, timed too), the MoE grouped matmuls
   (K4's gather + swiglu and scatter modes, K5's gmm) at the
   DeepSeek-MoE-16B decode and prefill ticks, at Qwen2-57B-A14B's widths
   and at edge routings, and the MoE backward's modes (K4's transposed
   gather and scatter, K5's d(lhs) and tgmm) at the phase-12 training
   shape (2 x 4096 tokens, top-6), at Qwen2-57B widths (4096 tokens,
   top-8) and at the edge routings, with the four forward modes (K4's
   gather + swiglu, scatter and the recompute's gather gmm, K5's gmm)
   held on the same rows (the Hopper body at these widths) and timed at
   both training shapes beside their bound, ``torch._grouped_mm`` and
   the K4 modes' composites, and the FlashMask forward / dq / dk-dv
   kernels (K6) at Llama-3-8B's attention heads (B 1, L 4096, 32 / 8
   heads, D 128) under five masks: (a) 8 unequal documents, causal, (b)
   two bounds per query head, (c) half the rows hidden everywhere (o, dq
   exactly 0, lse NEG_INF there), (d) nothing hidden beyond causal
   (equal to K1 causal), (e) a 4000-token tail at 8 / 4 heads, D 64 —
   and time kernel, plain version and a PyTorch library yardstick with
   CUDA events (K6 on mask (a), against SDPA with the dense boolean mask
   and K1 causal); and the ragged, decode and verify kernels again on
   int8 pools (``QuantKV``: int8 pages, a float32 scale a position and
   kv head) at both ticks, phase 7's shape and both MoE GQA groups,
   float32 (the FMA bodies) and bfloat16 (the Hopper body's int8 mode),
   timed cold beside a bound of 2 x (D + 4) bytes a position-head; and
   K2v's token-tree mode at phase 7's shape, fp and int8 pools, GQA
   groups 4, 1 and 7: the branching tree (0, 0, 1, 2, 3, 4, 5) (T 8)
   against the plain version's tree mask, the chain (0, 1, 2, 3) equal to
   linear K2v bit for bit, timed cold beside linear K2v at T 8; and K2r's
   per-slot tree mode at a speculating tick (8 slots: 7 flagged T 8
   windows at contexts up to 2048 and an unflagged 128-row prefill
   chunk), bf16 and float32, fp and int8 pools, GQA groups 4, 1 and 7:
   the branching tree against the plain version's mask, the chain of T 8
   equal to linear K2r bit for bit, timed cold beside linear K2r on the
   same tick; and the K2 kernels with a bfloat16 query over float32 pools
   (GPT's serving mode, ``*_f32pool``) at phase 18's shapes (16 / 16
   heads, D 64): K2r at a serving tick, a decode tick and a tree tick,
   K2d, K2v and K2v's tree mode at its ``generate()`` shape, each against
   its plain version and against the float32 kernel on the widened query
   (within one bf16 ulp, under 2 % of outputs differing), timed cold; and
   K1 at GPT's training shape (B 8, L 1024, 16 / 16 heads, D 64) in both
   dtypes; and K4's float32 gather and scatter modes as the LoRA delta
   calls them (``lora_gmm``, ``lora_scatter_gmm``) at a 136-row tick of
   d 4096 over 9 adapter groups at rank 16, to 4096 and 1024 columns,
   and at the edges (every row in the null group, a group of one row,
   rank 4 in stacks padded to 8, the pure tick's 8 rows, 3 groups, a
   128-row chunk in one group, rank 64 and rank 72 on either side of the
   float32 bodies' bound; the body each call takes is logged), against
   their plain versions and the reference's einsum, a row's delta the
   same alone as in the batch, timed cold beside the reference's
   fallback (a per-row gather of the stacks and an einsum);
3. serve 10 requests (prompts of 64..1024 tokens, 32 new tokens each,
   greedy) through ``ServingEngine`` on a Llama-3-8B-width model in
   bfloat16 with seeded random weights, counting kernel launches (every
   tick replays a CUDA graph; ticks with prefill rows at the static
   width), then profile 4 ticks of a second wave, ticks with prefill rows
   (wall and device ms a tick, idle share, host scalar reads a tick) and
   4 pure ticks of a third;
4. serve a short float32 run at reduced depth twice — through the
   kernels and through their plain versions — and compare the first
   tick's logits and the token streams (a divergence fails unless the
   top-2 logit margin of the agreed context, read by a dense forward,
   is under the logits tolerance);
5. train a Llama-3-8B-width model cut to 4 layers in bfloat16 through
   ``TrainStep`` + ``AdamW(1e-4, multi_precision=True)`` on batches of
   2 x 4096 tokens from a seeded 4-batch pool: 2 untimed steps, 5 timed
   ones (tokens/s, ms per step, MFU, peak memory, every loss) and 3
   under ``torch.profiler`` (one to start it, two read), counting kernel
   launches;
6. one float32 forward + backward of a 2-layer full-width model on 1 x
   1024 tokens through the kernels and through their plain versions:
   the loss and every parameter's gradient compared;
7. ``generate()`` on Llama-3-8B (32 layers, bfloat16, seeded weights):
   4 prompts of 512 tokens, each repeating a seeded 64-token motif among
   random tokens, 64 new tokens greedy, five times — the dense cache,
   the paged cache (K2d), n-gram speculation at gamma 4 (K2v), a
   2-layer Llama-3-8B-width draft model at gamma 4 (K2d and K2v), the
   model drafting for itself at gamma 4, whose windows must accept
   drafts, and tree speculation (K2v's tree mode) with the chain
   (0, 1, 2, 3), whose stream and tokens per verify must equal the n-gram
   run's, and the branching tree (0, 0, 1, 2, 3, 4, 5) at gamma 7, whose
   stream is held against the paged one by the near-tie rule below —
   printing tokens/s, ms per target forward, tokens emitted per
   verify and peak memory, then a torch.profiler table and the device's
   idle share of one more paged run of 16 tokens; each bf16 stream is
   compared with the dense one (logged: where it first differs and the
   top-2 margin there), and the self-drafted stream is held against the
   paged one (a divergence fails unless its top-2 margin is within the
   largest logit difference of two bf16 recipes, read on the prompts);
8. float32, 2 layers at full widths: paged and speculative greedy
   ``generate()`` (n-gram drafts, the model drafting for itself so
   that drafts are accepted, and the branching tree) through the kernels
   and through their plain versions; the token streams must be equal (the
   same margin rule as phase 4), the scores agree within SCORE_ATOL, and
   the self-drafted run must emit more than one token per verify window;
   then two hand-built tree verifies whose windows make the accepted path
   leave the spine (and, second, take the whole chain): the emitted
   tokens, the pools equal to the window's rows moved by the path, and
   to sequential decoding's where rope positions allow;
9. DeepSeek-MoE-16B (all 28 layers, bfloat16, dropless, seeded weights)
   serves phase 3's traffic (K2r and K4 must launch; tokens/s, TTFT,
   ticks, rows a tick, peak memory, the engine's MoE stats), is profiled
   over 4 ticks (its host scalar reads a tick may not exceed the Llama
   engine's), then runs ``generate()`` on 4 motif prompts of 512 tokens,
   32 new, dense, paged (K2d + K4) and n-gram at gamma 4 (K2v + K4);
10. float32 DeepSeek-MoE at full widths cut to 3 layers: the engine's
    first-tick logits and streams and paged ``generate()``'s streams
    and scores, kernels vs plain versions, and the sorted path
    (``moe_fused_gmm=False``, K5's gmm) vs the fused one (K4);
11. Qwen2-MoE at Qwen2-57B-A14B widths cut to 4 layers (bfloat16,
    dropless) serves 4 requests on the fused path (K2r at GQA group 7,
    biased q/k/v, K4 at d 3584 / top-8) and on the sorted path (K5);
12. MoE training in bfloat16 through ``TrainStep`` + ``AdamW(1e-4,
    multi_precision=True)``: DeepSeek-MoE-16B widths cut to 4 layers
    (1 dense + 3 MoE, dropless) on batches of 2 x 4096 tokens, 2
    untimed steps, 5 timed (ms per step, trained tokens/s, MFU over
    active parameters, peak memory, every loss) and 3 under
    ``torch.profiler``, each K4 mode, the backward's kernels and K1
    launching the count the layers imply; then 2 steps of the same model
    on the sorted path (K5), and 2 steps of Qwen2-57B-A14B widths cut to
    one layer, capacity-routed, on 1 x 4096 tokens (its drop rates read
    first);
13. float32 DeepSeek-MoE at full widths cut to 3 layers, one forward +
    backward on 1 x 1024 tokens: the loss and every gradient through the
    kernels against the plain versions, and the fused path against the
    sorted one; every routed expert that received pairs must have a
    gradient;
14. dense Qwen2-7B (all 28 layers, bfloat16, seeded weights, q/k/v
    biases) serves phase 3's traffic through the fused decode tick (K3a
    and K3b must launch twice a layer a tick: tokens/s, TTFT, idle share
    over 4 profiled ticks), then a 2-layer float32 model at Qwen2-7B
    widths is served through the kernels and through their plain
    versions (phase 4's rule);
15. ``nn.functional.flashmask_attention`` forward + backward in bfloat16
    on one 16384-token row of 8 equal documents, causal, at Llama-3-8B's
    attention heads (32 / 8, D 128): K6f, K6dq and K6dkv launch once
    each and K1 never, q / k / v get finite nonzero gradients, and the
    output and gradients equal K1 causal run document by document and
    the plain K6 passes (the lse too);
    then fwd + bwd ms of K6 and of K1 causal over the whole row, their
    ratio, the kernels alone, and peak memory; then
    ``scaled_dot_product_attention`` with a boolean mask and dropout
    at a small shape (undropped output vs the plain composition, the
    dropped share within 4 sigma of p, two seeded runs equal);
16. int8 KV pools: phase 3's engine and traffic (Llama-3-8B, 32 layers,
    bf16, phase 3's seeded weights) with ``kv_cache_dtype="int8"``
    (K2r's int8 mode must launch: tokens/s, TTFT, ticks, rows a tick,
    the idle share of 4 profiled ticks, pool bytes at most 0.55x the
    bf16 engine's, each stream's match with phase 3's, its first
    divergence and top-2 margin logged), ``generate()`` at phase 7's
    shape on int8 pools, paged (K2d), n-gram (K2v) and the branching tree
    (K2v's tree mode), and a 2-layer float32 model at full widths on int8
    pools, paged, self-drafted and tree ``generate()`` and the engine
    through the kernels and through their plain versions (phase 4's
    rule);
17. speculative decoding in the engine: phase 3's model, weights and
    traffic served five times — linear n-gram at gamma 4 (K2r), the
    model drafting for itself at gamma 4 (K2r and K2d; the mean accepted
    length must exceed 1; 4 profiled ticks: device time, idle share),
    the chain tree (0, 1, 2, 3) (stream and tokens a verify equal to the
    n-gram run's; K2r's tree mode), the branching tree at gamma 7, and
    draft heads (seeded float32 weights) on the depth-2 tree (0, 0, 1,
    1) — each with tokens/s, TTFT, ticks, rows a tick, accepted length,
    acceptance rate and peak memory, each stream held against phase 3's
    by phase 7's near-tie rule; the branching tree on int8 pools (K2r's
    tree mode on int8 pools); then 2 float32 layers at full widths served
    linear, self-drafted, tree and heads through the kernels and through
    their plain versions (phase 4's rule);
18. GPT at ``GPTConfig()``'s widths and all 24 layers (354.9 M
    parameters, seeded weights cast to bf16, float32 pools as the
    reference's): (a) the fused engine serves phase 3's traffic with
    prompts cut to 960 tokens (K3a ``ln``, K3b ``act=None`` and
    ``gelu_tanh`` twice a layer a tick, K2r's ``_f32pool`` mode a layer a
    tick; tokens/s, TTFT, ticks, rows a tick, idle share, host scalar
    reads and K2r's share of the device time over 4 profiled ticks, in
    which no separate split-merge kernel may run, K3's device ms a tick
    by kernel over those mixed ticks and over 4 profiled pure ticks,
    peak memory), its
    streams held against the unfused engine and the engine through the
    plain versions by the bf16 near-tie rule; (b) the same on int8 pools
    (K2r's int8 instance at D 64; pool bytes against the float32 pools');
    (c) the model drafting for itself at gamma 4 and the chain tree in
    the engine; (d) ``generate()`` on 4 motif prompts of 512, 64 new:
    paged, n-gram and the chain tree (K2d, K2v and K2v's tree mode in the
    new mode); (e)
    ``TrainStep`` + AdamW on 8 x 1024 tokens with dropout 0.1 (ms a step,
    tokens/s, MFU, idle share, peak memory, K1 at D 64 a layer a step,
    falling losses), then 2 float32 layers' loss and gradients through K1
    against its plain versions; the phase's seconds;
19. CUDA graphs and the async pipeline (on the models of phases 3, 7, 9
    and 18, while they are loaded): (a) two engines stepped in lockstep,
    one replaying every tick from CUDA graphs, one running every tick
    eagerly at the same widths, on 4 prompts of 300 tokens (three
    128-row chunks each) submitted 3 ticks apart, 16 new: Llama-3-8B (32
    layers, bf16), the same on int8 pools and drafting for itself at
    gamma 4, DeepSeek-MoE-16B and GPT on float32 pools; every tick's
    tokens and logits and, (c), the launch counts it adds, and the pools
    at the end, equal to the bit, and at least one replay of a pure
    tick's graph and one of a mixed tick's (prefill rows, at the static
    width); (b) phase 3's engine with ``async_depth=1`` serves phase 3's
    traffic twice (the published blocks purged before each wave, so the
    second prefills as the first): streams equal to phase 3's token for
    token, no graph
    captured in the second wave, tokens/s, TTFT, ticks, pure ticks,
    pipeline flushes, host gap p50 / p99 and graphs logged, and 4
    profiled pure ticks (wall ms, idle share) beside phase 3's; (d)
    phase 7's paged, n-gram, self-drafted and tree ``generate()`` runs
    (steps replayed from graphs) again with every step eager: tokens,
    scores and launch counts equal to the bit, ms a target forward of
    both logged;
20. the prefix cache, preemption with the host KV tier and the request
    lifecycle on phase 3's model (Llama-3-8B, 32 layers, bf16, phase 3's
    weights): (a) 8 slots, two waves of 8 requests, each one of two
    1024-token system prompts plus a distinct 64..512-token tail (the
    first of wave 2 exactly a system prompt: a full-prompt hit and its
    copy-on-write), 32 new, with the cache on and off: hit rate, tokens
    reused, copies, TTFT a wave, tokens/s, 4 profiled ticks with prefill
    rows (wall ms, idle share), the mixed graph not captured again in
    wave 2, streams on vs off held by the near-tie rule; (b) 4 slots, a
    4 GiB host tier: 4 priority-0 requests of 1024 tokens and 128 new,
    after 8 ticks 4 priority-2 ones of 256 and 32 new, resuming by swap,
    by recompute and by the cost model, against a never-preempted run on
    8 slots: preemptions, blocks spilled / restored, resumes by path,
    the transfer rate, TTFT by class, one 1024-token slot's export and
    import ms, every import's blocks equal to the bytes spilled; (c) one
    slot and a pool of two requests' blocks: A's published blocks
    evicted into the host tier by B and C, restored by D (A's prompt and
    a tail), held against a cold engine; (e) ``async_depth=1`` under
    (b)'s storm and under a cancel mid-pipeline, token for token equal
    to the synchronous engine; (d) (a)-(c) in float32 at 2 layers through
    the kernels and through their plain versions (phase 4's rule), the
    published blocks unchanged by wave 2's copy;
21. batched multi-LoRA serving (run after phase 19, on phase 3's model):
    (b) bf16, 32 layers, adapters 1-4 on ``attn`` targets at rank 16
    (``LORA_SCALE``) over two resident rows: phase 3's traffic under
    adapters (1, 2, base) then (3, 4, base), each wave on the LoRA engine
    and on a LoRA-off one in turns (A B B A): tokens/s, TTFT, ms a tick,
    graphs equal in number (churn captures none), swaps, the base riders'
    streams by the near-tie rule; adapter 3 reloaded while resident and
    wave 2 again (replays only: its streams move, the others stay to the
    bit); 4 profiled ticks of the LoRA engine and of the LoRA-off one
    (K4's float32 bodies by name, and the LoRA tick's device ms beyond
    the LoRA-off tick's by kernel); one prompt under adapters 1-4 and
    none (five continuations); graphed ticks equal to eager ones bit for
    bit across a reload mid-run;
    (a) float32 at Llama-3-8B widths, 2 layers: ``attn`` and ``all``
    targets at rank 16, rank 4, ``lora_quant``, a batch of five requests
    (adapters 1, 2, 3, base riders) equal to each request served alone,
    and the kernels against K4's plain versions (phase 4's rule under each
    stream's adapter); (c) GPT at ``GPTConfig()``'s widths, 2 layers,
    float32, ``qkv_proj`` / ``out_proj`` adapters, batched equal to solo;
22. the monitor modules on the graphed tick (run after phase 21, on phase
    3's model and traffic): (a) telemetry on (tracing and health, the
    defaults) against off (``health=False``, ``PADDLE_TPU_TRACE=0``) in
    turns A B B A, a fresh engine a run: streams equal bit for bit, graphs
    equal in number, each run's tokens/s, TTFT, ms a pure tick (16 timed)
    and host gap; (b) ``stats()['roofline']`` of every captured layout
    (counted FLOPs and bytes over the measured tick: step_mfu,
    step_hbm_bw_util; a pure layout's bytes within 2x of the weights') and
    ``kernel_census()`` (graph nodes by type, kernel nodes and their
    symbols, the hand-written kernels a replay launches: K3a / K3b twice a
    layer, K2r once), and the registry's ``serving_*`` samples; (c)
    ``dump_trace`` (the documented tids) and ``profile(4)`` (a
    torch.profiler trace under ``build/phase22`` in which K3's and K2r's
    kernels appear by name); (d) a float32 2-layer engine at Llama-3-8B
    widths with an LM-head column at inf fires ``nonfinite_logits`` and
    captures no graph more than a clean one;
23. the per-width engine (``ragged_batch=False``, run after phase 22, on
    phase 3's model and traffic): synchronous chunk steps, interleaved
    chunks (``max_prefill_chunks_per_step=1``), bucketed prefill
    (``chunked_prefill=False``) and n-gram speculation at gamma 4, each
    replaying its steps from CUDA graphs (K3a / K3b around K2d, K2v at
    T = 128 for the chunks and at gamma + 1 for the verify must launch)
    and again through the plain versions (graphs off), the streams held
    by the near-tie rule against each other and against the ragged
    engine of phase 3's config, served before and after them; each run's
    tokens/s, TTFT, ms a decode tick and graphs captured, with the card
    (phase 2 holds K2v's chunk window at 1 slot x 128 rows, contexts 5,
    16 and 1029, on bfloat16, int8 and float32 pools and a bfloat16 q
    over float32 pools at GPT's 16 / 16 heads of 64, timed beside K2r on
    the same rows);
24. beam search on phase 3's model (run after phase 23): greedy and
    one-beam ``beam_search`` give the same tokens; ``beam_search`` with
    4 beams and ``group_beam_search`` with 4 beams in 2 groups at
    diversity 0.5, 2 prompts x 512 tokens, 64 new, on the dense cache
    (ms a beam step, tokens/s); each beam score against the summed
    log-probabilities of a dense forward over its sequence over the
    length penalty (BEAM_SCORE_RTOL; a group beam's score, which carries
    the diversity penalty, at most that); an ``export_generation`` ->
    ``load_generation`` round trip of a 2-layer cut at full widths gives
    ``generate()``'s tokens;
25. activation recompute at Llama-3-8B widths, 2 x 4096 tokens, bf16:
    4 layers' loss and every gradient with ``recompute=True`` against
    ``recompute=False`` (bitwise, else GRAD_RTOL), K1f launching twice a
    layer; ms/step, MFU and peak memory of ``TrainStep`` + AdamW with
    recompute off, on and at interval 2; then the most layers the card's
    memory holds under recompute, reckoned from the 4-layer peak; one
    DeepSeek-MoE-16B-width layer pair's loss and gradients with recompute
    against without (K4's forward modes launching twice);
26. the optimizers on GPT at ``GPTConfig()``'s widths (phase 18's
    model, bf16, 8 x 1024 tokens): three ``TrainStep`` steps of each of
    the twelve optimizers on one batch, the loss finite and the last
    under the first (Adagrad's second step rises: its first steps are
    lr-sized in every coordinate); AdamW's
    ``state_dict`` -> ``set_state_dict`` round trip continuing the
    trajectory bit for bit; ``step_report``'s counted FLOPs a token
    against bench.py's analytic 6N + 12 L s h (within OPT_FLOPS_FACTOR)
    and ``analytic_mfu``;
27. BERT-base MLM + NSP pretraining (``BertForPretraining(BertConfig())``,
    float32 parameters, nothing cut) on B 32 x L 512 seeded batches with
    15 % MLM masking and no attention mask, so each layer's attention is
    K1 non-causal at D 64: under ``amp.auto_cast`` O1 (bf16) with a
    ``GradScaler`` and the example's AdamW recipe (2 untimed, 5 timed, 2
    profiled steps), then under ``amp.decorate`` O2 (bf16 parameters,
    float32 master weights); ms a step, tokens/s, MFU, peak memory, every
    loss; K1f / K1dq / K1dkv 12 launches a step (phase 2 holds K1's
    non-causal mode at these shapes, at L 128, and with fewer query rows
    than keys);
28. BERT-base SST-2-shaped classification at B 32 x L 128, sentences of
    8-66 tokens padded: inference with the bool padding mask (the plain
    biased attention, 0 K1 launches) against the same batch unmasked (K1
    at L 128), sentences/s each; 20 O1 fine-tune steps whose last loss is
    under the first; a 2-layer f32 BERT-base-width model's loss and every
    gradient through the kernels against their plain versions;
29. BASELINE config 1, the canonical drive through ``paddle.Model``:
    ``seed(42)``, LeNet, Adam(1e-3), cross-entropy and ``Accuracy``,
    ``fit`` over 2048 MNIST images (the seeded synthetic set) at batch
    128 for 3 epochs, ``evaluate`` on 512 (acc > 0.9), ``predict``
    (512 x 10); images/s of each;
30. BASELINE config 2, ResNet-50 at ImageNet width
    (``resnet50(num_classes=1000)``, 224 x 224 x 3, NCHW, 64 images a
    step, PaddleClas ResNet50.yaml's per-card batch; Momentum(0.1, 0.9,
    L2Decay(1e-4))): ``TrainStep`` under AMP O1 (bf16) on one fixed
    batch, 2 warm, 5 timed and 2 profiled steps: ms a step, images/s,
    MFU (the step's counted FLOPs, and 3 x the forward's conv and linear
    FLOPs, over 989.4 TFLOP/s), peak memory, idle share, the top device
    operations; the last of its 11 losses under the first; then
    ``Model.fit`` over 8 batches of 64 Flowers images through the
    ``DataLoader`` and ``Model.predict`` at 64 a batch, images/s each;
31. the card held against the CPU: one float32 ``TrainStep`` (TF32 off)
    of ResNet-50 at 4 x 3 x 64 x 64 and of LeNet at 8 x 1 x 28 x 28 from
    the same weights and batch, on each and in float64 on the CPU; the
    loss, the gradients of the stem conv, the head and a batch norm's
    weight and the running statistics: the card's float32 error against
    float64 within ``VISION_CARD_CPU`` of the CPU's. The vision phases
    launch no hand-written kernel (their counts are printed, all 0);
32. print the kernels line, the card's name and power limit, and the
    result line ``{"ok": true, "device": {...}}`` last.

Each path (phases 3, 5, each run of phases 7 and 9, both runs of phase
11, the three runs of phase 12, phase 14, phase 15, each run of phases
16, 17 and 18, both waves of phase 19 (b), each run of phase 20 (a)-(c)
and (e) in bf16, each LoRA run and batch of phase 21, each run of phase
22 (a), each kernel run of phase 23, each run of phases 24, 25, 26 and
27, and phase 28's inference and fine-tune runs) runs with every
launch count set to 0
just before it and read just after; a kernel of the path that never
launched fails the run. Any
failed comparison or exception exits non-zero before the result line.
Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result. ``--layers`` cuts phase 3's depth (widths stay full);
``--kernels-only`` stops after phase 2.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import weakref
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989.4e12,  # dense tensor-core bf16
              "float32": 67e12}      # float32 outside the tensor cores
TOL = {"bfloat16": dict(atol=3e-2, rtol=2e-2),
       "float32": dict(atol=1e-4, rtol=1e-4)}
# K1 outputs are also held row by row, scale-free: the largest over rows
# of ||kernel - plain|| / ||plain||. A kernel that drops one 64-column kv
# tile (or q tile, for dk/dv) moves the rows it touches by 10 % or more,
# a causal edge off by one column the early rows by more; the lse, a log,
# is held absolutely (one column in 4096 moves it by 2.4e-4). The limits
# are about 4x and 24x the largest readings of the sound kernels at the
# training shape on an H100 (bf16 5.0e-3, float32 4.2e-6).
ROW_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_ATOL = 1e-4
LOGITS_ATOL = 2e-3                   # f32 kernel path vs plain path
# the K2 kernels' bf16-q-over-f32-pool mode against the float32 kernel on
# the widened q, rounded: the share of outputs that may differ (each by
# one bf16 ulp at most). The hi + lo recipe is ~2^-16 relative before the
# output's 2^-8 rounding, so well under 1 % of roundings land apart;
# rounding K, V or P to bf16 once moves most of them.
F32POOL_DIFFER = 0.02
# phase 8: summed log-probabilities of 32 greedy tokens, kernel vs plain
# path (each logit within LOGITS_ATOL moves a log-softmax by at most
# twice that; the sum over 32 tokens of such errors, far below it)
SCORE_ATOL = 1e-2
SEED = 0
REQUESTS = 10                        # phase 3
TICK_WINDOW = 4                      # engine ticks profiled in phases 3, 9
PHASE4_LAYERS = 2
SLEEP_CYCLES = 50_000_000            # ~25 ms of device time
ATTN = dict(B=2, L=4096, H=32, Hkv=8, D=128)   # phase 2's K1 shape
TRAIN = dict(layers=4, batch=2, seq=4096, warm=2, timed=5, profiled=2,
             pool=4)
PHASE6 = dict(layers=2, batch=1, seq=1024)
# phase 2's K2r ticks at each model's widths: head_dim D, tables of MB
# blocks of 16, the 8 slots' contexts (base + the rows) and two ticks'
# rows a slot; "prefill" (7 decode rows + a 128-row chunk) is the kernels
# line's. Llama-3-8B: contexts 65..2048; GPT: within its 1024 positions
RAGGED_TICKS = {"prefill": [1, 1, 1, 1, 1, 1, 1, 128], "decode": [1] * 8}
RAGGED = {"llama": dict(D=128, MB=128, ticks=RAGGED_TICKS,
                        base=[2047, 1500, 900, 300, 64, 1024, 1800, 512]),
          "gpt": dict(D=64, MB=64, ticks=RAGGED_TICKS,
                      base=[959, 700, 500, 300, 64, 900, 800, 512])}
# phase 2's K2d / K2v shapes. "generate" is the one phase 7 gives them:
# 4 slots of a 512-token prompt + 64 new tokens, tables of 37 blocks (the
# +gamma headroom), contexts 513..580 (windows included); it is timed for
# the kernels line. "long" holds them at 8 slots and contexts to 2048.
PAGED = {"generate": dict(S=4, MB=37, lens=[513, 528, 549, 576]),
         "long": dict(S=8, MB=130, lens=None)}
PAGED_T = 5                          # K2v's window: gamma 4 + 1
# phase 2's K2v chunk window: the per-width engine's chunk step (one slot,
# T = prefill_chunk rows at pend_pos + t), at contexts that start mid
# block, on a block boundary and deep in the table; timed at the last,
# beside K2r on the same 128 rows of one slot
CHUNK = dict(T=128, MB=80, lens=[5, 16, 1029])
# phase 23: the per-width engine on phase 3's model and traffic
PER_WIDTH = {"sync": dict(ragged_batch=False),
             "interleaved": dict(ragged_batch=False,
                                 max_prefill_chunks_per_step=1),
             "bucketed": dict(ragged_batch=False, chunked_prefill=False),
             "ngram": dict(ragged_batch=False, num_speculative_tokens=4)}
GENERATE = dict(batch=4, prompt=512, motif=64, new=64, gamma=4,
                draft_layers=2, profiled_new=16)
PHASE8 = dict(layers=2, batch=2, prompt=256, motif=32, new=32, gamma=4)
# phase 19 (d): the generate() runs of phase 7 held graphed against eager
GRAPHED_GENERATE = ("paged", "ngram", "self", "tree")
GRAD_RTOL = 1e-4      # phase 6: max |kernel - plain| / max |plain|
LOSS_RTOL = 1e-5      # phase 6: the loss
# phase 2's K3 cases at a prefill tick's rows: Llama-3-8B's (the kernels
# line's rows, as in earlier runs), Qwen2-7B's (q/k/v biases) and GPT's
# defaults (LayerNorm + beta + bias, tanh-gelu + bias;
# paddle_tpu/models/gpt.py:29-32); Llama's and GPT's also at a pure
# decode tick's 8 rows (one a slot) and generate()'s 4, and Llama's at
# phase 23's per-width steps: the n-gram verify step's 8 slots x
# (gamma 4 + 1) = 40 rows and the chunk step's prefill_chunk = 128
K3_ROWS = 136
K3_DECODE_ROWS = (8, 4)
PW_BASE = dict(num_slots=8, block_size=16, max_model_len=2048,
               prefill_chunk=128, max_new_tokens=32)
K3_PER_WIDTH_ROWS = (
    PW_BASE["num_slots"] * (PER_WIDTH["ngram"]["num_speculative_tokens"]
                            + 1), PW_BASE["prefill_chunk"])
K3A_CASES = {   # label: d, widths, kind, beta, biases
    "llama qkv": (4096, (4096, 1024, 1024), "rms", False, (False,) * 3),
    "llama gate/up": (4096, (14336, 14336), "rms", False, (False,) * 2),
    "qwen2 qkv": (3584, (3584, 512, 512), "rms", False, (True,) * 3),
    "qwen2 gate/up": (3584, (18944, 18944), "rms", False, (False,) * 2),
    "gpt qkv": (1024, (3072,), "ln", True, (True,)),
    "gpt fc1": (1024, (4096,), "ln", True, (True,))}
K3B_CASES = {   # label: K, N, act, bias
    "llama o_proj": (4096, 4096, None, False),
    "llama down": (14336, 4096, "swiglu", False),
    "qwen2 o_proj": (3584, 3584, None, False),
    "qwen2 down": (18944, 3584, "swiglu", False),
    "gpt out_proj": (1024, 1024, None, True),
    "gpt fc2": (4096, 1024, "gelu_tanh", True)}
K3_TABLE = {"norm_matmul": ("llama qkv", "llama gate/up"),
            "matmul_residual": ("llama o_proj", "llama down")}
SERVING_KERNELS = ("ragged_paged_attention", "norm_matmul",
                   "matmul_residual")
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                    "flash_attention_dkv")
GENERATE_KERNELS = ("paged_decode_attention", "paged_verify_attention",
                    "paged_verify_attention_tree")
# phase 16: the K2 kernels on int8 pools (their launches counted apart)
INT8_KERNELS = ("ragged_paged_attention_int8", "paged_decode_attention_int8",
                "paged_verify_attention_int8",
                "paged_verify_attention_tree_int8")
# K2v's tree mode (phases 2, 7, 8, 16): a chain at gamma 4 (the linear
# bound itself) and a branching tree at gamma 7 (spine 1-3-5-7, branch
# 2-4-6)
CHAIN_TREE = (0, 1, 2, 3)
BRANCH_TREE = (0, 0, 1, 2, 3, 4, 5)
# phase 2's K2r tree ticks: 7 slots verify a T 8 tree window (flagged),
# one carries a 128-row prefill chunk (unflagged), at contexts up to 2048
# (Llama-3-8B) or within GPT's 1024 positions; CHAIN7 is the chain of the
# same T
RAGGED_TREE = {
    "llama": dict(D=128, MB=128, q_lens=[8] * 7 + [128], flags=[1] * 7 + [0],
                  base=[2040, 1500, 900, 300, 64, 1024, 1800, 512]),
    "gpt": dict(D=64, MB=64, q_lens=[8] * 7 + [128], flags=[1] * 7 + [0],
                base=[1000, 700, 500, 300, 64, 900, 800, 512])}
CHAIN7 = tuple(range(7))
# phase 8's hand-built tree verifies: the accepted root paths (off the
# spine, and the whole chain)
TREE_PATHS = {BRANCH_TREE: (0, 2, 4, 6), CHAIN_TREE: (0, 1, 2, 3, 4)}
INT8_POOL_RATIO = 0.55               # int8 pool bytes / bf16's, at most
# phase 18: GPT at GPTConfig()'s widths and depth (24 layers, hidden 1024,
# 16 heads of 64, ffn 4096, vocab 50304, 1024 positions), bf16 weights over
# float32 pools. Serving: phase 3's engine settings and traffic, prompts
# cut to GPT_PROMPT_MAX so prompt + 32 new + a gamma-4 window fit the
# positions; generate(): GENERATE's 4 motif prompts of 512, 64 new;
# training: 8 x 1024 tokens, hidden dropout 0.1 (the config's).
GPT_HEADS = 16
GPT_PROMPT_MAX = 960
GPT_MAX_LEN = 1016                    # + gamma 4 = the 1024 positions
GPT_TRAIN = dict(batch=8, seq=1024, warm=2, timed=5, profiled=2)
GPT_GRAD = dict(layers=2, batch=1, seq=1024)
GPT_ATTN = dict(B=8, L=1024, H=16, Hkv=16, D=64)   # its K1 shape
GPT_SERVING_KERNELS = ("ragged_paged_attention_f32pool", "norm_matmul",
                       "matmul_residual")
F32POOL_KERNELS = ("ragged_paged_attention_f32pool",
                   "ragged_paged_attention_tree_f32pool",
                   "paged_decode_attention_f32pool",
                   "paged_verify_attention_f32pool",
                   "paged_verify_attention_tree_f32pool")
# phase 17: phase 3's engine speculating, each run with the kernels it
# must launch; the heads' depth-2 tree keeps its two float32 [4096,
# 128256] heads at 4.2 GB
SPEC_RUNS = {
    "ngram": (dict(num_speculative_tokens=4), ("ragged_paged_attention",)),
    # the draft loop runs the fused layer: K3a / K3b around its K2d steps
    "self": (dict(num_speculative_tokens=4, drafter="model"),
             ("ragged_paged_attention", "paged_decode_attention",
              "norm_matmul", "matmul_residual")),
    "chain": (dict(num_speculative_tokens=4, spec_tree=CHAIN_TREE),
              ("ragged_paged_attention_tree",)),
    "tree": (dict(num_speculative_tokens=7, spec_tree=BRANCH_TREE),
             ("ragged_paged_attention_tree",)),
    "heads": (dict(num_speculative_tokens=4, spec_tree=(0, 0, 1, 1),
                   drafter="heads"), ("ragged_paged_attention_tree",))}
SPEC_KERNELS = ("ragged_paged_attention_tree",
                "ragged_paged_attention_tree_int8")
# phase 24: beam search on phase 3's model
BEAM = dict(batch=2, prompt=512, new=64, beams=4, groups=2, diversity=0.5,
            length_penalty=1.0, export_layers=2)
BEAM_SCORE_RTOL = 1e-2   # bf16: cached decode vs one dense forward
# phase 25: recompute at Llama-3-8B widths (phase 5's batch) and a
# DeepSeek-MoE-16B-width layer pair (phase 12's config)
RECOMPUTE = dict(layers=4, batch=2, seq=4096, warm=1, timed=3, moe_layers=2,
                 mem_share=0.88)
# phase 26: the optimizers on GPT at GPTConfig()'s widths, each's rate
OPTIMIZERS = {"SGD": 0.3, "Momentum": 0.1, "Adagrad": 0.01, "Adam": 1e-4,
              "AdamW": 1e-4, "Adamax": 1e-4, "RMSProp": 1e-4,
              "Adadelta": 1.0, "Lamb": 1e-3, "NAdam": 1e-4, "RAdam": 1e-4,
              "LBFGS": 0.3}
OPT_BATCH = dict(batch=8, seq=1024, steps=3, timed=3)
OPT_FLOPS_FACTOR = (0.7, 1.3)    # counted / analytic FLOPs a token
# phase 2: K1 at BERT-base's attention (non-causal, 12 / 12 heads of 64):
# pretraining's 512 rows and the fine-tune's 128; then queries shorter
# than the keys, as cached decoding (one row) and cross-attention read
BERT_ATTN = {"pretrain": dict(B=32, L=512, H=12, Hkv=12, D=64),
             "finetune": dict(B=32, L=128, H=12, Hkv=12, D=64)}
BERT_CROSS = ((1, 37), (1, 200), (7, 200))          # (Lq, Lk)
# phase 27: BERT-base MLM + NSP pretraining, the example's recipe
BERT_PRETRAIN = dict(batch=32, seq=512, warm=2, timed=5, profiled=2,
                     pool=4, mlm=0.15, lr=1e-4, warmup=2)
BERT_MASK_ID, BERT_CLS_ID, BERT_SEP_ID = 103, 101, 102
# phase 28: SST-2-shaped fine-tune and inference, and the f32 parity check
BERT_SST2 = dict(batch=32, seq=128, lens=(8, 66), infer=10, steps=20,
                 lr=5e-5, warmup=2, pool=4)
BERT_GRAD = dict(layers=2, batch=4, seq=512)
# phase 29: the canonical LeNet drive (the verify skill's flow)
LENET = dict(seed=42, train=2048, test=512, batch=128, epochs=3, acc=0.9)
# phase 30: ResNet-50 at ImageNet width, PaddleClas ResNet50.yaml's
# per-card batch and optimizer; fit / predict over Flowers' 224 x 224
RESNET50 = dict(batch=64, size=224, classes=1000, warm=2, timed=5,
                profiled=2, lr=0.1, momentum=0.9, decay=1e-4,
                fit_batches=8)
# phase 31: (model, batch shape, classes) held card against CPU in
# float32, each anchored on a float64 run of the same step on the CPU: a
# tensor's error (max |x - x64| over max |x64|) on the card may be at
# most `factor` times the CPU's float32 error plus `floor`. A direct
# card-vs-CPU bound cannot hold ResNet-50: its stem conv's and first
# batch norm's gradients differ from float64 by ~2e-2 in float32 on the
# CPU itself (cancellation back through 53 batch norms, the last at 2 x
# 2 positions); the readings are in PERF.md (PR 28)
VISION_CASES = (("resnet50", (4, 3, 64, 64), 1000),
                ("lenet", (8, 1, 28, 28), 10))
VISION_CARD_CPU = dict(factor=4.0, floor=1e-5)
# phase 16, f32: the first layer's scales in two paths' pools (absmax /
# 127 of rows that agree within float32 rounding), relative
INT8_SCALE_RTOL = 1e-4
# phase 2's K4 / K5 shapes: the DeepSeek-MoE-16B decode tick (8 tokens x
# top-6) and 136-row prefill tick, and Qwen2-57B-A14B's widths; the edge
# routings run at the decode tick's widths; the prefill tick is timed for
# the kernels line
MOE = {"decode": dict(tokens=8, d=2048, f=1408, e=64, k=6),
       "prefill": dict(tokens=136, d=2048, f=1408, e=64, k=6),
       "qwen2": dict(tokens=136, d=3584, f=2560, e=64, k=8)}
MOE_EDGES = ("one", "sparse", "single")
MOE_EDGE_SHAPE = "decode"
MOE_TIMED = "prefill"
MOE_KERNELS = ("moe_gather_gmm_swiglu", "moe_scatter_gmm")
# phase 2's shapes of the MoE backward: the phase-12 training steps'
# (DeepSeek-MoE-16B at 2 x 4096 tokens, top-6) and Qwen2-57B widths at
# 4096 tokens, top-8; the edge routings run at DeepSeek widths on
# MOE_BWD_EDGE tokens; the DeepSeek shape is timed for the kernels line
MOE_BWD = {"deepseek_train": dict(tokens=8192, d=2048, f=1408, e=64, k=6),
           "qwen2_train": dict(tokens=4096, d=3584, f=2560, e=64, k=8)}
MOE_BWD_EDGE = 512
MOE_BWD_TIMED = "deepseek_train"
MOE_BWD_KERNELS = ("moe_gmm_t", "moe_scatter_gmm_t", "moe_tgmm")
# phase 2's attention checks at the MoE families' GQA groups: 1 and 7
MOE_HEADS = {"deepseek": (16, 16), "qwen2": (28, 4)}
MOE_GENERATE = dict(batch=4, prompt=512, motif=64, new=32, gamma=4)
MOE_F32 = dict(layers=3, batch=2, prompt=256, motif=32, new=16)
QWEN2 = dict(layers=4, requests=4, new=16)
# phase 12: MoE training in bf16 (DeepSeek-MoE-16B widths, then Qwen2-57B
# widths capacity-routed); phase 13: f32 gradients, kernels vs plain
MOE_TRAIN = dict(layers=4, batch=2, seq=4096, warm=2, timed=5, profiled=2,
                 pool=4, sorted_steps=2)
QWEN2_TRAIN = dict(layers=1, batch=1, seq=4096, steps=2)
MOE_GRAD = dict(layers=3, batch=1, seq=1024)
# phase 2's FlashMask shapes: Llama-3-8B's attention heads at L 4096, and
# a tail length at the reference bench's heads; phase 15's 16k row of 8
# equal documents (the reference bench's workload at Llama-3-8B's heads)
# and its small masked-SDPA check
FLASHMASK = dict(B=1, L=4096, H=32, Hkv=8, D=128)
FLASHMASK_TAIL = dict(B=1, L=4000, H=8, Hkv=4, D=64, Hm=4)
FLASHMASK_ROW = dict(B=1, L=16384, H=32, Hkv=8, D=128, docs=8)
SDPA_MASKED = dict(B=2, L=256, H=8, Hkv=2, D=64, p=0.1)
FLASHMASK_KERNELS = ("flashmask_fwd", "flashmask_dq", "flashmask_dkv")
# multi-LoRA (phases 2 and 21): the delta's K4 calls, counted apart from
# MoE's; phase 2 holds them at a 136-row tick of Llama-3-8B's width over
# max_adapters + 1 = 9 groups at rank 16, to q's / o's 4096 and k's / v's
# 1024 columns (the kernels line's: 4096), rows over five groups with the
# null one
LORA_KERNELS = ("lora_gmm", "lora_scatter_gmm")
LORA_TICK = dict(rows=136, d=4096, groups=9, rank=16, outs=(4096, 1024),
                 used=(0, 1, 3, 5, 8))
# phase 21: the adapters' weights are drawn N(0, LORA_SCALE): at d 4096 and
# rank 16 a delta's entries have a standard deviation of about 4096 ** 0.5
# * 16 ** 0.5 * LORA_SCALE ** 2 on unit-norm rows (0.64 here), half the
# base projection's (4096 ** 0.5 * 0.02 = 1.28), enough for distinct
# adapters to decode distinct continuations
LORA_SCALE = 0.05
LORA_RANK = 16
LORA_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
LORA_ALL = LORA_ATTN + ("gate_proj", "up_proj", "down_proj")
# (a) and (c): float32 at PHASE4_LAYERS layers, a mixed batch of five
# requests (adapters 1, 2, 3 and base riders) and each request alone
LORA_F32 = dict(num_slots=4, block_size=16, max_model_len=512,
                prefill_chunk=128, max_new_tokens=8)
LORA_F32_LENS = (40, 150, 70, 200, 90)
LORA_F32_AIDS = (1, 2, None, 3, None)


def log(*a):
    print(*a, flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=10, rounds=5, warmup=3):
    """Device time of one call: the median over ``rounds`` of CUDA-event
    time around ``reps`` back-to-back calls, divided by ``reps``. A sleep
    kernel queued first keeps the device busy while the host enqueues the
    calls, so host time between launches is not counted (a function that
    synchronises inside, like the plain attention's ``.tolist()``, still
    pays it). Inputs stay resident between calls: what fits in the 50 MB
    L2 is read warm."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return float(np.median(ts))


def bound(nbytes, flops, dtype):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def row_rel_err(got, ref):
    """Largest over rows (the last axis) of ||got - ref|| / ||ref||. A row
    whose reference norm is under a tenth of the median nonzero row's is
    measured against that tenth: such rows are cancellations (dq's first
    row is zero in exact arithmetic), whose rounding is not relative to
    them."""
    diff = (got.float() - ref.float()).norm(dim=-1)
    den = ref.float().norm(dim=-1)
    live = den[den > 0]     # rows no column reaches are zero
    den = den.clamp_min(0.1 * float(live.median()) if live.numel() else 1.0)
    return float((diff / den).max())


def held_attention(torch, got, ref, dtype, what, fails):
    """One kernel output (K1, K2d, K2v, K3, K4) against its plain version: an
    lse by LSE_ATOL, the others by TOL and ROW_RTOL. Logs the readings,
    appends a failure to ``fails`` (so every output is read before the
    run stops) and returns the max abs error."""
    g, r = got.float(), ref.float()
    err = float((g - r).abs().max())
    if what.endswith("lse"):
        ok = err <= LSE_ATOL
        note = f"(atol {LSE_ATOL})"
    else:
        rel = row_rel_err(g, r)
        close = torch.allclose(g, r, **TOL[dtype])
        ok = close and rel <= ROW_RTOL[dtype]
        note = (f"row_rel_err={rel:.3e} (limit {ROW_RTOL[dtype]}); "
                f"allclose(atol {TOL[dtype]['atol']}, rtol "
                f"{TOL[dtype]['rtol']}) {'ok' if close else 'FAIL'};")
    ok = ok and bool(torch.isfinite(g).all())
    log(f"  {what} [{dtype}] max_abs_err={err:.3e} {note} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append(what)
    return err


# ---------------------------------------------------------------- phase 2

def kv_pools(torch, g, shape, dt, int8, timing):
    """Random K/V pool pairs of ``shape`` [NB, BS, Hkv, D] in ``dt``, or
    int8 QuantKV pairs (random rows quantized as the write path does):
    one, or with ``timing`` enough copies to fill twice the 50 MB L2, so
    calls taken in turn read their K/V from device memory."""
    from paddle_tpu_torch.ops.paged_cache import QuantKV, kv_quantize
    nb, bs, hkv, d = shape
    pos_bytes = d + 4 if int8 else d * torch.finfo(dt).bits // 8
    copies = max(3, -(-int(100e6) // (2 * nb * bs * hkv * pos_bytes))) \
        if timing else 1
    pools = []
    for _ in range(copies):
        kv = [torch.randn(*shape, generator=g, device="cuda")
              for _ in range(2)]
        pools.append(tuple(QuantKV(*kv_quantize(x)) if int8 else x.to(dt)
                           for x in kv))
    return pools, pos_bytes


def k2_mode(torch, dtype, int8, f32pool):
    """A phase-2 K2 case's types: (q's dtype, the pools' dtype, the
    counter suffix, the bound's operation type). ``f32pool``: a bfloat16
    q over float32 pools (the ``*_f32pool`` mode, GPT's serving under a
    bfloat16 model; the recipe's operations are float32); ``int8``: int8
    pools."""
    dt = getattr(torch, dtype)
    if f32pool:
        assert dtype == "bfloat16" and not int8
        return dt, torch.float32, "_f32pool", "float32"
    return dt, dt, "_int8" if int8 else "", dtype


def held_f32pool(torch, got, wide, what, fails):
    """The ``*_f32pool`` mode (the Hopper body, K, V and P as bfloat16 hi
    + lo halves, ~2^-16 relative) against the float32 kernel's output on
    the widened q, rounded: every output within one bfloat16 ulp (at the
    larger of the two magnitudes and of 2^-8 of its row's largest: an
    output under that is a cancellation), and under F32POOL_DIFFER of them
    differing at all; logs the share that differs."""
    g, r = got.float(), wide.to(torch.bfloat16).float()
    # the ulp of the larger of the two, and at least of 2^-8 of the row's
    # largest (a cancellation: rounding is not relative to it)
    floor = r.abs().amax(-1, keepdim=True) * 2.0 ** -8
    _, e = torch.frexp(torch.maximum(torch.maximum(g.abs(), r.abs()), floor))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)     # 8 significant bits
    over = int(((g - r).abs() > ulp).sum())
    share = float((g != r).float().mean())
    ok = over == 0 and share < F32POOL_DIFFER
    log(f"  {what}: against the float32 kernel on the widened q, rounded: "
        f"{share:.4%} of {g.numel()} outputs differ (limit "
        f"{F32POOL_DIFFER:.0%}), {over} by more than one ulp "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append(f"{what}: off the float32 kernel")


def launched(counts, name, n0, fails):
    if counts[name] != n0 + 1:
        fails.append(f"{name}: did not launch")


def check_ragged(torch, rpa, dtype, timing, heads=32, kv_heads=8,
                 int8=False, model="llama", f32pool=False):
    """K2r at a serving tick of ``model``'s (RAGGED: 8 slots, BS 16, its
    head_dim, table width and contexts): the ticks' "prefill" (7 decode
    rows + a 128-row prefill chunk, the kernels line's) and "decode" (one
    row a slot, w_max 1); 32 / 8 heads (Llama-3-8B) unless ``heads`` /
    ``kv_heads`` say otherwise; ``int8``: on int8 pools; ``f32pool``: a
    bfloat16 q over float32 pools, also held against the float32 kernel
    on the widened q (:func:`held_f32pool`). Held elementwise and row by
    row; timed over enough sets of pools, taken in turn, to fill twice
    the 50 MB L2, so each call reads its K/V from device memory, as each
    layer of a tick does. Returns the largest error and ``{tick: row}``."""
    dt, pool_dt, sfx, op_dt = k2_mode(torch, dtype, int8, f32pool)
    g = torch.Generator(device="cuda").manual_seed(11)
    shape = RAGGED[model]
    S, Hkv, rep, BS = 8, kv_heads, heads // kv_heads, 16
    D, MB, base = shape["D"], shape["MB"], shape["base"]
    NB = 1 + S * MB
    pools, pos_bytes = kv_pools(torch, g, (NB, BS, Hkv, D), pool_dt, int8,
                                timing)
    copies = len(pools)
    name = "ragged_paged_attention" + sfx
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    tables = perm[:S * MB].reshape(S, MB).to(torch.int32).contiguous()
    ctx = torch.tensor([b + 1 for b in base], dtype=torch.int32,
                       device="cuda")
    fails, errs, rows = [], [], {}
    for tick, q_lens in shape["ticks"].items():
        R = sum(q_lens)
        q = torch.randn(R, Hkv * rep, D, generator=g, device="cuda").to(dt)
        starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
        ql = torch.tensor(q_lens, dtype=torch.int32, device="cuda")
        rs = torch.tensor(starts, dtype=torch.int32, device="cuda")
        w_max = max(q_lens)
        kp, vp = pools[0]
        args = (q, kp, vp, tables, ctx, ql, rs)
        n0 = rpa.launch_counts[name]
        got = rpa.ragged_paged_attention(*args, w_max)
        launched(rpa.launch_counts, name, n0, fails)
        ref = rpa.plain_ragged_paged_attention(*args)
        torch.cuda.synchronize()
        what = f"{name} {model} {tick} tick {heads}/{kv_heads} heads D {D}"
        errs.append(held_attention(torch, got, ref, dtype, what, fails))
        if f32pool:
            held_f32pool(torch, got, rpa.ragged_paged_attention(
                q.float(), *args[1:], w_max), what, fails)
        if not timing:
            continue
        es = q.element_size()
        kv_pos = sum(b + n for b, n in zip(base, q_lens))
        nbytes = 2 * kv_pos * Hkv * pos_bytes + 2 * q.numel() * es \
            + 4 * (tables.numel() + 3 * S)
        vis = sum(b + 1 + t for b, n in zip(base, q_lens) for t in range(n))
        b_ms, b_by = bound(nbytes, 4 * vis * Hkv * rep * D, op_dt)
        turn = iter(range(1 << 30))

        def run(f, *extra):
            kp_i, vp_i = pools[next(turn) % len(pools)]
            return f(q, kp_i, vp_i, tables, ctx, ql, rs, *extra)

        rows[tick] = dict(
            ms=time_ms(torch, lambda: run(rpa.ragged_paged_attention,
                                          w_max)),
            plain_ms=time_ms(torch, lambda: run(
                rpa.plain_ragged_paged_attention)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        # the wrapper zero-fills its output (pad rows stay zero): that
        # fill alone, timed the same way
        fill_ms = time_ms(torch, lambda: torch.zeros_like(q))
        log(f"  {name} [{dtype}] {model} {tick} tick, "
            f"{heads}/{kv_heads} heads D {D}, {R} rows: "
            f"ms={rows[tick]['ms']:.4f} (its output's zero fill alone "
            f"{fill_ms:.4f}) plain_ms="
            f"{rows[tick]['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}: "
            f"{nbytes / 1e6:.2f} MB; {copies} pool copies)")
    if fails:
        raise AssertionError(f"[{dtype}] disagrees with its plain version: "
                             f"{fails}")
    return max(errs), rows


def check_paged(torch, pda, dtype, timing, shape, heads=32, kv_heads=8,
                int8=False, head_dim=128, f32pool=False):
    """K2d and K2v at generate()'s widths (32 / 8 heads unless ``heads``
    / ``kv_heads`` say otherwise, ``head_dim``, BS 16, a window of
    PAGED_T for K2v) and one of the PAGED shapes: slots, table width MB
    and contexts (each set has one ending on a block boundary);
    ``int8``: on int8 pools, the rows named ``<kernel>_int8``;
    ``f32pool``: a bfloat16 q over float32 pools (``<kernel>_f32pool``),
    also held against the float32 kernel on the widened q
    (:func:`held_f32pool`).
    Held elementwise and row by row; timed over enough sets of pools,
    taken in turn, to fill twice the 50 MB L2, so each call reads its K/V
    from device memory, as each layer of a decode step does."""
    dt, pool_dt, sfx, op_dt = k2_mode(torch, dtype, int8, f32pool)
    g = torch.Generator(device="cuda").manual_seed(16)
    H, Hkv, D, BS, T = heads, kv_heads, head_dim, 16, PAGED_T
    S, MB, lens = (PAGED[shape][k] for k in ("S", "MB", "lens"))
    if lens is None:
        rng = np.random.RandomState(16)
        lens = [1, 40 * BS, 2048] + sorted(
            rng.randint(2, 2048, S - 3).tolist())
    NB = 1 + S * MB
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pools, pos_bytes = kv_pools(torch, g, (NB, BS, Hkv, D), pool_dt, int8,
                                timing)
    copies = len(pools)
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    tables = perm[:S * MB].reshape(S, MB).to(torch.int32).contiguous()
    qs = {"paged_decode_attention": torch.randn(
              S, H, D, generator=g, device="cuda").to(dt),
          "paged_verify_attention": torch.randn(
              S, T, H, D, generator=g, device="cuda").to(dt)}
    fns = {"paged_decode_attention": (pda.paged_decode_attention,
                                      pda.plain_paged_decode_attention),
           "paged_verify_attention": (pda.paged_verify_attention,
                                      pda.plain_paged_verify_attention)}
    fails, errs, rows = [], {}, {}
    for name, (kern, plain) in fns.items():
        q = qs[name]
        kp, vp = pools[0]
        n0 = pda.launch_counts[name + sfx]
        got = kern(q, kp, vp, tables, ctx)
        launched(pda.launch_counts, name + sfx, n0, fails)
        ref = plain(q, kp, vp, tables, ctx)
        torch.cuda.synchronize()
        what = f"{name}{sfx} {shape} {H}/{Hkv} heads D {D}"
        errs[name + sfx] = held_attention(torch, got, ref, dtype, what,
                                          fails)
        if f32pool:
            held_f32pool(torch, got, kern(q.float(), kp, vp, tables, ctx),
                         what, fails)
        if not timing:
            continue
        tw = q.shape[1] if q.dim() == 4 else 1
        es = q.element_size()
        kv_pos = sum(min(n + tw - 1, MB * BS) for n in lens)
        nbytes = 2 * kv_pos * Hkv * pos_bytes + 2 * q.numel() * es \
            + 4 * (tables.numel() + S)
        vis = sum(n + t for n in lens for t in range(tw))
        b_ms, b_by = bound(nbytes, 4 * vis * H * D, op_dt)
        turn = iter(range(1 << 30))

        def run(f):
            kp_i, vp_i = pools[next(turn) % len(pools)]
            return f(q, kp_i, vp_i, tables, ctx)

        r = rows[name + sfx] = dict(
            ms=time_ms(torch, lambda: run(kern)),
            plain_ms=time_ms(torch, lambda: run(plain)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"  {name}{sfx} [{dtype}] {shape}: {S} slots, MB {MB}, "
            f"{H}/{Hkv} heads D {D}, contexts {lens}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}: "
            f"{nbytes / 1e6:.2f} MB; {copies} pool copies)")
    if fails:
        raise AssertionError(f"[{dtype}] {shape}: disagree with their plain "
                             f"versions: {fails}")
    return errs, rows


def check_paged_tree(torch, pda, dtype, timing, heads=32, kv_heads=8,
                     int8=False, head_dim=128, f32pool=False):
    """K2v's tree mode at phase 7's shape (PAGED["generate"]: 4 slots,
    tables of 37 blocks, contexts 513..576; ``head_dim``, BS 16):
    BRANCH_TREE (T 8) held against the plain version's tree mask,
    elementwise and row by row, and CHAIN_TREE (T 4) equal to linear K2v
    bit for bit; 32 / 8 heads unless ``heads`` / ``kv_heads`` say
    otherwise; ``int8``: on int8 pools (the rows named ``*_int8``);
    ``f32pool``: a bfloat16 q over float32 pools (``*_f32pool``), also
    held against the float32 kernel on the widened q
    (:func:`held_f32pool`). With
    ``timing``, the tree mode is timed cold beside linear K2v at the same
    T in this call, with the bound of the same bytes. Returns ``(errors,
    rows)``."""
    dt, pool_dt, sfx, op_dt = k2_mode(torch, dtype, int8, f32pool)
    g = torch.Generator(device="cuda").manual_seed(17)
    H, Hkv, D, BS = heads, kv_heads, head_dim, 16
    S, MB, lens = (PAGED["generate"][k] for k in ("S", "MB", "lens"))
    NB = 1 + S * MB
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pools, pos_bytes = kv_pools(torch, g, (NB, BS, Hkv, D), pool_dt, int8,
                                timing)
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    tables = perm[:S * MB].reshape(S, MB).to(torch.int32).contiguous()
    name = "paged_verify_attention_tree" + sfx
    kp, vp = pools[0]
    fails, errs, rows = [], {}, {}
    T = len(BRANCH_TREE) + 1
    q = torch.randn(S, T, H, D, generator=g, device="cuda").to(dt)
    n0 = pda.launch_counts[name]
    got = pda.paged_verify_attention(q, kp, vp, tables, ctx,
                                     tree_anc=BRANCH_TREE)
    launched(pda.launch_counts, name, n0, fails)
    ref = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx,
                                           tree_anc=BRANCH_TREE)
    torch.cuda.synchronize()
    what = f"{name} generate {H}/{Hkv} heads D {D}, tree {BRANCH_TREE}"
    errs[name] = held_attention(torch, got, ref, dtype, what, fails)
    if f32pool:
        held_f32pool(torch, got, pda.paged_verify_attention(
            q.float(), kp, vp, tables, ctx, tree_anc=BRANCH_TREE), what,
            fails)
    qc = q[:, :len(CHAIN_TREE) + 1].contiguous()
    lin = pda.paged_verify_attention(qc, kp, vp, tables, ctx, tree_anc=None)
    chain = pda.paged_verify_attention(qc, kp, vp, tables, ctx,
                                       tree_anc=CHAIN_TREE)
    same = bool(torch.equal(lin, chain))
    verdict = "bitwise equal" if same else "FAIL: they differ"
    log(f"  {name} [{dtype}] chain {CHAIN_TREE} against linear K2v at T "
        f"{qc.shape[1]}, {H}/{Hkv} heads D {D}: {verdict}")
    if not same:
        fails.append(f"{name} chain != linear")
    if timing:
        es = q.element_size()
        kv_pos = sum(min(n + T - 1, MB * BS) for n in lens)
        nbytes = 2 * kv_pos * Hkv * pos_bytes + 2 * q.numel() * es \
            + 4 * (tables.numel() + S + T)
        vis = sum(n + t for n in lens for t in range(T))
        b_ms, b_by = bound(nbytes, 4 * vis * H * D, op_dt)
        turn = iter(range(1 << 30))

        def run(f, **kw):
            kp_i, vp_i = pools[next(turn) % len(pools)]
            return f(q, kp_i, vp_i, tables, ctx, **kw)

        r = rows[name] = dict(
            ms=time_ms(torch, lambda: run(pda.paged_verify_attention,
                                          tree_anc=BRANCH_TREE)),
            plain_ms=time_ms(torch, lambda: run(
                pda.plain_paged_verify_attention, tree_anc=BRANCH_TREE)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        lin_ms = time_ms(torch, lambda: run(pda.paged_verify_attention,
                                            tree_anc=None))
        log(f"  {name} [{dtype}] generate, {H}/{Hkv} heads D {D}, T {T}: "
            f"ms={r['ms']:.4f} (linear K2v at T {T}: {lin_ms:.4f}) "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}: "
            f"{nbytes / 1e6:.2f} MB; {len(pools)} pool copies)")
    if fails:
        raise AssertionError(f"[{dtype}] tree mode: {fails}")
    return errs, rows


def check_chunk_window(torch, pda, rpa, dtype, timing, heads=32,
                       kv_heads=8, int8=False, head_dim=128, f32pool=False):
    """K2v's chunk window: the per-width engine's chunk step, one slot of
    CHUNK["T"] rows at each of CHUNK's contexts (BS 16, tables of
    CHUNK["MB"] blocks; 32 / 8 heads unless ``heads`` / ``kv_heads`` say
    otherwise, ``head_dim``), held against the plain version elementwise
    and row by row; ``int8`` / ``f32pool`` as :func:`check_paged`'s. With
    ``timing``, timed cold at the last context beside K2r on the same 128
    rows of one slot (a ragged tick's prefill chunk), with the bound of
    the bytes both must move. Returns ``(error, row)``; the row is None
    without ``timing``."""
    dt, pool_dt, sfx, op_dt = k2_mode(torch, dtype, int8, f32pool)
    g = torch.Generator(device="cuda").manual_seed(18)
    H, Hkv, D, BS = heads, kv_heads, head_dim, 16
    T, MB = CHUNK["T"], CHUNK["MB"]
    NB = 1 + MB
    pools, pos_bytes = kv_pools(torch, g, (NB, BS, Hkv, D), pool_dt, int8,
                                timing)
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    tables = perm[:MB].reshape(1, MB).to(torch.int32).contiguous()
    name = "paged_verify_attention" + sfx
    q = torch.randn(1, T, H, D, generator=g, device="cuda").to(dt)
    kp, vp = pools[0]
    fails, errs = [], []
    for n in CHUNK["lens"]:
        ctx = torch.tensor([n], dtype=torch.int32, device="cuda")
        n0 = pda.launch_counts[name]
        got = pda.paged_verify_attention(q, kp, vp, tables, ctx)
        launched(pda.launch_counts, name, n0, fails)
        ref = pda.plain_paged_verify_attention(q, kp, vp, tables, ctx)
        torch.cuda.synchronize()
        what = (f"{name} chunk window T {T}, context {n}, {H}/{Hkv} heads "
                f"D {D}")
        errs.append(held_attention(torch, got, ref, dtype, what, fails))
        if f32pool:
            held_f32pool(torch, got, pda.paged_verify_attention(
                q.float(), kp, vp, tables, ctx), what, fails)
    if fails:
        raise AssertionError(f"[{dtype}] chunk window: {fails}")
    if not timing:
        return max(errs), None
    n = CHUNK["lens"][-1]
    ctx = torch.tensor([n], dtype=torch.int32, device="cuda")
    es = q.element_size()
    kv_pos = min(n + T - 1, MB * BS)
    nbytes = 2 * kv_pos * Hkv * pos_bytes + 2 * q.numel() * es \
        + 4 * (tables.numel() + 1)
    vis = sum(n + t for t in range(T))
    b_ms, b_by = bound(nbytes, 4 * vis * H * D, op_dt)
    turn = iter(range(1 << 30))

    def run(f, *extra):
        kp_i, vp_i = pools[next(turn) % len(pools)]
        return f(q, kp_i, vp_i, tables, ctx, *extra)

    row = dict(ms=time_ms(torch, lambda: run(pda.paged_verify_attention)),
               plain_ms=time_ms(torch, lambda: run(
                   pda.plain_paged_verify_attention)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # K2r over the same rows: one slot of T rows at the same context
    q2 = q.reshape(T, H, D)
    ql = torch.tensor([T], dtype=torch.int32, device="cuda")
    rs = torch.zeros(1, dtype=torch.int32, device="cuda")
    k2r = rpa.ragged_paged_attention(q2, kp, vp, tables, ctx, ql, rs, T)
    same = float((k2r.float() - pda.paged_verify_attention(
        q, kp, vp, tables, ctx)[0].float()).abs().max())

    def run_r():
        kp_i, vp_i = pools[next(turn) % len(pools)]
        return rpa.ragged_paged_attention(q2, kp_i, vp_i, tables, ctx, ql,
                                          rs, T)

    k2r_ms = time_ms(torch, run_r)
    log(f"  {name} [{dtype}] chunk window: 1 slot, T {T}, context {n}, "
        f"{H}/{Hkv} heads D {D}: ms={row['ms']:.4f} (K2r on the same "
        f"{T} rows: {k2r_ms:.4f}; ratio {row['ms'] / k2r_ms:.3f}; "
        f"max |K2v - K2r| {same:.3e}) plain_ms={row['plain_ms']:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}: {nbytes / 1e6:.2f} MB; "
        f"{len(pools)} pool copies)")
    row["k2r_ms"] = k2r_ms
    return max(errs), row


def check_ragged_tree(torch, rpa, dtype, timing, heads=32, kv_heads=8,
                      int8=False, model="llama", f32pool=False):
    """K2r's tree mode at a speculating engine's tick of ``model``'s
    (RAGGED_TREE: 8 slots, BS 16, its head_dim and table width; 7 slots
    verify a T 8 BRANCH_TREE window, flagged, and one carries a 128-row
    prefill chunk, unflagged): held against the plain version's per-slot
    tree mask, elementwise and row by row; CHAIN7 (T 8) equal to linear
    K2r bit for bit; 32 / 8 heads unless ``heads`` / ``kv_heads`` say
    otherwise; ``int8``: on int8 pools (the rows named ``*_int8``);
    ``f32pool``: a bfloat16 q over float32 pools (``*_f32pool``), also
    held against the float32 kernel on the widened q
    (:func:`held_f32pool`). With
    ``timing``, the tree mode is timed cold beside linear K2r on the same
    layout in this call, with the bound of the same bytes (the mask is a
    subset of the linear bound). Returns ``(errors, rows)``."""
    dt, pool_dt, sfx, op_dt = k2_mode(torch, dtype, int8, f32pool)
    g = torch.Generator(device="cuda").manual_seed(19)
    shape = RAGGED_TREE[model]
    S, Hkv, rep, BS = 8, kv_heads, heads // kv_heads, 16
    D, MB = shape["D"], shape["MB"]
    NB = 1 + S * MB
    base, q_lens, flags = (shape[k] for k in ("base", "q_lens", "flags"))
    pools, pos_bytes = kv_pools(torch, g, (NB, BS, Hkv, D), pool_dt, int8,
                                timing)
    name = "ragged_paged_attention_tree" + sfx
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    tables = perm[:S * MB].reshape(S, MB).to(torch.int32).contiguous()
    i32 = lambda a: torch.tensor(a, dtype=torch.int32,  # noqa: E731
                                 device="cuda")
    ctx, ql, fl = i32([b + 1 for b in base]), i32(q_lens), i32(flags)
    starts = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    rs = i32(starts.tolist())
    R, w_max = sum(q_lens), max(q_lens)
    q = torch.randn(R, Hkv * rep, D, generator=g, device="cuda").to(dt)
    kp, vp = pools[0]
    args = (q, kp, vp, tables, ctx, ql, rs)
    fails, errs, rows = [], {}, {}
    n0 = rpa.launch_counts[name]
    t_rows = len(BRANCH_TREE) + 1       # a flagged slot's rows: T 8
    tree_kw = dict(tree_anc=BRANCH_TREE, tree_slots=fl, tree_rows=t_rows)
    got = rpa.ragged_paged_attention(*args, w_max, **tree_kw)
    launched(rpa.launch_counts, name, n0, fails)
    ref = rpa.plain_ragged_paged_attention(*args, tree_anc=BRANCH_TREE,
                                           tree_slots=fl)
    torch.cuda.synchronize()
    what = (f"{name} {model} spec tick {heads}/{kv_heads} heads D {D}, "
            f"tree {BRANCH_TREE}")
    errs[name] = held_attention(torch, got, ref, dtype, what, fails)
    if f32pool:
        held_f32pool(torch, got, rpa.ragged_paged_attention(
            q.float(), *args[1:], w_max, **tree_kw), what, fails)
    lin = rpa.ragged_paged_attention(*args, w_max)
    chain = rpa.ragged_paged_attention(*args, w_max, tree_anc=CHAIN7,
                                       tree_slots=fl, tree_rows=t_rows)
    same = bool(torch.equal(lin, chain))
    log(f"  {name} [{dtype}] chain {CHAIN7} against linear K2r on the same "
        f"tick, {heads}/{kv_heads} heads D {D}: "
        f"{'bitwise equal' if same else 'FAIL: they differ'}")
    if not same:
        fails.append(f"{name} chain != linear")
    if timing:
        es = q.element_size()
        kv_pos = sum(b + n for b, n in zip(base, q_lens))
        nbytes = 2 * kv_pos * Hkv * pos_bytes + 2 * q.numel() * es \
            + 4 * (tables.numel() + 4 * S)
        vis = sum(b + 1 + t for b, n in zip(base, q_lens) for t in range(n))
        b_ms, b_by = bound(nbytes, 4 * vis * Hkv * rep * D, op_dt)
        turn = iter(range(1 << 30))

        def run(f, *extra, **kw):
            kp_i, vp_i = pools[next(turn) % len(pools)]
            return f(q, kp_i, vp_i, tables, ctx, ql, rs, *extra, **kw)

        # the tree instance with no slot flagged: linear K2r's mask
        kws = (dict(), tree_kw, dict(tree_kw, tree_slots=torch.zeros_like(fl)))
        # linear, tree, unflagged, unflagged, tree, linear on the same pool
        # copies: a drift of the card's clock falls on each alike
        ab = [time_ms(torch, lambda: run(rpa.ragged_paged_attention, w_max,
                                         **kws[k]))
              for k in (0, 1, 2, 2, 1, 0)]
        r = rows[name] = dict(
            ms=(ab[1] + ab[4]) / 2,
            plain_ms=time_ms(torch, lambda: run(
                rpa.plain_ragged_paged_attention, **tree_kw)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"  {name} [{dtype}] {model} spec tick, {heads}/{kv_heads} "
            f"heads D {D}, {R} rows: ms={r['ms']:.4f} (timed linear K2r, "
            f"tree, the tree instance with no slot flagged, the same, tree, "
            f"linear: " + " ".join(f"{t:.4f}" for t in ab) + f") plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}: "
            f"{nbytes / 1e6:.2f} MB; {len(pools)} pool copies)")
    if fails:
        raise AssertionError(f"[{dtype}] K2r tree mode: {fails}")
    return errs, rows


def k3_inputs(torch, dt, seed, *shapes, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(scale * torch.randn(*s, generator=g, device="cuda")).to(dt)
            for s in shapes]


def k3_rows(label):
    """The rows phase 2 holds a K3 case at: the prefill tick's, for
    Llama's and GPT's cases the decode ticks' too, and for Llama's the
    per-width verify and chunk steps'; each case's label names its rows
    but at K3_ROWS (the kernels line's)."""
    model = label.split()[0]
    more = K3_DECODE_ROWS if model in ("llama", "gpt") else ()
    if model == "llama":
        more += K3_PER_WIDTH_ROWS
    return [(K3_ROWS, label)] + [(r, f"{label} R={r}") for r in more]


def log_body(df, name, tag, r, k, widths):
    """The bf16 body a K3 case took, as the library reports it."""
    body, cfg = df._c_body(r, k, widths)
    how = (f" ({cfg[0]}-column tiles, clusters of {cfg[1]}, {cfg[2]} "
           f"blocks)") if cfg else ""
    log(f"  {name} {tag}: body {body}{how}")


def check_norm_matmul(torch, df, dtype, timing):
    """K3a in every case of K3A_CASES at the rows of :func:`k3_rows`:
    held elementwise and row by row against its plain version; in bf16
    the body logged and timed beside its bound and the library yardstick
    (``F.rms_norm`` or ``F.layer_norm``, then ``matmul`` / ``addmm`` a
    projection). Returns ``(max error, {label: timing row})``."""
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    errs, rows, fails = [], {}, []
    for i, (case, (d, widths, kind, has_beta, has_bias)) in enumerate(
            K3A_CASES.items()):
        ws = k3_inputs(torch, dt, 40 + i, *[(d, n) for n in widths],
                       scale=0.02)
        bs = [b if hb else None for b, hb in zip(
            k3_inputs(torch, dt, 60 + i, *[(n,) for n in widths],
                      scale=0.1), has_bias)]
        kw = dict(eps=1e-5 if kind == "ln" else 1e-6, kind=kind)
        for R, label in k3_rows(case):
            seed = 12 + i + (R if R != K3_ROWS else 0)
            x, gamma, beta = k3_inputs(torch, dt, seed, (R, d), (d,), (d,))
            gamma = 1 + 0.1 * gamma
            beta = 0.1 * beta if has_beta else None
            got = df.norm_matmul(x, gamma, beta, ws, bs, **kw)
            ref = df.plain_norm_matmul(x, gamma, beta, ws, bs, **kw)
            torch.cuda.synchronize()
            errs.append(max(held_attention(
                torch, a, b, dtype, f"norm_matmul {label} {d}->{widths}",
                fails) for a, b in zip(got, ref)))
            if not timing:
                continue
            log_body(df, "norm_matmul", label, R, d, widths)
            es = x.element_size()
            nbytes = es * (x.numel() + d * (2 if has_beta else 1)
                           + sum(w.numel() for w in ws) + R * sum(widths)
                           + sum(b.numel() for b in bs if b is not None))
            flops = 2 * R * d * sum(widths) \
                + (6 if kind == "ln" else 4) * R * d
            b_ms, b_by = bound(nbytes, flops, dtype)

            def library():
                y = F.rms_norm(x, (d,), gamma, kw["eps"]) if kind == "rms" \
                    else F.layer_norm(x, (d,), gamma, beta, kw["eps"])
                return [torch.addmm(b, y, w) if b is not None else y @ w
                        for w, b in zip(ws, bs)]

            rows[label] = dict(
                ms=time_ms(torch, lambda: df.norm_matmul(
                    x, gamma, beta, ws, bs, **kw)),
                plain_ms=time_ms(torch, lambda: df.plain_norm_matmul(
                    x, gamma, beta, ws, bs, **kw)),
                library_ms=time_ms(torch, library), bound_ms=b_ms,
                bound_by=b_by, nbytes=nbytes, flops=flops)
            del got, ref
        del ws
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"K3a disagrees with its plain version: "
                             f"{fails}")
    return max(errs), rows


def check_matmul_residual(torch, df, dtype, timing):
    """K3b in every case of K3B_CASES at the rows of :func:`k3_rows`,
    held, logged and timed as K3a (yardstick: the activation, then
    ``addmm`` onto the residual, plus the bias)."""
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    errs, rows, fails = [], {}, []
    for i, (case, (k, n, act, has_bias)) in enumerate(K3B_CASES.items()):
        (w,) = k3_inputs(torch, dt, 80 + i, (k, n), scale=0.02)
        for R, label in k3_rows(case):
            seed = 13 + i + (R if R != K3_ROWS else 0)
            gate, up, res, b = k3_inputs(torch, dt, seed, (R, k), (R, k),
                                         (R, n), (n,))
            xs = [gate, up] if act == "swiglu" else [gate]
            b = 0.1 * b if has_bias else None
            got = df.matmul_residual(xs, w, b, res, act=act)
            ref = df.plain_matmul_residual(xs, w, b, res, act=act)
            torch.cuda.synchronize()
            errs.append(held_attention(torch, got, ref, dtype,
                                       f"matmul_residual {label} act={act} "
                                       f"{k}->{n}", fails))
            if not timing:
                continue
            log_body(df, "matmul_residual", label, R, k, [n])
            es = res.element_size()
            nbytes = es * (sum(x.numel() for x in xs) + w.numel()
                           + 2 * R * n + (n if has_bias else 0))
            flops = 2 * R * k * n + (4 * R * k if act else 0)
            b_ms, b_by = bound(nbytes, flops, dtype)

            def library():
                xin = F.silu(xs[0]) * xs[1] if act == "swiglu" else \
                    F.gelu(xs[0], approximate="tanh") if act else xs[0]
                return torch.addmm(res if b is None else res + b, xin, w)

            rows[label] = dict(
                ms=time_ms(torch, lambda: df.matmul_residual(
                    xs, w, b, res, act=act)),
                plain_ms=time_ms(torch, lambda: df.plain_matmul_residual(
                    xs, w, b, res, act=act)),
                library_ms=time_ms(torch, library), bound_ms=b_ms,
                bound_by=b_by, nbytes=nbytes, flops=flops)
            del got, ref
        del w
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"K3b disagrees with its plain version: "
                             f"{fails}")
    return max(errs), rows


def check_flash(torch, F, fa, dtype, timing, shape=ATTN, causal=True):
    """K1f, K1dq and K1dkv at the training run's attention shape (or
    ``shape``: phase 18's GPT at D 64, BERT's at D 64 with ``causal``
    False), causal or not: each against its plain version on the same
    inputs (dq and dk/dv take the plain forward's lse and delta). Timing
    rows in bfloat16; the library yardstick is
    ``scaled_dot_product_attention`` (forward for K1f; its forward +
    backward is printed beside fwd + dq + dkv)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(15)
    B, L, H, Hkv, D = (shape[k] for k in ("B", "L", "H", "Hkv", "D"))
    log(f"  K1 at B {B}, L {L}, {H}/{Hkv} heads, D {D}, "
        f"{'causal' if causal else 'non-causal'} [{dtype}]")
    rnd = lambda *sh: torch.randn(*sh, generator=g, device="cuda").to(dt)  # noqa
    q, k, v, do = rnd(B, L, H, D), rnd(B, L, Hkv, D), rnd(B, L, Hkv, D), \
        rnd(B, L, H, D)
    scale = D ** -0.5
    fails = []
    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
    o_p, lse_p = fa.plain_flash_attention_fwd(q, k, v, scale, causal)
    torch.cuda.synchronize()
    errs = {"flash_attention_fwd": max(
        held_attention(torch, o, o_p, dtype, "flash_attention_fwd o",
                       fails),
        held_attention(torch, lse, lse_p, dtype, "flash_attention_fwd lse",
                       fails))}
    del o, lse
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse_p, delta, scale, causal)
    errs["flash_attention_dq"] = held_attention(
        torch, fa.flash_attention_dq(*args), fa.plain_flash_attention_dq(
            *args), dtype, "flash_attention_dq", fails)
    errs["flash_attention_dkv"] = max(
        held_attention(torch, a, b, dtype, f"flash_attention_dkv {n}",
                       fails)
        for n, a, b in zip(("dk", "dv"), fa.flash_attention_dkv(*args),
                           fa.plain_flash_attention_dkv(*args)))
    if fails:
        raise AssertionError(f"[{dtype}] disagree with their plain "
                             f"versions: {fails}")
    if not timing:
        return errs, None
    # what this run's data needs: causal rows see L (L + 1) / 2 columns
    pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
    es = q.element_size()
    qkv = es * (q.numel() + 2 * k.numel())
    rows = 4 * B * H * L                 # one float32 statistic per row
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    do_t = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qt, kt, vt), do_t)

    cases = {
        "flash_attention_fwd": (
            qkv + es * q.numel() + rows, 4 * D * pairs,
            lambda: fa.flash_attention_fwd(q, k, v, scale, causal),
            lambda: fa.plain_flash_attention_fwd(q, k, v, scale, causal),
            sdpa),
        "flash_attention_dq": (
            qkv + 2 * es * q.numel() + 2 * rows, 6 * D * pairs,
            lambda: fa.flash_attention_dq(*args),
            lambda: fa.plain_flash_attention_dq(*args), None),
        "flash_attention_dkv": (
            qkv + es * q.numel() + 2 * rows + 2 * es * k.numel(),
            8 * D * pairs, lambda: fa.flash_attention_dkv(*args),
            lambda: fa.plain_flash_attention_dkv(*args), None)}
    slow = dict(reps=2, rounds=3, warmup=1)
    # the kernels and the forward's yardstick are about a millisecond or
    # less: 20 calls a round; the plain versions take tens
    fast = dict(reps=20, rounds=5, warmup=3)
    rows_out = {}
    with torch.no_grad():
        for name, (nbytes, flops, kern, plain, lib) in cases.items():
            b_ms, b_by = bound(nbytes, flops, dtype)
            rows_out[name] = dict(
                ms=time_ms(torch, kern, **fast),
                plain_ms=time_ms(torch, plain, **slow), bound_ms=b_ms,
                bound_by=b_by,
                library_ms=time_ms(torch, lib, **fast) if lib else None)
        for name, (_, flops, *_) in cases.items():
            r = rows_out[name]
            lib = "" if r["library_ms"] is None \
                else f" library_ms={r['library_ms']:.4f}"
            log(f"  {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f}{lib}; "
                f"{flops / r['ms'] / 1e9:.1f} TFLOP/s "
                f"({r['bound_ms'] / r['ms']:.3f} of its {r['bound_by']} "
                f"bound)")
        fwd = rows_out["flash_attention_fwd"]
        flops = cases["flash_attention_fwd"][1]
        log(f"  SDPA forward {flops / fwd['library_ms'] / 1e9:.1f} TFLOP/s, "
            f"served by {sdpa_kernels(torch, sdpa)}")
    lib_fb = time_ms(torch, sdpa_fwd_bwd, **slow)
    ours = sum(r["ms"] for r in rows_out.values())
    log(f"  flash attention fwd + dq + dkv: ms={ours:.4f}; library "
        f"scaled_dot_product_attention fwd + bwd: ms={lib_fb:.4f}")
    # the backward alone: one autograd call of SDPA's graph (dq, dk and
    # dv together) against K1dq + K1dkv
    out_t = sdpa()

    def sdpa_bwd():
        return torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                   retain_graph=True)

    lib_b = time_ms(torch, sdpa_bwd, **fast)
    ours_b = rows_out["flash_attention_dq"]["ms"] \
        + rows_out["flash_attention_dkv"]["ms"]
    log(f"  flash attention dq + dkv: ms={ours_b:.4f}; library "
        f"scaled_dot_product_attention backward (dq, dk, dv): "
        f"ms={lib_b:.4f}, served by {sdpa_kernels(torch, sdpa_bwd)}")
    del out_t
    return errs, rows_out


def sdpa_kernels(torch, fn):
    """The device kernels one call of ``fn`` launches, by name, read with
    torch.profiler: which backend of ``scaled_dot_product_attention``
    served it (FlashAttention-2's ``flash_fwd``, the memory-efficient
    ``fmha_cutlass``, cuDNN's ``cudnn`` kernels, or the math path's
    matmuls and softmax)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and not e.name.startswith("Memset")})
    return "; ".join(n[:80] for n in names) or "no kernel recorded"


def doc_bounds(lengths, causal_only=True):
    """One-bound FlashMask bounds of documents of ``lengths`` packed in
    one row (as ``bench.py``'s ``_flashmask_bench`` builds them): column
    j of the document [a, b) hides rows [b, L), so with causal a token
    sees its own document's prefix."""
    edges = np.concatenate([[0], np.cumsum(lengths)])
    start = np.zeros(int(edges[-1]), np.int32)
    for a, b in zip(edges[:-1], edges[1:]):
        start[a:b] = b
    return start


def flashmask_masks(torch, rng):
    """Phase 2's FlashMask masks at FLASHMASK's shape, each
    ``(startend_row_indices, causal)`` from the seeded ``rng``."""
    B, L, H = (FLASHMASK[k] for k in ("B", "L", "H"))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731

    def unequal_docs(length, n):
        cuts = np.sort(rng.choice(np.arange(1, length // 64), n - 1,
                                  replace=False)) * 64
        return np.diff(np.concatenate([[0], cuts, [length]]))
    # (a) document-causal, one bound, 8 unequal documents, one mask head
    a = doc_bounds(unequal_docs(L, 8))[None, None, :, None]
    # (b) two bounds per query head: the columns of each document hide
    # the rows from its end for a random span, not causal
    b = np.zeros((B, H, L, 2), np.int32)
    for h in range(H):
        docs = np.diff(np.concatenate([[0], np.sort(rng.choice(
            np.arange(16, L - 16), 7, replace=False)), [L]]))
        start = doc_bounds(docs)
        span = rng.randint(0, L, size=len(docs))
        b[0, h, :, 0] = start
        b[0, h, :, 1] = np.minimum(L, start + np.repeat(span, docs))
    # (c) rows [L/2, L) hidden on every column
    c = np.full((B, 1, L, 1), L // 2, np.int32)
    # (d) start = L everywhere: hides nothing beyond causal
    d = np.full((B, 1, L, 1), L, np.int32)
    Le = FLASHMASK_TAIL["L"]
    e = np.stack([doc_bounds(unequal_docs(Le - Le % 64, 8)) for _ in
                  range(FLASHMASK_TAIL["Hm"])])
    e = np.concatenate([e, np.full((len(e), Le % 64), Le, np.int32)], 1)
    return {"a": (t(a), True), "b": (t(b), False), "c": (t(c), False),
            "d": (t(d), True), "e": (t(e[None, ..., None]), True)}


def visible_pairs(torch, start, end, b, h, lq, causal):
    """The (query row, key column) pairs a FlashMask mask leaves
    visible, summed over every query head: what the kernels' bounds
    count. ``start`` / ``end`` [B * Hm, Lk] int32."""
    s, e = start.long(), end.long().clamp(max=lq)
    j = torch.arange(start.shape[1], device=start.device)
    lo = j if causal else torch.zeros_like(j)          # first row seeing j
    hidden = (e - torch.maximum(s, lo)).clamp(min=0)
    seen = (lq - lo).clamp(min=0) - hidden
    return int(seen.sum()) * (h // (start.shape[0] // b))


def check_flashmask(torch, F, fa, fm, dtype, timing):
    """K6f, K6dq and K6dkv against their plain versions at FLASHMASK's
    shape (Llama-3-8B's heads at L 4096) under masks (a)-(d) of
    ``flashmask_masks`` and at FLASHMASK_TAIL's under (e), elementwise
    and row by row; on (c) o and dq must be exactly 0 and lse NEG_INF on
    the hidden rows, and on (d) K6 must give K1 causal's results. Timing
    rows in bfloat16 on (a): K6, the operations bound over the visible
    pairs, the plain versions, SDPA with the dense boolean mask (k / v
    repeated to the query heads) and K1 causal at the same shape."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(16)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device="cuda").to(dt)  # noqa
    masks = flashmask_masks(torch, np.random.RandomState(SEED + 16))
    fails, errs, keep = [], {}, {}
    for name, (idx, causal) in masks.items():
        shape = FLASHMASK_TAIL if name == "e" else FLASHMASK
        B, L, H, Hkv, D = (shape[k] for k in ("B", "L", "H", "Hkv", "D"))
        q, k, v, do = rnd(B, L, H, D), rnd(B, L, Hkv, D), \
            rnd(B, L, Hkv, D), rnd(B, L, H, D)
        start, end = fm.flashmask_bounds(idx, L, H, Hkv, device="cuda")
        scale = D ** -0.5
        tag = f"flashmask ({name})"
        o, lse, tiles = fm.flashmask_fwd(q, k, v, start, end, scale,
                                         causal)
        o_p, lse_p = fm.plain_flashmask_fwd(q, k, v, start, end, scale,
                                            causal)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, do, lse_p, delta, start, end, scale, causal)
        dq = fm.flashmask_dq(*args, tiles=tiles)
        dkv = fm.flashmask_dkv(*args, tiles=tiles)
        torch.cuda.synchronize()
        same = torch.equal(tiles, fm.plain_flashmask_tiles(start, end))
        log(f"  {tag} tile summary [{dtype}] equals the plain one: "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            fails.append(f"{tag} tiles")
        e = {"flashmask_fwd": max(
            held_attention(torch, o, o_p, dtype, f"{tag} fwd o", fails),
            held_attention(torch, lse, lse_p, dtype, f"{tag} fwd lse",
                           fails)),
             "flashmask_dq": held_attention(
                 torch, dq, fm.plain_flashmask_dq(*args), dtype,
                 f"{tag} dq", fails),
             "flashmask_dkv": max(
                 held_attention(torch, a, b, dtype, f"{tag} dkv {n}", fails)
                 for n, a, b in zip(("dk", "dv"), dkv,
                                    fm.plain_flashmask_dkv(*args)))}
        for kname, err in e.items():
            errs[kname] = max(errs.get(kname, 0.0), err)
        if name == "c":
            h2 = L // 2
            zero = bool((o[:, h2:] == 0).all()) and bool(
                (dq[:, h2:] == 0).all()) and bool(
                (lse[..., h2:] == fa.NEG_INF).all())
            log(f"  {tag}: o, dq exactly 0 and lse NEG_INF on the hidden "
                f"rows: {'ok' if zero else 'FAIL'}")
            if not zero:
                fails.append(f"{tag} hidden rows")
        if name == "d":
            o1, lse1 = fa.flash_attention_fwd(q, k, v, scale, True)
            held_attention(torch, o, o1, dtype, f"{tag} fwd o vs K1 causal",
                           fails)
            held_attention(torch, lse, lse1, dtype,
                           f"{tag} fwd lse vs K1 causal", fails)
            k1 = (q, k, v, do, lse_p, delta, scale, True)
            held_attention(torch, dq, fa.flash_attention_dq(*k1), dtype,
                           f"{tag} dq vs K1 causal", fails)
            for n, a, b in zip(("dk", "dv"), dkv, fa.flash_attention_dkv(
                    *k1)):
                held_attention(torch, a, b, dtype,
                               f"{tag} dkv {n} vs K1 causal", fails)
        if name == "a":
            keep = dict(q=q, k=k, v=v, do=do, start=start, end=end,
                        args=args, scale=scale, tiles=tiles)
        del q, k, v, do, o, o_p, dq, dkv
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"[{dtype}] FlashMask kernels disagree: "
                             f"{fails}")
    if not timing:
        return errs, None
    q, k, v, do, start, end, args, scale, tiles = (
        keep[n] for n in ("q", "k", "v", "do", "start", "end", "args",
                          "scale", "tiles"))
    B, L, H, Hkv, D = (FLASHMASK[n] for n in ("B", "L", "H", "Hkv", "D"))
    pairs = visible_pairs(torch, start, end, B, H, L, True)
    es = q.element_size()
    qkv = es * (q.numel() + 2 * k.numel())
    rows = 4 * B * H * L
    bnds = 4 * (start.numel() + end.numel())
    # the library yardstick: SDPA with the dense [L, L] boolean mask
    # (True keeps), k / v repeated to the query heads
    j = torch.arange(L, device="cuda")
    hid = (j[:, None] >= start[0][None, :]) & (j[:, None] < end[0][None, :])
    dense = ~(hid | (j[None, :] > j[:, None]))
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (x.repeat_interleave(H // Hkv, 2).transpose(1, 2).contiguous()
              .requires_grad_() for x in (k, v))
    do_t = do.transpose(1, 2).contiguous()
    lib_args, lib_kw = (qt, kt, vt), dict(attn_mask=dense)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(*lib_args, **lib_kw)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), lib_args, do_t)

    cases = {
        "flashmask_fwd": (
            qkv + es * q.numel() + rows + bnds, 4 * D * pairs,
            lambda: fm.flashmask_fwd(q, k, v, start, end, scale, True),
            lambda: fm.plain_flashmask_fwd(q, k, v, start, end, scale,
                                           True), sdpa),
        "flashmask_dq": (
            qkv + 2 * es * q.numel() + 2 * rows + bnds, 6 * D * pairs,
            lambda: fm.flashmask_dq(*args, tiles=tiles),
            lambda: fm.plain_flashmask_dq(*args), None),
        "flashmask_dkv": (
            qkv + es * q.numel() + 2 * rows + 2 * es * k.numel() + bnds,
            8 * D * pairs, lambda: fm.flashmask_dkv(*args, tiles=tiles),
            lambda: fm.plain_flashmask_dkv(*args), None)}
    slow = dict(reps=2, rounds=3, warmup=1)
    fast = dict(reps=20, rounds=5, warmup=3)     # the kernels: sub-ms
    rows_out = {}
    with torch.no_grad():
        for name, (nbytes, flops, kern, plain, lib) in cases.items():
            b_ms, b_by = bound(nbytes, flops, dtype)
            rows_out[name] = dict(
                ms=time_ms(torch, kern, **fast),
                plain_ms=time_ms(torch, plain, **slow), bound_ms=b_ms,
                bound_by=b_by,
                library_ms=time_ms(torch, lib, **slow) if lib else None)
        k1 = (q, k, v, do, args[4], args[5], scale, True)
        k1_ms = [time_ms(torch, lambda: fa.flash_attention_fwd(
                     q, k, v, scale, True), **fast),
                 time_ms(torch, lambda: fa.flash_attention_dq(*k1), **fast),
                 time_ms(torch, lambda: fa.flash_attention_dkv(*k1),
                         **fast)]
    lib_fb = time_ms(torch, sdpa_fwd_bwd, **slow)
    ours = sum(r["ms"] for r in rows_out.values())
    log(f"  flashmask (a) at B {B}, L {L}, {H} / {Hkv} heads, D {D}: "
        f"{pairs} visible pairs ({pairs / (B * H * L * (L + 1) / 2):.4f} "
        f"of causal's)")
    log(f"  flashmask fwd + dq + dkv: ms={ours:.4f}; K1 causal fwd + dq + "
        f"dkv at the same shape: ms={sum(k1_ms):.4f} ({k1_ms[0]:.4f} + "
        f"{k1_ms[1]:.4f} + {k1_ms[2]:.4f}); library "
        f"scaled_dot_product_attention with the dense bool mask "
        f"(EFFICIENT_ATTENTION backend) fwd + bwd: ms={lib_fb:.4f}")
    return errs, rows_out


def moe_routing(torch, tokens, e, k, kind, seed):
    """``(order, src_rows, group_sizes)`` int32 on the card for ``tokens``
    x ``k`` (token, slot) pairs: ``random`` gives each token k distinct
    experts (a router's top-k of random logits), ``one`` sends every pair
    to one expert, ``sparse`` to three (61 of 64 groups empty, the first
    and last not), ``single`` all but one pair to one expert and the last
    pair alone to the last expert (a group of one row). Sorted
    expert-major and stable, as the dispatch sorts them."""
    rng = np.random.RandomState(seed)
    flat = rng.rand(tokens, e).argsort(1)[:, :k].reshape(-1)
    if kind == "one":
        flat[:] = e // 3
    elif kind == "sparse":
        flat = rng.choice([0, e // 4, e - 1], flat.size)
    elif kind == "single":
        flat[:] = 5
        flat[-1] = e - 1
    order = np.argsort(flat, kind="stable")
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()  # noqa
    return i32(order), i32(order // k), i32(np.bincount(flat, minlength=e))


def grouped_mm_yardstick(torch, a, b, offs):
    """``lhs -> torch._grouped_mm(lhs, b, offs=offs)`` (with ``b``
    column-major if the row-major layout is refused) tried on ``a``, and
    None; or ``(None, reason)`` where this PyTorch has no such call for
    these inputs."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm is missing"
    reason = None
    for bb in (b, b.transpose(-2, -1).contiguous().transpose(-2, -1)):
        try:
            fn(a, bb, offs=offs)
            torch.cuda.synchronize()
            return (lambda lhs: fn(lhs, bb, offs=offs)), None
        except Exception as e:          # the yardstick is optional
            reason = f"{type(e).__name__}: {str(e)[:160]}"
    return None, reason


def check_moe(torch, mg, dtype, timing):
    """K4's forward modes and K5's gmm against their plain versions at
    the MoE paths' shapes (MOE: the DeepSeek-16B decode and prefill
    ticks, Qwen2-57B widths) and at MOE_EDGES routings, elementwise and
    row by row. In bfloat16 each is timed at the MOE shapes with CUDA
    events (every shape's experts hold far more than the 50 MB L2, so
    each call streams its touched experts' weights from device memory),
    beside its bound and ``torch._grouped_mm``: one call for K5's gmm,
    composites for the K4 modes (printed, never in the kernels line).
    Returns ``(errs, rows)``; ``rows`` holds the MOE_TIMED shape's
    timings by kernel name."""
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(17)
    fails, rows = [], {}
    errs = dict.fromkeys(("moe_gather_gmm_swiglu", "moe_scatter_gmm",
                          "moe_gmm"), 0.0)
    weights = {}
    cases = [(shape, "random") for shape in MOE] + \
        [(MOE_EDGE_SHAPE, kind) for kind in MOE_EDGES]
    for i, (shape, kind) in enumerate(cases):
        c = MOE[shape]
        tokens, d, f, e, k = (c[n] for n in ("tokens", "d", "f", "e", "k"))
        if (d, f, e) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[d, f, e] = tuple(
                (0.02 * torch.randn(*sh, generator=g, device="cuda")).to(dt)
                for sh in ((e, d, 2 * f), (e, f, d)))
        gu, dn = weights[d, f, e]
        x = torch.randn(tokens, d, generator=g, device="cuda").to(dt)
        order, src, gs = moe_routing(torch, tokens, e, k, kind, 17 + i)
        xs = x[src.long()].contiguous()
        h_ref = mg.plain_gather_gmm_swiglu(x, src, gu, gs)
        label = f"{shape} {kind}: {tokens * k} rows, d {d}, f {f}, e {e}"
        outs = {"moe_gather_gmm_swiglu": (
                    lambda: mg.gather_gmm_swiglu(x, src, gu, gs),
                    lambda: mg.plain_gather_gmm_swiglu(x, src, gu, gs)),
                "moe_scatter_gmm": (
                    lambda: mg.scatter_gmm(h_ref, dn, gs, order),
                    lambda: mg.plain_scatter_gmm(h_ref, dn, gs, order)),
                "moe_gmm": (lambda: mg.gather_gmm(xs, None, gu, gs),
                            lambda: mg.plain_gather_gmm(xs, None, gu, gs))}
        for name, (kern, plain) in outs.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            errs[name] = max(errs[name], held_attention(
                torch, got, ref, dtype, f"{name} {label}", fails))
        if not timing or kind != "random":
            continue
        es = x.element_size()
        m = tokens * k
        touched = int((gs > 0).sum())
        offs = torch.cumsum(gs, 0).to(torch.int32)
        gm_up, why = grouped_mm_yardstick(torch, xs, gu, offs)
        gm_dn, _ = grouped_mm_yardstick(torch, h_ref, dn, offs)
        idx, sidx = order.long(), src.long()

        def silu_up(y):
            return F.silu(y[:, :f]) * y[:, f:]

        # (bytes, flops, one-call library, composite library)
        work = {"moe_gather_gmm_swiglu": (
                    es * (touched * d * 2 * f + tokens * d + m * f)
                    + 4 * (m + e), 2 * m * d * 2 * f, None,
                    gm_up and (lambda: silu_up(gm_up(x[sidx])))),
                "moe_scatter_gmm": (
                    es * (touched * f * d + m * f + m * d) + 4 * (m + e),
                    2 * m * f * d, None,
                    gm_dn and (lambda: (lambda y: torch.empty_like(
                        y).index_copy_(0, idx, y))(gm_dn(h_ref)))),
                "moe_gmm": (es * (touched * d * 2 * f + m * d + m * 2 * f)
                            + 4 * e, 2 * m * d * 2 * f,
                            gm_up and (lambda: gm_up(xs)), None)}
        if gm_up is not None:
            lerr = float((gm_up(xs).float() - mg.plain_gather_gmm(
                xs, None, gu, gs).float()).abs().max())
            log(f"  torch._grouped_mm {label}: max_abs_err vs plain "
                f"{lerr:.3e}")
        else:
            log(f"  torch._grouped_mm unavailable: {why}")
        for name, (nbytes, flops, one, comp) in work.items():
            kern, plain = outs[name]
            b_ms, b_by = bound(nbytes, flops, dtype)
            row = dict(ms=time_ms(torch, kern), plain_ms=time_ms(
                torch, plain, reps=3, rounds=3, warmup=1), bound_ms=b_ms,
                bound_by=b_by,
                library_ms=time_ms(torch, one) if one else None)
            comp_ms = time_ms(torch, comp) if comp else None
            log(f"  {name} [{dtype}] {label} ({touched} experts touched): "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}: {nbytes / 1e6:.2f} MB) "
                f"library_ms={row['library_ms']}"
                + (f" composite library_ms={comp_ms:.4f}"
                   if comp_ms is not None else ""))
            if shape == MOE_TIMED:
                rows[name] = row
    weights.clear()
    if fails:
        raise AssertionError(f"[{dtype}] MoE kernels disagree with their "
                             f"plain versions: {fails}")
    return errs, rows


def lora_routing(kind, rows, groups, used, seed):
    """Each packed row's stack row (int64, numpy): ``tick`` spreads the
    rows over the ``used`` groups (the null one among them), ``null``
    puts every row in the null group, ``single`` all but one row in the
    null group and one row alone in the last group, ``chunk`` the last
    128 rows (a prefill chunk) in the last group and the others over the
    rest of ``used``."""
    rng = np.random.RandomState(seed)
    if kind == "null":
        return np.zeros(rows, np.int64)
    if kind == "single":
        ra = np.zeros(rows, np.int64)
        ra[rows // 2] = groups - 1
        return ra
    if kind == "chunk":
        ra = rng.choice(np.asarray(used[:-1], np.int64), rows)
        ra[rows - 128:] = groups - 1
        return ra
    return rng.choice(np.asarray(used, np.int64), rows)


def lora_stacks(torch, g, groups, d, rank, out, copies=1):
    """``copies`` pairs of stacks ``A [groups, d, padded]``, ``B [groups,
    padded, out]`` float32 as the adapter pool holds them: row 0 (the
    null adapter) and the padded rank's columns of A / rows of B zero,
    the rest N(0, 0.05)."""
    from paddle_tpu_torch.ops.lora import padded_rank
    rp = padded_rank(rank)
    pairs = []
    for _ in range(copies):
        A = torch.zeros(groups, d, rp, device="cuda")
        B = torch.zeros(groups, rp, out, device="cuda")
        A[1:, :, :rank] = 0.05 * torch.randn(groups - 1, d, rank,
                                             generator=g, device="cuda")
        B[1:, :rank] = 0.05 * torch.randn(groups - 1, rank, out,
                                          generator=g, device="cuda")
        pairs.append((A, B))
    return pairs


def check_lora(torch, mg, lora):
    """K4's float32 gather and scatter modes as the LoRA delta calls them
    (``ops/lora.ragged_delta``), against their plain versions elementwise
    and row by row, at LORA_TICK's shapes (136 packed rows of d 4096, 9
    groups, rank 16, outs 4096 and 1024, rows over five groups with the
    null one) and at its edges (every row in the null group: an exact-
    zero delta; a group of one row; rank 4 padded to 8; the pure tick's 8
    rows; phase 21's 3 groups; a 128-row prefill chunk in one group; rank
    64, the split-K and wide-scatter bodies' bound, and rank 72 past it,
    which takes ``moe_gmm_fma``; each case logs the bodies it took); the
    whole delta also against the reference's stacked-gather einsum at the
    unpadded rank. At the tick (outs 4096 and 1024), the pure tick and 3
    groups, each mode is timed cold (enough copies of the stacks, taken
    in turn, to fill twice the 50 MB L2) with CUDA events beside its
    bound, its plain version and the composite (the reference's
    fallback: a per-row gather of the stacks and an einsum, in eager
    PyTorch); no one PyTorch call computes either. Returns ``(errs,
    rows)``, ``rows`` at the tick's out 4096 by kernel name."""
    t = LORA_TICK
    R0, d, G0 = t["rows"], t["d"], t["groups"]
    g = torch.Generator(device="cuda").manual_seed(21)
    fails, rows_out = [], {}
    errs = dict.fromkeys(LORA_KERNELS, 0.0)
    # (kind, rank, out, rows, groups, timed)
    cases = [("tick", t["rank"], out, R0, G0, True) for out in t["outs"]] + [
        ("null", t["rank"], t["outs"][0], R0, G0, False),
        ("single", t["rank"], t["outs"][0], R0, G0, False),
        ("tick", 4, t["outs"][0], R0, G0, False),
        ("tick", t["rank"], t["outs"][0], 8, G0, True),
        ("tick", t["rank"], t["outs"][0], R0, 3, True),
        ("chunk", t["rank"], t["outs"][0], R0, G0, False),
        ("tick", 64, t["outs"][1], R0, G0, False),
        ("tick", 72, t["outs"][1], R0, G0, False)]
    for i, (kind, rank, out, R, G, timing) in enumerate(cases):
        used = t["used"] if G == G0 else tuple(range(G))
        ra = torch.from_numpy(lora_routing(kind, R, G, used, 21 + i)).cuda()
        rp = lora.padded_rank(rank)
        copies = max(3, -(-int(100e6) // (4 * G * rp * (d + out)))) \
            if timing else 1
        stacks = lora_stacks(torch, g, G, d, rank, out, copies)
        A, B = stacks[0]
        x = torch.randn(R, d, generator=g, device="cuda")
        order, sizes = lora.sort_rows(ra, G)
        want_order = np.argsort(ra.cpu().numpy(), kind="stable")
        if not (np.array_equal(order.cpu().numpy(), want_order)
                and np.array_equal(sizes.cpu().numpy(), np.bincount(
                    ra.cpu().numpy(), minlength=G))):
            fails.append(f"lora sort {kind}")
        label = (f"{kind}: {R} rows, d {d}, rank {rank} (stacks at {rp}), "
                 f"out {out}, {G} groups")
        log(f"  lora {label}: bodies lora_gmm "
            f"{mg.f32_body('gmm', R, d, rp, G)}, lora_scatter_gmm "
            f"{mg.f32_body('scatter', R, rp, out, G)}")
        n0 = dict(mg.launch_counts)
        ax = mg.gather_gmm(x, order, A, sizes, count="lora_gmm")
        ax_ref = mg.plain_gather_gmm(x, order, A, sizes)
        y = mg.scatter_gmm(ax_ref, B, sizes, order, count="lora_scatter_gmm")
        y_ref = mg.plain_scatter_gmm(ax_ref, B, sizes, order)
        delta = lora.ragged_delta(x, ra, A, B)
        ein = lora.plain_ragged_delta(x, ra, A[:, :, :rank], B[:, :rank])
        torch.cuda.synchronize()
        for name, n in (("lora_gmm", 2), ("lora_scatter_gmm", 2),
                        ("moe_gmm", 0), ("moe_scatter_gmm", 0)):
            if mg.launch_counts[name] != n0[name] + n:
                fails.append(f"lora {kind}: {name} launched "
                             f"{mg.launch_counts[name] - n0[name]} times")
        errs["lora_gmm"] = max(errs["lora_gmm"], held_attention(
            torch, ax, ax_ref, "float32", f"lora_gmm {label}", fails))
        errs["lora_scatter_gmm"] = max(errs["lora_scatter_gmm"],
                                       held_attention(
            torch, y, y_ref, "float32", f"lora_scatter_gmm {label}", fails))
        held_attention(torch, delta, ein, "float32",
                       f"lora delta vs the reference's einsum {label}", fails)
        if kind == "null" and delta.any():
            fails.append("lora null group: a nonzero delta")
        # a row's delta is its own: the rows of one adapter alone give it
        # to the bit (batched == solo)
        sub = (ra == ra[R // 2]).nonzero()[:, 0]
        alone = lora.ragged_delta(x[sub].contiguous(), ra[sub], A, B)
        if not torch.equal(alone, delta[sub]):
            fails.append(f"lora {kind}: a row's delta depends on the batch")
        if not timing:
            continue
        touched = int((sizes > 0).sum())
        turn = iter(range(1 << 30))

        def pick():
            return stacks[next(turn) % len(stacks)]

        idx = ra.long()
        # (bytes, flops, kernel, plain, composite)
        work = {"lora_gmm": (
                    4 * (R * d + touched * d * rp + R * rp) + 4 * (R + G),
                    2 * R * d * rp,
                    lambda: mg.gather_gmm(x, order, pick()[0], sizes,
                                          count="lora_gmm"),
                    lambda: mg.plain_gather_gmm(x, order, pick()[0], sizes),
                    lambda: torch.einsum("rd,rdk->rk", x, pick()[0][idx])),
                "lora_scatter_gmm": (
                    4 * (R * rp + touched * rp * out + R * out) + 4 * (R + G),
                    2 * R * rp * out,
                    lambda: mg.scatter_gmm(ax_ref, pick()[1], sizes, order,
                                           count="lora_scatter_gmm"),
                    lambda: mg.plain_scatter_gmm(ax_ref, pick()[1], sizes,
                                                 order),
                    lambda: torch.einsum("rk,rko->ro", ax_ref,
                                         pick()[1][idx]))}
        for name, (nbytes, flops, kern, plain, comp) in work.items():
            b_ms, b_by = bound(nbytes, flops, "float32")
            row = dict(ms=time_ms(torch, kern), plain_ms=time_ms(
                torch, plain, reps=3, rounds=3, warmup=1), bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
            comp_ms = time_ms(torch, comp)
            log(f"  {name} [float32] {label} ({touched} groups touched, "
                f"{copies} stack copies): ms={row['ms']:.4f} plain_ms="
                f"{row['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}: "
                f"{nbytes / 1e6:.2f} MB) composite library_ms="
                f"{comp_ms:.4f} (the reference's fallback); share of bound "
                f"{b_ms / row['ms']:.3f}; {comp_ms / row['ms']:.2f}x "
                f"faster than the composite")
            if i == 0:
                rows_out[name] = row
        del stacks
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"LoRA K4 modes disagree with their plain "
                             f"versions: {fails}")
    return errs, rows_out


def library_call(torch, fn, *args):
    """``fn`` when it runs on ``args`` here, else None and the reason (a
    PyTorch without the call, or a layout it refuses)."""
    try:
        fn(*args)
        torch.cuda.synchronize()
        return fn, None
    except Exception as e:          # the yardstick is optional
        return None, f"{type(e).__name__}: {str(e)[:160]}"


def check_moe_backward(torch, mg, dtype, timing):
    """The MoE backward's modes against their plain versions at the
    training shapes (MOE_BWD: DeepSeek-MoE-16B's 2 x 4096 tokens, top-6;
    Qwen2-57B widths at 4096 tokens, top-8) and at MOE_EDGES routings
    (MOE_BWD_EDGE tokens at DeepSeek widths), elementwise and row by row:
    K4's transposed gather (``dh``, ``moe_gmm_t``), K5's d(lhs) on
    sorted rows (``moe_gmm_t`` without the gather), K4's transposed
    scatter (``dx``, ``moe_scatter_gmm_t``) and tgmm for d(down) and
    d(gate_up) (``moe_tgmm``; an empty group must come out zero). In
    bfloat16 each is timed at the MOE_BWD shapes with CUDA events beside
    its bound and a library call: ``torch._grouped_mm`` of the
    transposed weights for d(lhs), of ``lhs.t()`` and ``dy`` with row
    offsets for tgmm; composites for the gather and scatter modes
    (printed, never in the kernels line). The forward modes (K4's gather
    + swiglu and scatter, the gather gmm of the backward's recompute,
    K5's gmm on sorted rows) are held on the same rows in every case
    (held_forward; at these widths bf16 runs them on the Hopper body)
    and timed at the MOE_BWD shapes (forward_at_training_shape). Returns
    ``(errs, rows)``; ``errs`` also holds the forward modes' largest
    errors here; ``rows`` holds MOE_BWD_TIMED's timings by kernel name
    (tgmm: both products of one layer summed)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(19)
    fails, rows = [], {}
    errs = dict.fromkeys(("moe_gmm_t", "moe_scatter_gmm_t", "moe_tgmm",
                          "moe_gather_gmm_swiglu", "moe_scatter_gmm",
                          "moe_gmm"), 0.0)
    cases = [(shape, "random") for shape in MOE_BWD] + \
        [("edge", kind) for kind in MOE_EDGES]
    weights = {}
    for i, (shape, kind) in enumerate(cases):
        c = MOE_BWD[shape] if shape in MOE_BWD else dict(
            MOE_BWD[MOE_BWD_TIMED], tokens=MOE_BWD_EDGE)
        tokens, d, f, e, k = (c[n] for n in ("tokens", "d", "f", "e", "k"))
        m = tokens * k
        if (d, f, e) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[d, f, e] = tuple(
                (0.02 * torch.randn(*sh, generator=g, device="cuda")).to(dt)
                for sh in ((e, d, 2 * f), (e, f, d)))
        gu, dn = weights[d, f, e]
        rnd = lambda *sh, sc=1.0: (sc * torch.randn(  # noqa: E731
            *sh, generator=g, device="cuda")).to(dt)
        # cotangents are small in training (0.02, as the weights): a sum
        # of 3072 unit products (the "one" routing's tgmm) reaches ~250,
        # where float32's own rounding passes TOL's absolute 1e-4
        x, h = rnd(tokens, d), rnd(m, f)
        dpair, dgu = rnd(m, d, sc=0.02), rnd(m, 2 * f, sc=0.02)
        order, src, gs = moe_routing(torch, tokens, e, k, kind, 19 + i)
        ds = dpair[order.long()].contiguous()
        xs = x[src.long()].contiguous()
        label = f"{shape} {kind}: {m} rows, d {d}, f {f}, e {e}"
        outs = {
            "moe_gmm_t": (
                lambda: mg.gather_gmm(dpair, order, dn, gs,
                                      transpose_rhs=True),
                lambda: mg.plain_gather_gmm(dpair, order, dn, gs,
                                            transpose_rhs=True)),
            "moe_gmm_t sorted (K5 d(lhs))": (
                lambda: mg.gather_gmm(ds, None, dn, gs, transpose_rhs=True),
                lambda: mg.plain_gather_gmm(ds, None, dn, gs,
                                            transpose_rhs=True)),
            "moe_scatter_gmm_t": (
                lambda: mg.scatter_gmm(dgu, gu, gs, order,
                                       transpose_rhs=True),
                lambda: mg.plain_scatter_gmm(dgu, gu, gs, order,
                                             transpose_rhs=True)),
            "moe_tgmm d(down)": (lambda: mg.tgmm(h, ds, gs, e),
                                 lambda: mg.plain_tgmm(h, ds, gs, e)),
            "moe_tgmm d(gate_up)": (lambda: mg.tgmm(xs, dgu, gs, e),
                                    lambda: mg.plain_tgmm(xs, dgu, gs, e))}
        empty = gs == 0
        for name, (kern, plain) in outs.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            key = name.split()[0]
            errs[key] = max(errs[key], held_attention(
                torch, got, ref, dtype, f"{name} {label}", fails))
            if key == "moe_tgmm" and got[empty].any():
                fails.append(f"{name} {label}: an empty group is not zero")
            del got, ref
        held_forward(torch, mg, dtype, label, x, src, xs, h, order, gu, dn,
                     gs, errs, fails)
        if not timing or kind != "random":
            continue
        es = x.element_size()
        touched = int((gs > 0).sum())
        offs = torch.cumsum(gs, 0).to(torch.int32)
        gmm = getattr(torch, "_grouped_mm", None)
        dn_t = dn.transpose(-2, -1)             # [e, d, f], a view
        gu_t = gu.transpose(-2, -1)             # [e, 2f, d]
        idx = order.long()

        def lib(what, fn):
            if gmm is None:
                log(f"  {what}: torch._grouped_mm is missing")
                return None
            got, why = library_call(torch, fn)
            if got is None:
                log(f"  {what}: torch._grouped_mm refused: {why}")
            return got

        def tg_lib(what, lhs, dy):
            """tgmm's library call: 2-D x 2-D with offsets over the rows,
            on the path's ``lhs.t()`` view, else on a prepared row-major
            copy (said so)."""
            got = lib(what, lambda: gmm(lhs.t(), dy, offs=offs))
            if got is None and gmm is not None:
                lt = lhs.t().contiguous()
                got = lib(what + " (on a contiguous copy of lhs.t())",
                          lambda: gmm(lt, dy, offs=offs))
                if got is not None:
                    log(f"  {what}: timed on a contiguous copy of lhs.t()")
            return got

        one_dlhs = lib("d(lhs)", lambda: gmm(ds, dn_t, offs=offs))
        if one_dlhs is not None:
            lerr = float((one_dlhs().float() - mg.plain_gather_gmm(
                ds, None, dn, gs, transpose_rhs=True).float()).abs().max())
            log(f"  torch._grouped_mm d(lhs) {label}: max_abs_err vs plain "
                f"{lerr:.3e}")
        wdn, wgu = es * touched * f * d, es * touched * d * 2 * f

        def tg_work(lhs, dy):
            kk, nn = lhs.shape[1], dy.shape[1]
            return (es * (m * kk + m * nn + e * kk * nn) + 4 * e,
                    2 * m * kk * nn)
        # (bytes, flops, one-call library, composite library)
        work = {
            "moe_gmm_t": (
                es * (m * d + m * f) + wdn + 4 * (m + e), 2 * m * d * f,
                None, lib("gather + _grouped_mm", lambda: gmm(
                    dpair[idx], dn_t, offs=offs))),
            "moe_gmm_t sorted (K5 d(lhs))": (
                es * (m * d + m * f) + wdn + 4 * e, 2 * m * d * f,
                one_dlhs, None),
            "moe_scatter_gmm_t": (
                es * (m * 2 * f + m * d) + wgu + 4 * (m + e),
                2 * m * 2 * f * d, None,
                lib("_grouped_mm + index_copy", lambda: torch.empty(
                    m, d, device="cuda", dtype=dt).index_copy_(
                        0, idx, gmm(dgu, gu_t, offs=offs)))),
            "moe_tgmm d(down)": tg_work(h, ds) + (
                tg_lib("tgmm d(down)", h, ds), None),
            "moe_tgmm d(gate_up)": tg_work(xs, dgu) + (
                tg_lib("tgmm d(gate_up)", xs, dgu), None)}
        timed = {}
        for name, (nbytes, flops, one, comp) in work.items():
            kern, plain = outs[name]
            b_ms, b_by = bound(nbytes, flops, dtype)
            row = dict(ms=time_ms(torch, kern), plain_ms=time_ms(
                torch, plain, reps=2, rounds=3, warmup=1), bound_ms=b_ms,
                bound_by=b_by, nbytes=nbytes, flops=flops,
                library_ms=time_ms(torch, one) if one else None)
            comp_ms = time_ms(torch, comp) if comp else None
            log(f"  {name} [{dtype}] {label} ({touched} experts touched): "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}: {nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.1f} GFLOP) library_ms={row['library_ms']}"
                + (f" composite library_ms={comp_ms:.4f}"
                   if comp_ms is not None else ""))
            timed[name] = row
        forward_at_training_shape(torch, mg, dtype, label, x, src, xs, h,
                                  order, gu, dn, gs, offs, touched)
        if shape == MOE_BWD_TIMED:
            rows["moe_gmm_t"] = timed["moe_gmm_t"]
            rows["moe_scatter_gmm_t"] = timed["moe_scatter_gmm_t"]
            tg = [timed["moe_tgmm d(down)"], timed["moe_tgmm d(gate_up)"]]
            rows["moe_tgmm"] = dict(
                merge_rows([dict(r, library_ms=0.0) for r in tg], dtype),
                library_ms=None if any(r["library_ms"] is None for r in tg)
                else sum(r["library_ms"] for r in tg))
        del x, dpair, dgu, h, ds, xs
    weights.clear()
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"[{dtype}] MoE backward kernels disagree with "
                             f"their plain versions: {fails}")
    return errs, rows


def forward_calls(mg, x, src, xs, h, order, gu, dn, gs):
    """``{name: (kernel, plain)}`` of the forward modes every MoE
    training step runs on one routing: the first matmul's gather +
    swiglu, the second's scatter, the backward's recompute of the gate /
    up projection by the gather gmm, and the sorted path's gmm."""
    return {"moe_gather_gmm_swiglu": (
                lambda: mg.gather_gmm_swiglu(x, src, gu, gs),
                lambda: mg.plain_gather_gmm_swiglu(x, src, gu, gs)),
            "moe_scatter_gmm": (
                lambda: mg.scatter_gmm(h, dn, gs, order),
                lambda: mg.plain_scatter_gmm(h, dn, gs, order)),
            "moe_gmm (recompute, gather)": (
                lambda: mg.gather_gmm(x, src, gu, gs),
                lambda: mg.plain_gather_gmm(x, src, gu, gs)),
            "moe_gmm sorted (K5 gmm)": (
                lambda: mg.gather_gmm(xs, None, gu, gs),
                lambda: mg.plain_gather_gmm(xs, None, gu, gs))}


def held_forward(torch, mg, dtype, label, x, src, xs, h, order, gu, dn, gs,
                 errs, fails):
    """The forward modes of forward_calls against their plain versions,
    elementwise and row by row; each error goes to its kernel's entry of
    ``errs``."""
    for name, (kern, plain) in forward_calls(
            mg, x, src, xs, h, order, gu, dn, gs).items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        key = name.split()[0]
        errs[key] = max(errs[key], held_attention(
            torch, got, ref, dtype, f"forward {name} {label}", fails))
        del got, ref


def forward_at_training_shape(torch, mg, dtype, label, x, src, xs, h, order,
                              gu, dn, gs, offs, touched):
    """The forward modes of forward_calls on the same rows as the
    backward, timed beside their bound and a library yardstick: for the
    sorted gmm ``torch._grouped_mm`` (one call), for K4's modes the
    composites that compute the same function (the gather, then
    ``torch._grouped_mm`` and ``silu(gate) * up``; ``torch._grouped_mm``
    and ``index_copy_`` for the scatter; the gather and
    ``torch._grouped_mm`` for the recompute); printed, not in the kernels
    line (held by held_forward)."""
    import torch.nn.functional as F
    m, d = src.shape[0], x.shape[1]
    f, es = dn.shape[1], x.element_size()
    gm, why = grouped_mm_yardstick(torch, xs, gu, offs)
    gm_dn, _ = grouped_mm_yardstick(torch, h, dn, offs)
    wgu, wdn = es * touched * d * 2 * f, es * touched * f * d
    idx, sidx = order.long(), src.long()
    calls = forward_calls(mg, x, src, xs, h, order, gu, dn, gs)
    # (bytes, flops, one-call library, composite library)
    work = {"moe_gather_gmm_swiglu": (
                es * (x.shape[0] * d + m * f) + wgu + 4 * m,
                2 * m * d * 2 * f, None,
                gm and (lambda: (lambda y: F.silu(y[:, :f]) * y[:, f:])(
                    gm(x[sidx])))),
            "moe_scatter_gmm": (
                es * (m * f + m * d) + wdn + 4 * m, 2 * m * f * d, None,
                gm_dn and (lambda: (lambda y: torch.empty_like(
                    y).index_copy_(0, idx, y))(gm_dn(h)))),
            "moe_gmm (recompute, gather)": (
                es * (x.shape[0] * d + m * 2 * f) + wgu + 4 * m,
                2 * m * d * 2 * f, None, gm and (lambda: gm(x[sidx]))),
            "moe_gmm sorted (K5 gmm)": (
                es * (m * d + m * 2 * f) + wgu, 2 * m * d * 2 * f,
                gm and (lambda: gm(xs)), None)}
    for name, (nbytes, flops, one, comp) in work.items():
        b_ms, b_by = bound(nbytes, flops, dtype)
        ms = time_ms(torch, calls[name][0])
        lib_ms = time_ms(torch, one) if one else None
        comp_ms = time_ms(torch, comp) if comp else None
        log(f"  forward {name} [{dtype}] {label}: ms={ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) ratio={ms / b_ms:.2f}"
            + (f" library_ms={lib_ms:.4f}" if lib_ms is not None else "")
            + (f" composite library_ms={comp_ms:.4f}"
               if comp_ms is not None else "")
            + (f" (torch._grouped_mm: {why})" if why else ""))


def merge_rows(rows, dtype):
    """One decoder layer runs both shapes: sum their times and bounds."""
    nbytes = sum(r["nbytes"] for r in rows)
    flops = sum(r["flops"] for r in rows)
    return dict(ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by=bound(nbytes, flops, dtype)[1],
                library_ms=sum(r["library_ms"] for r in rows))


def profiled(torch, step, n, row_limit, cpu_rows=0, by_kernel=None):
    """torch.profiler over ``n`` calls of ``step``, after one call that
    runs while the profiler starts and is not read. Prints the device
    time by kernel (and, with ``cpu_rows``, the host time by operator;
    with a dict ``by_kernel``, fills it with each kernel's device ms)
    and returns ``(wall_ms, busy_ms, scalar_reads)`` of
    the same ``n`` calls: host time from the first call to the device's
    end (profiler on), the sum of their kernels' durations (one stream,
    so they do not overlap; the ``ProfilerStep`` range on the device is
    no kernel), and the count of ``aten::_local_scalar_dense`` (a tensor
    read back to the host as a scalar, which waits for the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
        prof.step()
    log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=row_limit))
    if cpu_rows:        # where the host's time goes
        log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=cpu_rows))
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    for e in kernels if by_kernel is not None else ():
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    scalar_reads = sum(e.count for e in prof.key_averages()
                       if e.key == "aten::_local_scalar_dense")
    return wall_ms, busy_ms, scalar_reads


# ---------------------------------------------------------------- phase 4

def plain_patches(df, rpa):
    """Route the model's kernel calls to the plain versions (phase 4's
    reference run on the card), with the engines' and ``generate()``'s
    CUDA graphs off: the plain versions read values back, which a capture
    cannot."""
    from paddle_tpu_torch.generation import GenerationMixin
    from paddle_tpu_torch.inference.serving import ServingEngine
    def plain_attn(q, k_pool, v_pool, tables, ctx, q_lens, starts, w_max,
                   sm_scale=None, tree_anc=None, tree_slots=None,
                   tree_rows=None):
        return rpa.plain_ragged_paged_attention(
            q, k_pool, v_pool, tables, ctx, q_lens, starts,
            sm_scale=sm_scale, tree_anc=tree_anc, tree_slots=tree_slots,
            tree_rows=tree_rows)
    return [mock.patch.object(ServingEngine, "cuda_graphs", False),
            mock.patch.object(GenerationMixin, "cuda_graphs", False),
            mock.patch.object(df, "norm_matmul", df.plain_norm_matmul),
            mock.patch.object(df, "matmul_residual",
                              df.plain_matmul_residual),
            mock.patch.object(rpa, "ragged_paged_attention", plain_attn)]


def top2_margin(torch, model, ids):
    """The gap between the two largest next-token logits of the dense
    forward over ``ids`` (1-D), at its last position."""
    with torch.no_grad():
        logits = model(torch.as_tensor(np.asarray(ids, np.int64),
                                       device=model.device)[None])[0, -1]
    logits = logits.float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def held_streams(torch, model, what, prompts, a, b, fails,
                 limit=LOGITS_ATOL, margin=None):
    """Token streams ``a`` and ``b`` (one per prompt) must be equal; a
    divergence is tolerated only where the top-2 logit margin of the
    common context (the prompt and the agreed tokens) is at most
    ``limit``, a near tie that rounding may break either way. Logs the
    margin either way; with ``fails`` None it only logs. ``margin(i,
    ids)``: the margin of stream ``i``'s context (default: the model's
    dense forward, :func:`top2_margin`)."""
    diverged = False
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        if np.array_equal(x, y):
            continue
        diverged = True
        j = int(np.argmax(x[:len(y)] != y[:len(x)]))
        ids = np.concatenate([np.asarray(prompts[i]).reshape(-1), x[:j]])
        gap = top2_margin(torch, model, ids) if margin is None \
            else margin(i, ids)
        ok = gap <= limit
        verdict = "a near tie" if ok else (
            "FAIL" if fails is not None else "over the limit")
        log(f"  {what}: stream {i} diverges at token {j} ({x[j]} vs "
            f"{y[j]}); top-2 logit margin {gap:.3e} (limit "
            f"{limit:.3e}) {verdict}")
        if not ok and fails is not None:
            fails.append(f"{what} stream {i}")
    if not diverged:
        log(f"  {what}: streams equal ({sum(map(len, a))} tokens)")


def serve_f32(torch, ServingEngine, ServingConfig, model, prompts,
              after_first=None, draft_model=None, spec_heads=None, **kw):
    """The short float32 run of phases 4, 16 and 17: the first tick's
    logits and the streams (``after_first(engine)`` runs after the first
    tick; ``kw`` goes to the config, ``draft_model`` / ``spec_heads`` to
    the engine)."""
    eng = ServingEngine(model, ServingConfig(
        num_slots=2, block_size=16, max_model_len=512, prefill_chunk=128,
        max_new_tokens=8, **kw), device="cuda", draft_model=draft_model,
        spec_heads=spec_heads)
    rids = [eng.submit(p) for p in prompts]
    eng.step()
    first = eng.last_logits.float().clone()
    if after_first is not None:
        after_first(eng)
    done = eng.run()
    eng.shutdown()
    return first, [done[r] for r in rids]


# ---------------------------------------------------------------- phase 5

def train_run(torch, kernels, LlamaConfig, LlamaForCausalLM, AdamW,
              TrainStep):
    """The training path: Llama-3-8B widths at TRAIN["layers"] layers,
    bfloat16, TrainStep + AdamW(1e-4, multi_precision=True), as the
    reference's bench.py trains. Returns the path's launch counts."""
    cfg = LlamaConfig.llama3_8b()
    cfg.dtype = "bfloat16"
    cfg.num_hidden_layers = TRAIN["layers"]
    bsz, seq = TRAIN["batch"], TRAIN["seq"]
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, lambda out, a, k: out, opt)
    rng = np.random.RandomState(SEED)
    pool = []
    for _ in range(TRAIN["pool"]):
        ids = rng.randint(0, cfg.vocab_size, (bsz, seq)).astype(np.int64)
        pool.append(tuple(torch.from_numpy(a).cuda()
                          for a in (ids, np.roll(ids, -1, axis=1))))
    torch.cuda.synchronize()
    log(f"phase 5: Llama-3-8B widths, {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e9:.3f}B params bf16, batch {bsz} x {seq}, init "
        f"{time.monotonic() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    it = 0

    def one_step():
        nonlocal it
        loss = step(*pool[it % len(pool)])
        it += 1
        return loss

    losses = [float(one_step()) for _ in range(TRAIN["warm"])]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    timed = [one_step() for _ in range(TRAIN["timed"])]
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    losses += [float(x) for x in timed]
    # where a step's time goes, and the device's idle share of the same
    # steps' wall time
    n_prof = TRAIN["profiled"]
    wall_ms, busy_ms, _ = profiled(torch, one_step, n_prof, 20)
    log(f"phase 5 profile: {n_prof} steps, wall {wall_ms:.3f} ms "
        f"({wall_ms / n_prof:.3f} ms a step, profiler on), device busy "
        f"{busy_ms:.3f} ms -> idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f}")
    torch.cuda.synchronize()
    launches = {k: kernels.launch_counts[k] for k in TRAINING_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    tokens = bsz * seq * TRAIN["timed"]
    tok_s = tokens / dt
    ms_step = 1e3 * dt / TRAIN["timed"]
    peak_flops = PEAK_FLOPS["bfloat16"]
    lsh = cfg.num_hidden_layers * seq * cfg.hidden_size
    # the reference's bench.py formula: every parameter in 6N, attention
    # as if no column were masked
    f_ref = 6 * n_params + 12 * lsh
    # the matmuls the step runs: the input embedding is a gather, and
    # causal attention computes half the score and PV products
    f_model = 6 * (n_params - cfg.vocab_size * cfg.hidden_size) + 6 * lsh
    log(f"phase 5: {TRAIN['timed']} timed steps in {dt:.4f}s -> "
        f"{ms_step:.3f} ms/step, {tok_s:.1f} tokens/s, "
        f"MFU {tok_s * f_ref / peak_flops:.4f} (6N + 12 L s h = "
        f"{f_ref / 1e9:.3f} GFLOP/token), without the input embedding and "
        f"with causal attention {tok_s * f_model / peak_flops:.4f} "
        f"(6(N - V h) + 6 L s h = {f_model / 1e9:.3f} GFLOP/token), at "
        f"{peak_flops / 1e12:.1f} TFLOP/s; peak memory "
        f"{peak / 2**30:.2f} GiB; master weights "
        f"{len(opt._master_weights)}")
    log(f"phase 5: losses {[round(x, 5) for x in losses]} "
        f"(steps 1-{TRAIN['warm']} untimed; {n_prof + 1} more steps "
        f"under the profiler)")
    log(f"phase 5: kernel launches {launches} over {it} steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    want = cfg.num_hidden_layers * it
    wrong = {k: n for k, n in launches.items() if n != want}
    if wrong:
        raise AssertionError(f"training kernels launched {wrong} times, "
                             f"want {want} each (layers x steps)")
    return launches


# ---------------------------------------------------------------- phase 6

def train_f32_check(torch, fa, LlamaConfig, LlamaForCausalLM):
    """Kernel path against plain path on the card, float32: the loss and
    every parameter's gradient of one forward + backward."""
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = PHASE6["layers"]
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED + 2)
    rng = np.random.RandomState(SEED + 2)
    ids = rng.randint(0, cfg.vocab_size,
                      (PHASE6["batch"], PHASE6["seq"])).astype(np.int64)
    ids_t = torch.from_numpy(ids).cuda()
    labels_t = torch.from_numpy(np.roll(ids, -1, axis=1)).cuda()

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model(ids_t, labels=labels_t)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    loss_k, grads_k = loss_and_grads()
    patches = [mock.patch.object(fa, "flash_attention_fwd",
                                 fa.plain_flash_attention_fwd),
               mock.patch.object(fa, "flash_attention_dq",
                                 fa.plain_flash_attention_dq),
               mock.patch.object(fa, "flash_attention_dkv",
                                 fa.plain_flash_attention_dkv)]
    for p in patches:
        p.start()
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        for p in patches:
            p.stop()
    lerr = abs(loss_k - loss_p) / abs(loss_p)
    gerr = {n: float((grads_k[n] - grads_p[n]).abs().max()
                     / grads_p[n].abs().max().clamp(min=1e-30))
            for n in grads_p}
    worst = max(gerr, key=gerr.get)
    log(f"phase 6: f32, {cfg.num_hidden_layers} layers at full widths, "
        f"{PHASE6['batch']} x {PHASE6['seq']} tokens: loss kernel "
        f"{loss_k:.6f} plain {loss_p:.6f} (rel {lerr:.2e}, tol "
        f"{LOSS_RTOL}); {len(gerr)} gradients, worst {worst} rel "
        f"{gerr[worst]:.2e} (tol {GRAD_RTOL})")
    if not lerr <= LOSS_RTOL:
        raise AssertionError(f"kernel path loss disagrees: {lerr}")
    bad = {n: e for n, e in gerr.items() if not e <= GRAD_RTOL}
    if bad:
        raise AssertionError(f"kernel path gradients disagree: {bad}")


# ---------------------------------------------------------- phases 7, 8

def motif_prompts(batch, length, motif, vocab, seed):
    """Seeded prompts: random tokens with one seeded ``motif``-token run
    repeated at four places, so prompt lookup has something to find."""
    rng = np.random.RandomState(seed)
    run = rng.randint(0, vocab, motif)
    out = rng.randint(0, vocab, (batch, length))
    step = length // 4
    for r in range(batch):
        for k in range(4):
            at = k * step + (r * 7) % (step - motif + 1)
            out[r, at:at + motif] = run
    return out.astype(np.int64)


def logit_noise(torch, model, ids):
    """The largest |difference|, over rows and vocabulary, between the
    last-position logits of two bf16 recipes of one forward over ``ids``:
    the dense forward (K1f attention) and generate()'s cached prefill
    (float32 scores, weights rounded to bf16 before P @ V). Two bf16
    paths through the model disagree by up to about this much, so a
    top-2 margin under it is a near tie they may break either way."""
    with torch.no_grad():
        a = model(ids)[:, -1].float()
        b, _ = model(ids, caches=model.init_caches(*ids.shape), offset=0)
        return float((a - b[:, -1].float()).abs().max())


def generate_once(torch, kernels, model, ids, new, kw, forwards, tag,
                  counted, want, scores_out=None):
    """One timed ``generate()`` with every launch count set to 0 just
    before it and read just after: checks the output, logs tokens/s, ms
    per target forward (``forwards`` collects the model's forward calls
    of the dense path; a paged run counts its decode steps by K2d's
    launches, a replayed graph calling no forward), tokens per verify and
    peak memory, and fails when a kernel of ``want`` never launched.
    Returns ``(stream, launches of counted, tokens emitted per row per
    verify)``; ``scores_out`` (a list) takes the scores."""
    cfg = model.config
    b = ids.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forwards.clear()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out, scores = model.generate(ids, max_new_tokens=new, **kw)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = {k: kernels.launch_counts[k] for k in counted}
    out = out.cpu().numpy()
    if out.shape != (b, new) or out.min() < 0 \
            or out.max() >= cfg.vocab_size \
            or not torch.isfinite(scores).all():
        raise AssertionError(f"{tag}: bad output {out} {scores}")
    spec = "num_speculative_tokens" in kw
    # one K2v launch per layer per verify window (on bf16 or int8 pools,
    # linear or tree);
    # the loop runs until the slowest row is done: (new - 1) tokens after
    # the prefill's over the windows (1.0: no draft accepted)
    windows = sum(n for k, n in kernels.launch_counts.items()
                  if k.startswith("paged_verify_attention")) \
        // cfg.num_hidden_layers
    steps = sum(n for k, n in kernels.launch_counts.items()
                if k.startswith("paged_decode_attention")) \
        // cfg.num_hidden_layers
    n_fwd = 1 + windows if spec else 1 + steps \
        if kw.get("cache_impl") == "paged" else len(forwards)
    if scores_out is not None:
        scores_out.append(scores.cpu().numpy())
    per_verify = (new - 1) / max(1, windows)
    log(f"{tag}: {b} x {new} tokens in {dt:.3f}s -> "
        f"{b * new / dt:.1f} tokens/s, {n_fwd} target forwards, "
        f"{1e3 * dt / n_fwd:.2f} ms per target forward" + (
            f", {per_verify:.3f} tokens emitted per row per verify "
            f"({windows} verify forwards)" if spec else "")
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches {launches}")
    missing = [k for k in want if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    return out, launches, per_verify


def graph_vs_eager_generate(torch, kernels, model, ids, new, runs,
                            forwards, streams, scores, launches, fails):
    """Phase 19 (d) at phase 7's shape: each ``runs`` entry (paged,
    n-gram, self-drafted, tree), run by phase 7 with its steps replayed
    from CUDA graphs (``streams``, ``scores``, ``launches``), runs again
    with the model's ``cuda_graphs`` off, every step eager: the tokens,
    the scores and the launch counts must be equal to the bit. Both runs'
    ms per target forward are logged (phase 7's lines and these)."""
    t0 = time.monotonic()
    model.cuda_graphs = False
    try:
        for name, kw in runs.items():
            sc = []
            s_e, n_e, _ = generate_once(
                torch, kernels, model, ids, new, kw, forwards,
                f"phase 19 (d) {name} eager", GENERATE_KERNELS, (),
                scores_out=sc)
            ok = np.array_equal(s_e, streams[name]) and n_e == launches[name] \
                and np.array_equal(sc[0].view(np.int32),
                                   scores[name].view(np.int32))
            log(f"phase 19 (d) {name}: steps replayed from graphs (phase 7) "
                f"vs eager: tokens, scores and launch counts "
                f"{'equal to the bit' if ok else 'DIFFER'}")
            if not ok:
                fails.append(f"phase 19 (d) {name}: graph != eager")
    finally:
        del model.cuda_graphs
    log(f"phase 19 (d): {time.monotonic() - t0:.1f}s")


def generate_run(torch, kernels, model, LlamaConfig, LlamaForCausalLM):
    """Phase 7: generate() on the 32-layer bf16 model five ways. Returns
    ``{run: launch counts}``."""
    cfg = model.config
    dcfg = LlamaConfig.llama3_8b()
    dcfg.dtype = "bfloat16"
    dcfg.num_hidden_layers = GENERATE["draft_layers"]
    draft = LlamaForCausalLM(dcfg, device="cuda", seed=SEED + 4)
    b, new, gamma = GENERATE["batch"], GENERATE["new"], GENERATE["gamma"]
    prompts = motif_prompts(b, GENERATE["prompt"], GENERATE["motif"],
                            cfg.vocab_size, SEED + 3)
    ids = torch.from_numpy(prompts).to(model.device)
    forwards = []
    hook = model.register_forward_pre_hook(lambda m, a: forwards.append(1))
    # "self": the target drafts for itself (K2d drafts, K2v verifies), so
    # drafts are accepted and windows commit up to gamma + 1 tokens
    # "chain" / "tree": n-gram drafts filling CHAIN_TREE (gamma 4, the
    # linear n-gram run's windows) and BRANCH_TREE (gamma 7), verified by
    # K2v's tree mode
    runs = {"dense": dict(cache_impl="dense"),
            "paged": dict(cache_impl="paged"),
            "ngram": dict(num_speculative_tokens=gamma),
            "draft": dict(num_speculative_tokens=gamma, draft_model=draft),
            "self": dict(num_speculative_tokens=gamma, draft_model=model),
            "chain": dict(num_speculative_tokens=len(CHAIN_TREE),
                          spec_tree=CHAIN_TREE),
            "tree": dict(num_speculative_tokens=len(BRANCH_TREE),
                         spec_tree=BRANCH_TREE)}
    linear = ("paged_decode_attention", "paged_verify_attention")
    want = {"paged": ("paged_decode_attention",),
            "ngram": ("paged_verify_attention",),
            "draft": linear, "self": linear,
            "chain": ("paged_verify_attention_tree",),
            "tree": ("paged_verify_attention_tree",)}
    streams, launches, per_verify, fails = {}, {}, {}, []
    scores = {}
    for name, kw in runs.items():
        sc = []
        streams[name], launches[name], per_verify[name] = generate_once(
            torch, kernels, model, ids, new, kw, forwards,
            f"phase 7 {name}", GENERATE_KERNELS, want.get(name, ()),
            scores_out=sc)
        scores[name] = sc[0]
        if name == "self" and not per_verify[name] > 1:
            fails.append("phase 7 self: no draft accepted")
        if name in ("chain", "tree") \
                and launches[name]["paged_verify_attention"]:
            fails.append(f"phase 7 {name}: linear K2v launched")
    # a chain tree is the linear n-gram path: the same windows, tokens
    same = np.array_equal(streams["chain"], streams["ngram"]) \
        and per_verify["chain"] == per_verify["ngram"]
    log(f"  phase 7 chain {CHAIN_TREE} vs ngram gamma {gamma}: streams "
        f"{'equal' if np.array_equal(streams['chain'], streams['ngram']) else 'DIFFER'}"
        f", tokens per verify {per_verify['chain']:.4f} / "
        f"{per_verify['ngram']:.4f} {'ok' if same else 'FAIL'}")
    if not same:
        fails.append("phase 7 chain tree != linear n-gram")
    graph_vs_eager_generate(torch, kernels, model, ids, new,
                            {k: runs[k] for k in GRAPHED_GENERATE},
                            forwards, streams, scores, launches, fails)
    hook.remove()
    # where a paged generate()'s time goes, and the device's idle share
    n_new = GENERATE["profiled_new"]
    wall_ms, busy_ms, _ = profiled(torch, lambda: model.generate(
        ids, max_new_tokens=n_new, cache_impl="paged"), 1, 15)
    log(f"phase 7 profile: one paged generate() of {n_new} new tokens "
        f"(prefill included), wall {wall_ms:.3f} ms (profiler on), device "
        f"busy {busy_ms:.3f} ms -> idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f}")
    del draft
    noise = logit_noise(torch, model, ids)
    log(f"phase 7: bf16 logits of two recipes (dense forward vs cached "
        f"prefill, {b} x {GENERATE['prompt']} tokens) differ by up to "
        f"{noise:.3e}: the near-tie limit of the bf16 streams")
    # the bf16 streams against dense, logged; the self-drafted stream
    # (every token a K2v verify's argmax) held against paged (every token
    # a K2d step's)
    for name in ("paged", "ngram", "draft", "self"):
        held_streams(torch, model, f"phase 7 {name} vs dense", prompts,
                     streams[name], streams["dense"], None, limit=noise)
    held_streams(torch, model, "phase 7 self vs paged", prompts,
                 streams["self"], streams["paged"], fails, limit=noise)
    held_streams(torch, model, "phase 7 tree vs paged", prompts,
                 streams["tree"], streams["paged"], fails, limit=noise)
    if fails:
        raise AssertionError(f"phase 7 failed: {fails}")
    return launches


def tree_verify_check(torch, model, ids, tree, path, fails):
    """One hand-built tree verify (``build_tree_verify_step``, greedy)
    through the kernels whose window is built a depth at a time so that
    ``path`` is its greedy root path (off the spine: the spine's head
    carries a wrong token). The emitted tokens must be the path's and its
    last node's argmax; the pools after it must be the window's rows moved
    by the path (``permute_window``), bit for bit; and those of sequential
    paged decoding of the emitted tokens within float32's TOL where rope
    positions allow: every layer for a chain, layer 0's V off the spine
    (the model ropes window node j at lens + j, as the reference does)."""
    from paddle_tpu_torch.generation import _paged_prefill
    from paddle_tpu_torch.generation import speculative as spec
    from paddle_tpu_torch.ops import paged_cache as pc
    from paddle_tpu_torch.ops.kernels import paged_attention as pda
    bs, (b, P), t = 16, ids.shape, len(tree) + 1
    mb = pc.blocks_for(P + t, bs)
    lens = torch.full((b,), P, dtype=torch.int32, device=ids.device)
    vocab = model.config.vocab_size

    def window(toks):
        _, tables, pools = _paged_prefill(model, ids, mb, bs)
        with pda.spec_tree_scope(tree):
            logits, pools = model(toks, caches=pools, block_tables=tables,
                                  cache_lens=lens)
        return logits, tables, pools

    with torch.no_grad():
        logits, _, _ = _paged_prefill(model, ids, mb, bs)
        toks = (torch.arange(t, device=ids.device)[None, :] * 7 + 3
                + torch.arange(b, device=ids.device)[:, None]) % vocab
        toks[:, 0] = logits[:, -1].argmax(-1)
        for d in range(1, len(path)):
            logits, _, _ = window(toks)
            toks[:, path[d]] = logits[:, path[d - 1]].argmax(-1)
            if d == 1 and path[1] != 1:
                toks[:, 1] = (toks[:, path[1]] + 1) % vocab
        logits, tables, wpools = window(toks)
        bonus = logits[:, path[-1]].argmax(-1)
        verify = spec.build_tree_verify_step(spec._paged_step(model),
                                             parents=tree, do_sample=False)
        _, tables, pools = _paged_prefill(model, ids, mb, bs)
        out, accept, _, pools = verify(pools, tables, lens, toks)
        _, _, seq = _paged_prefill(model, ids, mb, bs)
        for j, i in enumerate(path):
            _, seq = model(toks[:, i:i + 1], caches=seq, block_tables=tables,
                           cache_lens=lens + j)
    n_acc = len(path) - 1
    want = torch.cat([toks[:, list(path[1:])], bonus[:, None]], 1)
    ok_tok = torch.equal(out[:, :n_acc + 1], want) \
        and bool(accept[:, :n_acc].all()) and not bool(accept[:, n_acc:].any())
    src = torch.tensor([P + i for i in path], device=ids.device)
    moved = all(torch.equal(pc.gather_dense(a, tables)[:, :P],
                            pc.gather_dense(w, tables)[:, :P])
                and torch.equal(pc.gather_dense(a, tables)[:, P:P + n_acc + 1],
                                pc.gather_dense(w, tables)[:, src])
                for kv, wkv in zip(pools, wpools) for a, w in zip(kv, wkv))
    chain = tuple(path[1:]) == tuple(range(1, len(path)))
    halves = [(li, h) for li in range(len(seq)) for h in (0, 1)] if chain \
        else [(0, 1)]
    keep = P + n_acc + 1
    err, close = 0.0, True
    for li, h in halves:
        a = pc.gather_dense(pools[li][h], tables)[:, :keep]
        w = pc.gather_dense(seq[li][h], tables)[:, :keep]
        err = max(err, float((a - w).abs().max()))
        close = close and torch.allclose(a, w, **TOL["float32"])
    ok = ok_tok and moved and close
    log(f"  phase 8 tree verify {tree}, path {path}: tokens "
        f"{'ok' if ok_tok else 'FAIL'}; pools = window rows moved by the "
        f"path {'bitwise' if moved else 'FAIL'}; against sequential decode "
        f"({'every layer' if chain else 'layer 0 V'}) max_abs_err "
        f"{err:.3e} {'ok' if close else 'FAIL'}")
    if not ok:
        fails.append(f"phase 8 tree verify {tree}")


def generate_f32_check(torch, pda, LlamaConfig, LlamaForCausalLM):
    """Phase 8: paged and speculative greedy generate() (n-gram drafts,
    and the model drafting for itself) through the kernels and through
    their plain versions, float32, 2 layers at full widths. Streams must
    be equal, scores within SCORE_ATOL, and the self-drafted run must
    accept drafts."""
    from paddle_tpu_torch.generation import GenerationMixin
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = PHASE8["layers"]
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED + 5)
    prompts = motif_prompts(PHASE8["batch"], PHASE8["prompt"],
                            PHASE8["motif"], cfg.vocab_size, SEED + 5)
    ids = torch.from_numpy(prompts).to(model.device)
    # "self": the target drafts for itself, so its drafts are accepted
    # and the verify windows commit up to gamma + 1 tokens each (random
    # weights accept no n-gram draft)
    kinds = {"paged": dict(cache_impl="paged"),
             "spec": dict(num_speculative_tokens=PHASE8["gamma"]),
             "self": dict(num_speculative_tokens=PHASE8["gamma"],
                          draft_model=model),
             "tree": dict(num_speculative_tokens=len(BRANCH_TREE),
                          spec_tree=BRANCH_TREE)}
    res, windows = {}, None
    for path in ("kernel", "plain"):
        patches = [] if path == "kernel" else [
            mock.patch.object(GenerationMixin, "cuda_graphs", False),
            mock.patch.object(pda, "paged_decode_attention",
                              pda.plain_paged_decode_attention),
            mock.patch.object(pda, "paged_verify_attention",
                              pda.plain_paged_verify_attention)]
        for p in patches:
            p.start()
        try:
            for kind, kw in kinds.items():
                counts0 = dict(pda.launch_counts)
                out, sc = model.generate(ids, max_new_tokens=PHASE8["new"],
                                         **kw)
                n = sum(pda.launch_counts[k] - counts0[k]
                        for k in GENERATE_KERNELS)
                if (n > 0) != (path == "kernel"):
                    raise AssertionError(f"phase 8 {path} {kind}: {n} "
                                         "kernel launches")
                if (path, kind) == ("kernel", "tree") and not (
                        pda.launch_counts["paged_verify_attention_tree"]
                        > counts0["paged_verify_attention_tree"]):
                    raise AssertionError("phase 8 kernel tree: the tree "
                                         "mode never launched")
                if (path, kind) == ("kernel", "self"):
                    # one K2v launch per layer per verify window
                    windows = (pda.launch_counts["paged_verify_attention"]
                               - counts0["paged_verify_attention"]) \
                        // cfg.num_hidden_layers
                res[path, kind] = (out.cpu().numpy(), sc.cpu().numpy())
        finally:
            for p in patches:
                p.stop()
    fails = []
    for a, b in ((("kernel", "paged"), ("plain", "paged")),
                 (("kernel", "spec"), ("plain", "spec")),
                 (("kernel", "self"), ("plain", "self")),
                 (("kernel", "tree"), ("plain", "tree")),
                 (("kernel", "spec"), ("kernel", "paged")),
                 (("kernel", "self"), ("kernel", "paged")),
                 (("plain", "spec"), ("plain", "paged"))):
        what = f"phase 8 {' '.join(a)} vs {' '.join(b)}"
        held_streams(torch, model, what, prompts, res[a][0], res[b][0],
                     fails)
        if np.array_equal(res[a][0], res[b][0]):
            err = float(np.abs(res[a][1] - res[b][1]).max())
            log(f"  {what}: scores max_abs_err={err:.3e} (atol "
                f"{SCORE_ATOL}) {'ok' if err <= SCORE_ATOL else 'FAIL'}")
            if not err <= SCORE_ATOL:
                fails.append(f"{what} scores")
    # the loop runs until the slowest row is done: (new - 1) tokens after
    # the prefill's over the windows; 1.0 would mean no draft accepted
    per_window = (PHASE8["new"] - 1) / max(1, windows)
    log(f"  phase 8 kernel self: {windows} verify windows, {per_window:.3f}"
        f" tokens emitted per row per window "
        f"{'ok' if per_window > 1 else 'FAIL (no draft accepted)'}")
    if not per_window > 1:
        fails.append("phase 8 kernel self: no draft accepted")
    # the tree stream against the paged one, logged: a branch node sits at
    # its window position, not its depth, in the rope (the reference's
    # recipe), so an accepted branch may part it from sequential decoding
    held_streams(torch, model, "phase 8 kernel tree vs kernel paged",
                 prompts, res["kernel", "tree"][0],
                 res["kernel", "paged"][0], None)
    for tree, path in TREE_PATHS.items():
        tree_verify_check(torch, model, ids, tree, path, fails)
    log(f"phase 8: f32, {cfg.num_hidden_layers} layers at full widths, "
        f"{PHASE8['batch']} prompts of {PHASE8['prompt']} tokens, "
        f"{PHASE8['new']} new tokens, gamma {PHASE8['gamma']}")
    if fails:
        raise AssertionError(f"phase 8 failed: {fails}")


# ------------------------------------------------------- phases 9 to 11

def serving_prompts(vocab, n, seed):
    """Phase 3's traffic: ``n`` prompts of 64..1024 tokens, seeded."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(64, 1025, size=n)
    return lens, [rng.randint(0, vocab, size=k) for k in lens]


def serve_run(torch, kernels, engine, prompts, lens, tag, want,
              adapter_ids=None):
    """Submit every prompt at once (under ``adapter_ids``' LoRA adapters,
    one a prompt, where given) and run the engine dry, with every
    launch count set to 0 just before and read just after. Checks the
    tokens, logs tokens/s, TTFT, ticks, rows a tick and peak memory, and
    fails when a kernel of ``want`` never launched. Returns ``(launches,
    stats, streams in submission order)``; the stats gain ``wall_s``."""
    cfg = engine.model.config
    max_new = engine.config.max_new_tokens
    rids = [engine.submit(p, adapter_id=a) for p, a in zip(
        prompts, adapter_ids or [None] * len(prompts))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(kernels.launch_counts)
    st = dict(engine.stats(), wall_s=wall)
    if sorted(done) != sorted(rids):
        raise AssertionError(f"{tag}: {len(done)} of {len(rids)} requests "
                             "done")
    for rid, toks in done.items():
        if len(toks) != max_new or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{tag}: request {rid}: bad tokens {toks}")
    # (a per-width verify step keeps no logits: its tokens are checked)
    if engine.last_logits is not None \
            and not torch.isfinite(engine.last_logits).all():
        raise AssertionError(f"{tag}: non-finite logits in the last tick")
    n_tok = sum(len(t) for t in done.values())
    log(f"{tag}: {len(prompts)} requests, prompt tokens {int(sum(lens))} "
        f"(lengths {[int(n) for n in lens]}), {n_tok} tokens in {wall:.3f}s "
        f"-> {n_tok / wall:.2f} tok/s; ticks {st['ticks']}, rows "
        f"{st['rows_total']} ({st['rows_total'] / st['ticks']:.1f} a tick); "
        f"TTFT ms mean {st['ttft_ms']['mean']:.1f} p50 "
        f"{st['ttft_ms']['p50']:.1f} max {st['ttft_ms']['max']:.1f}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(reserved {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB, "
        f"the graphs' pools included)")
    gap = st["host_gap_ms"]
    log(f"{tag}: {st['pure_ticks']} pure ticks ({st['pipelined_ticks']} "
        f"pipelined), {st['executables_compiled']} CUDA graphs, "
        f"async_depth {st['async_depth']}, pipeline flushes "
        f"{st['pipeline_flushes']}, host gap ms p50 {gap['p50']:.3f} p99 "
        f"{gap['p99']:.3f}")
    log(f"{tag}: kernel launches {launches}")
    missing = [k for k in want if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched on the main "
                             f"path: {missing}")
    return launches, st, [done[r] for r in rids]


def pool_tensors(pools):
    """Every tensor of a per-layer ``[(k, v), ...]`` pool list (an int8
    pool's data and scales)."""
    for pair in pools:
        for p in pair:
            yield from ((p.data, p.scale) if hasattr(p, "scale") else (p,))


def lockstep(torch, kernels, ServingEngine, model, cfg, prompts, max_new,
             tag, draft=None, stagger=3, adapters=None, on_tick=None):
    """The core of :func:`graph_lockstep` and :func:`per_width_lockstep`:
    two engines of ``cfg`` over ``model`` (and ``draft``), one replaying
    its steps from CUDA graphs and one running them eagerly (its graphs
    off), stepped in lockstep over ``prompts``, prompt k submitted before
    tick ``stagger * k``: at every tick both must commit the same tokens,
    add the same launch counts and give the same logits to the bit, and
    at the end every layer's pools (the null block aside) must be equal
    to the bit. ``adapters``: ``(weights by adapter id, an adapter id or
    None a prompt)`` for a LoRA ``cfg``; ``on_tick(engine, tick)`` runs on
    each engine before its tick. Returns the two engines, the graph one
    first."""
    engines = []
    for graphs in (True, False):
        e = ServingEngine(model, cfg, device="cuda", draft_model=draft)
        e.cuda_graphs = graphs
        for aid, w in (adapters[0] if adapters else {}).items():
            e.load_adapter(aid, w)
        engines.append(e)
    aids = adapters[1] if adapters else [None] * len(prompts)
    waiting = list(zip(prompts, aids))
    ticks = 0
    while waiting or any(e.num_active or e.num_queued for e in engines):
        while waiting and ticks >= stagger * (len(prompts) - len(waiting)):
            p, aid = waiting.pop(0)
            for e in engines:
                e.submit(p, max_new, adapter_id=aid)
        seen = []
        for e in engines:
            if on_tick is not None:
                on_tick(e, ticks)
            c0 = dict(kernels.launch_counts)
            emitted = e.step()
            torch.cuda.synchronize()
            added = {k: v - c0[k] for k, v in kernels.launch_counts.items()
                     if v != c0[k]}
            lg = None if e.last_logits is None else e.last_logits.clone()
            seen.append((emitted, added, lg))
        (em_g, n_g, lg_g), (em_e, n_e, lg_e) = seen
        if em_g != em_e or n_g != n_e or (lg_g is None) != (lg_e is None) \
                or (lg_g is not None and not torch.equal(lg_g, lg_e)):
            raise AssertionError(
                f"{tag}: tick {ticks}: the graph engine differs from the "
                f"eager one (tokens {em_g} vs {em_e}, launches {n_g} vs "
                f"{n_e})")
        ticks += 1
    results = [e.run() for e in engines]
    if {r: list(t) for r, t in results[0].items()} \
            != {r: list(t) for r, t in results[1].items()}:
        raise AssertionError(f"{tag}: streams differ")
    for name in ("_pools", "_dpools"):
        pg, pe = (getattr(e, name) for e in engines)
        if pg is None:
            continue
        for a, b in zip(pool_tensors(pg), pool_tensors(pe)):
            if not torch.equal(a[1:], b[1:]):
                raise AssertionError(f"{tag}: {name} differ after the run")
    return engines


def graph_lockstep(torch, kernels, ServingEngine, model, cfg, prompts,
                   max_new, tag, draft=None, stagger=3, adapters=None,
                   on_tick=None):
    """:func:`lockstep` on the ragged engine, at the same widths in both
    engines, the prompts staggered so that ticks with prefill rows recur
    beside decoding slots. Returns the graph engine's ``stats()`` with its ``mixed_graphs`` / ``mixed_replays``
    (ticks with prefill rows, at the static width) and ``pure_graphs`` /
    ``pure_replays``; fails unless both kinds replayed."""
    engines = lockstep(torch, kernels, ServingEngine, model, cfg, prompts,
                       max_new, tag, draft, stagger, adapters, on_tick)
    eng = engines[0]
    st = eng.stats()
    pure_graphs = sum(lay.pure for lay in eng._graphs)
    mixed_graphs = len(eng._graphs) - pure_graphs
    st.update(pure_graphs=pure_graphs, mixed_graphs=mixed_graphs,
              pure_replays=st["pure_ticks"] - pure_graphs,
              mixed_replays=st["ticks"] - st["pure_ticks"] - mixed_graphs)
    if any(lay.rows != eng._rows or lay.w_max != eng._wmax
           for lay in eng._graphs if not lay.pure):
        raise AssertionError(f"{tag}: a mixed tick off the static width")
    if st["pure_replays"] < 1 or st["mixed_replays"] < 1:
        raise AssertionError(
            f"{tag}: no replay of both kinds ({st['pure_ticks']} pure "
            f"ticks, {pure_graphs} pure graphs; "
            f"{st['ticks'] - st['pure_ticks']} mixed ticks, {mixed_graphs}"
            " mixed graphs)")
    for e in engines:
        e.shutdown()
    return st


def tick_window(torch, engine, prompts, n, tag, by_kernel=None):
    """Where a tick's time goes: a fresh wave of ``prompts``, 4 untimed
    ticks, then torch.profiler over ``n`` ticks (device time by kernel,
    host time by operator, the idle share of their wall time, host reads
    of device scalars a tick; ``by_kernel``: :func:`profiled`'s), then
    the wave drained. Returns the scalar reads a tick."""
    for p in prompts:
        engine.submit(p)
    for _ in range(4):
        engine.step()
    st0 = engine.stats()
    wall_ms, busy_ms, reads = profiled(torch, engine.step, n, 15,
                                       cpu_rows=12, by_kernel=by_kernel)
    st1 = engine.stats()
    engine.run()
    ticks = st1["ticks"] - st0["ticks"]
    mixed = ticks - (st1["pure_ticks"] - st0["pure_ticks"])
    log(f"{tag} profile: {n} ticks, wall {wall_ms:.3f} ms (profiler on), "
        f"device busy {busy_ms:.3f} ms -> idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f}; aten::_local_scalar_dense "
        f"{reads / n:.2f} a tick; {mixed} of the {ticks} ticks run (the "
        f"profiler's first included) with prefill rows, "
        f"{wall_ms / n:.3f} ms a tick, device {busy_ms / n:.3f} ms a tick")
    return reads / n


def pure_tick_window(torch, engine, prompts, n, tag, by_kernel=None):
    """Where a pure tick's time goes: a fresh wave of ``prompts`` stepped
    until no prompt is queued or pending, then torch.profiler over ``n``
    ticks that must all be pure (every seated slot decoding: a graph's
    replay on the card; ``by_kernel``: :func:`profiled`'s), then the wave
    drained. Returns ``(wall ms a tick, idle share)``."""
    for p in prompts:
        engine.submit(p)
    while engine.num_queued or any(s is not None and s.pend_pos is not None
                                   for s in engine._slots):
        engine.step()
    p0 = engine.stats()["pure_ticks"]
    wall_ms, busy_ms, _ = profiled(torch, engine.step, n, 12, cpu_rows=8,
                                   by_kernel=by_kernel)
    pure = engine.stats()["pure_ticks"] - p0
    engine.run()
    if pure < n:
        raise AssertionError(f"{tag}: {pure} of the {n + 1} profiled ticks "
                             "were pure")
    idle = max(0.0, 1 - busy_ms / wall_ms)
    log(f"{tag} pure-tick profile: {n} ticks, wall {wall_ms:.3f} ms "
        f"({wall_ms / n:.3f} a tick, profiler on), device busy "
        f"{busy_ms:.3f} ms -> idle share {idle:.4f}")
    return wall_ms / n, idle


def per_width_lockstep(torch, kernels, ServingEngine, model, cfg, prompts,
                       max_new, tag, draft=None, stagger=3):
    """:func:`lockstep` on the per-width engine (``cfg`` with
    ``ragged_batch=False``), whose graph engine replays every step from
    its CUDA graph (decode or verify, the draft loop, the chunk steps and
    their draft twins, the buckets). Returns the graph engine's
    ``stats()`` with ``graphs``, the names of its captured steps; fails
    unless it replayed a step past its capture."""
    engines = lockstep(torch, kernels, ServingEngine, model, cfg, prompts,
                       max_new, tag, draft, stagger)
    eng = engines[0]
    st = dict(eng.stats(), graphs=sorted(
        n for n, step in eng._pw.items() if step.graph is not None))
    steps = st["decode_steps"] + st["prefill_chunks"]
    if st["executables_compiled"] != len(st["graphs"]) \
            or steps <= len(st["graphs"]):
        raise AssertionError(f"{tag}: {st['graphs']} captured over {steps} "
                             "steps: nothing replayed")
    for e in engines:
        e.shutdown()
    return st


LOCKSTEP = dict(num_slots=4, block_size=16, max_model_len=512,
                prefill_chunk=128)
LOCKSTEP_PROMPT = 300


def lockstep_run(torch, kernels, ServingEngine, ServingConfig, model, tag,
                 draft=None, **kw):
    """Phase 19 (a) and (c) on a loaded model: :func:`graph_lockstep` of
    ``LOCKSTEP`` engines (``kw`` to the config) over 4 prompts of
    ``LOCKSTEP_PROMPT`` tokens (three 128-row chunks each, so a mixed
    layout recurs), 16 new, submitted 3 ticks apart, logged."""
    t0 = time.monotonic()
    rng = np.random.RandomState(SEED + 19)
    prompts = [rng.randint(0, model.config.vocab_size, size=LOCKSTEP_PROMPT)
               for _ in range(4)]
    st = graph_lockstep(torch, kernels, ServingEngine, model,
                        ServingConfig(**LOCKSTEP, **kw), prompts, 16, tag,
                        draft=draft)
    log(f"{tag}: {st['ticks']} ticks in lockstep, {st['pure_ticks']} pure "
        f"({st['pure_graphs']} graphs, {st['pure_replays']} replays), "
        f"{st['ticks'] - st['pure_ticks']} with prefill rows at the static "
        f"width ({st['mixed_graphs']} graphs, {st['mixed_replays']} "
        f"replays): tokens, logits and launch counts of every tick and the "
        f"pools at the end equal to the eager engine's, bit for bit "
        f"({time.monotonic() - t0:.1f}s)")
    return st


def async_phase(torch, kernels, ServingEngine, ServingConfig, model, prompts,
                lens, streams3, pure3):
    """Phase 19 on phase 3's model (Llama-3-8B widths, bf16): (a) the
    ticks of the bf16 engine, of an int8 engine and of the model drafting
    for itself at gamma 4, pure and mixed, each replayed from its graph
    and held against the same ticks run eagerly (:func:`lockstep_run`;
    (c): the launch counts each tick adds, to the count); (b) phase 3's
    traffic with
    ``async_depth=1``: streams equal to phase 3's token for token, the
    pipeline's stats, a second wave that must capture no graph and stream
    the same, and 4 profiled pure ticks beside phase 3's ``pure3`` (wall
    ms a tick, idle share). Returns (b)'s launches."""
    t0 = time.monotonic()
    for tag, kw, draft in (
            ("bf16", {}, None),
            ("int8 pools", dict(kv_cache_dtype="int8"), None),
            ("self-drafted", dict(num_speculative_tokens=4,
                                  drafter="model"), model)):
        lockstep_run(torch, kernels, ServingEngine, ServingConfig, model,
                     f"phase 19 (a) {tag}", draft=draft, **kw)
    engine = ServingEngine(model, ServingConfig(
        num_slots=8, block_size=16, max_model_len=2048, prefill_chunk=128,
        max_new_tokens=32, async_depth=1), device="cuda")
    launches, ticks0 = None, 0
    layers = model.config.num_hidden_layers
    for wave in (1, 2):
        tag = f"phase 19 (b) wave {wave}"
        # each wave prefills cold, as phase 3's did: the first wave's
        # published blocks forgotten
        engine.purge_published()
        got, st, streams = serve_run(torch, kernels, engine, prompts, lens,
                                     tag, SERVING_KERNELS)
        launches = launches or got
        # (c) replays add their capture's counts: one K2r and two K3a /
        # K3b launches a layer a tick, replayed or not
        ticks, ticks0 = st["ticks"] - ticks0, st["ticks"]
        want = {"ragged_paged_attention": layers * ticks,
                "norm_matmul": 2 * layers * ticks,
                "matmul_residual": 2 * layers * ticks}
        if any(got[k] != n for k, n in want.items()):
            raise AssertionError(f"{tag}: launches {got} over {ticks} "
                                 f"ticks, want {want}")
        if wave == 1:
            graphs = st["executables_compiled"]
        elif st["executables_compiled"] != graphs:
            raise AssertionError(f"{tag}: {st['executables_compiled']} "
                                 f"graphs, {graphs} after wave 1")
        same = sum(np.array_equal(a, b) for a, b in zip(streams, streams3))
        log(f"{tag}: {same} of {len(streams)} streams equal phase 3's")
        if same != len(streams):
            raise AssertionError(f"{tag}: streams differ from phase 3's")
    wall, idle = pure_tick_window(torch, engine, prompts[:8], TICK_WINDOW,
                                  "phase 19 (b)")
    log(f"phase 19 (b): pure ticks {wall:.3f} ms a tick, idle {idle:.4f} "
        f"(phase 3, synchronous: {pure3[0]:.3f} ms, idle {pure3[1]:.4f}); "
        f"phase {time.monotonic() - t0:.1f}s")
    engine.shutdown()
    return launches


def moe_serving_phase(torch, kernels, ServingEngine, ServingConfig,
                      DeepseekMoeForCausalLM, deepseek_moe_16b, llama_reads):
    """Phase 9: DeepSeek-MoE-16B (all 28 layers, bf16, dropless, seeded
    weights) serves phase 3's traffic, is profiled over TICK_WINDOW ticks
    (its scalar reads a tick may not exceed the Llama engine's
    ``llama_reads``), then runs generate() dense, paged and n-gram.
    Returns ``(serving launches, {run: generate launches})``."""
    cfg = deepseek_moe_16b(dropless=True)
    layers = cfg.num_hidden_layers
    t0 = time.monotonic()
    model = DeepseekMoeForCausalLM(cfg, device="cuda", seed=SEED + 6)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 9: DeepSeek-MoE-16B, {layers} layers ({layers - 1} MoE: "
        f"{cfg.n_routed_experts} experts of ffn "
        f"{cfg.moe_intermediate_size}, top-{cfg.num_experts_per_tok}, "
        f"{cfg.n_shared_experts} shared), {n_params / 1e9:.3f}B params "
        f"bf16, dropless, init {time.monotonic() - t0:.1f}s")
    lens, prompts = serving_prompts(cfg.vocab_size, REQUESTS, SEED)
    engine = ServingEngine(model, ServingConfig(
        num_slots=8, block_size=16, max_model_len=2048, prefill_chunk=128,
        max_new_tokens=32), device="cuda")
    launches, st, _ = serve_run(torch, kernels, engine, prompts, lens,
                                "phase 9 serving",
                                ("ragged_paged_attention",) + MOE_KERNELS)
    log(f"phase 9 serving: stats " + json.dumps(
        {k: st[k] for k in ("moe", "moe_fused_gmm", "moe_dispatches",
                            "moe_routing_entropy", "moe_expert_load_max")}))
    reads = tick_window(torch, engine, prompts[:8], TICK_WINDOW, "phase 9")
    engine.shutdown()
    del engine
    torch.cuda.empty_cache()
    lockstep_run(torch, kernels, ServingEngine, ServingConfig, model,
                 "phase 19 (a) DeepSeek-MoE-16B")
    if reads > llama_reads:
        raise AssertionError(f"phase 9: {reads} scalar reads a tick, more "
                             f"than the Llama engine's {llama_reads}")

    b, new, gamma = (MOE_GENERATE[k] for k in ("batch", "new", "gamma"))
    prompts7 = motif_prompts(b, MOE_GENERATE["prompt"],
                             MOE_GENERATE["motif"], cfg.vocab_size,
                             SEED + 3)
    ids = torch.from_numpy(prompts7).to(model.device)
    forwards = []
    hook = model.register_forward_pre_hook(lambda m, a: forwards.append(1))
    runs = {"dense": dict(cache_impl="dense"),
            "paged": dict(cache_impl="paged"),
            "ngram": dict(num_speculative_tokens=gamma)}
    want = {"dense": MOE_KERNELS,
            "paged": ("paged_decode_attention",) + MOE_KERNELS,
            "ngram": ("paged_verify_attention",) + MOE_KERNELS}
    streams, gen_launches = {}, {}
    for name, kw in runs.items():
        streams[name], gen_launches[name], _ = generate_once(
            torch, kernels, model, ids, new, kw, forwards,
            f"phase 9 generate {name}", GENERATE_KERNELS + MOE_KERNELS,
            want[name])
    hook.remove()
    noise = logit_noise(torch, model, ids)
    log(f"phase 9: bf16 logits of two recipes differ by up to {noise:.3e}")
    for name in ("paged", "ngram"):
        held_streams(torch, model, f"phase 9 {name} vs dense", prompts7,
                     streams[name], streams["dense"], None, limit=noise)
    return launches, gen_launches


def plain_moe_patches(df, rpa, mg, pda):
    """Route an MoE model's kernel calls to the plain versions: phase 4's
    patches (K2r; K3a / K3b, which MoE layers do not call), K4 / K5, K2d
    and K2v."""
    return plain_patches(df, rpa) + [
        mock.patch.object(mg, n, getattr(mg, "plain_" + n))
        for n in ("gather_gmm_swiglu", "scatter_gmm", "gather_gmm")] + [
        mock.patch.object(pda, n, getattr(pda, "plain_" + n))
        for n in ("paged_decode_attention", "paged_verify_attention")]


def patched(patches, fn):
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in patches:
            p.stop()


def moe_f32_check(torch, kernels, df, rpa, mg, pda, ServingEngine,
                  ServingConfig, DeepseekMoeForCausalLM, deepseek_moe_16b):
    """Phase 10: float32 DeepSeek-MoE at full widths cut to 3 layers (two
    MoE layers after the dense one). The engine's first-tick logits and
    streams, and paged generate()'s streams and scores, through the
    kernels and through their plain versions; then the sorted path
    (``moe_fused_gmm=False``: K5's gmm) against the fused one (K4)."""
    cfg = deepseek_moe_16b(dtype="float32", dropless=True,
                           num_hidden_layers=MOE_F32["layers"])
    model = DeepseekMoeForCausalLM(cfg, device="cuda", seed=SEED + 7)
    rng = np.random.RandomState(SEED + 7)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (40, 150, 70)]
    plain = plain_moe_patches(df, rpa, mg, pda)
    run = lambda: serve_f32(torch, ServingEngine, ServingConfig,  # noqa
                            model, prompts)
    fails = []
    first_k, toks_k = run()
    first_p, toks_p = patched(plain, run)
    lerr = float((first_k - first_p).abs().max())
    log(f"phase 10: f32 DeepSeek-MoE, {cfg.num_hidden_layers} layers at "
        f"full widths: engine first-tick logits kernel vs plain "
        f"max_abs_err={lerr:.3e} (atol {LOGITS_ATOL})")
    if not lerr <= LOGITS_ATOL:
        fails.append(f"engine logits {lerr}")
    held_streams(torch, model, "phase 10 engine kernel vs plain", prompts,
                 toks_k, toks_p, fails)

    ids = torch.from_numpy(motif_prompts(
        MOE_F32["batch"], MOE_F32["prompt"], MOE_F32["motif"],
        cfg.vocab_size, SEED + 7)).cuda()
    gen = lambda: model.generate(ids, max_new_tokens=MOE_F32["new"],  # noqa
                                 cache_impl="paged")
    kernels.reset_launch_counts()
    out_k, sc_k = gen()
    n_k = dict(kernels.launch_counts)
    out_p, sc_p = patched(plain, gen)
    if min(n_k[k] for k in ("paged_decode_attention",) + MOE_KERNELS) <= 0:
        fails.append(f"paged generate launches {n_k}")
    out_k, out_p = out_k.cpu().numpy(), out_p.cpu().numpy()
    held_streams(torch, model, "phase 10 paged generate kernel vs plain",
                 ids.cpu().numpy(), out_k, out_p, fails)
    if np.array_equal(out_k, out_p):
        err = float((sc_k - sc_p).abs().max())
        log(f"  phase 10 paged generate: scores max_abs_err={err:.3e} "
            f"(atol {SCORE_ATOL})")
        if not err <= SCORE_ATOL:
            fails.append(f"paged generate scores {err}")

    cfg.moe_fused_gmm = False           # the sorted path: K5's gmm
    kernels.reset_launch_counts()
    first_s, toks_s = run()
    n_s = dict(kernels.launch_counts)
    cfg.moe_fused_gmm = True
    serr = float((first_s - first_k).abs().max())
    log(f"phase 10: sorted path (moe_gmm {n_s['moe_gmm']} launches, "
        f"moe_gather_gmm_swiglu {n_s['moe_gather_gmm_swiglu']}) vs fused: "
        f"first-tick logits max_abs_err={serr:.3e} (atol {LOGITS_ATOL})")
    if n_s["moe_gmm"] <= 0 or n_s["moe_gather_gmm_swiglu"] != 0:
        fails.append(f"sorted path launches {n_s}")
    if not serr <= LOGITS_ATOL:
        fails.append(f"sorted vs fused logits {serr}")
    held_streams(torch, model, "phase 10 engine sorted vs fused", prompts,
                 toks_s, toks_k, fails)
    if fails:
        raise AssertionError(f"phase 10 failed: {fails}")


def qwen2_phase(torch, kernels, ServingEngine, ServingConfig,
                Qwen2MoeConfig, Qwen2MoeForCausalLM):
    """Phase 11: Qwen2-57B-A14B widths cut to QWEN2["layers"] layers,
    bf16, dropless: QWEN2["requests"] requests through the engine on the
    fused path (K2r at GQA group 7, biased q/k/v, K4 at d 3584 / top-8),
    then again on the sorted path (K5's gmm). Returns ``(fused launches,
    sorted launches)``."""
    cfg = Qwen2MoeConfig(dtype="bfloat16", dropless=True,
                         num_hidden_layers=QWEN2["layers"])
    t0 = time.monotonic()
    model = Qwen2MoeForCausalLM(cfg, device="cuda", seed=SEED + 8)
    torch.cuda.synchronize()
    attn = model.base.layers[0].self_attn
    if attn.q_proj.bias is None or attn.num_heads // attn.num_kv_heads != 7:
        raise AssertionError("phase 11: want biased q/k/v at GQA group 7")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 11: Qwen2-57B-A14B widths, {cfg.num_hidden_layers} of 28 "
        f"layers, {n_params / 1e9:.3f}B params bf16, dropless, init "
        f"{time.monotonic() - t0:.1f}s")
    lens, prompts = serving_prompts(cfg.vocab_size, QWEN2["requests"],
                                    SEED + 8)
    scfg = ServingConfig(num_slots=QWEN2["requests"], block_size=16,
                         max_model_len=2048, prefill_chunk=128,
                         max_new_tokens=QWEN2["new"])
    engine = ServingEngine(model, scfg, device="cuda")
    fused, st, toks_f = serve_run(
        torch, kernels, engine, prompts, lens, "phase 11 fused",
        ("ragged_paged_attention",) + MOE_KERNELS)
    engine.shutdown()
    cfg.moe_fused_gmm = False
    engine = ServingEngine(model, scfg, device="cuda")
    sorted_, _, toks_s = serve_run(
        torch, kernels, engine, prompts, lens, "phase 11 sorted",
        ("ragged_paged_attention", "moe_gmm"))
    engine.shutdown()
    if sorted_["moe_gather_gmm_swiglu"] or not st["moe_fused_gmm"]:
        raise AssertionError("phase 11: the fused / sorted selector")
    held_streams(torch, model, "phase 11 sorted vs fused (bf16)", prompts,
                 toks_s, toks_f, None)
    return fused, sorted_


# ---------------------------------------------------------------- phase 14

def qwen2_dense_phase(torch, kernels, df, rpa, ServingEngine, ServingConfig,
                      Qwen2Config, Qwen2ForCausalLM):
    """Phase 14: dense Qwen2-7B (all 28 layers, bf16, seeded weights,
    q/k/v biases) serves phase 3's traffic on the fused decode tick, K3a
    and K3b each launching twice a layer a tick; profiled over
    TICK_WINDOW ticks; then a PHASE4_LAYERS-layer float32 model at full
    widths through the kernels and through their plain versions (phase
    4's rule). Returns the bf16 run's launches."""
    cfg = Qwen2Config()
    cfg.dtype = "bfloat16"
    t0 = time.monotonic()
    model = Qwen2ForCausalLM(cfg, device="cuda", seed=SEED + 14)
    torch.cuda.synchronize()
    if model.base.layers[0].self_attn.q_proj.bias is None:
        raise AssertionError("phase 14: want biased q/k/v")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 14: Qwen2-7B, {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e9:.3f}B params bf16 "
        f"({2 * n_params / 1e9:.1f} GB), init "
        f"{time.monotonic() - t0:.1f}s")
    lens, prompts = serving_prompts(cfg.vocab_size, REQUESTS, SEED)
    engine = ServingEngine(model, ServingConfig(
        num_slots=8, block_size=16, max_model_len=2048, prefill_chunk=128,
        max_new_tokens=32, fused_decode=True), device="cuda")
    launches, st, _ = serve_run(torch, kernels, engine, prompts, lens,
                                "phase 14", SERVING_KERNELS)
    per_tick = 2 * cfg.num_hidden_layers * st["ticks"]
    log(f"phase 14: K2r {launches['ragged_paged_attention']}, K3a "
        f"{launches['norm_matmul']}, K3b {launches['matmul_residual']} "
        f"launches over {st['ticks']} ticks (want {per_tick} each of K3)")
    for k in ("norm_matmul", "matmul_residual"):
        if launches[k] != per_tick:
            raise AssertionError(f"phase 14: {k} launched {launches[k]} "
                                 f"times, want 2 x {cfg.num_hidden_layers} "
                                 f"x {st['ticks']} ticks")
    tick_window(torch, engine, prompts[:8], TICK_WINDOW, "phase 14")
    engine.shutdown()
    del engine, model
    torch.cuda.empty_cache()

    cfg = Qwen2Config()
    cfg.num_hidden_layers = PHASE4_LAYERS
    model = Qwen2ForCausalLM(cfg, device="cuda", seed=SEED + 15)
    rng = np.random.RandomState(SEED + 15)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (40, 150, 70)]
    first_k, toks_k = serve_f32(torch, ServingEngine, ServingConfig, model,
                                prompts)
    first_p, toks_p = patched(plain_patches(df, rpa), lambda: serve_f32(
        torch, ServingEngine, ServingConfig, model, prompts))
    lerr = float((first_k - first_p).abs().max())
    log(f"phase 14: f32, {PHASE4_LAYERS} layers at Qwen2-7B widths: "
        f"first-tick logits max_abs_err={lerr:.3e} (atol {LOGITS_ATOL})")
    if not lerr <= LOGITS_ATOL:
        raise AssertionError(f"phase 14: kernel path logits disagree with "
                             f"the plain path: {lerr}")
    fails = []
    held_streams(torch, model, "phase 14 kernel vs plain", prompts, toks_k,
                 toks_p, fails)
    if fails:
        raise AssertionError(f"phase 14: token streams diverge: {fails}")
    del model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- phases 12, 13

def active_params(model):
    """``(parameters, active parameters, MoE layers)``: active are all
    but the routed experts a token is not sent to (``experts - top_k`` of
    each MoE layer), as the reference's bench.py counts them."""
    experts = [lay.mlp.experts for lay in model.base.layers
               if hasattr(lay.mlp, "experts")]
    k = model.config.num_experts_per_tok
    n = sum(p.numel() for p in model.parameters())
    skipped = sum((ex.num_experts - k) * (ex.gate_up_proj.numel()
                                          + ex.down_proj.numel())
                  // ex.num_experts for ex in experts)
    return n, n - skipped, len(experts)


def moe_train_steps(torch, kernels, step, pool, n, tag):
    """``n`` steps of ``step`` over ``pool`` with every launch count set
    to 0 just before them and read just after; returns (losses, seconds,
    launches)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    losses = [step(*pool[i % len(pool)]) for i in range(n)]
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    losses = [float(x) for x in losses]
    launches = dict(kernels.launch_counts)
    log(f"{tag}: {n} steps in {dt:.4f}s, losses "
        f"{[round(x, 5) for x in losses]}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite training loss: {losses}")
    return losses, dt, launches


def want_launches(tag, launches, want):
    """Fail unless each kernel of ``want`` launched exactly that often."""
    wrong = {k: (launches.get(k, 0), n) for k, n in want.items()
             if launches.get(k, 0) != n}
    if wrong:
        raise AssertionError(f"{tag}: kernel launches (got, want): {wrong}")


def moe_train_phase(torch, kernels, DeepseekMoeForCausalLM, deepseek_moe_16b,
                    Qwen2MoeConfig, Qwen2MoeForCausalLM, AdamW, TrainStep):
    """Phase 12: MoE training in bfloat16 through TrainStep + AdamW(1e-4,
    multi_precision=True), as the reference's bench.py trains MoE. (1)
    DeepSeek-MoE-16B widths at MOE_TRAIN["layers"] layers (the first
    dense), dropless, on batches of 2 x 4096 tokens: warm-up steps, timed
    steps (ms per step, tokens/s, MFU over active parameters, peak memory,
    every loss) and profiled ones (idle share, top device operations),
    every K4 mode, the backward's kernels and K1 launching the count the
    layers imply; (2) the same model on the sorted path (K5's gmm,
    d(lhs) and tgmm); (3) Qwen2-57B-A14B widths cut to one layer,
    capacity-routed (drop rates read first, as the reference's bench),
    1 x 4096 tokens: q/k/v biases, the shared-expert gate, GQA group 7
    in K1's backward. Returns the launches of each run by name."""
    import gc
    runs = {}
    cfg = deepseek_moe_16b(num_hidden_layers=MOE_TRAIN["layers"],
                           dropless=True)
    bsz, seq = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    t0 = time.monotonic()
    model = DeepseekMoeForCausalLM(cfg, device="cuda", seed=SEED + 9)
    model.train()
    n_params, active, n_moe = active_params(model)
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, lambda out, a, k: out, opt)
    rng = np.random.RandomState(SEED + 9)
    pool = []
    for _ in range(MOE_TRAIN["pool"]):
        ids = rng.randint(0, cfg.vocab_size, (bsz, seq)).astype(np.int64)
        pool.append(tuple(torch.from_numpy(a).cuda()
                          for a in (ids, np.roll(ids, -1, axis=1))))
    torch.cuda.synchronize()
    log(f"phase 12: DeepSeek-MoE-16B widths, {cfg.num_hidden_layers} "
        f"layers ({n_moe} MoE), {n_params / 1e9:.3f}B params bf16 "
        f"({active / 1e9:.3f}B active), dropless, batch {bsz} x {seq}, "
        f"init {time.monotonic() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    it = 0

    def one_step():
        nonlocal it
        loss = step(*pool[it % len(pool)])
        it += 1
        return loss

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses = [float(one_step()) for _ in range(MOE_TRAIN["warm"])]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    timed = [one_step() for _ in range(MOE_TRAIN["timed"])]
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    losses += [float(x) for x in timed]
    n_prof = MOE_TRAIN["profiled"]
    wall_ms, busy_ms, _ = profiled(torch, one_step, n_prof, 25)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    tokens = bsz * seq * MOE_TRAIN["timed"]
    tok_s = tokens / dt
    f_tok = 6 * active + 12 * cfg.num_hidden_layers * seq * cfg.hidden_size
    log(f"phase 12 profile: {n_prof} steps, wall {wall_ms:.3f} ms "
        f"({wall_ms / n_prof:.3f} ms a step, profiler on), device busy "
        f"{busy_ms:.3f} ms -> idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f}")
    log(f"phase 12: {MOE_TRAIN['timed']} timed steps in {dt:.4f}s -> "
        f"{1e3 * dt / MOE_TRAIN['timed']:.3f} ms/step, {tok_s:.1f} "
        f"trained tokens/s, MFU {tok_s * f_tok / PEAK_FLOPS['bfloat16']:.4f}"
        f" (6 x active + 12 L s h = {f_tok / 1e9:.3f} GFLOP/token, active "
        f"= all parameters but the "
        f"{cfg.n_routed_experts - cfg.num_experts_per_tok} routed experts "
        f"of each MoE layer a token skips, at "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.1f} TFLOP/s); peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"phase 12: losses {[round(x, 5) for x in losses]} (steps "
        f"1-{MOE_TRAIN['warm']} untimed; {n_prof + 1} more under the "
        f"profiler); launches over {it} steps "
        f"{ {k: v for k, v in launches.items() if v} }")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 12: non-finite loss: {losses}")
    per_moe = {"moe_gather_gmm_swiglu": 1, "moe_scatter_gmm": 1,
               "moe_gmm": 1, "moe_gmm_t": 1, "moe_scatter_gmm_t": 1,
               "moe_tgmm": 2}
    want = {k: n * n_moe * it for k, n in per_moe.items()}
    want.update({k: cfg.num_hidden_layers * it for k in TRAINING_KERNELS})
    want_launches("phase 12 main run", launches, want)
    runs["main"] = launches

    cfg.moe_fused_gmm = False               # the sorted path: K5
    n = MOE_TRAIN["sorted_steps"]
    _, _, sorted_ = moe_train_steps(torch, kernels, step, pool, n,
                                    "phase 12 sorted path")
    want = {"moe_gmm": 2 * n_moe * n, "moe_gmm_t": 2 * n_moe * n,
            "moe_tgmm": 2 * n_moe * n, "moe_gather_gmm_swiglu": 0,
            "moe_scatter_gmm": 0, "moe_scatter_gmm_t": 0}
    want_launches("phase 12 sorted path", sorted_, want)
    runs["sorted"] = sorted_
    del model, opt, step, pool
    gc.collect()
    torch.cuda.empty_cache()

    qcfg = Qwen2MoeConfig(dtype="bfloat16",
                          num_hidden_layers=QWEN2_TRAIN["layers"])
    t0 = time.monotonic()
    model = Qwen2MoeForCausalLM(qcfg, device="cuda", seed=SEED + 10)
    model.train()
    attn = model.base.layers[0].self_attn
    if attn.q_proj.bias is None or attn.num_heads // attn.num_kv_heads != 7 \
            or model.config.dropless:
        raise AssertionError("phase 12: want a capacity-routed Qwen2-MoE "
                             "with biased q/k/v at GQA group 7")
    n_params, _, n_moe_q = active_params(model)
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, lambda out, a, k: out, opt)
    rng = np.random.RandomState(SEED + 10)
    ids = rng.randint(0, qcfg.vocab_size,
                      (QWEN2_TRAIN["batch"], QWEN2_TRAIN["seq"]))
    pool = [tuple(torch.from_numpy(a.astype(np.int64)).cuda()
                  for a in (ids, np.roll(ids, -1, axis=1)))]
    drops = model.collect_drop_rates(pool[0][0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 12: Qwen2-57B-A14B widths, {qcfg.num_hidden_layers} of 28 "
        f"layers, {n_params / 1e9:.3f}B params bf16, capacity "
        f"{qcfg.capacity_factor}, {QWEN2_TRAIN['batch']} x "
        f"{QWEN2_TRAIN['seq']} tokens, init {time.monotonic() - t0:.1f}s; "
        f"drop rates {[round(x, 4) for x in drops]}")
    n = QWEN2_TRAIN["steps"]
    _, dt, qwen = moe_train_steps(torch, kernels, step, pool, n,
                                  "phase 12 Qwen2 capacity-routed")
    log(f"phase 12 Qwen2: {1e3 * dt / n:.3f} ms/step, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = {k: c * n_moe_q * n for k, c in per_moe.items()}
    want.update({k: qcfg.num_hidden_layers * n for k in TRAINING_KERNELS})
    want_launches("phase 12 Qwen2", qwen, want)
    runs["qwen2"] = qwen
    if not all(np.isfinite(drops)):
        raise AssertionError(f"phase 12: drop rates {drops}")
    del model, opt, step, pool
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def plain_train_patches(fa, mg):
    """Route the training path's kernel calls (K1, K4, K5) to their
    plain versions."""
    return [mock.patch.object(fa, n, getattr(fa, "plain_" + n))
            for n in ("flash_attention_fwd", "flash_attention_dq",
                      "flash_attention_dkv")] + [
        mock.patch.object(mg, n, getattr(mg, "plain_" + n))
        for n in ("gather_gmm_swiglu", "scatter_gmm", "gather_gmm", "tgmm")]


def moe_grad_check(torch, kernels, fa, mg, moe, DeepseekMoeForCausalLM,
                   deepseek_moe_16b):
    """Phase 13: float32 DeepSeek-MoE at full widths cut to
    MOE_GRAD["layers"] layers (one dense, the rest MoE), one forward +
    backward on MOE_GRAD tokens: the loss and every parameter's gradient
    through the kernels against the plain versions, and the fused path
    (K4) against the sorted one (K5), each by LOSS_RTOL and GRAD_RTOL
    (max |a - b| / max |b|); every routed expert that received pairs has
    a non-zero gradient in both paths."""
    cfg = deepseek_moe_16b(dtype="float32", dropless=True,
                           num_hidden_layers=MOE_GRAD["layers"])
    model = DeepseekMoeForCausalLM(cfg, device="cuda", seed=SEED + 11)
    model.train()
    rng = np.random.RandomState(SEED + 11)
    ids = rng.randint(0, cfg.vocab_size,
                      (MOE_GRAD["batch"], MOE_GRAD["seq"])).astype(np.int64)
    ids_t = torch.from_numpy(ids).cuda()
    labels_t = torch.from_numpy(np.roll(ids, -1, axis=1)).cuda()
    experts = [(i, lay.mlp.experts) for i, lay in enumerate(model.base.layers)
               if hasattr(lay.mlp, "experts")]

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        counts = []
        with moe.serving_stats_tap(counts):
            loss = model(ids_t, labels=labels_t)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()},\
            counts

    def compare(what, a, b):
        (la, ga, _), (lb, gb, _) = a, b
        lerr = abs(la - lb) / abs(lb)
        gerr = {n: float((ga[n] - gb[n]).abs().max()
                         / gb[n].abs().max().clamp(min=1e-30)) for n in gb}
        worst = max(gerr, key=gerr.get)
        log(f"phase 13 {what}: loss {la:.6f} vs {lb:.6f} (rel {lerr:.2e}, "
            f"tol {LOSS_RTOL}); {len(gerr)} gradients, worst {worst} rel "
            f"{gerr[worst]:.2e} (tol {GRAD_RTOL})")
        bad = {n: e for n, e in gerr.items() if not e <= GRAD_RTOL}
        return ([f"{what} loss {lerr}"] if not lerr <= LOSS_RTOL else []) \
            + ([f"{what} gradients {bad}"] if bad else [])

    def experts_learn(what, run):
        _, grads, counts = run
        fails = []
        for (i, ex), c in zip(experts, counts):
            hit = c > 0
            for name in ("gate_up_proj", "down_proj"):
                g = getattr(ex, name).grad
                live = g.flatten(1).abs().amax(1) > 0
                if not bool(live[hit].all()):
                    fails.append(f"{what} layer {i} {name}: experts "
                                 f"{torch.nonzero(hit & ~live).flatten()}"
                                 " received pairs but no gradient")
        log(f"phase 13 {what}: {int(sum(int((c > 0).sum()) for c in counts))}"
            f" routed experts received pairs over {len(counts)} MoE layers;"
            f" {'all' if not fails else 'NOT all'} have a gradient")
        return fails

    kernels.reset_launch_counts()
    fused_k = loss_and_grads()
    n_k = dict(kernels.launch_counts)
    fused_p = patched(plain_train_patches(fa, mg), loss_and_grads)
    cfg.moe_fused_gmm = False
    kernels.reset_launch_counts()
    sorted_k = loss_and_grads()
    n_s = dict(kernels.launch_counts)
    cfg.moe_fused_gmm = True
    log(f"phase 13: f32 DeepSeek-MoE, {cfg.num_hidden_layers} layers at "
        f"full widths ({len(experts)} MoE), {MOE_GRAD['batch']} x "
        f"{MOE_GRAD['seq']} tokens; launches fused "
        f"{ {k: v for k, v in n_k.items() if v} }, sorted "
        f"{ {k: v for k, v in n_s.items() if v} }")
    fails = compare("fused kernels vs plain", fused_k, fused_p) \
        + compare("fused vs sorted (kernels)", fused_k, sorted_k) \
        + experts_learn("fused", fused_k) + experts_learn("sorted", sorted_k)
    if min(n_k[k] for k in MOE_KERNELS + MOE_BWD_KERNELS) <= 0 \
            or min(n_s[k] for k in ("moe_gmm", "moe_gmm_t", "moe_tgmm")) <= 0:
        fails.append(f"launches fused {n_k} sorted {n_s}")
    del model, fused_k, fused_p, sorted_k
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 13 failed: {fails}")


def flashmask_phase(torch, kernels, fa, fm, F):
    """Phase 15: ``nn.functional.flashmask_attention`` forward + backward
    at Llama-3-8B's attention widths on one 16k row of FLASHMASK_ROW's
    equal documents, document-causal, bfloat16 (the reference bench's
    ``_flashmask_bench`` workload). K6f, K6dq and K6dkv must each launch
    once and K1 never; q, k and v get finite, nonzero gradients; the
    output and the three gradients equal K1 causal run document by
    document (doc-causal attention is block-diagonal causal attention)
    and, with the lse, the plain K6 passes on the same inputs, within
    bf16's tolerances. Then fwd + bwd times of K6 and of K1 causal
    over the whole row, their ratio (the tile skip's gain), and peak
    memory. Last, ``scaled_dot_product_attention`` with a boolean
    ``attn_mask`` and dropout at a small shape: the undropped output
    equals the plain composition, the dropped share is within 4 sigma
    of p, and two runs from one seed agree exactly. Returns the K6
    launches of the checked run."""
    from paddle_tpu_torch.framework import random as trandom
    B, L, H, Hkv, D, n_docs = (FLASHMASK_ROW[k] for k in (
        "B", "L", "H", "Hkv", "D", "docs"))
    dtype = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device="cuda").to(dtype)  # noqa
    q, k, v, do = rnd(B, L, H, D), rnd(B, L, Hkv, D), rnd(B, L, Hkv, D), \
        rnd(B, L, H, D)
    docs = [L // n_docs] * n_docs
    idx = torch.from_numpy(doc_bounds(docs)).cuda()[None, None, :, None] \
        .expand(B, 1, L, 1).contiguous()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def run(qq, kk, vv):
        out = F.flashmask_attention(qq, kk, vv, startend_row_indices=idx,
                                    causal=True)
        out.backward(do)
        return out

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = run(*leaves)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    log(f"phase 15: flashmask_attention fwd + bwd, B {B}, L {L}, {H} / "
        f"{Hkv} heads, D {D}, bf16, {n_docs} documents of {docs[0]} "
        f"tokens, causal; launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    fails = []
    want_launches("phase 15", launches, {
        "flashmask_fwd": 1, "flashmask_dq": 1, "flashmask_dkv": 1,
        "flash_attention_fwd": 0, "flash_attention_dq": 0,
        "flash_attention_dkv": 0})
    grads = [x.grad for x in leaves]
    for n, gr in zip("qkv", grads):
        ok = bool(torch.isfinite(gr).all()) and float(gr.abs().max()) > 0
        log(f"  phase 15 d{n}: finite and nonzero {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"phase 15 d{n}")
    # K1 causal on each document's slice, concatenated
    ref = [torch.empty_like(x) for x in (q, q, k, v)]
    a = 0
    for n in docs:
        sl = slice(a, a + n)
        part = [x[:, sl].clone().requires_grad_() for x in (q, k, v)]
        o = fa.flash_attention(*part, D ** -0.5, causal=True)
        o.backward(do[:, sl])
        for r, x in zip(ref, [o.detach()] + [p.grad for p in part]):
            r[:, sl] = x
        a += n
    for n, got, want in zip(("o", "dq", "dk", "dv"), [out.detach()] + grads,
                            ref):
        held_attention(torch, got, want, "bfloat16",
                       f"phase 15 {n} vs K1 per document", fails)
    del ref
    # and against the plain K6 passes on the same inputs: K1 and K6 share
    # their kernel bodies, so the check above alone would not see a fault
    # in them; the plain passes build one kv group's [4, L, L] float32
    # scores at a time
    start, end = fm.flashmask_bounds(idx, L, H, Hkv)
    scale = D ** -0.5
    with torch.no_grad():
        o, lse, tiles = fm.flashmask_fwd(q, k, v, start, end, scale, True)
        o_p, lse_p = fm.plain_flashmask_fwd(q, k, v, start, end, scale,
                                            True)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        p6 = (q, k, v, do, lse_p, delta, start, end, scale, True)
        plain = [o_p, lse_p, fm.plain_flashmask_dq(*p6),
                 *fm.plain_flashmask_dkv(*p6)]
    for n, got, want in zip(("o", "lse", "dq", "dk", "dv"),
                            [out.detach(), lse] + grads, plain):
        held_attention(torch, got, want, "bfloat16",
                       f"phase 15 vs plain: {n}", fails)
    del out, o, lse, o_p, lse_p, delta, p6, plain
    torch.cuda.empty_cache()
    for x in leaves:
        x.grad = None

    def k6():
        run(*leaves)

    def k1():
        o = fa.flash_attention(*leaves, D ** -0.5, causal=True)
        o.backward(do)

    k6_ms = time_ms(torch, k6, reps=3, rounds=3, warmup=1)
    k1_ms = time_ms(torch, k1, reps=2, rounds=3, warmup=1)
    for x in leaves:
        x.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k6()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"phase 15: fwd + bwd over the {L}-token row: flashmask "
        f"ms={k6_ms:.4f}, K1 causal ms={k1_ms:.4f}, speedup "
        f"{k1_ms / k6_ms:.3f}x; peak memory {peak / 2**30:.3f} GiB above "
        f"the {base / 2**30:.3f} GiB held before the call")
    # the same work as kernel launches alone: where the call's time goes
    pairs = visible_pairs(torch, start, end, B, H, L, True)
    with torch.no_grad():
        o, lse, tiles = fm.flashmask_fwd(q, k, v, start, end, scale, True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        m6 = (q, k, v, do, lse, delta, start, end, scale, True)
        m1 = (q, k, v, do, lse, delta, scale, True)
        once = dict(reps=1, rounds=3, warmup=1)
        k6_parts = [time_ms(torch, f, **once) for f in (
            lambda: fm.flashmask_fwd(q, k, v, start, end, scale, True),
            lambda: fm.flashmask_dq(*m6, tiles=tiles),
            lambda: fm.flashmask_dkv(*m6, tiles=tiles))]
        k1_parts = [time_ms(torch, f, **once) for f in (
            lambda: fa.flash_attention_fwd(q, k, v, scale, True),
            lambda: fa.flash_attention_dq(*m1),
            lambda: fa.flash_attention_dkv(*m1))]
    b_ms, b_by = bound(0, 18 * D * pairs, "bfloat16")
    log(f"phase 15: the kernels alone: K6f + K6dq + K6dkv = "
        f"{' + '.join(f'{t:.4f}' for t in k6_parts)} = "
        f"{sum(k6_parts):.4f} ms over {pairs} visible pairs (operations "
        f"bound {b_ms:.4f} ms); K1 causal = "
        f"{' + '.join(f'{t:.4f}' for t in k1_parts)} = "
        f"{sum(k1_parts):.4f} ms; kernel speedup "
        f"{sum(k1_parts) / sum(k6_parts):.3f}x")
    del o, lse, delta
    del leaves, q, k, v, do, m6, m1
    torch.cuda.empty_cache()

    # SDPA with a boolean mask and dropout
    Bs, Ls, Hs, Hkvs, Ds, p = (SDPA_MASKED[k] for k in (
        "B", "L", "H", "Hkv", "D", "p"))
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    qs = torch.randn(Bs, Ls, Hs, Ds, generator=g, device="cuda")
    ks, vs = (torch.randn(Bs, Ls, Hkvs, Ds, generator=g, device="cuda")
              for _ in range(2))
    mask = torch.rand(Bs, 1, Ls, Ls, generator=g, device="cuda") > 0.3
    mask[..., 0] = True
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         dropout_p=p, training=False)
    kr, vr = (x.repeat_interleave(Hs // Hkvs, 2) for x in (ks, vs))
    logits = torch.einsum("bthd,bshd->bhts", qs, kr) * Ds ** -0.5 \
        + torch.where(mask, 0.0, -1e9)
    plain = torch.einsum("bhts,bshd->bthd", torch.softmax(logits, -1), vr)
    err = float((out - plain).abs().max())
    trandom.seed(SEED + 17)
    dropped = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                             dropout_p=p)
    trandom.seed(SEED + 17)
    again = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                           dropout_p=p)
    share = float((dropped == 0).float().mean())
    sigma = (p * (1 - p) / dropped.numel()) ** 0.5
    same = bool(torch.equal(dropped, again))
    log(f"phase 15 sdpa: bool attn_mask, B {Bs}, L {Ls}, {Hs} / {Hkvs} "
        f"heads, D {Ds}, f32: undropped vs plain max_abs_err={err:.3e} "
        f"(atol {TOL['float32']['atol']}); dropout p {p}: zero share "
        f"{share:.5f} (4 sigma {4 * sigma:.5f}); two seeded runs equal: "
        f"{same}")
    if not err <= TOL["float32"]["atol"]:
        fails.append("phase 15 sdpa mask")
    if not abs(share - p) <= 4 * sigma:
        fails.append("phase 15 sdpa dropout share")
    if not same:
        fails.append("phase 15 sdpa dropout seed")
    if fails:
        raise AssertionError(f"phase 15 failed: {fails}")
    return {n: launches[n] for n in FLASHMASK_KERNELS}


# ---------------------------------------------------------------- phase 16

def int8_pool_diff(a, b):
    """Two per-layer int8 pool lists: the largest difference of a stored
    value in int8 steps, the share of values that differ, and each
    layer's largest relative difference of a scale."""
    steps, n, ndiff, srel = 0, 0, 0, []
    for kv_a, kv_b in zip(a, b):
        srel.append(0.0)
        for x, y in zip(kv_a, kv_b):
            d = (x.data.int() - y.data.int()).abs()
            steps = max(steps, int(d.max()))
            ndiff += int((d > 0).sum())
            n += d.numel()
            srel[-1] = max(srel[-1], float(
                ((x.scale - y.scale).abs()
                 / y.scale.abs().clamp_min(1e-30)).max()))
    return steps, ndiff / max(n, 1), srel


def match_rate(a, b):
    """Share of equal tokens, position by position, over streams a, b."""
    tot = hit = 0
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        n = min(len(x), len(y))
        tot += max(len(x), len(y))
        hit += int((x[:n] == y[:n]).sum())
    return hit / max(tot, 1)


def int8_phase(torch, kernels, df, rpa, pda, ServingEngine, ServingConfig,
               LlamaConfig, LlamaForCausalLM, bf16_streams, bf16_pool_bytes):
    """Phase 16: int8 KV pools on the main paths. Phase 3's engine
    (Llama-3-8B, all 32 layers, bf16, phase 3's seeded weights and
    traffic) with ``kv_cache_dtype="int8"``: tokens/s, TTFT, ticks, rows
    a tick, a profiled tick window's idle share, its pool bytes against
    the bf16 engine's (at most INT8_POOL_RATIO) and each stream's match
    with phase 3's bf16 streams (first divergence and its top-2 margin
    logged, not held: random weights have small margins); K2r must
    launch on int8 pools only. Then ``generate()`` at phase 7's shape on
    int8 pools, paged (K2d) and n-gram (K2v). Then float32, PHASE8's
    2 layers at full widths on int8 pools: paged and self-drafted
    speculative ``generate()`` and the engine, through the kernels (the
    FMA bodies' int8 mode) and through their plain versions; the streams
    must be equal (phase 4's margin rule). The two paths quantize K/V
    rows that differ in their last float32 bits, so a value within that
    of a rounding boundary is stored one int8 step apart; the layers
    after the first read such values, so their rows, and the logits,
    move by more than LOGITS_ATOL: the engine's pools after the first
    tick must agree within one int8 step, the first layer's scales (its
    rows read no int8 value) within INT8_SCALE_RTOL; the later layers'
    scales and the first tick's logits are logged. The bf16
    streams' divergences are read against the logit difference of two
    bf16 recipes of this model (phase 7's limit). Returns ``{run:
    launch counts}``."""
    cfg = LlamaConfig.llama3_8b()
    cfg.dtype = "bfloat16"
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    log(f"phase 16: Llama-3-8B, {cfg.num_hidden_layers} layers bf16 "
        f"(phase 3's weights), int8 KV pools; init "
        f"{time.monotonic() - t0:.1f}s")
    lens, prompts = serving_prompts(cfg.vocab_size, REQUESTS, SEED)
    engine = ServingEngine(model, ServingConfig(
        num_slots=8, block_size=16, max_model_len=2048, prefill_chunk=128,
        max_new_tokens=32, kv_cache_dtype="int8"), device="cuda")
    runs, fails = {}, []
    runs["serve"], st, streams = serve_run(
        torch, kernels, engine, prompts, lens, "phase 16 int8 serving",
        ("ragged_paged_attention_int8", "norm_matmul", "matmul_residual"))
    if runs["serve"]["ragged_paged_attention"]:
        fails.append("phase 16 serving launched K2r on bf16 pools")
    ratio = st["kv_pool_bytes"] / bf16_pool_bytes
    log(f"phase 16 int8 serving: kv_cache_dtype {st['kv_cache_dtype']}, "
        f"pool bytes {st['kv_pool_bytes']} against the bf16 engine's "
        f"{bf16_pool_bytes}: {ratio:.4f} (limit {INT8_POOL_RATIO}); "
        f"kv_bytes_per_step of the last tick {st['kv_bytes_per_step']}")
    if not ratio <= INT8_POOL_RATIO:
        fails.append(f"phase 16 pool bytes ratio {ratio}")
    log(f"phase 16 int8 serving: token match rate against phase 3's bf16 "
        f"streams {match_rate(streams, bf16_streams):.4f} over "
        f"{sum(map(len, streams))} tokens; per stream "
        f"{[round(match_rate([a], [b]), 4) for a, b in zip(streams, bf16_streams)]}")
    tick_window(torch, engine, prompts[:8], TICK_WINDOW, "phase 16")
    engine.shutdown()
    del engine
    torch.cuda.empty_cache()

    b, new, gamma = GENERATE["batch"], GENERATE["new"], GENERATE["gamma"]
    prompts7 = motif_prompts(b, GENERATE["prompt"], GENERATE["motif"],
                             cfg.vocab_size, SEED + 3)
    ids = torch.from_numpy(prompts7).to(model.device)
    noise = logit_noise(torch, model, ids)
    log(f"phase 16: bf16 logits of two recipes differ by up to {noise:.3e}"
        ": the near-tie limit of the streams read below")
    held_streams(torch, model, "phase 16 int8 vs bf16 pools", prompts,
                 streams, bf16_streams, None, limit=noise)
    forwards = []
    hook = model.register_forward_pre_hook(lambda m, a: forwards.append(1))
    gen = {}
    for name, kw, want in (
            ("paged", dict(cache_impl="paged"),
             ("paged_decode_attention_int8",)),
            ("ngram", dict(num_speculative_tokens=gamma),
             ("paged_verify_attention_int8",)),
            ("tree", dict(num_speculative_tokens=len(BRANCH_TREE),
                          spec_tree=BRANCH_TREE),
             ("paged_verify_attention_tree_int8",))):
        gen[name], runs[name], _ = generate_once(
            torch, kernels, model, ids, new, dict(kw, kv_cache_dtype="int8"),
            forwards, f"phase 16 generate {name} int8",
            GENERATE_KERNELS + INT8_KERNELS, want)
        if any(runs[name][k] for k in GENERATE_KERNELS):
            fails.append(f"phase 16 generate {name}: a K2 kernel launched "
                         "on bf16 pools")
    hook.remove()
    for name in ("ngram", "tree"):
        held_streams(torch, model,
                     f"phase 16 generate {name} vs paged (int8)", prompts7,
                     gen[name], gen["paged"], None, limit=noise)
    del model, ids
    torch.cuda.empty_cache()

    # float32 on int8 pools: the FMA bodies against the plain versions
    cfg8 = LlamaConfig.llama3_8b()
    cfg8.num_hidden_layers = PHASE8["layers"]
    model = LlamaForCausalLM(cfg8, device="cuda", seed=SEED + 5)
    prompts8 = motif_prompts(PHASE8["batch"], PHASE8["prompt"],
                             PHASE8["motif"], cfg8.vocab_size, SEED + 5)
    ids = torch.from_numpy(prompts8).to(model.device)
    rng = np.random.RandomState(SEED + 1)
    prompts4 = [rng.randint(0, cfg8.vocab_size, size=n)
                for n in (40, 150, 70)]
    kinds = {"paged": dict(cache_impl="paged"),
             "self": dict(num_speculative_tokens=PHASE8["gamma"],
                          draft_model=model),
             "tree": dict(num_speculative_tokens=len(BRANCH_TREE),
                          spec_tree=BRANCH_TREE)}
    res = {}
    for path in ("kernel", "plain"):
        patches = [] if path == "kernel" else plain_patches(df, rpa) + [
            mock.patch.object(pda, "paged_decode_attention",
                              pda.plain_paged_decode_attention),
            mock.patch.object(pda, "paged_verify_attention",
                              pda.plain_paged_verify_attention)]
        for p in patches:
            p.start()
        try:
            kernels.reset_launch_counts()
            for kind, kw in kinds.items():
                out, _ = model.generate(ids, max_new_tokens=PHASE8["new"],
                                        kv_cache_dtype="int8", **kw)
                res[path, kind] = out.cpu().numpy()
            snap = []
            res[path, "engine"] = serve_f32(
                torch, ServingEngine, ServingConfig, model, prompts4,
                after_first=lambda eng: snap.extend(
                    tuple(type(p)(p.data.clone(), p.scale.clone())
                          for p in kv) for kv in eng._pools),
                kv_cache_dtype="int8")
            res[path, "pools"] = snap
            n = {k: kernels.launch_counts[k] for k in INT8_KERNELS}
        finally:
            for p in patches:
                p.stop()
        if (min(n.values()) > 0) != (path == "kernel") \
                or (path == "plain" and max(n.values()) > 0):
            fails.append(f"phase 16 f32 {path}: launches {n}")
        log(f"phase 16 f32 int8 pools, {path} path: launches {n}")
    steps, share, srel = int8_pool_diff(res["kernel", "pools"],
                                        res["plain", "pools"])
    lerr = float((res["kernel", "engine"][0]
                  - res["plain", "engine"][0]).abs().max())
    log(f"phase 16 f32 int8 pools: the engine's pools after the first tick,"
        f" kernel vs plain path: stored values at most {steps} int8 step(s)"
        f" apart (limit 1), {share:.3e} of them differ; the first layer's "
        f"scales within {srel[0]:.3e} (rtol {INT8_SCALE_RTOL}), the later "
        f"layers' {[f'{x:.3e}' for x in srel[1:]]}; first-tick logits "
        f"max_abs_err={lerr:.3e}")
    if not (steps <= 1 and srel[0] <= INT8_SCALE_RTOL):
        fails.append(f"phase 16 f32 engine pools {steps} {srel}")
    held_streams(torch, model, "phase 16 f32 int8 engine kernel vs plain",
                 prompts4, res["kernel", "engine"][1],
                 res["plain", "engine"][1], fails)
    for kind in kinds:
        held_streams(torch, model,
                     f"phase 16 f32 int8 generate {kind} kernel vs plain",
                     prompts8, res["kernel", kind], res["plain", kind],
                     fails)
    del model
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 16 failed: {fails}")
    return runs


# ---------------------------------------------------------------- phase 17

def spec_serve_run(torch, kernels, engine, prompts, lens, tag, want):
    """``serve_run`` of a speculating engine, its speculation stats
    logged beside the serving metrics."""
    launches, st, streams = serve_run(torch, kernels, engine, prompts, lens,
                                      tag, want)
    log(f"{tag}: spec_mean_accepted_len "
        f"{st['spec_mean_accepted_len']:.4f}, spec_acceptance_rate "
        f"{st['spec_acceptance_rate']:.4f} (proposed "
        f"{st['spec_tokens_proposed']}, accepted "
        f"{st['spec_tokens_accepted']}), spec_tree_nodes "
        f"{st['spec_tree_nodes']}")
    return launches, st, streams


def spec_serving_phase(torch, kernels, df, rpa, pda, ServingEngine,
                       ServingConfig, LlamaConfig, LlamaForCausalLM, layers,
                       streams3):
    """Phase 17: speculative decoding in the engine. Phase 3's model
    (Llama-3-8B at ``layers`` layers, bf16, phase 3's seeded weights)
    serves phase 3's traffic five times (SPEC_RUNS): linear n-gram at
    gamma 4 (K2r), the model drafting for itself at gamma 4 (K2r and
    K2d; the mean accepted length must exceed 1), the chain tree (its
    stream and tokens a verify must equal the n-gram run's; K2r's tree
    mode), the branching tree at gamma 7, and draft heads (the
    reference's seeded float32 weights) on a depth-2 tree; each run's
    tokens/s, TTFT, ticks, rows a tick, accepted length, acceptance rate
    and peak memory, each stream held against phase 3's by the near-tie
    rule (the logit difference of two bf16 recipes); 4 profiled ticks of
    the self-drafted engine (device time, idle share). Then the branching
    tree on int8 pools (K2r's tree mode on int8 pools). Then float32,
    PHASE4_LAYERS layers at full widths: linear, self-drafted, tree and
    heads engines through the kernels and through their plain versions
    (phase 4's rule). Returns ``{run: launch counts}``."""
    cfg = LlamaConfig.llama3_8b()
    cfg.dtype = "bfloat16"
    cfg.num_hidden_layers = layers
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    log(f"phase 17: Llama-3-8B, {layers} layers bf16 (phase 3's weights), "
        f"speculative serving; init {time.monotonic() - t0:.1f}s")
    lens, prompts = serving_prompts(cfg.vocab_size, REQUESTS, SEED)
    ids7 = torch.from_numpy(motif_prompts(
        GENERATE["batch"], GENERATE["prompt"], GENERATE["motif"],
        cfg.vocab_size, SEED + 3)).to(model.device)
    noise = logit_noise(torch, model, ids7)
    del ids7
    log(f"phase 17: bf16 logits of two recipes differ by up to {noise:.3e}"
        ": the near-tie limit of the streams held below")
    base = dict(num_slots=8, block_size=16, max_model_len=2048,
                prefill_chunk=128, max_new_tokens=32)
    runs, stats, streams, fails = {}, {}, {}, []
    for name, (kw, want) in SPEC_RUNS.items():
        engine = ServingEngine(model, ServingConfig(**base, **kw),
                               device="cuda",
                               draft_model=model if name == "self" else None)
        runs[name], stats[name], streams[name] = spec_serve_run(
            torch, kernels, engine, prompts, lens, f"phase 17 {name}", want)
        if name == "self":
            tick_window(torch, engine, prompts[:8], TICK_WINDOW,
                        "phase 17 self")
            if not stats[name]["spec_mean_accepted_len"] > 1.0:
                fails.append("phase 17 self: no draft accepted")
            # the draft loop's K2d steps each sit between a K3a and a K3b
            # pair; the target's ticks add more K3 and no K2d
            r = runs[name]
            if not r["norm_matmul"] >= 2 * r["paged_decode_attention"]:
                fails.append("phase 17 self: the draft loop ran unfused "
                             f"({r['norm_matmul']} norm_matmul for "
                             f"{r['paged_decode_attention']} K2d)")
        if "spec_tree" in kw:
            # a tick with no verifying slot (prefill rows only) runs
            # linear K2r: no row of it is a tree row
            log(f"  phase 17 {name}: K2r tree mode "
                f"{runs[name]['ragged_paged_attention_tree']} launches, "
                f"linear {runs[name]['ragged_paged_attention']} (ticks "
                "that verify no window)")
        held_streams(torch, model, f"phase 17 {name} vs phase 3", prompts,
                     streams[name], streams3, fails, limit=noise)
        engine.shutdown()
        del engine
        torch.cuda.empty_cache()
    # the self-drafted engine with its draft loop unfused, as it ran
    # before the draft loop took the fused layer: the accepted length of
    # each
    with mock.patch.object(ServingEngine, "_draft_scope",
                           lambda self: contextlib.nullcontext()):
        engine = ServingEngine(model, ServingConfig(
            **base, **SPEC_RUNS["self"][0]), device="cuda",
            draft_model=model)
        unfused, st_u, streams_u = spec_serve_run(
            torch, kernels, engine, prompts, lens,
            "phase 17 self (draft loop unfused)",
            ("ragged_paged_attention", "paged_decode_attention"))
        engine.shutdown()
        del engine
    log(f"  phase 17 self: spec_mean_accepted_len "
        f"{stats['self']['spec_mean_accepted_len']:.4f} with the draft loop "
        f"on K3a / K3b ({runs['self']['norm_matmul']} norm_matmul, "
        f"{runs['self']['paged_decode_attention']} K2d), "
        f"{st_u['spec_mean_accepted_len']:.4f} with it unfused "
        f"({unfused['norm_matmul']} norm_matmul, "
        f"{unfused['paged_decode_attention']} K2d); streams "
        f"{sum(np.array_equal(a, b) for a, b in zip(streams['self'], streams_u))}"
        f" of {len(streams_u)} equal; card {card_line()}")
    held_streams(torch, model, "phase 17 self unfused vs phase 3", prompts,
                 streams_u, streams3, fails, limit=noise)
    torch.cuda.empty_cache()
    same = all(np.array_equal(a, b) for a, b in
               zip(streams["chain"], streams["ngram"]))
    per = [stats[n]["spec_mean_accepted_len"] for n in ("chain", "ngram")]
    log(f"  phase 17 chain {CHAIN_TREE} vs ngram gamma 4: streams "
        f"{'equal' if same else 'DIFFER'}; tokens a verify {per[0]:.4f} / "
        f"{per[1]:.4f}")
    if not same or per[0] != per[1]:
        fails.append("phase 17 chain tree != linear n-gram")

    engine = ServingEngine(model, ServingConfig(
        **base, kv_cache_dtype="int8", **SPEC_RUNS["tree"][0]),
        device="cuda")
    runs["tree_int8"], _, st_q = spec_serve_run(
        torch, kernels, engine, prompts, lens, "phase 17 tree int8",
        ("ragged_paged_attention_tree_int8",))
    if runs["tree_int8"]["ragged_paged_attention_tree"]:
        fails.append("phase 17 tree int8: the tree mode ran on bf16 pools")
    held_streams(torch, model, "phase 17 tree int8 vs phase 3", prompts,
                 st_q, streams3, None, limit=noise)
    engine.shutdown()
    del engine, model
    torch.cuda.empty_cache()

    # float32, full widths: every drafter through the kernels and through
    # their plain versions
    cfg4 = LlamaConfig.llama3_8b()
    cfg4.num_hidden_layers = PHASE4_LAYERS
    model = LlamaForCausalLM(cfg4, device="cuda", seed=SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    prompts4 = [rng.randint(0, cfg4.vocab_size, size=n)
                for n in (40, 150, 70)]
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    heads = [torch.randn(cfg4.hidden_size, cfg4.vocab_size, generator=g,
                         device="cuda") * 0.02 for _ in range(2)]
    kinds = {"ngram": dict(num_speculative_tokens=4),
             "self": dict(num_speculative_tokens=4, drafter="model"),
             "tree": SPEC_RUNS["tree"][0],
             "heads": SPEC_RUNS["heads"][0]}
    res = {}
    for path in ("kernel", "plain"):
        patches = [] if path == "kernel" else plain_patches(df, rpa) + [
                mock.patch.object(pda, n, getattr(pda, "plain_" + n))
                for n in ("paged_decode_attention", "paged_verify_attention")]
        for p in patches:
            p.start()
        try:
            for kind, kw in kinds.items():
                res[path, kind] = serve_f32(
                    torch, ServingEngine, ServingConfig, model, prompts4,
                    draft_model=model if kind == "self" else None,
                    spec_heads=heads if kind == "heads" else None, **kw)
        finally:
            for p in patches:
                p.stop()
    for kind in kinds:
        lerr = float((res["kernel", kind][0]
                      - res["plain", kind][0]).abs().max())
        log(f"phase 17 f32 {kind}: first-tick logits max_abs_err="
            f"{lerr:.3e} (atol {LOGITS_ATOL})")
        if not lerr <= LOGITS_ATOL:
            fails.append(f"phase 17 f32 {kind} logits {lerr}")
        held_streams(torch, model, f"phase 17 f32 {kind} kernel vs plain",
                     prompts4, res["kernel", kind][1], res["plain", kind][1],
                     fails)
    del model, heads
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 17 failed: {fails}")
    return runs


# ---------------------------------------------------------------- phase 18

def gpt_train(torch, kernels, fa, GPTConfig, GPTForCausalLM, AdamW,
              TrainStep):
    """Phase 18 (e): GPT at GPTConfig()'s widths and 24 layers in bf16
    through TrainStep + AdamW(1e-4, multi_precision=True) on one seeded
    batch of GPT_TRAIN's 8 x 1024 tokens, hidden dropout 0.1 (live in
    train()): ms a step, trained tokens/s, MFU over bench.py:141's 6N +
    12 L s h, the idle share of 2 profiled steps, peak memory, K1
    launches a step (one each of K1f, K1dq, K1dkv a layer) and every
    loss (finite, the last under the first). Then GPT_GRAD's 2 layers at
    full widths in float32, dropout 0: the loss and every gradient
    through the K1 kernels (D 64) against their plain versions. Returns
    the bf16 run's launches."""
    cfg = GPTConfig()
    bsz, seq = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    model = GPTForCausalLM(cfg, device="cuda", seed=SEED + 19).to(
        torch.bfloat16)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, lambda out, a, k: out, opt)
    ids = np.random.RandomState(SEED + 19).randint(0, cfg.vocab_size,
                                                   (bsz, seq))
    batch = tuple(torch.from_numpy(a.astype(np.int64)).cuda()
                  for a in (ids, np.roll(ids, -1, axis=1)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses = [float(step(*batch)) for _ in range(GPT_TRAIN["warm"])]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    timed = [step(*batch) for _ in range(GPT_TRAIN["timed"])]
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    losses += [float(x) for x in timed]
    n_prof = GPT_TRAIN["profiled"]
    wall_ms, busy_ms, _ = profiled(torch, lambda: losses.append(
        float(step(*batch))), n_prof, 12)
    torch.cuda.synchronize()
    n_steps = len(losses)
    launches = {k: kernels.launch_counts[k] for k in TRAINING_KERNELS}
    tok_s = bsz * seq * GPT_TRAIN["timed"] / dt
    f_tok = 6 * n_params + 12 * cfg.num_hidden_layers * seq \
        * cfg.hidden_size
    log(f"phase 18 (e) training: GPT {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e6:.1f}M params bf16, batch {bsz} x {seq}, dropout "
        f"{cfg.hidden_dropout_prob}: {GPT_TRAIN['timed']} timed steps in "
        f"{dt:.4f}s -> {1e3 * dt / GPT_TRAIN['timed']:.3f} ms/step, "
        f"{tok_s:.1f} tokens/s, MFU {tok_s * f_tok / PEAK_FLOPS['bfloat16']:.4f}"
        f" (6N + 12 L s h = {f_tok / 1e9:.3f} GFLOP/token at "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.1f} TFLOP/s); profile of {n_prof} "
        f"steps: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms -> "
        f"idle share {max(0.0, 1 - busy_ms / wall_ms):.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase 18 (e): losses {[round(x, 5) for x in losses]}; K1 "
        f"launches {launches} over {n_steps} steps "
        f"({ {k: n / n_steps for k, n in launches.items()} } a step)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 18 training: losses not finite and "
                             f"falling: {losses}")
    want = cfg.num_hidden_layers * n_steps
    wrong = {k: n for k, n in launches.items() if n != want}
    if wrong:
        raise AssertionError(f"phase 18 training: K1 launched {wrong} "
                             f"times, want {want} each (layers x steps)")
    del model, opt, step, batch
    torch.cuda.empty_cache()

    # float32, 2 layers at full widths: K1 at D 64 against plain
    cfg = GPTConfig(num_hidden_layers=GPT_GRAD["layers"],
                    hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=SEED + 20)
    with torch.no_grad():       # biases that count
        g = torch.Generator(device="cuda").manual_seed(SEED + 20)
        for n, p in model.named_parameters():
            if n.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g,
                                          device="cuda"))
    ids = np.random.RandomState(SEED + 20).randint(
        0, cfg.vocab_size, (GPT_GRAD["batch"], GPT_GRAD["seq"]))
    ids_t = torch.from_numpy(ids.astype(np.int64)).cuda()
    labels_t = torch.from_numpy(np.roll(ids, -1, axis=1).astype(
        np.int64)).cuda()

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model(ids_t, labels=labels_t)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    kernels.reset_launch_counts()
    loss_k, grads_k = loss_and_grads()
    ran = {k: kernels.launch_counts[k] for k in TRAINING_KERNELS}
    loss_p, grads_p = patched([mock.patch.object(fa, n, getattr(
        fa, "plain_" + n)) for n in TRAINING_KERNELS], loss_and_grads)
    lerr = abs(loss_k - loss_p) / abs(loss_p)
    gerr = {n: float((grads_k[n] - grads_p[n]).abs().max()
                     / grads_p[n].abs().max().clamp(min=1e-30))
            for n in grads_p}
    worst = max(gerr, key=gerr.get)
    log(f"phase 18 (e) f32, {cfg.num_hidden_layers} layers at full widths, "
        f"{GPT_GRAD['batch']} x {GPT_GRAD['seq']} tokens, K1 at D 64 "
        f"({ran}): loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel "
        f"{lerr:.2e}, tol {LOSS_RTOL}); {len(gerr)} gradients, worst {worst}"
        f" rel {gerr[worst]:.2e} (tol {GRAD_RTOL})")
    bad = {n: e for n, e in gerr.items() if not e <= GRAD_RTOL}
    if not lerr <= LOSS_RTOL or bad or min(ran.values()) <= 0:
        raise AssertionError(f"phase 18 f32 training: loss {lerr}, "
                             f"gradients {bad}, launches {ran}")
    del model
    torch.cuda.empty_cache()
    return launches


# K3's kernels by name in a profile (namespace ptt::dg90): the split and
# stream-K bodies and their pre-passes (K3a's norm on the split body or
# statistics on the stream-K body, K3b's activation)
K3_PROFILE_KERNELS = ("decode_gemm_split", "decode_gemm", "normalize",
                      "row_stats", "activate")


def k3_by_kernel(by_kernel, n, tag):
    """Log K3's device ms a tick, by kernel, in a profile of ``n`` ticks
    (``by_kernel``: :func:`profiled`'s), and its share of the device
    time."""
    busy = sum(by_kernel.values())
    k3 = {}
    for name, ms in by_kernel.items():
        kind = next((k for k in K3_PROFILE_KERNELS if k in name), None)
        if kind and "dg90" in name:
            k3[kind] = k3.get(kind, 0.0) + ms
    total = sum(k3.values())
    log(f"{tag}: device {busy / n:.3f} ms a tick, K3 {total / n:.3f} ms a "
        f"tick ({total / max(busy, 1e-9):.4f} of it): "
        + ", ".join(f"{k} {ms / n:.4f}" for k, ms in sorted(k3.items())))
    return k3


def gpt_phase(torch, kernels, df, rpa, pda, fa, ServingEngine,
              ServingConfig, GPTConfig, GPTForCausalLM, AdamW, TrainStep):
    """Phase 18: GPT at GPTConfig()'s widths, all 24 layers, seeded
    weights cast to bf16 (the reference's ``Layer.bfloat16()``), over
    float32 pools as the reference's. (a) the fused engine serves phase
    3's traffic (GPT_PROMPT_MAX-token prompts at most): K3a ``ln``, K3b
    (``act=None`` and ``gelu_tanh``) twice a layer a tick and K2r's
    bf16-q-over-f32-pool mode a layer a tick; tokens/s, TTFT, ticks,
    rows a tick, peak memory, the idle share and host scalar reads over
    4 profiled ticks; the streams held against the unfused engine and
    the engine with its kernels routed to their plain versions by the
    near-tie rule (the logit difference of two bf16 recipes). (b) the
    same on int8 pools (K2r's int8 instance at D 64): pool bytes against the
    float32 pools', the streams' match with (a) (logged), the streams
    held against the int8 engine routed to the plain versions. (c)
    speculating: the model drafting for itself at gamma 4 (K2r, K2d in
    the new mode; accepted length above 1) and the chain tree (K2r's
    tree mode), each stream held against (a). (d) ``generate()`` on 4 motif prompts of
    512, 64 new: paged (K2d), n-gram at gamma 4 (K2v) and the chain tree
    (K2v's tree mode), all in the new mode; the chain's stream equal to
    n-gram's. (e) training (:func:`gpt_train`). Returns every run's
    launches."""
    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    log(f"phase 18: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        "allocated by earlier phases (inside every peak below)")
    cfg = GPTConfig()
    t0 = time.monotonic()
    model = GPTForCausalLM(cfg, device="cuda", seed=SEED + 18).to(
        torch.bfloat16)
    model.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 18: GPT (GPTConfig(): vocab {cfg.vocab_size}, hidden "
        f"{cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
        f"{cfg.num_attention_heads} heads of {cfg.head_dim}, ffn "
        f"{cfg.intermediate_size}, {cfg.max_position_embeddings} "
        f"positions), {n_params / 1e6:.1f}M params bf16, float32 pools; "
        f"init {time.monotonic() - t0:.1f}s")
    lens, prompts = serving_prompts(cfg.vocab_size, REQUESTS, SEED)
    lens = np.minimum(lens, GPT_PROMPT_MAX)
    prompts = [p[:GPT_PROMPT_MAX] for p in prompts]
    ids = torch.from_numpy(motif_prompts(
        GENERATE["batch"], GENERATE["prompt"], GENERATE["motif"],
        cfg.vocab_size, SEED + 18)).to(model.device)
    noise = logit_noise(torch, model, ids)
    log(f"phase 18: bf16 logits of two recipes differ by up to {noise:.3e}"
        ": the near-tie limit of the streams held below")
    base = dict(num_slots=8, block_size=16, max_model_len=GPT_MAX_LEN,
                prefill_chunk=128, max_new_tokens=32)
    layers = cfg.num_hidden_layers
    runs, fails = {}, []

    def serve(tag, want, draft=None, **kw):
        engine = ServingEngine(model, ServingConfig(**base, **kw),
                               device="cuda", draft_model=draft)
        runs[tag], st, streams = serve_run(torch, kernels, engine, prompts,
                                           lens, f"phase 18 {tag}", want)
        return engine, st, streams

    # (a) the fused engine, against unfused and plain
    engine, st_a, streams_a = serve("serve", GPT_SERVING_KERNELS)
    la = runs["serve"]
    per_tick = layers * st_a["ticks"]
    log(f"phase 18 (a): K2r f32pool {la['ragged_paged_attention_f32pool']},"
        f" K3a {la['norm_matmul']}, K3b {la['matmul_residual']} launches "
        f"over {st_a['ticks']} ticks (want {per_tick}, {2 * per_tick}, "
        f"{2 * per_tick}); kv_cache_dtype {st_a['kv_cache_dtype']}, pool "
        f"bytes {st_a['kv_pool_bytes']}")
    if la["ragged_paged_attention_f32pool"] != per_tick \
            or la["norm_matmul"] != 2 * per_tick \
            or la["matmul_residual"] != 2 * per_tick \
            or la["ragged_paged_attention"]:
        fails.append("phase 18 (a): launches off the fused tick's count")
    by_kernel = {}
    tick_window(torch, engine, prompts[:8], TICK_WINDOW, "phase 18 (a)",
                by_kernel)
    busy = sum(by_kernel.values())
    k2r = sum(ms for k, ms in by_kernel.items()
              if "paged_attention_kernel" in k)
    merges = [k for k in by_kernel if "merge_kernel" in k]
    log(f"phase 18 (a) profile: K2r (the Hopper body) {k2r:.3f} ms of "
        f"{busy:.3f} ms of device time over {TICK_WINDOW} ticks = "
        f"{k2r / max(busy, 1e-9):.4f}; separate split-merge kernels: "
        f"{merges or 'none'}")
    if merges or k2r <= 0:
        fails.append("phase 18 (a): K2r not the Hopper body alone in the "
                     "profiled ticks")
    k3_by_kernel(by_kernel, TICK_WINDOW, "phase 18 (a) mixed ticks")
    pure = {}
    pure_tick_window(torch, engine, prompts[:8], TICK_WINDOW, "phase 18 (a)",
                     pure)
    k3_by_kernel(pure, TICK_WINDOW, "phase 18 (a) pure ticks")
    engine.shutdown()
    del engine
    lockstep_run(torch, kernels, ServingEngine, ServingConfig, model,
                 "phase 19 (a) GPT, float32 pools")
    # the unfused engine is a comparison: its launches are not the path's
    engine, _, streams_u = serve("unfused",
                                 ("ragged_paged_attention_f32pool",),
                                 fused_decode=False)
    engine.shutdown()
    unfused = runs.pop("unfused")
    if unfused["norm_matmul"] or unfused["matmul_residual"]:
        fails.append("phase 18 unfused: K3 launched")
    held_streams(torch, model, "phase 18 (a) fused vs unfused", prompts,
                 streams_a, streams_u, fails, limit=noise)
    eng = ServingEngine(model, ServingConfig(**base), device="cuda")
    streams_p = patched(plain_patches(df, rpa), lambda: eng.serve(
        prompts, max_new_tokens=base["max_new_tokens"]))
    eng.shutdown()
    del eng
    held_streams(torch, model, "phase 18 (a) kernels vs plain", prompts,
                 streams_a, streams_p, fails, limit=noise)
    torch.cuda.empty_cache()

    # (b) int8 pools
    engine, st_b, streams_b = serve(
        "int8", ("ragged_paged_attention_int8", "norm_matmul",
                 "matmul_residual"), kv_cache_dtype="int8")
    engine.shutdown()
    ratio = st_b["kv_pool_bytes"] / st_a["kv_pool_bytes"]
    log(f"phase 18 (b) int8 pools: pool bytes {st_b['kv_pool_bytes']} = "
        f"{ratio:.4f} x the float32 pools' (want (D + 4) / 4D = "
        f"{(cfg.head_dim + 4) / (4 * cfg.head_dim):.4f}); streams match (a)"
        f" at {match_rate(streams_b, streams_a):.4f} of tokens")
    if runs["int8"]["ragged_paged_attention_f32pool"] \
            or abs(ratio - (cfg.head_dim + 4) / (4 * cfg.head_dim)) > 1e-3:
        fails.append("phase 18 (b): not on int8 pools")
    # int8 against float32 pools is another cache: logged, not held;
    # the int8 engine's kernels are held against their plain versions on
    # the same int8 pools (a comparison run: not the path's launches)
    held_streams(torch, model, "phase 18 (b) int8 vs (a)", prompts,
                 streams_b, streams_a, None, limit=noise)
    eng = ServingEngine(model, ServingConfig(**base, kv_cache_dtype="int8"),
                        device="cuda")
    streams_bp = patched(plain_patches(df, rpa), lambda: eng.serve(
        prompts, max_new_tokens=base["max_new_tokens"]))
    eng.shutdown()
    del eng
    held_streams(torch, model, "phase 18 (b) int8 kernels vs plain",
                 prompts, streams_b, streams_bp, fails, limit=noise)
    torch.cuda.empty_cache()

    # (c) speculating: the model drafting for itself, and the chain tree
    spec = {"self": (dict(num_speculative_tokens=4, drafter="model"),
                     ("ragged_paged_attention_f32pool",
                      "paged_decode_attention_f32pool")),
            "chain": (dict(num_speculative_tokens=len(CHAIN_TREE),
                           spec_tree=CHAIN_TREE),
                      ("ragged_paged_attention_tree_f32pool",))}
    for name, (kw, want) in spec.items():
        engine, st, streams = serve(name, want, draft=model if name == "self"
                                    else None, **kw)
        log(f"phase 18 (c) {name}: spec_mean_accepted_len "
            f"{st['spec_mean_accepted_len']:.4f}, spec_acceptance_rate "
            f"{st['spec_acceptance_rate']:.4f}")
        if name == "self" and not st["spec_mean_accepted_len"] > 1.0:
            fails.append("phase 18 (c) self: no draft accepted")
        held_streams(torch, model, f"phase 18 (c) {name} vs (a)", prompts,
                     streams, streams_a, fails, limit=noise)
        engine.shutdown()
        del engine
        torch.cuda.empty_cache()

    # (d) generate()
    forwards = []
    hook = model.register_forward_pre_hook(lambda m, a: forwards.append(1))
    gen = {"paged": (dict(cache_impl="paged"),
                     ("paged_decode_attention_f32pool",)),
           "ngram": (dict(num_speculative_tokens=GENERATE["gamma"]),
                     ("paged_verify_attention_f32pool",)),
           "chain": (dict(num_speculative_tokens=len(CHAIN_TREE),
                          spec_tree=CHAIN_TREE),
                     ("paged_verify_attention_tree_f32pool",))}
    gstreams, per = {}, {}
    for name, (kw, want) in gen.items():
        gstreams[name], runs["generate " + name], per[name] = generate_once(
            torch, kernels, model, ids, GENERATE["new"], kw, forwards,
            f"phase 18 (d) {name}", list(kernels.launch_counts), want)
    hook.remove()
    same = np.array_equal(gstreams["chain"], gstreams["ngram"]) \
        and per["chain"] == per["ngram"]
    log(f"  phase 18 (d) chain {CHAIN_TREE} vs n-gram gamma "
        f"{GENERATE['gamma']}: {'equal' if same else 'DIFFER'}")
    if not same:
        fails.append("phase 18 (d): chain tree != linear n-gram")
    held_streams(torch, model, "phase 18 (d) ngram vs paged",
                 ids.cpu().numpy(),
                 gstreams["ngram"], gstreams["paged"], fails, limit=noise)
    del model, ids
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 18 failed: {fails}")

    # (e) training
    runs["train"] = gpt_train(torch, kernels, fa, GPTConfig, GPTForCausalLM,
                              AdamW, TrainStep)
    log(f"phase 18: {time.monotonic() - t_phase:.1f}s")
    return runs


# ---------------------------------------------------------------- phase 20

# (a): two waves of PREFIX["requests"] requests, each one of two
# system-prompt-long shared prefixes plus a distinct tail (the first of
# wave 2 is exactly a system prompt: a full-prompt hit); (b): low-priority
# long requests, then after PREEMPT["after"] ticks high-priority short ones,
# on PREEMPT["slots"] slots with a host tier of PREEMPT["tier"] bytes; (c):
# a pool of RESTORE_POOL requests' worst-case blocks on one slot
PREFIX = dict(system=1024, tails=(64, 512), requests=8, new=32)
PREEMPT = dict(slots=4, lo=(4, 1024, 128), hi=(4, 256, 32), after=8,
               tier=4 << 30)
RESTORE_POOL = 2
CANCEL = dict(requests=4, prompt=256, new=64, at=16)
SERVE20 = dict(block_size=16, max_model_len=2048, prefill_chunk=128)


class FirstTokens:
    """A stream callback keeping each request's first-token time."""

    def __init__(self):
        self.t = {}

    def __call__(self, rid, tok):
        self.t.setdefault(rid, time.monotonic())


def run_plan(torch, kernels, engine, firsts, plan, tag, on_tick=None,
             full=True, want=SERVING_KERNELS):
    """Drive ``engine`` over ``plan`` (``(tick, prompt, max_new, priority)``
    each, submitted before that tick) to the end, every launch count set to
    0 just before and read just after; ``on_tick(engine, tick, rids)`` runs
    before each tick. Checks the tokens (``full``: every request its whole
    budget) and that each kernel of ``want`` launched. Returns ``(streams and TTFT ms in plan order, launches, wall
    seconds, stats)``."""
    order = sorted(range(len(plan)), key=lambda j: plan[j][0])
    rids, sub = {}, {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    tick = 0
    while order or engine.num_queued or engine.num_active:
        while order and plan[order[0]][0] <= tick:
            j = order.pop(0)
            sub[j] = time.monotonic()
            rids[j] = engine.submit(plan[j][1], plan[j][2],
                                    priority=plan[j][3])
        if on_tick is not None:
            on_tick(engine, tick, rids)
        engine.step()
        tick += 1
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(kernels.launch_counts)
    st = engine.stats()
    vocab = engine.model.config.vocab_size
    streams, ttft = [], []
    for j in range(len(plan)):
        toks = done.get(rids[j], np.zeros(0, np.int64))
        if (full and len(toks) != plan[j][2]) or len(toks) and (
                toks.min() < 0 or toks.max() >= vocab):
            raise AssertionError(f"{tag}: request {j}: bad tokens {toks}")
        streams.append(toks)
        t = firsts.t.get(rids[j])
        ttft.append(None if t is None else 1000.0 * (t - sub[j]))
    missing = [k for k in want if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched on the main "
                             f"path: {missing}")
    n_tok = sum(len(x) for x in streams)
    log(f"{tag}: {len(plan)} requests, {n_tok} tokens in {wall:.3f}s -> "
        f"{n_tok / wall:.2f} tok/s; ticks {tick}, {st['pure_ticks']} pure "
        f"(engine total); {st['executables_compiled']} CUDA graphs")
    return streams, ttft, launches, wall, st


def ms_stats(xs):
    xs = [x for x in xs if x is not None]
    return (f"mean {np.mean(xs):.1f} p50 {np.percentile(xs, 50):.1f}"
            if xs else "none")


def add_launches(total, got):
    for k in SERVING_KERNELS:
        total[k] = total.get(k, 0) + got[k]


def check_imports(torch, engine, pc, bad):
    """Wrap ``engine._import_payload``: after each import the blocks it
    wrote must hold the payload's bytes (a swap's are the victim's bytes
    at its preemption, an evicted block's those it was published with);
    a mismatch lands in ``bad``. The wrapper holds the engine weakly, so
    a dropped engine is freed at once, as without it."""
    imp = type(engine)._import_payload
    ref = weakref.ref(engine)

    def checked(blocks, payload):
        eng = ref()
        imp(eng, blocks, payload)
        back = pc.payload_to_host(pc.export_blocks(eng._pools, blocks))
        for (bk, bv), (pk, pv) in zip(back, payload):
            for x, y in ((bk, pk), (bv, pv)):
                pairs = ((x.data, y.data), (x.scale, y.scale)) \
                    if hasattr(x, "scale") else ((x, y),)
                if not all(torch.equal(a, b) for a, b in pairs):
                    bad.append(list(blocks))
    engine._import_payload = checked


def prefix_traffic(vocab, seed):
    """Phase 20 (a)'s two waves (seeded)."""
    rng = np.random.RandomState(seed)
    systems = [rng.randint(0, vocab, PREFIX["system"]) for _ in range(2)]
    waves = []
    for w in range(2):
        wave = []
        for k in range(PREFIX["requests"]):
            if w == 1 and k == 0:
                wave.append(systems[0].copy())
                continue
            lo, hi = PREFIX["tails"]
            tail = rng.randint(0, vocab, rng.randint(lo, hi + 1))
            wave.append(np.concatenate([systems[k % 2], tail]))
        waves.append(wave)
    return systems, waves


def mixed_window(torch, engine, prompts, tag):
    """TICK_WINDOW profiled ticks with prefill rows (their wall ms and
    idle share): ``prompts`` submitted, one tick, the window, drained."""
    for p in prompts:
        engine.submit(p)
    engine.step()
    p0 = engine.stats()["pure_ticks"]
    wall_ms, busy_ms, _ = profiled(torch, engine.step, TICK_WINDOW, 6)
    pure = engine.stats()["pure_ticks"] - p0
    engine.run()
    log(f"{tag}: {TICK_WINDOW} profiled ticks ({TICK_WINDOW + 1 - pure} "
        f"of {TICK_WINDOW + 1} with prefill rows, the profiler's first "
        f"included): {wall_ms / TICK_WINDOW:.3f} ms a tick, device "
        f"{busy_ms / TICK_WINDOW:.3f} ms -> idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f}")


def prefix_phase(torch, kernels, pc, ServingEngine, ServingConfig, model,
                 tag, limit, fails, launches, want=SERVING_KERNELS,
                 profile=True):
    """Phase 20 (a): the two waves on 8 slots, the cache on and off: hit
    rate, tokens reused, copies, TTFT a wave, tokens/s; the mixed graph
    not captured again in wave 2; the published blocks of the first system
    prompt unchanged by wave 2 (its full-prompt hit copies the shared
    block); streams on vs off held by the near-tie ``limit``. Returns the
    cache-on streams."""
    systems, waves = prefix_traffic(model.config.vocab_size, SEED + 20)
    out = {}
    for cache in (True, False):
        name = f"{tag} cache {'on' if cache else 'off'}"
        firsts = FirstTokens()
        engine = ServingEngine(model, ServingConfig(
            num_slots=PREFIX["requests"], **SERVE20,
            max_new_tokens=PREFIX["new"], enable_prefix_cache=cache),
            device="cuda", stream_callback=firsts)
        streams, mixed = [], []
        for w, wave in enumerate(waves):
            snap = None
            if cache and w == 1:
                blocks = [engine._alloc.lookup(h) for h in pc.chain_hashes(
                    engine._fp, systems[0], engine._bs)]
                if None in blocks:
                    fails.append(f"{name}: system prompt not published")
                else:
                    snap = [t[blocks].clone()
                            for t in pool_tensors(engine._pools)]
            got, ttft, n, wall, st = run_plan(
                torch, kernels, engine, firsts,
                [(0, p, PREFIX["new"], 0) for p in wave],
                f"{name} wave {w + 1}", want=want)
            add_launches(launches, n)
            streams += got
            mixed.append(sum(not lay.pure for lay in engine._graphs))
            log(f"{name} wave {w + 1}: TTFT ms {ms_stats(ttft)}; "
                f"prefix_hit_rate {st['prefix_hit_rate']:.4f} (engine "
                f"total), prefix_tokens_reused {st['prefix_tokens_reused']},"
                f" prefix_blocks_reused {st['prefix_blocks_reused']}, "
                f"cow_copies {st['cow_copies']}, cached_blocks "
                f"{st['cached_blocks']}, executables_compiled "
                f"{st['executables_compiled']} ({mixed[-1]} mixed)")
            if snap is not None:
                same = all(torch.equal(a, t[blocks]) for a, t in
                           zip(snap, pool_tensors(engine._pools)))
                log(f"{name}: the first system prompt's {len(blocks)} "
                    f"published blocks after wave 2: "
                    f"{'unchanged' if same else 'CHANGED'}")
                if not same:
                    fails.append(f"{name}: published blocks changed")
        if cache:
            if not (st["cow_copies"] >= 1 and st["prefix_tokens_reused"]
                    >= PREFIX["system"] * (PREFIX["requests"] - 1)):
                fails.append(f"{name}: no full-prompt hit / reuse ({st})")
            if len(mixed) == 2 and mixed[1] != mixed[0] and \
                    engine._graphs_ok and engine.cuda_graphs:
                fails.append(f"{name}: wave 2 captured a mixed graph")
        if profile:
            mixed_window(torch, engine, waves[1], f"{name} mixed ticks")
        engine.shutdown()
        out[cache] = streams
        del engine
        torch.cuda.empty_cache()
    held_streams(torch, model, f"{tag} cache on vs off", waves[0] + waves[1],
                 out[True], out[False], fails, limit=limit)
    return out[True]


def preempt_plan(vocab, seed):
    rng = np.random.RandomState(seed)
    plan = []
    for (n, length, new), (tick, prio) in (
            (PREEMPT["lo"], (0, 0)), (PREEMPT["hi"], (PREEMPT["after"], 2))):
        plan += [(tick, rng.randint(0, vocab, length), new, prio)
                 for _ in range(n)]
    return plan


def preempt_phase(torch, kernels, pc, ServingEngine, ServingConfig, model,
                  tag, limit, fails, launches, want=SERVING_KERNELS,
                  xfer=True):
    """Phase 20 (b): PREEMPT's traffic never preempted (8 slots), then on
    PREEMPT["slots"] slots resuming by swap, by recompute and by the cost
    model: preemptions, blocks spilled / restored, resumes by path, the
    measured transfer rate, TTFT by class; every import's blocks equal
    the bytes spilled; streams held against the never-preempted run.
    ``xfer``: also time one export and one import of a 1024-token slot.
    Returns the swap run's streams."""
    plan = preempt_plan(model.config.vocab_size, SEED + 21)
    n_lo = PREEMPT["lo"][0]
    res = {}
    for run, kw in (("never", dict(num_slots=2 * PREEMPT["slots"])),
                    ("swap", dict(preempt_resume="swap")),
                    ("recompute", dict(preempt_resume="recompute")),
                    ("auto", dict(preempt_resume="auto"))):
        name = f"{tag} {run}"
        firsts = FirstTokens()
        engine = ServingEngine(model, ServingConfig(**dict(
            dict(num_slots=PREEMPT["slots"], **SERVE20,
                 host_kv_tier_bytes=PREEMPT["tier"]), **kw)), device="cuda",
            stream_callback=firsts)
        bad = []
        check_imports(torch, engine, pc, bad)
        streams, ttft, n, wall, st = run_plan(torch, kernels, engine,
                                              firsts, plan, name, want=want)
        add_launches(launches, n)
        res[run] = streams
        log(f"{name}: preemptions {st['preemptions']}, kv_blocks_spilled "
            f"{st['kv_blocks_spilled']}, kv_blocks_restored "
            f"{st['kv_blocks_restored']}, swap resumes "
            f"{st['preempt_swap_resumes']}, recompute resumes "
            f"{st['preempt_recompute_resumes']}, host_xfer_bytes_per_s_est "
            f"{st['host_xfer_bytes_per_s_est']}, prefill_rows_per_s_est "
            f"{st['prefill_rows_per_s_est']}, cow_copies {st['cow_copies']};"
            f" TTFT ms priority 0 {ms_stats(ttft[:n_lo])}, priority 2 "
            f"{ms_stats(ttft[n_lo:])}; imports checked: "
            f"{'equal' if not bad else 'DIFFER ' + str(bad)}")
        if bad:
            fails.append(f"{name}: imported blocks differ from the spill")
        if run != "never" and not st["preemptions"]:
            fails.append(f"{name}: nothing preempted")
        if run == "swap" and not st["preempt_swap_resumes"]:
            fails.append(f"{name}: no swap resume")
        if run == "recompute" and not st["preempt_recompute_resumes"]:
            fails.append(f"{name}: no recompute resume")
        if run != "never":
            held_streams(torch, model, f"{name} vs never preempted",
                         [p for _, p, _, _ in plan], streams, res["never"],
                         fails, limit=limit)
        if xfer and run == "swap":
            blocks = list(range(1, 1 + PREEMPT["lo"][1] // engine._bs))
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                payload = engine._export_payload(blocks)
                t1 = time.monotonic()
                # the engine's own import, not the checking wrapper
                type(engine)._import_payload(engine, blocks, payload)
                torch.cuda.synchronize()
                times.append((1e3 * (t1 - t0),
                              1e3 * (time.monotonic() - t1)))
            nb = pc.payload_nbytes(payload)
            ex, im = (min(t[k] for t in times) for k in (0, 1))
            log(f"{name}: one {PREEMPT['lo'][1]}-token slot ({len(blocks)}"
                f" blocks, {nb} bytes): export to host {ex:.3f} ms "
                f"({nb / ex / 1e6:.3f} GB/s), import {im:.3f} ms "
                f"({nb / im / 1e6:.3f} GB/s), best of 3")
        engine.shutdown()
        del engine
        torch.cuda.empty_cache()
    return res["swap"]


def restore_phase(torch, kernels, pc, ServingEngine, ServingConfig, model,
                  tag, limit, fails, launches, want=SERVING_KERNELS):
    """Phase 20 (c): one slot, a pool of RESTORE_POOL requests' worst-case
    blocks and a host tier: A, then B and C (distinct prompts) evict A's
    published blocks into the tier, then D shares A's prompt and restores
    them; every import's blocks equal their spilled bytes; the four
    streams held against a cold engine's (cache off). Returns the warm
    streams."""
    rng = np.random.RandomState(SEED + 22)
    vocab = model.config.vocab_size
    n, tail, new = PREFIX["system"], PREFIX["tails"][0], PREFIX["new"]
    a = rng.randint(0, vocab, n)
    prompts = [a, rng.randint(0, vocab, n), rng.randint(0, vocab, n),
               np.concatenate([a, rng.randint(0, vocab, tail)])]
    worst = -(-(n + tail + new) // SERVE20["block_size"])
    out = {}
    for cache in (True, False):
        name = f"{tag} cache {'on' if cache else 'off'}"
        firsts = FirstTokens()
        engine = ServingEngine(model, ServingConfig(
            num_slots=1, **SERVE20, num_blocks=1 + RESTORE_POOL * worst,
            host_kv_tier_bytes=PREEMPT["tier"], enable_prefix_cache=cache),
            device="cuda", stream_callback=firsts)
        bad = []
        check_imports(torch, engine, pc, bad)
        streams = []
        for k, p in enumerate(prompts):
            got, ttft, nl, _, st = run_plan(
                torch, kernels, engine, firsts, [(0, p, new, 0)],
                f"{name} request {'ABCD'[k]}", want=want)
            add_launches(launches, nl)
            streams += got
            log(f"{name} request {'ABCD'[k]}: TTFT ms {ttft[0]:.1f}; "
                f"cache_evictions {st['cache_evictions']}, "
                f"kv_blocks_spilled {st['kv_blocks_spilled']}, "
                f"kv_blocks_restored {st['kv_blocks_restored']}, "
                f"host_tier_bytes {st['host_tier_bytes']}, "
                f"prefix_tokens_reused {st['prefix_tokens_reused']}")
        if cache and not st["kv_blocks_restored"] > 0:
            fails.append(f"{name}: nothing restored from the host tier")
        if bad:
            fails.append(f"{name}: restored blocks differ from the spill")
        out[cache] = streams
        engine.shutdown()
        del engine
        torch.cuda.empty_cache()
    held_streams(torch, model, f"{tag} warm vs cold", prompts, out[True],
                 out[False], fails, limit=limit)
    return prompts, out[True]


def async_lifecycle_phase(torch, kernels, ServingEngine, ServingConfig,
                          model, swap_streams, fails, launches):
    """Phase 20 (e): ``async_depth=1`` under (b)'s storm (resuming by
    swap) and under a cancel mid-pipeline: streams equal to the
    synchronous engine's token for token."""
    plan = preempt_plan(model.config.vocab_size, SEED + 21)
    firsts = FirstTokens()
    engine = ServingEngine(model, ServingConfig(
        num_slots=PREEMPT["slots"], **SERVE20,
        host_kv_tier_bytes=PREEMPT["tier"], preempt_resume="swap",
        async_depth=1), device="cuda", stream_callback=firsts)
    got, _, n, _, st = run_plan(torch, kernels, engine, firsts, plan,
                                "phase 20 (e) storm async")
    add_launches(launches, n)
    engine.shutdown()
    same = sum(np.array_equal(x, y) for x, y in zip(got, swap_streams))
    log(f"phase 20 (e) storm: {same} of {len(got)} streams equal the "
        f"synchronous swap run's; preemptions {st['preemptions']}, "
        f"pipelined ticks {st['pipelined_ticks']}, flushes "
        f"{st['pipeline_flushes']}")
    if same != len(got) or not st["preemptions"]:
        fails.append("phase 20 (e): async storm differs from sync")
    rng = np.random.RandomState(SEED + 23)
    plan = [(0, rng.randint(0, model.config.vocab_size, CANCEL["prompt"]),
             CANCEL["new"], 0) for _ in range(CANCEL["requests"])]

    def cancel(engine, tick, rids):
        if tick == CANCEL["at"]:
            engine.cancel(rids[1])

    res = {}
    for depth in (0, 1):
        firsts = FirstTokens()
        engine = ServingEngine(model, ServingConfig(
            num_slots=CANCEL["requests"], **SERVE20, async_depth=depth),
            device="cuda", stream_callback=firsts)
        res[depth], _, n, _, st = run_plan(
            torch, kernels, engine, firsts, plan,
            f"phase 20 (e) cancel async {depth}", on_tick=cancel,
            full=False)
        add_launches(launches, n)
        res[depth] = (res[depth], st)
        engine.shutdown()
        del engine
    (sync, st0), (asy, st1) = res[0], res[1]
    same = sum(np.array_equal(x, y) for x, y in zip(sync, asy))
    log(f"phase 20 (e) cancel at tick {CANCEL['at']}: {same} of "
        f"{len(sync)} streams equal, the cancelled one "
        f"{len(asy[1])} of {CANCEL['new']} tokens; pipelined ticks "
        f"{st1['pipelined_ticks']}, requests_cancelled "
        f"{st1['requests_cancelled']}")
    if same != len(sync) or not 0 < len(asy[1]) < CANCEL["new"] \
            or st1["requests_cancelled"] != 1 or not st1["pipelined_ticks"]:
        fails.append("phase 20 (e): cancel mid-pipeline")
    torch.cuda.empty_cache()


def lifecycle_phase(torch, kernels, df, rpa, ServingEngine, ServingConfig,
                    LlamaConfig, LlamaForCausalLM, layers):
    """Phase 20: the prefix cache, preemption with the host KV tier and
    the request lifecycle on phase 3's model (Llama-3-8B at ``layers``
    layers, bf16, phase 3's seeded weights): (a)-(c) and (e), the bf16
    streams held by the near-tie rule (the logit difference of two bf16
    recipes), (e) token for token; then (d): (a)-(c) in float32 at
    PHASE4_LAYERS layers through the kernels and through their plain
    versions (phase 4's rule). Returns the launch counts of its runs."""
    from paddle_tpu_torch.ops import paged_cache as pc
    t_phase = time.monotonic()
    cfg = LlamaConfig.llama3_8b()
    cfg.dtype = "bfloat16"
    cfg.num_hidden_layers = layers
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED)
    ids7 = torch.from_numpy(motif_prompts(
        GENERATE["batch"], GENERATE["prompt"], GENERATE["motif"],
        cfg.vocab_size, SEED + 3)).to(model.device)
    noise = logit_noise(torch, model, ids7)
    del ids7
    log(f"phase 20: Llama-3-8B, {layers} layers bf16 (phase 3's weights); "
        f"bf16 logits of two recipes differ by up to {noise:.3e}: the "
        "near-tie limit of the streams held below")
    fails, launches = [], {}
    prefix_phase(torch, kernels, pc, ServingEngine, ServingConfig, model,
                 "phase 20 (a)", noise, fails, launches)
    swap = preempt_phase(torch, kernels, pc, ServingEngine, ServingConfig,
                         model, "phase 20 (b)", noise, fails, launches)
    restore_phase(torch, kernels, pc, ServingEngine, ServingConfig, model,
                  "phase 20 (c)", noise, fails, launches)
    async_lifecycle_phase(torch, kernels, ServingEngine, ServingConfig,
                          model, swap, fails, launches)
    del model
    torch.cuda.empty_cache()
    log(f"phase 20 (a)-(c), (e): {time.monotonic() - t_phase:.1f}s")

    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = PHASE4_LAYERS
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED + 1)
    streams = {}
    for path in ("kernels", "plain"):
        patches = plain_patches(df, rpa) if path == "plain" else []
        want = () if patches else SERVING_KERNELS
        for p in patches:
            p.start()
        try:
            tag = f"phase 20 (d) f32 {path}"
            streams[path] = (
                prefix_phase(torch, kernels, pc, ServingEngine,
                             ServingConfig, model, f"{tag} (a)",
                             LOGITS_ATOL, fails, {}, want, profile=False),
                preempt_phase(torch, kernels, pc, ServingEngine,
                              ServingConfig, model, f"{tag} (b)",
                              LOGITS_ATOL, fails, {}, want, xfer=False),
                restore_phase(torch, kernels, pc, ServingEngine,
                              ServingConfig, model, f"{tag} (c)",
                              LOGITS_ATOL, fails, {}, want))
        finally:
            for p in patches:
                p.stop()
    _, waves = prefix_traffic(cfg.vocab_size, SEED + 20)
    held_streams(torch, model, "phase 20 (d) f32 (a) kernels vs plain",
                 waves[0] + waves[1], streams["kernels"][0],
                 streams["plain"][0], fails)
    held_streams(torch, model, "phase 20 (d) f32 (b) kernels vs plain",
                 [p for _, p, _, _ in preempt_plan(cfg.vocab_size,
                                                   SEED + 21)],
                 streams["kernels"][1], streams["plain"][1], fails)
    held_streams(torch, model, "phase 20 (d) f32 (c) kernels vs plain",
                 streams["kernels"][2][0], streams["kernels"][2][1],
                 streams["plain"][2][1], fails)
    del model
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 20 failed: {fails}")
    log(f"phase 20: {time.monotonic() - t_phase:.1f}s; launches {launches}")
    return launches


# --------------------------------------------------------------- phase 21

def lora_weights(model, names, aid, rank=LORA_RANK, scale=LORA_SCALE):
    """Adapter ``aid``'s leaf-name weights (every layer's module of each
    name), ``A [d_in, rank]`` and ``B [rank, d_out]`` drawn N(0, scale)
    from a generator seeded by ``aid``, at ``model``'s widths."""
    from paddle_tpu_torch.ops.lora import ATTN_TARGETS, MLP_TARGETS
    widths = {q.rsplit(".", 1)[-1]: tuple(m.weight.shape)
              for q, m in model.named_modules()
              if q.rsplit(".", 1)[-1] in ATTN_TARGETS + MLP_TARGETS}
    rng = np.random.RandomState(SEED + 2100 + aid)
    return {n: (rng.normal(0, scale, (widths[n][0], rank)).astype(
                    np.float32),
                rng.normal(0, scale, (rank, widths[n][1])).astype(
                    np.float32)) for n in names}


def lora_margin(torch, lora, engine):
    """``margin(i, ids)`` for :func:`held_streams` over an engine's LoRA
    streams: the top-2 logit margin of the dense forward over ``ids``
    under the adapter of stream ``i`` (``engine.stream_adapters[i]``),
    the forward run inside a scope whose rows all take that adapter's
    stack row."""
    def margin(i, ids):
        pool, aid = engine._lora, engine.stream_adapters[i]
        row = 0 if aid is None else pool.acquire(aid)
        try:
            x = torch.as_tensor(np.asarray(ids, np.int64),
                                device=engine.model.device)[None]
            ra = torch.full((x.shape[1],), row, device=x.device)
            with torch.no_grad(), lora.serving_lora_scope(
                    pool.operand(), ra, pool.scaling):
                logits = engine.model(x)[0, -1].float()
        finally:
            if aid is not None:
                pool.release(aid)
        top = torch.topk(logits, 2).values
        return float(top[0] - top[1])
    return margin


def lora_batch(torch, kernels, engine, prompts, aids, tag, want):
    """Serve ``prompts`` at once under ``aids`` on ``engine``, every launch
    count set to 0 just before and read just after; fails when a kernel
    of ``want`` never launched. Returns ``(streams, launches)``."""
    rids = [engine.submit(p, adapter_id=a) for p, a in zip(prompts, aids)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    done = engine.run()
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    missing = [k for k in want if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched on the main "
                             f"path: {missing}")
    return [done[r] for r in rids], launches


def lora_f32_case(torch, kernels, lora, mg, ServingEngine, ServingConfig,
                  model, prompts, tag, names, fails, want, plain=False,
                  **kw):
    """One float32 case of phase 21 (a) / (c): an engine of LORA_F32 (``kw``
    on top) with adapters 1-3 of ``names`` serves the LORA_F32_AIDS batch,
    then each request alone on the same engine; batched and solo streams
    must be equal token for token (a row's delta is its own, bit for bit).
    ``plain``: the batch again on an engine with K4 patched to its plain
    versions (graphs off), held to the kernels' streams by phase 4's rule
    under each stream's adapter. Returns the batch's launches."""
    t0 = time.monotonic()
    rank = kw.pop("lora_rank", LORA_RANK)
    cfg = ServingConfig(**LORA_F32, lora_rank=rank, max_adapters=4, **kw)

    def engine():
        eng = ServingEngine(model, cfg, device="cuda")
        for aid in (1, 2, 3):
            eng.load_adapter(aid, lora_weights(model, names, aid, rank))
        eng.stream_adapters = LORA_F32_AIDS
        return eng

    eng = engine()
    batch, launches = lora_batch(torch, kernels, eng, prompts,
                                 LORA_F32_AIDS, tag, want)
    solo = [lora_batch(torch, kernels, eng, [p], [a], f"{tag} solo", ())[0][0]
            for p, a in zip(prompts, LORA_F32_AIDS)]
    same = [np.array_equal(a, b) for a, b in zip(batch, solo)]
    st = eng.stats()
    log(f"{tag}: rank {rank} (stacks at {lora.padded_rank(rank)}), "
        f"{len(prompts)} requests under {LORA_F32_AIDS}: batched == solo "
        f"for {sum(same)} of {len(same)} streams; "
        f"{st['executables_compiled']} CUDA graphs; lora launches "
        f"{ {k: launches[k] for k in LORA_KERNELS} }")
    if not all(same):
        fails.append(f"{tag}: batched != solo")
    if plain:
        patches = [mock.patch.object(ServingEngine, "cuda_graphs", False),
                   mock.patch.object(mg, "gather_gmm",
                                     lambda *a, count=None, **k:
                                     mg.plain_gather_gmm(*a, **k)),
                   mock.patch.object(mg, "scatter_gmm",
                                     lambda *a, count=None, **k:
                                     mg.plain_scatter_gmm(*a, **k))]
        for p in patches:
            p.start()
        try:
            peng = engine()
            plain_streams, pl = lora_batch(torch, kernels, peng, prompts,
                                           LORA_F32_AIDS, f"{tag} plain", ())
            peng.shutdown()
        finally:
            for p in patches:
                p.stop()
        if any(pl[k] for k in LORA_KERNELS):
            fails.append(f"{tag} plain: K4 launched")
        held_streams(torch, model, f"{tag} K4 kernels vs plain", prompts,
                     batch, plain_streams, fails,
                     margin=lora_margin(torch, lora, eng))
    eng.shutdown()
    log(f"{tag}: {time.monotonic() - t0:.1f}s")
    return launches


def lora_bf16_phase(torch, kernels, lora, ServingEngine, ServingConfig,
                    model, prompts, lens, fails):
    """Phase 21 (b) on phase 3's model (Llama-3-8B, bf16, its seeded
    weights): adapters 1-4 (``attn`` targets, rank 16) over a resident
    window of two. Phase 3's traffic twice on a LoRA engine and on a
    LoRA-off one, in turns (A B B A): wave 1 under adapters (1, 2, base)
    in turn, wave 2 under (3, 4, base), so wave 2 swaps both rows
    (each wave seats as the LoRA-off engine does: no request waits for a
    row). Logs tokens/s, TTFT and ms a tick of each run; the LoRA engine's
    graphs must equal the LoRA-off engine's in number after each wave
    (churn captures none), its base riders' streams the LoRA-off
    engine's by the near-tie rule. Then a hot reload of resident
    adapter 3 changes its next request's tokens, replayed from the
    graphs captured; a profile of TICK_WINDOW ticks on both engines
    (K4's float32 bodies by name, then what else the LoRA tick spends,
    by kernel); distinct adapters decode distinct continuations of
    one prompt; and the ticks of a LoRA engine replayed from graphs
    equal the eager ticks bit for bit (:func:`graph_lockstep`), across a
    hot reload mid-run. Returns the LoRA runs' launches."""
    t0 = time.monotonic()
    ids7 = torch.from_numpy(motif_prompts(
        GENERATE["batch"], GENERATE["prompt"], GENERATE["motif"],
        model.config.vocab_size, SEED + 3)).to(model.device)
    noise = logit_noise(torch, model, ids7)
    del ids7
    base_kw = dict(num_slots=8, block_size=16, max_model_len=2048,
                   prefill_chunk=128, max_new_tokens=32)
    lkw = dict(lora_rank=LORA_RANK, max_adapters=2)
    weights = {aid: lora_weights(model, LORA_ATTN, aid) for aid in range(1, 5)}
    engines = {"lora": ServingEngine(model, ServingConfig(**base_kw, **lkw),
                                     device="cuda"),
               "base": ServingEngine(model, ServingConfig(**base_kw),
                                     device="cuda")}
    for aid, w in weights.items():
        engines["lora"].load_adapter(aid, w)
    waves = {1: [(1, 2, None)[k % 3] for k in range(len(prompts))],
             2: [(3, 4, None)[k % 3] for k in range(len(prompts))]}
    want = SERVING_KERNELS + LORA_KERNELS
    runs, launches, last = {}, {}, {}
    for name, wave in (("base", 1), ("lora", 1), ("lora", 2), ("base", 2)):
        eng = engines[name]
        eng.purge_published()       # every run prefills cold
        tag = f"phase 21 (b) {name} wave {wave}"
        got, st, streams = serve_run(
            torch, kernels, eng, prompts, lens, tag,
            want if name == "lora" else SERVING_KERNELS,
            adapter_ids=waves[wave] if name == "lora" else None)
        # this run's ticks and mean TTFT (the stats count the engine's life)
        prev = last.get(name, dict(ticks=0, ttft_ms=dict(count=0, mean=0.0)))
        n_ttft = st["ttft_ms"]["count"] - prev["ttft_ms"]["count"]
        st["run_ticks"] = st["ticks"] - prev["ticks"]
        st["run_ttft_ms"] = (st["ttft_ms"]["mean"] * st["ttft_ms"]["count"]
                             - prev["ttft_ms"]["mean"]
                             * prev["ttft_ms"]["count"]) / max(n_ttft, 1)
        last[name] = st
        runs[name, wave] = (st, streams)
        if name == "lora":
            for k in want:
                launches[k] = launches.get(k, 0) + got[k]
        log(f"{tag}: {st['run_ticks']} ticks, "
            f"{1e3 * st['wall_s'] / st['run_ticks']:.3f} ms a tick, TTFT "
            f"mean {st['run_ttft_ms']:.1f} ms; lora_adapter_swaps "
            f"{st['lora_adapter_swaps']}, resident "
            f"{st['lora_adapters_resident']}, host tier "
            f"{st['lora_host_tier_bytes']} B")
    for wave in (1, 2):
        (sb, base), (sl, lo) = runs["base", wave], runs["lora", wave]
        n_tok = sum(map(len, lo))
        log(f"phase 21 (b) wave {wave} ({card_line()}): LoRA "
            f"{n_tok / sl['wall_s']:.2f} against LoRA-off "
            f"{sum(map(len, base)) / sb['wall_s']:.2f} tok/s; TTFT mean "
            f"{sl['run_ttft_ms']:.1f} against {sb['run_ttft_ms']:.1f} ms; "
            f"{1e3 * sl['wall_s'] / sl['run_ticks']:.3f} against "
            f"{1e3 * sb['wall_s'] / sb['run_ticks']:.3f} ms a tick; graphs "
            f"{sl['executables_compiled']} against "
            f"{sb['executables_compiled']}")
        if sl["executables_compiled"] != sb["executables_compiled"]:
            fails.append(f"phase 21 (b) wave {wave}: LoRA engine "
                         f"{sl['executables_compiled']} graphs, LoRA-off "
                         f"{sb['executables_compiled']}")
        riders = [k for k, a in enumerate(waves[wave]) if a is None]
        held_streams(torch, model, f"phase 21 (b) wave {wave} base riders "
                     "vs LoRA-off", [prompts[k] for k in riders],
                     [lo[k] for k in riders], [base[k] for k in riders],
                     fails, limit=noise)
    st2 = runs["lora", 2][0]
    if st2["lora_adapter_swaps"] < 2:
        fails.append(f"phase 21 (b): {st2['lora_adapter_swaps']} swaps")
    eng = engines["lora"]
    n_graphs = st2["executables_compiled"]
    # a hot reload of resident adapter 3, then wave 2 again: every tick
    # replays a graph wave 2 captured; adapter 3's streams move, the
    # others stay to the bit (a row's work is its own)
    if not eng.adapter_resident(3):
        fails.append("phase 21 (b): adapter 3 not resident after wave 2")
    eng.load_adapter(3, lora_weights(model, LORA_ATTN, 33))
    eng.purge_published()
    got, st, again = serve_run(torch, kernels, eng, prompts, lens,
                               "phase 21 (b) lora wave 2 after a reload",
                               want, adapter_ids=waves[2])
    for k in want:
        launches[k] += got[k]
    before = runs["lora", 2][1]
    moved = [not np.array_equal(a, b) for a, b in zip(again, before)]
    three = [m for m, a in zip(moved, waves[2]) if a == 3]
    others = [m for m, a in zip(moved, waves[2]) if a != 3]
    log(f"phase 21 (b): adapter 3 hot-reloaded while resident: "
        f"{sum(three)} of its {len(three)} streams moved, {sum(others)} of "
        f"the {len(others)} others; graphs {st['executables_compiled']} "
        f"(before {n_graphs})")
    if not all(three) or any(others) \
            or st["executables_compiled"] != n_graphs:
        fails.append("phase 21 (b): hot reload")
    # where a LoRA tick's time goes: wave 2's first 8 requests, 4 ticks
    # in, TICK_WINDOW profiled ticks on the LoRA engine and on the LoRA-off
    # one (the same composition); K4's float32 bodies by name, then what
    # else the LoRA tick spends beyond the LoRA-off tick, by kernel
    prof = {}
    for name, adapters in (("lora", waves[2]), ("base", [None] * 8)):
        e = engines[name]
        e.purge_published()
        for p, a in zip(prompts[:8], adapters):
            e.submit(p, adapter_id=a)
        for _ in range(4):
            e.step()
        by_kernel = {}
        wall_ms, busy_ms, _ = profiled(torch, e.step, TICK_WINDOW, 8,
                                       by_kernel=by_kernel)
        e.run()
        prof[name] = (wall_ms, busy_ms, by_kernel)
    wall_ms, busy_ms, by_kernel = prof["lora"]
    k4 = {body: sum(v for k, v in by_kernel.items()
                    if "moe_gmm" in k and body in k) / TICK_WINDOW
          for body in ("split_k", "wide_scatter", "fma")}
    log(f"phase 21 (b) profile ({card_line()}): {TICK_WINDOW} LoRA ticks, "
        f"{wall_ms / TICK_WINDOW:.3f} ms a tick, device "
        f"{busy_ms / TICK_WINDOW:.3f} ms (K4's float32 bodies "
        f"{sum(k4.values()):.3f} ms: moe_gmm_split_k {k4['split_k']:.3f}, "
        f"moe_gmm_wide_scatter {k4['wide_scatter']:.3f}, moe_gmm_fma "
        f"{k4['fma']:.3f}) -> idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f}; LoRA-off "
        f"{prof['base'][0] / TICK_WINDOW:.3f} ms a tick, device "
        f"{prof['base'][1] / TICK_WINDOW:.3f} ms")
    base_k = prof["base"][2]
    extra = sorted(((v - base_k.get(k, 0.0)) / TICK_WINDOW, k)
                   for k, v in by_kernel.items())[::-1]
    log("phase 21 (b): device ms a tick beyond the LoRA-off tick, by "
        "kernel: " + "; ".join(f"{ms:.3f} {k[:96]}"
                               for ms, k in extra[:10] if ms > 0.001))
    # one prompt under each adapter and none, at once
    one = [eng.submit(prompts[1], adapter_id=a) for a in (1, 2, 3, 4, None)]
    done = eng.run()
    outs = [tuple(done[r].tolist()) for r in one]
    log(f"phase 21 (b): one prompt under adapters 1-4 and none: "
        f"{len(set(outs))} distinct continuations of 5 (delta scale "
        f"N(0, {LORA_SCALE}) at rank {LORA_RANK})")
    if len(set(outs)) != 5:
        fails.append("phase 21 (b): adapters decode the same continuation")
    for e in engines.values():
        e.shutdown()
    del engines, eng
    torch.cuda.empty_cache()
    # graphed == eager, a hot reload of adapter 1 mid-run included
    rng = np.random.RandomState(SEED + 21)
    lprompts = [rng.randint(0, model.config.vocab_size, size=LOCKSTEP_PROMPT)
                for _ in range(4)]

    def reload(e, tick):
        if tick == 9:
            e.load_adapter(1, weights[2])
    st = graph_lockstep(torch, kernels, ServingEngine, model,
                        ServingConfig(**LOCKSTEP, **lkw), lprompts, 16,
                        "phase 21 (b) lockstep",
                        adapters=(weights, (1, None, 2, 1)), on_tick=reload)
    log(f"phase 21 (b) lockstep: {st['ticks']} ticks, {st['pure_replays']} "
        f"pure and {st['mixed_replays']} mixed replays, adapter 1 reloaded "
        f"at tick 9: tokens, logits, launch counts and pools equal to the "
        f"eager engine's, bit for bit; phase (b) "
        f"{time.monotonic() - t0:.1f}s")
    return launches


def lora_phase(torch, kernels, mg, ServingEngine, ServingConfig, LlamaConfig,
               LlamaForCausalLM, GPTConfig, GPTForCausalLM, model, prompts,
               lens):
    """Phase 21, batched multi-LoRA serving: (b) on phase 3's loaded
    ``model`` (:func:`lora_bf16_phase`); (a) float32 at Llama-3-8B widths
    cut to PHASE4_LAYERS layers: ``attn`` and ``all`` targets at rank 16,
    rank 4 (stacks at 8), the kernels against K4's plain versions, and
    ``lora_quant``, each batched == solo (:func:`lora_f32_case`); (c) GPT
    (``GPTConfig()``'s widths at PHASE4_LAYERS layers, float32) with
    ``qkv_proj`` / ``out_proj`` adapters, batched == solo. Returns the
    launch counts of the LoRA paths' runs."""
    from paddle_tpu_torch.ops import lora
    t_phase = time.monotonic()
    fails = []
    launches = lora_bf16_phase(torch, kernels, lora, ServingEngine,
                               ServingConfig, model, prompts, lens, fails)
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = PHASE4_LAYERS
    f32 = LlamaForCausalLM(cfg, device="cuda", seed=SEED + 1)
    rng = np.random.RandomState(SEED + 2101)
    fprompts = [rng.randint(0, cfg.vocab_size, size=n) for n in LORA_F32_LENS]
    no_k3b = ("ragged_paged_attention", "norm_matmul")
    for tag, names, plain, want, kw in (
            ("attn", LORA_ATTN, True, SERVING_KERNELS, {}),
            ("all", LORA_ALL, False, no_k3b, dict(lora_targets="all")),
            ("rank 4", LORA_ATTN, False, SERVING_KERNELS, dict(lora_rank=4)),
            ("quant", LORA_ATTN, False, SERVING_KERNELS,
             dict(lora_quant=True))):
        got = lora_f32_case(torch, kernels, lora, mg, ServingEngine,
                            ServingConfig, f32, fprompts,
                            f"phase 21 (a) f32 {tag}", names, fails,
                            want + LORA_KERNELS, plain=plain, **kw)
        for k in LORA_KERNELS:
            launches[k] += got[k]
    del f32
    torch.cuda.empty_cache()
    gcfg = GPTConfig()
    gcfg.num_hidden_layers = PHASE4_LAYERS
    gpt = GPTForCausalLM(gcfg, device="cuda", seed=SEED + 18).eval()
    rng = np.random.RandomState(SEED + 2102)
    gprompts = [rng.randint(0, gcfg.vocab_size, size=n)
                for n in LORA_F32_LENS]
    got = lora_f32_case(torch, kernels, lora, mg, ServingEngine,
                        ServingConfig, gpt, gprompts, "phase 21 (c) GPT f32",
                        ("qkv_proj", "out_proj"), fails,
                        ("ragged_paged_attention", "norm_matmul",
                         "matmul_residual") + LORA_KERNELS)
    for k in LORA_KERNELS:
        launches[k] += got[k]
    del gpt
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 21 failed: {fails}")
    log(f"phase 21: {time.monotonic() - t_phase:.1f}s; LoRA launches "
        f"{launches}")
    return launches

# ---------------------------------------------------------------- phase 22

PHASE3 = dict(num_slots=8, block_size=16, max_model_len=2048,
              prefill_chunk=128, max_new_tokens=32)
TELEMETRY_PURE_TICKS = 16            # timed pure ticks a run
TELEMETRY_PROFILE_TICKS = 4
K3_SYMBOL = "decode_gemm"            # K3a / K3b bodies' kernel names
K2_SYMBOL = "paged_attention"        # K2r's


def telemetry_run(torch, kernels, ServingEngine, ServingConfig, model,
                  prompts, lens, tag, on):
    """One run of phase 22 (a): a fresh engine of phase 3's config with
    the telemetry on (the defaults: tracing and health) or off
    (``health=False`` and ``PADDLE_TPU_TRACE=0``) serves phase 3's wave
    (:func:`serve_run`), then a cold wave of 8 prompts is stepped past
    its prefills and TELEMETRY_PURE_TICKS pure ticks are timed on the
    host's clock. Returns ``(engine, launches, stats, streams, ms a pure
    tick)``; the engine stays up for (b) and (c)."""
    env = {} if on else {"PADDLE_TPU_TRACE": "0"}
    with mock.patch.dict(os.environ, env):
        engine = ServingEngine(model, ServingConfig(**PHASE3, health=on),
                               device="cuda")
    launches, st, streams = serve_run(torch, kernels, engine, prompts, lens,
                                      tag, SERVING_KERNELS)
    engine.purge_published()
    for p in prompts[:8]:
        engine.submit(p)
    while engine.num_queued or any(s is not None and s.pend_pos is not None
                                   for s in engine._slots):
        engine.step()
    p0 = engine.stats()["pure_ticks"]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(TELEMETRY_PURE_TICKS):
        engine.step()
    torch.cuda.synchronize()
    pure_ms = 1e3 * (time.monotonic() - t0) / TELEMETRY_PURE_TICKS
    if engine.stats()["pure_ticks"] - p0 < TELEMETRY_PURE_TICKS:
        raise AssertionError(f"{tag}: the timed ticks were not all pure")
    engine.run()
    return engine, launches, st, streams, pure_ms


def telemetry_numbers(torch, engine, n_params, fails):
    """Phase 22 (b): the roofline of each captured layout (its counted
    FLOPs and bytes over its measured tick time), the kernel census of
    each (graph nodes by type, kernel nodes, the hand-written kernels'
    launches a replay adds, K3a / K3b / K2r among them and among the
    graph's kernel symbols), and the registry's ``serving_*`` samples.
    A pure layout's counted bytes must lie within 2x of the weights'
    (a miscounted cost otherwise)."""
    from paddle_tpu_torch import monitor
    layers = engine.model.config.num_hidden_layers
    st = engine.stats()
    roof = st["roofline"]
    log(f"phase 22 (b) roofline: peaks {roof['peak_flops_per_s'] / 1e12} "
        f"TFLOP/s, {roof['peak_hbm_bytes_per_s'] / 1e12} TB/s (spec "
        f"sheet), ridge {roof['ridge_flops_per_byte']} FLOP/B, cpu_proxy "
        f"{roof['cpu_proxy']}; card {card_line()}")
    weights = 2 * n_params
    for name, r in sorted(roof["per_executable"].items()):
        log(f"  {name}: {r['flops'] / 1e9:.3f} GFLOP, "
            f"{r['bytes_accessed'] / 1e9:.4f} GB, intensity "
            f"{r['arithmetic_intensity']} ({r['bound']}), ticks "
            f"{r['ticks']}, tick {r['step_time_ms']} ms -> step_mfu "
            f"{r['mfu']}, step_hbm_bw_util {r['hbm_bw_util']}")
        if "-pure-" in name and not \
                0.5 * weights <= r["bytes_accessed"] <= 2 * weights:
            fails.append(f"{name}: counted {r['bytes_accessed']:.4g} bytes "
                         f"against {weights:.4g} of weights")
        if "-pure-" in name and r["ticks"] and not 0 < r["mfu"] < 1:
            fails.append(f"{name}: step_mfu {r['mfu']}")
    census = engine.kernel_census()
    want = {"norm_matmul": 2 * layers, "matmul_residual": 2 * layers,
            "ragged_paged_attention": layers}
    for name, c in sorted(census.items()):
        syms = c.get("kernel_names", {})
        k3 = sum(n for k, n in syms.items() if K3_SYMBOL in k)
        k2 = sum(n for k, n in syms.items() if K2_SYMBOL in k)
        top = sorted(syms.items(), key=lambda kv: -kv[1])[:6]
        log(f"  census {name}: graph nodes {c['graph_nodes']}, kernel "
            f"nodes {c['kernel_nodes']}, launch proxy {c['launch_proxy']}; "
            f"hand-written kernels a replay {c['kernels']}; kernel nodes "
            f"named {K3_SYMBOL}* {k3}, {K2_SYMBOL}* {k2}; top symbols "
            f"{[(k[:60], n) for k, n in top]}")
        got = {k: c["kernels"].get(k, 0) for k in want}
        if got != want:
            fails.append(f"census {name}: {got}, want {want}")
        if syms and not (k3 >= 4 * layers and k2 >= layers):
            fails.append(f"census {name}: kernel symbols {K3_SYMBOL} {k3}, "
                         f"{K2_SYMBOL} {k2}")
        if c["kernel_nodes"] != c["graph_nodes"].get("kernel"):
            fails.append(f"census {name}: kernel nodes disagree")
    rows = [r for r in monitor.get_registry().collect()
            if r["name"].startswith("serving_")
            and r["kind"] in ("counter", "histogram")]
    log("  registry (process-wide, every engine so far): " + "; ".join(
        f"{r['name']}{r['labels'] or ''}="
        f"{r['value']['count'] if r['kind'] == 'histogram' else r['value']}"
        for r in rows))
    return roof, census


def telemetry_files(torch, engine, prompts, fails):
    """Phase 22 (c): ``dump_trace`` writes a Chrome trace whose tids are
    the documented ones (0 the ticks, 1 + i slot i, the last the queue);
    ``profile(TELEMETRY_PROFILE_TICKS)`` over a cold wave's pure ticks
    writes a torch.profiler trace in which K3's and K2r's kernels appear
    by name, replayed from the graphs."""
    out = os.path.join(HERE, "build", "phase22")
    n_slots = engine.config.num_slots
    path = engine.dump_trace(os.path.join(out, "serve_trace.json"))
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    tids = {e["tid"] for e in evs if e["ph"] != "M"}
    names = {e["tid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    want = {0: "engine", n_slots + 1: "queue",
            **{1 + i: f"slot {i}" for i in range(n_slots)}}
    if names != want or not tids <= set(want):
        fails.append(f"trace tids {sorted(tids)}, names {names}")
    kinds = {}
    for e in evs:
        if e["ph"] == "M":
            continue
        key = e["name"]
        if key.startswith("req"):       # one span a request: by kind
            key = "req queued" if key.endswith(" queued") else "req"
        kinds[key] = kinds.get(key, 0) + 1
    log(f"phase 22 (c) trace: {path}, {os.path.getsize(path)} bytes, "
        f"{len(evs)} events, tids {sorted(tids)}; events by name "
        f"{dict(sorted(kinds.items()))}")
    engine.purge_published()
    for p in prompts[:8]:
        engine.submit(p)
    while engine.num_queued or any(s is not None and s.pend_pos is not None
                                   for s in engine._slots):
        engine.step()
    c0 = engine.stats()["profile_captures"]
    engine.profile(TELEMETRY_PROFILE_TICKS, os.path.join(out, "profile"))
    for _ in range(TELEMETRY_PROFILE_TICKS):
        engine.step()
    engine.run()
    st = engine.stats()
    prof = engine._prof.last_file
    if st["profile_captures"] != c0 + 1 or not prof \
            or not os.path.exists(prof):
        fails.append(f"profile: captures {st['profile_captures']}, file "
                     f"{prof}")
        return
    with open(prof) as f:
        pdoc = json.load(f)
    kern = {}
    for e in pdoc.get("traceEvents", []):
        if e.get("cat") == "kernel":
            kern[e["name"]] = kern.get(e["name"], 0) + 1
    k3 = sum(n for k, n in kern.items() if K3_SYMBOL in k)
    k2 = sum(n for k, n in kern.items() if K2_SYMBOL in k)
    layers = engine.model.config.num_hidden_layers
    log(f"phase 22 (c) profile: {prof}, {os.path.getsize(prof)} bytes, "
        f"{sum(kern.values())} kernel events over "
        f"{TELEMETRY_PROFILE_TICKS} ticks; {K3_SYMBOL}* {k3}, "
        f"{K2_SYMBOL}* {k2}")
    # the window's edges may clip a kernel or two: ask for all but one
    # tick's worth
    if k3 < 4 * layers * (TELEMETRY_PROFILE_TICKS - 1) \
            or k2 < layers * (TELEMETRY_PROFILE_TICKS - 1):
        fails.append(f"profile: K3 kernels {k3}, K2r kernels {k2}")


def telemetry_probe(torch, ServingEngine, ServingConfig, LlamaConfig,
                    LlamaForCausalLM, fails):
    """Phase 22 (d): a float32 engine at Llama-3-8B widths cut to
    PHASE4_LAYERS layers serves a wave clean, then with one LM-head
    column set to inf: the probe inside the captured ticks fires
    ``nonfinite_logits`` and counts ticks, and the poisoned engine
    captures as many graphs as the clean one."""
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = PHASE4_LAYERS
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED + 1)
    rng = np.random.RandomState(SEED + 2200)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (40, 150, 70)]
    kw = dict(num_slots=4, block_size=16, max_model_len=512,
              prefill_chunk=128, max_new_tokens=8)
    res = []
    for poisoned in (False, True):
        if poisoned:
            with torch.no_grad():
                model.lm_head.weight[:, 7] = float("inf")
        engine = ServingEngine(model, ServingConfig(**kw), device="cuda")
        engine.serve(prompts, 8)
        st = engine.stats()
        res.append((st["nonfinite_logits_ticks"], st["ticks"],
                    st["executables_compiled"],
                    engine.health()["alerts_firing"]))
        engine.shutdown(check_leaks=not poisoned)
        del engine
    log(f"phase 22 (d) probe, f32 {PHASE4_LAYERS} layers at Llama-3-8B "
        f"widths: clean (non-finite ticks, ticks, graphs, alerts) {res[0]}"
        f"; LM-head column 7 at inf {res[1]}")
    (n0, _, g0, a0), (n1, t1, g1, a1) = res
    if n0 or a0 or not n1 or "nonfinite_logits" not in a1 or g1 != g0:
        fails.append(f"probe: clean {res[0]}, poisoned {res[1]}")
    del model
    torch.cuda.empty_cache()


def telemetry_phase(torch, kernels, ServingEngine, ServingConfig,
                    LlamaConfig, LlamaForCausalLM, model, prompts, lens):
    """Phase 22, the monitor modules on the graphed tick (phase 3's model
    and traffic): (a) telemetry on against off, in turns A B B A, equal
    streams bit for bit and equal graphs in number, each run's tokens/s,
    TTFT, ms a pure tick and host gap; (b) the roofline and kernel census
    of the last telemetry-on run (:func:`telemetry_numbers`); (c) the
    trace and profile files (:func:`telemetry_files`); (d) the non-finite
    probe (:func:`telemetry_probe`). Returns the serving kernels'
    launches of (a)'s runs."""
    t_phase = time.monotonic()
    fails = []
    n_params = sum(p.numel() for p in model.parameters())
    launches = {k: 0 for k in SERVING_KERNELS}
    runs, want, keep = [], None, None
    for k, on in enumerate((True, False, False, True)):
        tag = f"phase 22 (a) run {k + 1} telemetry {'on' if on else 'off'}"
        engine, got, st, streams, pure_ms = telemetry_run(
            torch, kernels, ServingEngine, ServingConfig, model, prompts,
            lens, tag, on)
        for name in SERVING_KERNELS:
            launches[name] += got[name]
        gap = st["host_gap_ms"]
        runs.append(dict(on=on, tok_s=32 * len(prompts) / st["wall_s"],
                         ttft=st["ttft_ms"]["mean"], pure_ms=pure_ms,
                         gap_p50=gap["p50"], gap_mean=gap["mean"],
                         graphs=st["executables_compiled"]))
        log(f"{tag}: {runs[-1]}")
        if want is None:
            want = streams
        elif any(not np.array_equal(a, b) for a, b in zip(want, streams)):
            fails.append(f"{tag}: streams differ from run 1's")
        if k == 3:
            keep = engine
        else:
            engine.shutdown()
            del engine
            torch.cuda.empty_cache()
    if len({r["graphs"] for r in runs}) != 1:
        fails.append(f"graph counts differ: {[r['graphs'] for r in runs]}")
    on = [r for r in runs if r["on"]]
    off = [r for r in runs if not r["on"]]
    for key in ("tok_s", "ttft", "pure_ms", "gap_p50"):
        log(f"phase 22 (a) {key}: on {[round(r[key], 3) for r in on]} "
            f"off {[round(r[key], 3) for r in off]} (A B B A; card "
            f"{card_line()})")
    telemetry_numbers(torch, keep, n_params, fails)
    telemetry_files(torch, keep, prompts, fails)
    keep.shutdown()
    del keep
    torch.cuda.empty_cache()
    telemetry_probe(torch, ServingEngine, ServingConfig, LlamaConfig,
                    LlamaForCausalLM, fails)
    if fails:
        raise AssertionError(f"phase 22 failed: {fails}")
    log(f"phase 22: {time.monotonic() - t_phase:.1f}s; launches {launches}")
    return launches


# --------------------------------------------------------------- phase 23

PW_KERNELS = {"sync": ("paged_decode_attention", "paged_verify_attention",
                       "norm_matmul", "matmul_residual"),
              "interleaved": ("paged_decode_attention",
                              "paged_verify_attention", "norm_matmul",
                              "matmul_residual"),
              "bucketed": ("paged_decode_attention", "norm_matmul",
                           "matmul_residual"),
              "ngram": ("paged_verify_attention", "norm_matmul",
                        "matmul_residual")}


def tick_ms(st):
    """The engine's ms a decode tick: the launch-to-read-back EMA of its
    decode or verify step (per-width), or of the pure tick layout that
    ran most (ragged)."""
    per = st["roofline"]["per_executable"]
    if not st["ragged_batch"]:
        r = per.get("verify" if "spec_tokens_proposed" in st else "decode")
    else:
        pure = [v for k, v in per.items() if "-pure-" in k]
        r = max(pure, key=lambda v: v["ticks"]) if pure else None
    return None if r is None else r["step_time_ms"]


def per_width_phase(torch, kernels, df, rpa, pda, mg, ServingEngine,
                    ServingConfig, model, prompts, lens, card):
    """Phase 23: the per-width engine (``ragged_batch=False``) on phase
    3's model (Llama-3-8B, 32 layers, bf16, phase 3's seeded weights) and
    traffic, in PER_WIDTH's four configurations (synchronous chunks,
    interleaved chunks, bucketed prefill, n-gram speculation at gamma
    4), each served through the kernels (steps replayed from CUDA graphs;
    K3a / K3b around K2d / K2v must launch, K2v also at T =
    prefill_chunk) and through their plain versions (graphs off), the
    streams held by the near-tie rule (the logit difference of two bf16
    recipes) against each other and against the ragged engine (phase 3's
    config), which serves the same traffic before and after them in this
    call. Logs each run's tokens/s, TTFT, ms a decode tick and graphs
    captured with the card. Returns ``(launches by run, the chunk steps'
    K2v launches)``."""
    t_phase = time.monotonic()
    ids7 = torch.from_numpy(motif_prompts(
        GENERATE["batch"], GENERATE["prompt"], GENERATE["motif"],
        model.config.vocab_size, SEED + 3)).to(model.device)
    noise = logit_noise(torch, model, ids7)
    del ids7
    base = PW_BASE
    fails, runs, streams, chunk_k2v = [], {}, {}, 0

    def report(tag, st, out, graphs, ttft):
        ms = tick_ms(st)
        n_tok = sum(len(t) for t in out)
        log(f"{tag}: {n_tok / st['wall_s']:.2f} tok/s, TTFT ms {ttft}, "
            f"ms a decode tick {'n/a' if ms is None else f'{ms:.3f}'}, "
            f"{graphs}; decode steps {st['decode_steps']}, prefill "
            f"chunks {st['prefill_chunks']}, prefill compiles "
            f"{st['prefill_compiles']}; card {card}")

    def serve(name, kw, plain=False):
        """A first wave (its steps captured), and through the kernels a
        warm second wave of the same traffic on the same engine (the
        published prefixes purged: it prefills as the first did, from
        the graphs already captured); returns the first wave's launches
        and streams."""
        tag = f"phase 23 {name}{' plain' if plain else ''}"
        eng = ServingEngine(model, ServingConfig(**base, **kw),
                            device="cuda")
        want = () if plain else PW_KERNELS.get(name, SERVING_KERNELS)
        patches = plain_moe_patches(df, rpa, mg, pda) if plain else []
        launches, st, out = patched(patches, lambda: serve_run(
            torch, kernels, eng, prompts, lens, tag, want))
        n, t1 = st["executables_compiled"], st["ttft_ms"]
        report(tag, st, out, f"{n} steps built, eager (no graph)" if plain
               else f"{n} graphs captured",
               f"mean {t1['mean']:.1f} p50 {t1['p50']:.1f}")
        if not plain:
            eng.purge_published()
            _, st2, out2 = serve_run(torch, kernels, eng, prompts, lens,
                                     f"{tag} warm", want)
            new = st2["executables_compiled"] - n
            # the digest holds both waves: the warm wave's mean is the
            # difference of the sums
            t2 = st2["ttft_ms"]
            warm = (t2["mean"] * t2["count"] - t1["mean"] * t1["count"]) \
                / max(1, t2["count"] - t1["count"])
            report(f"{tag} warm", st2, out2,
                   f"{new} graphs captured (replays only)",
                   f"mean {warm:.1f}")
            if new:
                fails.append(f"{tag}: the warm wave captured {new} graphs")
            held_streams(torch, model, f"{tag} warm vs first wave",
                         prompts, out2, out, fails, limit=noise)
        eng.shutdown()
        del eng
        torch.cuda.empty_cache()
        return launches, out

    runs["ragged"], streams["ragged"] = serve("ragged", {})
    for name, kw in PER_WIDTH.items():
        runs[name], streams[name] = serve(name, kw)
        if "num_speculative_tokens" not in kw:
            chunk_k2v += runs[name]["paged_verify_attention"]
        held_streams(torch, model, f"phase 23 {name} vs ragged", prompts,
                     streams[name], streams["ragged"], fails, limit=noise)
    runs["ragged again"], streams["ragged again"] = serve("ragged", {})
    held_streams(torch, model, "phase 23 ragged vs ragged again", prompts,
                 streams["ragged"], streams["ragged again"], fails,
                 limit=noise)
    for name, kw in PER_WIDTH.items():
        _, plain = serve(name, kw, plain=True)
        held_streams(torch, model, f"phase 23 {name} kernels vs plain",
                     prompts, streams[name], plain, fails, limit=noise)
    if fails:
        raise AssertionError(f"phase 23 failed: {fails}")
    log(f"phase 23: {time.monotonic() - t_phase:.1f}s (near-tie limit "
        f"{noise:.3e}); the chunk steps' K2v launches {chunk_k2v}")
    return {k: v for k, v in runs.items() if k in PER_WIDTH}, chunk_k2v


# --------------------------------------------------------------- phase 24

def beam_phase(torch, kernels, model, LlamaConfig, LlamaForCausalLM, card):
    """Phase 24 on phase 3's model (Llama-3-8B widths, bf16): greedy
    dense ``generate()`` and one-beam ``beam_search`` give the same tokens;
    ``beam_search`` (BEAM["beams"] beams) and ``group_beam_search``
    (BEAM["groups"] groups, diversity BEAM["diversity"]) on BEAM["batch"]
    prompts x BEAM["prompt"] tokens, BEAM["new"] new, timed (ms a beam
    step, tokens/s); every beam score against the summed log-probabilities
    of one dense forward over its sequence, over the length penalty
    (BEAM_SCORE_RTOL), a group beam's at most that (its score carries the
    diversity penalty); then an ``export_generation`` ->
    ``load_generation`` round trip of a BEAM["export_layers"]-layer cut at
    full widths. The dense path launches no hand-written kernel (its
    cached attention is the reference's plain recipe)."""
    import shutil
    b, new, alpha = BEAM["batch"], BEAM["new"], BEAM["length_penalty"]
    cfg = model.config
    ids = torch.from_numpy(motif_prompts(b, BEAM["prompt"], 64,
                                         cfg.vocab_size, SEED + 24)).cuda()
    runs, fails = {}, []
    for name, kw in (
            ("greedy", {}),
            ("beam1", dict(decode_strategy="beam_search", num_beams=1)),
            ("beam", dict(decode_strategy="beam_search",
                          num_beams=BEAM["beams"], length_penalty=alpha)),
            ("group", dict(decode_strategy="group_beam_search",
                           num_beams=BEAM["beams"],
                           num_beam_groups=BEAM["groups"],
                           diversity_rate=BEAM["diversity"],
                           length_penalty=alpha))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out, score = model.generate(ids, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        runs[name] = (out, score)
        rows = b * kw.get("num_beams", 1)
        log(f"phase 24 {name}: {b} prompts x {BEAM['prompt']} tokens, "
            f"{new} new, {rows} decode rows: {dt:.3f}s -> "
            f"{1e3 * dt / new:.3f} ms a step (prefill included), "
            f"{b * new / dt:.2f} tokens/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {sum(kernels.launch_counts.values())}; card {card}")
        if not bool(torch.isfinite(score).all()) or tuple(out.shape) != (
                b, new) or int(out.min()) < 0 \
                or int(out.max()) >= cfg.vocab_size:
            fails.append(f"phase 24 {name}: bad output")
    if not torch.equal(runs["beam1"][0], runs["greedy"][0]):
        fails.append("phase 24: one-beam search != greedy search")
    # each hypothesis again, by one dense forward over prompt + tokens
    lp = float(new) ** alpha
    for name in ("beam", "group"):
        out, score = runs[name]
        with torch.no_grad():
            logits = model(torch.cat([ids, out], 1))
        logp = torch.log_softmax(logits[:, BEAM["prompt"] - 1:-1].float(),
                                 -1)
        want = torch.gather(logp, -1, out[..., None])[..., 0].sum(1) / lp
        err = ((score - want).abs() / want.abs()).tolist()
        log(f"phase 24 {name}: scores {[round(x, 4) for x in score.tolist()]}"
            f", dense forward over the length penalty "
            f"{[round(x, 4) for x in want.tolist()]}, relative "
            f"{[f'{e:.2e}' for e in err]} (rtol {BEAM_SCORE_RTOL})")
        if name == "beam" and not max(err) <= BEAM_SCORE_RTOL:
            fails.append(f"phase 24 {name}: scores off the dense forward")
        if name == "group" and not bool(
                (score <= want + BEAM_SCORE_RTOL * want.abs()).all()):
            fails.append("phase 24 group: a score above its log-probability")
    # the exported artifact of a cut at full widths
    cut = LlamaConfig.llama3_8b()
    cut.dtype = "bfloat16"
    cut.num_hidden_layers = BEAM["export_layers"]
    small = LlamaForCausalLM(cut, device="cuda", seed=SEED + 24).eval()
    from paddle_tpu_torch.generation import (GenerationConfig,
                                             load_generation)
    gcfg = GenerationConfig(decode_strategy="beam_search",
                            num_beams=BEAM["beams"], length_penalty=alpha,
                            max_new_tokens=new)
    where = os.path.join(HERE, "build", "phase24")
    os.makedirs(where, exist_ok=True)
    t0 = time.monotonic()
    path = small.export_generation(os.path.join(where, "beam"), b,
                                   BEAM["prompt"], new, gcfg)
    t1 = time.monotonic()
    gen = load_generation(path)
    t2 = time.monotonic()
    got = gen(ids.cpu().numpy())
    want, _ = small.generate(ids, generation_config=gcfg,
                             pad_prompt_to_bucket=False)
    size = sum(os.path.getsize(os.path.join(where, f))
               for f in os.listdir(where))
    log(f"phase 24 export: {cut.num_hidden_layers} layers, {size / 2**30:.2f}"
        f" GiB written in {t1 - t0:.1f}s, loaded in {t2 - t1:.1f}s; tokens "
        f"{'equal' if np.array_equal(got, want.cpu().numpy()) else 'DIFFER'}"
        f" to generate()'s")
    if not np.array_equal(got, want.cpu().numpy()):
        fails.append("phase 24: the loaded artifact's tokens differ")
    del gen, small
    shutil.rmtree(where, ignore_errors=True)
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 24 failed: {fails}")


# --------------------------------------------------------------- phase 25

def grads_of(torch, model, ids, labels):
    """``(loss, {name: gradient})`` of one ``loss.backward()``."""
    model.zero_grad(set_to_none=True)
    loss = model(ids, labels=labels)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def held_recompute(torch, kernels, model, ids, labels, tag, fails):
    """The loss and every gradient of ``model`` with ``recompute`` on
    against off: bitwise where the kernels are deterministic, else within
    GRAD_RTOL of each tensor's largest value. Returns each run's launch
    counts."""
    out, peaks = {}, {}
    for on in (False, True):
        model.config.recompute = on
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out[on] = grads_of(torch, model, ids, labels) + (
            dict(kernels.launch_counts),)
        # the forward and backward's own peak, the weights not counted
        peaks[on] = torch.cuda.max_memory_allocated() - base
    model.config.recompute = False
    (l0, g0, k0), (l1, g1, k1) = out[False], out[True]
    bitwise = l0 == l1 and all(torch.equal(g0[n], g1[n]) for n in g0)
    worst = max(g0, key=lambda n: float((g0[n].float() - g1[n].float())
                                        .abs().max()) / max(float(
                                            g0[n].float().abs().max()),
                                            1e-30))
    rel = float((g0[worst].float() - g1[worst].float()).abs().max()) \
        / max(float(g0[worst].float().abs().max()), 1e-30)
    log(f"{tag}: loss {l0:.6f} off / {l1:.6f} on; gradients "
        f"{'bitwise equal' if bitwise else 'differ'} (worst {worst}: "
        f"{rel:.2e} of its largest, tol {GRAD_RTOL}); forward + backward "
        f"peak above the weights {peaks[False] / 2**30:.2f} GiB off, "
        f"{peaks[True] / 2**30:.2f} GiB on; launches off "
        f"{ {k: v for k, v in k0.items() if v} } on "
        f"{ {k: v for k, v in k1.items() if v} }")
    if not (bitwise or (abs(l0 - l1) <= LOSS_RTOL * abs(l0)
                        and rel <= GRAD_RTOL)):
        fails.append(f"{tag}: recomputed gradients differ")
    return k0, k1


def recompute_train(torch, kernels, model, opt, pool, tag, card):
    """RECOMPUTE["warm"] + RECOMPUTE["timed"] ``TrainStep`` steps; logs
    ms/step, tokens/s, MFU (6N + 12 L s h) and peak memory. Returns
    ``(ms a step, peak bytes, launch counts)``; the step and its
    optimizer state go with it."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch import monitor
    cfg = model.config
    step = TrainStep(model, lambda out, a, k: out, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses = [float(step(*pool[i % len(pool)]))
              for i in range(RECOMPUTE["warm"])]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    timed = [step(*pool[i % len(pool)]) for i in range(RECOMPUTE["timed"])]
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    losses += [float(x) for x in timed]
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.launch_counts)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = RECOMPUTE["batch"] * RECOMPUTE["seq"]
    f_tok = 6 * n_params + 12 * cfg.num_hidden_layers * RECOMPUTE["seq"] \
        * cfg.hidden_size
    ms = 1e3 * dt / RECOMPUTE["timed"]
    tok_s = tokens / (ms / 1e3)
    counted = monitor.step_report(step.telemetry_name)["flops"]
    log(f"{tag}: {cfg.num_hidden_layers} layers, {n_params / 1e9:.3f}B "
        f"params, recompute {cfg.recompute} interval "
        f"{cfg.recompute_interval}: {ms:.3f} ms/step, {tok_s:.1f} tokens/s, "
        f"MFU {tok_s * f_tok / PEAK_FLOPS['bfloat16']:.4f} (6N + 12 L s h), "
        f"counted {counted / tokens / 1e9:.3f} GFLOP/token (analytic "
        f"{f_tok / 1e9:.3f}); peak memory {peak / 2**30:.2f} GiB; losses "
        f"{[round(x, 5) for x in losses]}; card {card}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    return ms, peak, launches


def recompute_phase(torch, kernels, LlamaConfig, LlamaForCausalLM,
                    DeepseekMoeForCausalLM, deepseek_moe_16b, AdamW, card):
    """Phase 25: activation recompute at Llama-3-8B widths on phase 5's
    batch (RECOMPUTE): 4 layers' loss and gradients on against off; then
    ``TrainStep`` + AdamW(multi_precision) with recompute off, on and at
    interval 2 (ms/step, MFU, peak memory; K1f launching once a layer a
    step more for each recomputed layer); then the most layers that fit
    under recompute, reckoned from the 4-layer run's peak and 12 bytes a
    parameter of a layer; then a DeepSeek-MoE-16B-width layer pair's
    loss and gradients on against off (K4's forward modes twice).
    Returns the launch counts of every run, summed."""
    import gc
    total, fails = {}, []

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    bsz, seq = RECOMPUTE["batch"], RECOMPUTE["seq"]
    rng = np.random.RandomState(SEED + 25)
    pool = []
    for _ in range(2):
        a = rng.randint(0, 128256, (bsz, seq)).astype(np.int64)
        pool.append(tuple(torch.from_numpy(x).cuda()
                          for x in (a, np.roll(a, -1, axis=1))))

    def llama(layers, **kw):
        cfg = LlamaConfig.llama3_8b()
        cfg.dtype = "bfloat16"
        cfg.num_hidden_layers = layers
        for k, v in kw.items():
            setattr(cfg, k, v)
        m = LlamaForCausalLM(cfg, device="cuda", seed=SEED + 25)
        return m.train()

    n4 = RECOMPUTE["layers"]
    model = llama(n4)
    k0, k1 = held_recompute(torch, kernels, model, *pool[0],
                            f"phase 25 Llama-3-8B widths, {n4} layers", fails)
    add(k0)
    add(k1)
    if k1["flash_attention_fwd"] != 2 * n4 or k1["flash_attention_dq"] != n4:
        fails.append(f"phase 25: K1 launched {k1} under recompute, want the "
                     f"forward {2 * n4} times, dq {n4}")
    runs = {}
    for name, kw in (("off", dict(recompute=False)),
                     ("on", dict(recompute=True)),
                     ("interval2", dict(recompute=True,
                                        recompute_interval=2))):
        for k, v in kw.items():
            setattr(model.config, k, v)
        opt = AdamW(1e-4, parameters=model.parameters(),
                    multi_precision=True)
        runs[name] = recompute_train(torch, kernels, model, opt, pool,
                                     f"phase 25 {name}", card)
        add(runs[name][2])
        steps = RECOMPUTE["warm"] + RECOMPUTE["timed"]
        n_rec = 0 if not model.config.recompute else \
            len(range(0, n4, model.config.recompute_interval))
        want = steps * (n4 + n_rec)
        if runs[name][2]["flash_attention_fwd"] != want:
            fails.append(f"phase 25 {name}: K1f launched "
                         f"{runs[name][2]['flash_attention_fwd']}, want "
                         f"{want}")
        del opt
        torch.cuda.empty_cache()
    model.config.recompute, model.config.recompute_interval = False, 1
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # the most layers: the 4-layer peak plus 12 bytes a parameter of each
    # further layer (bf16 weight and gradient, float32 moments; TrainStep
    # keeps no master copy) and its saved input, within mem_share of the card
    c = LlamaConfig.llama3_8b()
    h = c.hidden_size
    per_layer = h * (2 * h + 2 * c.num_key_value_heads * c.head_dim) \
        + 3 * h * c.intermediate_size + 2 * h
    total_mem = torch.cuda.get_device_properties(0).total_memory
    per_bytes = 12 * per_layer + bsz * seq * 4096 * 2
    peak_on = runs["on"][1]
    most = n4 + int((RECOMPUTE["mem_share"] * total_mem - peak_on)
                    // per_bytes)
    log(f"phase 25: a layer {per_layer / 1e6:.1f}M params, "
        f"{per_bytes / 2**30:.2f} GiB with its state; 4-layer peak "
        f"{peak_on / 2**30:.2f} GiB under recompute -> {most} layers within "
        f"{RECOMPUTE['mem_share']} of {total_mem / 2**30:.1f} GiB")
    model = llama(most, recompute=True)
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)
    ms_most, peak_most, k_most = recompute_train(
        torch, kernels, model, opt, pool, f"phase 25 most ({most} layers)",
        card)
    add(k_most)
    log(f"phase 25: recompute off / on / interval 2 at {n4} layers: "
        f"{runs['off'][0]:.3f} / {runs['on'][0]:.3f} / "
        f"{runs['interval2'][0]:.3f} ms/step, peak "
        f"{runs['off'][1] / 2**30:.2f} / {runs['on'][1] / 2**30:.2f} / "
        f"{runs['interval2'][1] / 2**30:.2f} GiB; {most} layers under "
        f"recompute {ms_most:.3f} ms/step, peak {peak_most / 2**30:.2f} GiB;"
        f" card {card}")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    # a DeepSeek-MoE-16B-width layer pair: a dense layer, a sparse one
    cfg = deepseek_moe_16b(num_hidden_layers=RECOMPUTE["moe_layers"],
                           dropless=True)
    moe_model = DeepseekMoeForCausalLM(cfg, device="cuda",
                                       seed=SEED + 25).train()
    ids = torch.randint(0, cfg.vocab_size, (bsz, seq), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(25))
    k0, k1 = held_recompute(torch, kernels, moe_model, ids,
                            torch.roll(ids, -1, 1),
                            "phase 25 DeepSeek-MoE-16B widths, "
                            f"{RECOMPUTE['moe_layers']} layers", fails)
    add(k0)
    add(k1)
    for k in MOE_KERNELS:
        if k1[k] != 2 * k0[k] or not k0[k]:
            fails.append(f"phase 25 MoE: {k} launched {k1[k]} under "
                         f"recompute against {k0[k]} without")
    del moe_model
    gc.collect()
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 25 failed: {fails}")
    return total


# --------------------------------------------------------------- phase 26

def optimizer_phase(torch, kernels, GPTConfig, GPTForCausalLM, card):
    """Phase 26: GPT at ``GPTConfig()``'s widths (24 layers, bf16, phase
    18's model) trains OPT_BATCH["steps"] ``TrainStep`` steps on one
    batch with each optimizer of OPTIMIZERS, from the same weights and
    dropout draws: the loss finite and the last under the first;
    AdamW's ``state_dict`` -> ``set_state_dict`` round trip into a fresh
    optimizer after two steps continues the trajectory bit for bit; the
    first step's ``step_report`` FLOPs a token against bench.py's
    6N + 12 L s h (OPT_FLOPS_FACTOR) and ``analytic_mfu`` of timed AdamW
    steps. Returns the launch counts of every run, summed."""
    import paddle_tpu_torch
    from paddle_tpu_torch import monitor, optimizer
    from paddle_tpu_torch.jit import TrainStep
    cfg = GPTConfig()
    bsz, seq = OPT_BATCH["batch"], OPT_BATCH["seq"]
    model = GPTForCausalLM(cfg, device="cuda", seed=SEED + 26).to(
        torch.bfloat16).train()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(SEED + 26)
    a = rng.randint(0, cfg.vocab_size, (bsz, seq)).astype(np.int64)
    batch = tuple(torch.from_numpy(x).cuda()
                  for x in (a, np.roll(a, -1, axis=1)))
    total, fails = {}, []

    def run(name, lr, steps, resume_at=None):
        # the same weights and the same dropout draws (hidden dropout 0.1
        # is live in train()) for every run
        model.load_state_dict(init)
        paddle_tpu_torch.seed(SEED + 26)
        opt = getattr(optimizer, name)(lr, parameters=model.parameters())
        step = TrainStep(model, lambda out, a_, k: out, opt)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        losses = []
        for i in range(steps):
            if i == resume_at:
                saved = opt.state_dict()
                opt = getattr(optimizer, name)(
                    lr, parameters=model.parameters())
                opt.set_state_dict(saved)
                step = TrainStep(model, lambda out, a_, k: out, opt)
            losses.append(float(step(*batch)))
        for k, v in kernels.launch_counts.items():
            total[k] = total.get(k, 0) + v
        return losses, step

    t0 = time.monotonic()
    for name, lr in OPTIMIZERS.items():
        losses, _ = run(name, lr, OPT_BATCH["steps"])
        log(f"phase 26 {name} (lr {lr}): losses "
            f"{[round(x, 5) for x in losses]}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fails.append(f"phase 26 {name}: losses {losses}")
    log(f"phase 26: {len(OPTIMIZERS)} optimizers x {OPT_BATCH['steps']} "
        f"steps in {time.monotonic() - t0:.1f}s; card {card}")
    whole, _ = run("AdamW", OPTIMIZERS["AdamW"], OPT_BATCH["steps"])
    after = {k: v.clone() for k, v in model.state_dict().items()}
    resumed, _ = run("AdamW", OPTIMIZERS["AdamW"], OPT_BATCH["steps"],
                     resume_at=2)
    same = whole == resumed and all(
        torch.equal(v, after[k]) for k, v in model.state_dict().items())
    log(f"phase 26: AdamW state_dict round trip after 2 steps: losses "
        f"{resumed} against {whole}, parameters "
        f"{'bitwise equal' if same else 'DIFFER'}")
    if not same:
        fails.append("phase 26: the state_dict round trip left the "
                     "trajectory")
    # the step's counted work against the analytic count, and its MFU
    model.load_state_dict(init)
    paddle_tpu_torch.seed(SEED + 26)
    opt = optimizer.AdamW(OPTIMIZERS["AdamW"], parameters=model.parameters())
    step = TrainStep(model, lambda out, a_, k: out, opt)
    kernels.reset_launch_counts()
    step(*batch)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(OPT_BATCH["timed"]):
        step(*batch)
    torch.cuda.synchronize()
    dt = (time.monotonic() - t0) / OPT_BATCH["timed"]
    for k, v in kernels.launch_counts.items():
        total[k] = total.get(k, 0) + v
    rep = monitor.step_report(step.telemetry_name)
    tokens = bsz * seq
    f_tok = 6 * n_params + 12 * cfg.num_hidden_layers * seq \
        * cfg.hidden_size
    ratio = rep["flops"] / tokens / f_tok
    mfu = monitor.analytic_mfu(step.telemetry_name, dt)
    log(f"phase 26: step_report {step.telemetry_name}: "
        f"{rep['flops'] / 1e12:.4f} TFLOP counted, "
        f"{rep['flops'] / tokens / 1e9:.4f} GFLOP/token against bench.py's "
        f"6N + 12 L s h = {f_tok / 1e9:.4f} (ratio {ratio:.4f}, bounds "
        f"{OPT_FLOPS_FACTOR}); bytes {rep['bytes_accessed'] / 1e9:.2f} GB; "
        f"peak {rep['memory'].get('peak_hbm_bytes', 0) / 2**30:.2f} GiB; "
        f"{1e3 * dt:.3f} ms/step -> analytic_mfu {mfu:.4f}; card {card}")
    if not OPT_FLOPS_FACTOR[0] <= ratio <= OPT_FLOPS_FACTOR[1]:
        fails.append(f"phase 26: counted FLOPs {ratio:.3f} x the analytic")
    del model, step, opt
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 26 failed: {fails}")
    return total


# --------------------------------------------------------------- phase 2

def check_flash_cross(torch, fa, dtype):
    """K1f, K1dq and K1dkv, non-causal, with fewer query rows than keys
    (BERT_CROSS: one row against a cache of 37 and of 200 keys, as
    ``MultiHeadAttention``'s cached decoding reads them, and 7 rows of
    cross-attention), 12 / 12 heads of 64, each against its plain
    version."""
    g = torch.Generator(device="cuda").manual_seed(27)
    dt = getattr(torch, dtype)
    fails = []
    for lq, lk in BERT_CROSS:
        rnd = lambda *sh: torch.randn(*sh, generator=g,  # noqa: E731
                                      device="cuda").to(dt)
        q, do = rnd(2, lq, 12, 64), rnd(2, lq, 12, 64)
        k, v = rnd(2, lk, 12, 64), rnd(2, lk, 12, 64)
        tag = f"K1 Lq {lq} Lk {lk}"
        o, lse = fa.flash_attention_fwd(q, k, v, 0.125, False)
        o_p, lse_p = fa.plain_flash_attention_fwd(q, k, v, 0.125, False)
        held_attention(torch, o, o_p, dtype, f"{tag} fwd o", fails)
        held_attention(torch, lse, lse_p, dtype, f"{tag} fwd lse", fails)
        delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, do, lse_p, delta, 0.125, False)
        held_attention(torch, fa.flash_attention_dq(*args),
                       fa.plain_flash_attention_dq(*args), dtype,
                       f"{tag} dq", fails)
        for n, a, b in zip(("dk", "dv"), fa.flash_attention_dkv(*args),
                           fa.plain_flash_attention_dkv(*args)):
            held_attention(torch, a, b, dtype, f"{tag} dkv {n}", fails)
    if fails:
        raise AssertionError(f"[{dtype}] K1 with Lq < Lk disagrees with its "
                             f"plain version: {fails}")


# ---------------------------------------------------------- phases 27, 28

def bert_optimizer(model, lr_peak, warmup, total):
    """The example's recipe (``examples/bert_pretrain_finetune.py``):
    AdamW, weight decay 0.01 off biases and norms by
    ``apply_decay_param_fun`` (a parameter's Paddle name is its
    structured name here), ``LambdaDecay`` warmup then linear decay, and
    ``ClipGradByGlobalNorm(1.0)``."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    for n, p in model.named_parameters():
        p.param_name = n
    decay = {n for n, _ in model.named_parameters()
             if not any(k in n for k in ("bias", "norm"))}
    sched = lr.LambdaDecay(
        learning_rate=lr_peak,
        lr_lambda=lambda s: min((s + 1) / max(warmup, 1), max(
            0.0, (total - s) / max(total - warmup, 1))))
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                weight_decay=0.01, apply_decay_param_fun=lambda n: n in decay,
                grad_clip=ClipGradByGlobalNorm(1.0), epsilon=1e-8)
    return opt, sched


def bert_mlm_batches(torch, cfg, seed):
    """BERT_PRETRAIN["pool"] batches of B x L ids from a seeded pool of
    tokens (4 .. vocab): each position masked with probability 0.15 (its
    label the token, -100 elsewhere; 80 % [MASK], 10 % a random token, 10
    % kept), token types 0 then 1 at the middle, random NSP labels."""
    P = BERT_PRETRAIN
    rng = np.random.RandomState(seed)
    bsz, seq = P["batch"], P["seq"]
    out = []
    for _ in range(P["pool"]):
        ids = rng.randint(4, cfg.vocab_size, (bsz, seq))
        masked = rng.rand(bsz, seq) < P["mlm"]
        labels = np.where(masked, ids, -100)
        roll = rng.rand(bsz, seq)
        ids = np.where(masked & (roll < 0.8), BERT_MASK_ID, ids)
        ids = np.where(masked & (roll >= 0.8) & (roll < 0.9),
                       rng.randint(4, cfg.vocab_size, (bsz, seq)), ids)
        types = (np.arange(seq)[None, :] >= seq // 2).repeat(bsz, 0)
        nsp = rng.randint(0, 2, bsz)
        out.append(tuple(torch.from_numpy(a.astype(np.int64)).cuda()
                         for a in (ids, types, labels, nsp)))
    return out


def bert_flops_per_token(n_params, cfg, seq):
    """bench.py:141's training FLOPs a token: 6 N + 12 layers L hidden."""
    return 6 * n_params + 12 * cfg.num_hidden_layers * seq * cfg.hidden_size


def bert_pretrain_phase(torch, kernels, card):
    """Phase 27: BERT-base MLM + NSP pretraining (``BertForPretraining(
    BertConfig())``: vocab 30522, 12 layers, hidden 768, 12 heads of 64,
    ffn 3072; float32 parameters; nothing cut) on BERT_PRETRAIN's B 32 x L
    512 batches with no attention mask, so every layer's attention is K1
    non-causal at D 64: first under ``amp.auto_cast(level="O1",
    dtype="bfloat16")`` with a ``GradScaler`` and the example's optimizer
    (2 untimed steps, 5 timed, 2 profiled), then from the same seed under
    ``amp.decorate(level="O2")`` (bf16 parameters, float32 master
    weights; 2 untimed, 5 timed). Prints ms a step, tokens/s, MFU by
    bench.py's formula, peak memory and every loss (finite). K1f, K1dq
    and K1dkv must launch 12 times a step. Returns the launch counts."""
    import paddle_tpu_torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    P = BERT_PRETRAIN
    cfg = BertConfig()
    pool = bert_mlm_batches(torch, cfg, SEED + 27)
    tokens = P["batch"] * P["seq"]
    total, fails, ms = {}, [], {}
    for level in ("O1", "O2"):
        paddle_tpu_torch.seed(SEED + 27)
        t0 = time.monotonic()
        model = BertForPretraining(cfg, device="cuda", seed=SEED + 27)
        model.train()
        n_params = sum(p.numel() for p in model.parameters())
        steps = P["warm"] + P["timed"] + (P["profiled"] + 1) * (
            level == "O1")
        opt, sched = bert_optimizer(model, P["lr"], P["warmup"], steps)
        if level == "O2":
            model, opt = amp.decorate(model, opt, level="O2",
                                      dtype="bfloat16")
        scaler = amp.GradScaler()
        it = 0

        def one_step():
            nonlocal it
            ids, types, labels, nsp = pool[it % len(pool)]
            it += 1
            with amp.auto_cast(level=level, dtype="bfloat16"):
                loss = model(ids, token_type_ids=types, labels=labels,
                             next_sentence_label=nsp)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad(set_to_zero=False)
            sched.step()
            return loss

        torch.cuda.synchronize()
        log(f"phase 27 {level}: BERT-base, {cfg.num_hidden_layers} layers, "
            f"{n_params / 1e6:.2f}M params "
            f"{'float32' if level == 'O1' else 'bfloat16 (+ f32 masters)'}, "
            f"batch {P['batch']} x {P['seq']}, init "
            f"{time.monotonic() - t0:.1f}s")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses = [float(one_step().detach()) for _ in range(P["warm"])]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        timed = [one_step().detach() for _ in range(P["timed"])]
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        losses += [float(x) for x in timed]
        if level == "O1":
            wall_ms, busy_ms, reads = profiled(torch, one_step,
                                               P["profiled"], 15)
            log(f"phase 27 O1 profile: {P['profiled']} steps, wall "
                f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms -> idle "
                f"share {max(0.0, 1 - busy_ms / wall_ms):.4f}; scalar reads "
                f"{reads}")
        torch.cuda.synchronize()
        launches = {k: kernels.launch_counts[k] for k in TRAINING_KERNELS}
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        tok_s = tokens * P["timed"] / dt
        ms[level] = 1e3 * dt / P["timed"]
        f_tok = bert_flops_per_token(n_params, cfg, P["seq"])
        log(f"phase 27 {level}: {P['timed']} timed steps -> "
            f"{ms[level]:.3f} ms/step, {tok_s:.1f} tokens/s, MFU "
            f"{tok_s * f_tok / PEAK_FLOPS['bfloat16']:.4f} (6N + 12 L s h = "
            f"{f_tok / 1e9:.4f} GFLOP/token over "
            f"{PEAK_FLOPS['bfloat16'] / 1e12:.1f} TFLOP/s); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss "
            f"scale {scaler.get_init_loss_scaling()}; master weights "
            f"{len(opt._master_weights)}; card {card}")
        log(f"phase 27 {level}: losses {[round(x, 5) for x in losses]}; "
            f"launches {launches} over {it} steps")
        if not all(np.isfinite(losses)):
            fails.append(f"phase 27 {level}: losses {losses}")
        want = cfg.num_hidden_layers * it
        wrong = {k: n for k, n in launches.items() if n != want}
        if wrong:
            fails.append(f"phase 27 {level}: K1 launched {wrong}, want "
                         f"{want} each (layers x steps)")
        if level == "O2" and not (
                all(p.dtype == torch.bfloat16 for p in model.parameters())
                and len(opt._master_weights) == len(
                    list(model.parameters()))):
            fails.append("phase 27 O2: parameters not bf16 with f32 masters")
        del model, opt, scaler
        torch.cuda.empty_cache()
    log(f"phase 27: ms/step O1 {ms['O1']:.3f}, O2 {ms['O2']:.3f}; "
        f"card {card}")
    if fails:
        raise AssertionError(f"phase 27 failed: {fails}")
    return total


def sst2_batches(torch, cfg, seed):
    """BERT_SST2["pool"] batches of B x 128 padded sentences, lengths a
    seeded draw of 8 .. 66 tokens ([CLS] ... [SEP], then 0s), a
    learnable label (the token after [CLS] is 4 + label, as the
    example's synthetic GLUE), and each batch's bool keep mask [B, 1, 1,
    L]."""
    S = BERT_SST2
    rng = np.random.RandomState(seed)
    bsz, seq = S["batch"], S["seq"]
    out = []
    for _ in range(S["pool"]):
        lens = rng.randint(S["lens"][0], S["lens"][1] + 1, bsz)
        ids = rng.randint(6, cfg.vocab_size, (bsz, seq))
        labels = rng.randint(0, 2, bsz)
        ids[:, 0] = BERT_CLS_ID
        ids[:, 1] = 4 + labels
        pos = np.arange(seq)[None, :]
        ids = np.where(pos == lens[:, None] - 1, BERT_SEP_ID, ids)
        ids = np.where(pos >= lens[:, None], 0, ids)
        keep = (pos < lens[:, None])[:, None, None, :]
        out.append(dict(ids=torch.from_numpy(ids).cuda(),
                        labels=torch.from_numpy(labels).cuda(),
                        keep=torch.from_numpy(keep).cuda(), lens=lens))
    return out


def bert_sst2_phase(torch, kernels, fa, card):
    """Phase 28: BERT-base SST-2-shaped classification
    (``BertForSequenceClassification(BertConfig(), num_classes=2)``,
    float32, nothing cut) at B 32 x L 128, sentences of 8-66 tokens
    padded. Inference in ``eval()``: the padded batch with its bool keep
    mask (the plain biased attention, as the reference's XLA path; K1
    must not launch) and the same batch with no mask (K1 non-causal at L
    128), sentences/s of each; a fine-tune of 20 O1 steps (GradScaler,
    the example's optimizer) on the learnable task, unmasked as the
    example's, whose last loss must be under its first; then one float32
    forward + backward of a 2-layer BERT-base-width pretraining model at
    BERT_GRAD's B 4 x L 512 through the kernels and through their plain
    versions, the loss and every gradient within phase 6's tolerances (a
    k bias's, zero but for rounding, on its layer's q bias's scale).
    Returns the launch counts of the inference and fine-tune runs."""
    import paddle_tpu_torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertForSequenceClassification)
    S = BERT_SST2
    cfg = BertConfig()
    pool = sst2_batches(torch, cfg, SEED + 28)
    paddle_tpu_torch.seed(SEED + 28)
    model = BertForSequenceClassification(cfg, num_classes=2, device="cuda",
                                          seed=SEED + 28)
    total, fails = {}, []

    def add(counts):
        for k in TRAINING_KERNELS:
            total[k] = total.get(k, 0) + counts[k]

    # (a) inference, masked against unmasked
    model.eval()
    b = pool[0]
    rates = {}
    with torch.no_grad():
        for name, mask in (("masked", b["keep"]), ("unmasked", None)):
            run = lambda: model(b["ids"], attention_mask=mask)  # noqa
            logits = run()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.monotonic()
            for _ in range(S["infer"]):
                logits = run()
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            counts = dict(kernels.launch_counts)
            add(counts)
            rates[name] = S["batch"] * S["infer"] / dt
            k1 = counts["flash_attention_fwd"]
            log(f"phase 28 inference {name}: {S['infer']} forwards of "
                f"{S['batch']} x {S['seq']} -> {rates[name]:.1f} "
                f"sentences/s ({1e3 * dt / S['infer']:.3f} ms a batch); "
                f"K1f launches {k1}; logits finite "
                f"{bool(torch.isfinite(logits).all())}; card {card}")
            want = 0 if mask is not None else \
                cfg.num_hidden_layers * S["infer"]
            if k1 != want or not torch.isfinite(logits).all() \
                    or tuple(logits.shape) != (S["batch"], 2):
                fails.append(f"phase 28 {name}: K1f {k1} (want {want}) or "
                             "bad logits")
    log(f"phase 28: unmasked / masked sentences/s "
        f"{rates['unmasked'] / rates['masked']:.3f}")
    # (b) the fine-tune, O1
    model.train()
    opt, sched = bert_optimizer(model, S["lr"], S["warmup"], S["steps"])
    scaler = amp.GradScaler()
    kernels.reset_launch_counts()
    losses = []
    t0 = time.monotonic()
    for i in range(S["steps"]):
        bb = pool[i % len(pool)]
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(bb["ids"], labels=bb["labels"])
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad(set_to_zero=False)
        sched.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    losses = [float(x) for x in losses]
    counts = dict(kernels.launch_counts)
    add(counts)
    log(f"phase 28 fine-tune: {S['steps']} O1 steps of {S['batch']} x "
        f"{S['seq']} in {dt:.3f}s ({1e3 * dt / S['steps']:.3f} ms/step); "
        f"losses {[round(x, 4) for x in losses]}; launches "
        f"{ {k: counts[k] for k in TRAINING_KERNELS} }; card {card}")
    want = cfg.num_hidden_layers * S["steps"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fails.append(f"phase 28 fine-tune: losses {losses}")
    if any(counts[k] != want for k in TRAINING_KERNELS):
        fails.append(f"phase 28 fine-tune: K1 launches {counts}, want "
                     f"{want} each")
    del model, opt, scaler
    torch.cuda.empty_cache()
    # (c) float32 kernels against their plain versions
    G = BERT_GRAD
    small = BertConfig(num_hidden_layers=G["layers"], hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    model = BertForPretraining(small, device="cuda", seed=SEED + 29)
    rng = np.random.RandomState(SEED + 29)
    ids = rng.randint(4, small.vocab_size, (G["batch"], G["seq"]))
    labels = np.where(rng.rand(*ids.shape) < 0.15, ids, -100)
    ids_t, labels_t = (torch.from_numpy(a.astype(np.int64)).cuda()
                       for a in (ids, labels))
    nsp = torch.tensor(rng.randint(0, 2, G["batch"])).cuda()

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model(ids_t, labels=labels_t, next_sentence_label=nsp)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    loss_k, grads_k = loss_and_grads()
    patches = [mock.patch.object(fa, name, getattr(fa, "plain_" + name))
               for name in TRAINING_KERNELS]
    for p in patches:
        p.start()
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        for p in patches:
            p.stop()
    lerr = abs(loss_k - loss_p) / abs(loss_p)
    # a k bias's gradient is zero in exact arithmetic (softmax ignores a
    # shift shared by a row): both sides hold rounding noise, measured
    # against the scale of the same layer's q bias gradient
    scale = {n: grads_p[n.replace("k_proj.bias", "q_proj.bias")]
             for n in grads_p}
    gerr = {n: float((grads_k[n] - grads_p[n]).abs().max()
                     / scale[n].abs().max().clamp(min=1e-30))
            for n in grads_p}
    worst = max(gerr, key=gerr.get)
    log(f"phase 28 f32: {G['layers']} BERT-base-width layers, {G['batch']} "
        f"x {G['seq']} tokens, unmasked: loss kernel {loss_k:.6f} plain "
        f"{loss_p:.6f} (rel {lerr:.2e}, tol {LOSS_RTOL}); {len(gerr)} "
        f"gradients, worst {worst} rel {gerr[worst]:.2e} (tol {GRAD_RTOL})")
    if not lerr <= LOSS_RTOL:
        fails.append(f"phase 28 f32: loss rel {lerr}")
    bad = {n: e for n, e in gerr.items() if not e <= GRAD_RTOL}
    if bad:
        fails.append(f"phase 28 f32: gradients {bad}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 28 failed: {fails}")
    return total


# ---------------------------------------------------------- phases 29-31

def vision_launches(kernels, tag):
    """The hand-written kernels' launch counts of a vision run: all 0
    (convolutions, pools and batch norms are PyTorch's)."""
    got = {k: n for k, n in kernels.launch_counts.items() if n}
    log(f"{tag}: hand-written kernel launches {got or 'none (all 0)'}")
    return got


def fit_timer(torch):
    """A ``Callback`` taking the host clock at each training batch's end
    (each ``train_batch`` reads its loss back, so the device is done)
    and the losses."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Timer(Callback):
        def __init__(self):
            super().__init__()
            self.times, self.losses = [], []

        def on_train_batch_end(self, step, logs=None):
            self.times.append(time.monotonic())
            self.losses.append(float(np.ravel(logs["loss"])[0]))
    return Timer()


def lenet_phase(torch, kernels, card):
    """Phase 29: the canonical drive (``.claude/skills/verify``'s flow)
    on the port, on the card. Fails unless acc > LENET['acc'], every loss
    is finite and ``predict`` gives (test, 10) finite outputs."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import Subset
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    L, fails = LENET, []
    paddle.seed(L["seed"])
    train = Subset(MNIST(mode="train"), range(L["train"]))
    test = Subset(MNIST(mode="test"), range(L["test"]))
    model = paddle.Model(LeNet())
    model.prepare(paddle.optimizer.Adam(1e-3, parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    timer = fit_timer(torch)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    model.fit(train, batch_size=L["batch"], epochs=L["epochs"], verbose=0,
              callbacks=[timer])
    fit_s = time.monotonic() - t0
    t0 = time.monotonic()
    logs = model.evaluate(test, batch_size=L["batch"], verbose=0)
    eval_s = time.monotonic() - t0
    t0 = time.monotonic()
    pred = model.predict(test, batch_size=L["batch"], stack_outputs=True)[0]
    pred_s = time.monotonic() - t0
    vision_launches(kernels, "phase 29")
    steady = (timer.times[-1] - timer.times[0]) / (len(timer.times) - 1)
    log(f"phase 29: LeNet on {next(model.parameters()).device}: fit "
        f"{len(timer.losses)} steps of {L['batch']} in {fit_s:.2f}s "
        f"(first step included; {1e3 * steady:.3f} ms a step after it, "
        f"{L['batch'] / steady:.1f} images/s), losses "
        f"{timer.losses[0]:.4f} -> {timer.losses[-1]:.4f}; evaluate "
        f"{logs} in {eval_s:.2f}s ({L['test'] / eval_s:.1f} images/s); "
        f"predict {pred.shape} in {pred_s:.2f}s "
        f"({L['test'] / pred_s:.1f} images/s); card {card}")
    if not np.all(np.isfinite(timer.losses)):
        fails.append(f"losses {timer.losses}")
    if not logs["acc"] > L["acc"]:
        fails.append(f"acc {logs['acc']} <= {L['acc']}")
    if pred.shape != (L["test"], 10) or not np.all(np.isfinite(pred)):
        fails.append(f"predict {pred.shape}")
    if fails:
        raise AssertionError(f"phase 29 failed: {fails}")


def conv_linear_flops(torch, model, x):
    """2 x the multiply-adds of every conv and linear layer in one forward
    of ``x`` (eval, no grad): the analytic forward FLOPs."""
    from paddle_tpu_torch.nn import Conv2D, Linear
    total, hooks = [0], []

    def count(m, inp, out):
        if isinstance(m, Conv2D):
            k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            total[0] += 2 * out.numel() * k
        else:
            total[0] += 2 * out.numel() * m.weight.shape[0]
    for m in model.modules():
        if isinstance(m, (Conv2D, Linear)):
            hooks.append(m.register_forward_hook(count))
    was = model.training
    model.eval()
    with torch.no_grad():
        model(x)
    model.train(was)
    for h in hooks:
        h.remove()
    return total[0]


def resnet50_phase(torch, kernels, card):
    """Phase 30: ResNet-50 at ImageNet width (module docstring). Fails on
    a non-finite loss, a last fixed-batch loss not under the first, or a
    hand-written kernel launch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, monitor
    from paddle_tpu_torch.io import Subset
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision.datasets import Flowers
    from paddle_tpu_torch.vision.models import resnet50
    R, fails = RESNET50, []
    paddle.seed(SEED + 30)
    t0 = time.monotonic()
    model = resnet50(num_classes=R["classes"])
    n_params = sum(p.numel() for p in model.parameters())
    opt = Momentum(R["lr"], momentum=R["momentum"],
                   parameters=model.parameters(),
                   weight_decay=L2Decay(R["decay"]))
    ce = paddle.nn.CrossEntropyLoss()
    step = TrainStep(model, lambda out, a, k: ce(out, k["_labels"][0]), opt)
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    x = torch.randn(R["batch"], 3, R["size"], R["size"], device="cuda",
                    generator=g)
    y = torch.randint(0, R["classes"], (R["batch"],), device="cuda",
                      generator=g)
    fwd_flops = conv_linear_flops(torch, model, x)
    log(f"phase 30: ResNet-50, {n_params / 1e6:.3f}M params, batch "
        f"{R['batch']} x 3 x {R['size']} x {R['size']}, forward "
        f"{fwd_flops / R['batch'] / 1e9:.4f} GFLOP an image (2 x conv + "
        f"linear multiply-adds), init {time.monotonic() - t0:.1f}s")

    def one_step():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return step(x, _labels=(y,))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses = [float(one_step()) for _ in range(R["warm"])]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    timed = [one_step() for _ in range(R["timed"])]
    torch.cuda.synchronize()
    dt = (time.monotonic() - t0) / R["timed"]
    losses += [float(v) for v in timed]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall_ms, busy_ms, reads = profiled(torch, one_step, R["profiled"], 15)
    losses.append(float(one_step()))
    rep = monitor.step_report(step.telemetry_name)
    img_s = R["batch"] / dt
    log(f"phase 30: TrainStep O1 bf16: {1e3 * dt:.3f} ms a step, "
        f"{img_s:.1f} images/s, MFU {rep['flops'] / dt / PEAK_FLOPS['bfloat16']:.4f} "
        f"(counted {rep['flops'] / 1e12:.4f} TFLOP a step) / "
        f"{3 * fwd_flops / dt / PEAK_FLOPS['bfloat16']:.4f} (3 x forward "
        f"= {3 * fwd_flops / 1e12:.4f} TFLOP) over "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.1f} TFLOP/s; peak memory "
        f"{peak:.2f} GiB; profile of {R['profiled']} steps: wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms -> idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.4f}, scalar reads {reads}; "
        f"losses {[round(v, 4) for v in losses]}; card {card}")
    if not np.all(np.isfinite(losses)):
        fails.append(f"TrainStep losses {losses}")
    if not losses[-1] < losses[0]:
        fails.append(f"fixed-batch loss {losses[-1]} not under {losses[0]}")
    launched = vision_launches(kernels, "phase 30 TrainStep")

    # Model.fit / predict over Flowers through the DataLoader
    t0 = time.monotonic()
    n = R["batch"] * R["fit_batches"]
    flowers = Subset(Flowers(mode="train"), range(n))
    log(f"phase 30: Flowers('train') {len(flowers.dataset)} synthetic "
        f"224 x 224 images made in {time.monotonic() - t0:.1f}s")
    hl = paddle.Model(model)
    hl.prepare(opt, ce)
    timer = fit_timer(torch)
    kernels.reset_launch_counts()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        t0 = time.monotonic()
        hl.fit(flowers, batch_size=R["batch"], epochs=1, verbose=0,
               callbacks=[timer])
        fit_s = time.monotonic() - t0
        steady = (timer.times[-1] - timer.times[0]) / (len(timer.times) - 1)
        hl.predict_batch(flowers[0][0][None])
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pred = hl.predict(flowers, batch_size=R["batch"],
                          stack_outputs=True)[0]
        pred_s = time.monotonic() - t0
    launched.update(vision_launches(kernels, "phase 30 fit / predict"))
    log(f"phase 30: Model.fit O1 over {R['fit_batches']} Flowers batches of "
        f"{R['batch']}: {fit_s:.2f}s with its first step; after it "
        f"{1e3 * steady:.3f} ms a batch, {R['batch'] / steady:.1f} images/s "
        f"against the bare TrainStep's {img_s:.1f} (the DataLoader's "
        f"host share and the per-batch loss read-back); losses "
        f"{[round(v, 4) for v in timer.losses]}; Model.predict O1 "
        f"{pred.shape} in {pred_s:.2f}s, {n / pred_s:.1f} images/s; card "
        f"{card}")
    if not np.all(np.isfinite(timer.losses)) or \
            not np.all(np.isfinite(pred)) or pred.shape != (n, R["classes"]):
        fails.append(f"fit / predict: losses {timer.losses}, predict "
                     f"{pred.shape}")
    if launched:
        fails.append(f"hand-written kernels launched: {launched}")
    del model, step, opt, hl, x
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"phase 30 failed: {fails}")


def vision_card_vs_cpu(torch, name, shape, classes, seed=0):
    """One ``TrainStep`` (SGD, lr 0.01) of ``name`` ("resnet50",
    "resnet18" or "lenet") from the same weights and batch: float32 on
    the card and on the CPU, float64 on the CPU. Returns, for the loss,
    the gradients of the stem conv, the head and the first batch norm's
    weight (LeNet: its last linear's bias) and the running statistics
    (all buffers together), ``(card, cpu, card_vs_cpu)``: the card's and
    the CPU's float32 error against float64 and the card against the
    CPU, each max |a - b| over max |b|. TF32 is off for the call."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.vision import models
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randint(0, classes, size=shape[0]).astype(np.int64)
    make = {"lenet": lambda d: models.LeNet(device=d),
            "resnet18": lambda d: models.resnet18(num_classes=classes,
                                                  device=d),
            "resnet50": lambda d: models.resnet50(num_classes=classes,
                                                  device=d)}[name]
    watch = (("features.0.weight", "fc.2.weight", "fc.2.bias")
             if name == "lenet" else ("conv1.weight", "fc.weight",
                                      "bn1.weight"))
    out = {}
    try:
        cpu = make("cpu")
        card, f64 = make("cuda"), make("cpu").double()
        card.load_state_dict(cpu.state_dict())
        f64.load_state_dict(cpu.state_dict())
        for dev, model in (("cpu", cpu), ("cuda", card), ("f64", f64)):
            grads, params = {}, dict(model.named_parameters())
            for w in watch:
                params[w].register_hook(
                    lambda g, w=w: grads.__setitem__(w, g.detach().cpu()))
            ce = CrossEntropyLoss()
            step = TrainStep(model, lambda o, a, k: ce(o, k["_labels"][0]),
                             SGD(0.01, parameters=model.parameters()))
            xd = x.astype(np.float64) if dev == "f64" else x
            loss = step(xd, _labels=(y,)).cpu()
            bufs = [b.detach().cpu().reshape(-1)
                    for _, b in model.named_buffers()]
            out[dev] = dict(grads, loss=loss, stats=torch.cat(bufs)
                            if bufs else torch.zeros(1))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev

    def rel(a, b):
        b = b.double()
        return float((a.double() - b).abs().max()) / (
            float(b.abs().max()) or 1.0)
    return {k: (rel(out["cuda"][k], ref), rel(out["cpu"][k], ref),
                rel(out["cuda"][k], out["cpu"][k]))
            for k, ref in out["f64"].items()}


def vision_held(r):
    """The tensors of a ``vision_card_vs_cpu`` reading whose card error
    is past VISION_CARD_CPU's bound."""
    T = VISION_CARD_CPU
    return {k: v for k, v in r.items()
            if v[0] > T["factor"] * v[1] + T["floor"]}


def vision_parity_phase(torch, kernels):
    """Phase 31: ``vision_card_vs_cpu`` at VISION_CASES; fails past
    VISION_CARD_CPU or on a hand-written kernel launch."""
    fails = []
    kernels.reset_launch_counts()
    for name, shape, classes in VISION_CASES:
        t0 = time.monotonic()
        r = vision_card_vs_cpu(torch, name, shape, classes, SEED + 31)
        log(f"phase 31 {name} {shape}, float32 error against float64 "
            f"(card, cpu, card against cpu): "
            + ", ".join(f"{k} {a:.3e} / {b:.3e} / {c:.3e}"
                        for k, (a, b, c) in r.items())
            + f" ({time.monotonic() - t0:.1f}s; bound: card <= "
            f"{VISION_CARD_CPU['factor']} x cpu + {VISION_CARD_CPU['floor']})")
        if vision_held(r):
            fails.append(f"{name}: {vision_held(r)}")
    if vision_launches(kernels, "phase 31"):
        fails.append("hand-written kernels launched")
    if fails:
        raise AssertionError(f"phase 31 failed: {fails}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of phase 3's model (default 32)")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--verbose-build", action="store_true")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import paddle_tpu_torch  # noqa: F401
        from paddle_tpu_torch.distributed import moe
        from paddle_tpu_torch.inference import ServingConfig, ServingEngine
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.models import (
            DeepseekMoeForCausalLM, LlamaConfig, LlamaForCausalLM,
            GPTConfig, GPTForCausalLM, Qwen2Config, Qwen2ForCausalLM,
            Qwen2MoeConfig, Qwen2MoeForCausalLM, deepseek_moe_16b)
        from paddle_tpu_torch.ops import kernels
        from paddle_tpu_torch.ops.kernels import _build
        from paddle_tpu_torch.ops.kernels import decode_fused as df
        from paddle_tpu_torch.nn import functional as PF
        from paddle_tpu_torch.ops.kernels import flash_attention as fa
        from paddle_tpu_torch.ops.kernels import flashmask as fm
        from paddle_tpu_torch.ops.kernels import moe_gmm as mg
        from paddle_tpu_torch.ops.kernels import paged_attention as pda
        from paddle_tpu_torch.ops import lora
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch.ops.kernels import \
            ragged_paged_attention as rpa
    except ImportError as e:
        print(f"chip_smoke: run from the root of a paddle-tpu checkout "
              f"({e})", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # -- phase 1: build --------------------------------------------------
    t0 = time.monotonic()
    built = _build.build_all(verbose=args.verbose_build)
    log(f"phase 1: built {sorted(built) or 'nothing (fresh)'} in "
        f"{time.monotonic() - t0:.1f}s (nvcc {_build.nvcc_path()})")

    # -- phase 2: kernels vs plain versions -------------------------------
    log("phase 2: kernels vs plain versions at the serving and training "
        "shapes")
    table = {}
    for dtype in ("float32", "bfloat16"):
        timing = dtype == "bfloat16"
        e1, r1 = check_ragged(torch, rpa, dtype, timing)
        r1 = r1.get("prefill")
        e5, r5 = check_paged(torch, pda, dtype, timing, "generate")
        check_paged(torch, pda, dtype, timing, "long")
        # K2v's tree mode: fp and int8 pools, GQA groups 4, 1 and 7 (timed
        # in float32 too: the FMA body's reading)
        e5t, r5t = check_paged_tree(torch, pda, dtype, True)
        e5tq, r5tq = check_paged_tree(torch, pda, dtype, True, int8=True)
        for heads, kv_heads in MOE_HEADS.values():
            for int8 in (False, True):
                check_paged_tree(torch, pda, dtype, False, heads, kv_heads,
                                 int8=int8)
        # K2r's tree mode: fp and int8 pools, GQA groups 4, 1 and 7 (timed
        # in float32 too)
        e1t, r1t = check_ragged_tree(torch, rpa, dtype, True)
        e1tq, r1tq = check_ragged_tree(torch, rpa, dtype, True, int8=True)
        for heads, kv_heads in MOE_HEADS.values():
            for int8 in (False, True):
                check_ragged_tree(torch, rpa, dtype, False, heads, kv_heads,
                                  int8=int8)
        # int8 pools: the same ticks, phase 7's shape, both GQA groups
        e1q, r1q = check_ragged(torch, rpa, dtype, timing, int8=True)
        e5q, r5q = check_paged(torch, pda, dtype, timing, "generate",
                               int8=True)
        for heads, kv_heads in MOE_HEADS.values():
            check_ragged(torch, rpa, dtype, timing, heads, kv_heads,
                         int8=True)
            check_paged(torch, pda, dtype, timing, "generate", heads,
                        kv_heads, int8=True)
        # K2v's chunk window (the per-width engine's chunk step): fp and
        # int8 pools, timed in bf16 beside K2r on the same rows
        ecw, rcw = check_chunk_window(torch, pda, rpa, dtype, timing)
        check_chunk_window(torch, pda, rpa, dtype, timing, int8=True)
        # GPT's serving on int8 pools (phase 18 (b)): K2r at its tick, 16 /
        # 16 heads of 64
        check_ragged(torch, rpa, dtype, timing, GPT_HEADS, GPT_HEADS,
                     int8=True, model="gpt")
        e2, r2 = check_norm_matmul(torch, df, dtype, timing)
        e3, r3 = check_matmul_residual(torch, df, dtype, timing)
        e4, r4 = check_flash(torch, F, fa, dtype, timing)
        torch.cuda.empty_cache()
        for heads, kv_heads in MOE_HEADS.values():
            check_ragged(torch, rpa, dtype, timing, heads, kv_heads)
            check_paged(torch, pda, dtype, timing, "generate", heads,
                        kv_heads)
        e6, r6 = check_moe(torch, mg, dtype, timing)
        torch.cuda.empty_cache()
        e7, r7 = check_moe_backward(torch, mg, dtype, timing)
        torch.cuda.empty_cache()
        e8, r8 = check_flashmask(torch, F, fa, fm, dtype, timing)
        torch.cuda.empty_cache()
        if timing:
            for name, r in r8.items():
                table[name] = dict(r, max_abs_err=e8[name])
            for name, r in r6.items():   # held at both phase-2 shapes
                table[name] = dict(r, max_abs_err=max(e6[name], e7[name]))
            for name, r in r7.items():
                table[name] = dict(r, max_abs_err=e7[name])
            for name, r in r4.items():
                table[name] = dict(r, max_abs_err=e4[name])
            table["ragged_paged_attention"] = dict(r1, max_abs_err=e1)
            table["paged_verify_attention_chunk"] = dict(rcw,
                                                         max_abs_err=ecw)
            table["ragged_paged_attention_int8"] = dict(r1q["prefill"],
                                                        max_abs_err=e1q)
            for name, r in list(r5.items()) + list(r5q.items()) \
                    + list(r5t.items()) + list(r5tq.items()) \
                    + list(r1t.items()) + list(r1tq.items()):
                table[name] = dict(r, max_abs_err={
                    **e5, **e5q, **e5t, **e5tq, **e1t, **e1tq}[name])
            for name, r in (("norm_matmul", r2), ("matmul_residual", r3)):
                table[name] = dict(merge_rows(
                    [r[label] for label in K3_TABLE[name]], dtype),
                    max_abs_err=e2 if name == "norm_matmul" else e3)
                for label, row in r.items():
                    log(f"  {name} {label}: ms={row['ms']:.4f} "
                        f"plain_ms={row['plain_ms']:.4f} "
                        f"library_ms={row['library_ms']:.4f} "
                        f"bound_ms={row['bound_ms']:.4f} "
                        f"({row['bound_by']}) share of bound "
                        f"{row['bound_ms'] / row['ms']:.3f}")
    # the K2 kernels' bf16-q-over-f32-pool mode and K1 at phase 18's
    # shapes (GPT, 16 / 16 heads of 64): K2r at its serving and tree
    # ticks, K2d / K2v / K2v's tree mode at generate()'s shape
    gpt = dict(heads=GPT_HEADS, kv_heads=GPT_HEADS, f32pool=True)
    e9, r9 = check_ragged(torch, rpa, "bfloat16", True, model="gpt", **gpt)
    table["ragged_paged_attention_f32pool"] = dict(r9["prefill"],
                                                   max_abs_err=e9)
    for errs, rows in (
            check_ragged_tree(torch, rpa, "bfloat16", True, model="gpt",
                              **gpt),
            check_paged(torch, pda, "bfloat16", True, "generate",
                        head_dim=64, **gpt),
            check_paged_tree(torch, pda, "bfloat16", True, head_dim=64,
                             **gpt)):
        for name, r in rows.items():
            table[name] = dict(r, max_abs_err=errs[name])
    check_chunk_window(torch, pda, rpa, "bfloat16", True, head_dim=64, **gpt)
    torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        check_flash(torch, F, fa, dtype, dtype == "bfloat16", shape=GPT_ATTN)
    torch.cuda.empty_cache()
    # K1 non-causal at BERT-base's shapes (phases 27-28): L 512 in both
    # dtypes, L 128 in bf16, timed in bf16; then queries shorter than keys
    for dtype in ("float32", "bfloat16"):
        check_flash(torch, F, fa, dtype, dtype == "bfloat16",
                    shape=BERT_ATTN["pretrain"], causal=False)
        check_flash_cross(torch, fa, dtype)
    check_flash(torch, F, fa, "bfloat16", True, shape=BERT_ATTN["finetune"],
                causal=False)
    torch.cuda.empty_cache()
    # K4's float32 modes as the LoRA delta drives them (phase 21)
    e10, r10 = check_lora(torch, mg, lora)
    for name, r in r10.items():
        table[name] = dict(r, max_abs_err=e10[name])
    for name, r in table.items():
        dt = "float32" if name in LORA_KERNELS else "bfloat16"
        log(f"  {name} [{dt}]: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
    log(f"  bound rates: {HBM_BYTES_PER_S / 1e12} TB/s, bf16 "
        f"{PEAK_FLOPS['bfloat16'] / 1e12} TFLOP/s (H100 SXM data sheet); "
        f"card {card}")
    if args.kernels_only:
        log("stopping after phase 2 (--kernels-only)")
        return 1

    # -- phase 3: the engine at Llama-3-8B widths -------------------------
    cfg = LlamaConfig.llama3_8b()
    cfg.dtype = "bfloat16"
    if args.layers != cfg.num_hidden_layers:
        log(f"phase 3: depth cut to {args.layers} of "
            f"{cfg.num_hidden_layers} layers (widths full)")
    cfg.num_hidden_layers = args.layers
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 3: Llama-3-8B widths, {cfg.num_hidden_layers} layers, "
        f"{n_params / 1e9:.2f}B params bf16, "
        f"init {time.monotonic() - t0:.1f}s")
    lens, prompts = serving_prompts(cfg.vocab_size, REQUESTS, SEED)
    engine = ServingEngine(model, ServingConfig(
        num_slots=8, block_size=16, max_model_len=2048, prefill_chunk=128,
        max_new_tokens=32), device="cuda")
    launches, st3, streams3 = serve_run(torch, kernels, engine, prompts,
                                        lens, "phase 3", SERVING_KERNELS)
    launches = {k: launches[k] for k in SERVING_KERNELS}
    log(f"phase 3: kv_cache_dtype {st3['kv_cache_dtype']}, pool bytes "
        f"{st3['kv_pool_bytes']}")
    # the windows re-prefill their prompts cold, as the first wave did
    engine.purge_published()
    llama_reads = tick_window(torch, engine, prompts[:8], TICK_WINDOW,
                              "phase 3")
    engine.purge_published()
    pure3 = pure_tick_window(torch, engine, prompts[:8], TICK_WINDOW,
                             "phase 3")
    engine.shutdown()
    del engine
    torch.cuda.empty_cache()

    # -- phase 19 (a), (b): CUDA graphs and the async pipeline -------------
    async_launches = async_phase(torch, kernels, ServingEngine,
                                 ServingConfig, model, prompts, lens,
                                 streams3, pure3)
    for k in SERVING_KERNELS:
        launches[k] += async_launches[k]

    # -- phase 21: multi-LoRA serving --------------------------------------
    lora_launches = lora_phase(torch, kernels, mg, ServingEngine,
                               ServingConfig, LlamaConfig, LlamaForCausalLM,
                               GPTConfig, GPTForCausalLM, model, prompts,
                               lens)
    for k in SERVING_KERNELS:
        launches[k] += lora_launches[k]
    for k in LORA_KERNELS:
        launches[k] = lora_launches[k]

    # -- phase 22: the monitor modules on the graphed tick -----------------
    for k, n in telemetry_phase(torch, kernels, ServingEngine, ServingConfig,
                                LlamaConfig, LlamaForCausalLM, model,
                                prompts, lens).items():
        launches[k] += n

    # -- phase 23: the per-width engine --------------------------------------
    pw_runs, chunk_k2v = per_width_phase(
        torch, kernels, df, rpa, pda, mg, ServingEngine, ServingConfig,
        model, prompts, lens, card)

    # -- phase 24: beam and group-beam search, the exported artifact -------
    beam_phase(torch, kernels, model, LlamaConfig, LlamaForCausalLM, card)
    del model
    torch.cuda.empty_cache()

    # -- phase 4: kernel path vs plain path, f32, reduced depth -----------
    cfg4 = LlamaConfig.llama3_8b()
    cfg4.num_hidden_layers = PHASE4_LAYERS
    model = LlamaForCausalLM(cfg4, device="cuda", seed=SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    prompts4 = [rng.randint(0, cfg4.vocab_size, size=n)
                for n in (40, 150, 70)]
    first_k, toks_k = serve_f32(torch, ServingEngine, ServingConfig, model,
                                prompts4)
    patches = plain_patches(df, rpa)
    for p in patches:
        p.start()
    try:
        first_p, toks_p = serve_f32(torch, ServingEngine, ServingConfig,
                                    model, prompts4)
    finally:
        for p in patches:
            p.stop()
    lerr = float((first_k - first_p).abs().max())
    log(f"phase 4: f32, {cfg4.num_hidden_layers} layers at full widths: "
        f"first-tick logits max_abs_err={lerr:.3e} (atol {LOGITS_ATOL})")
    if not lerr <= LOGITS_ATOL:
        raise AssertionError(f"kernel path logits disagree with the plain "
                             f"path: {lerr}")
    fails = []
    held_streams(torch, model, "phase 4 kernel vs plain", prompts4, toks_k,
                 toks_p, fails)
    if fails:
        raise AssertionError(f"phase 4: token streams diverge: {fails}")

    del model
    torch.cuda.empty_cache()

    # -- phase 5: training at Llama-3-8B widths ---------------------------
    launches.update(train_run(torch, kernels, LlamaConfig, LlamaForCausalLM,
                              AdamW, TrainStep))
    torch.cuda.empty_cache()

    # -- phase 6: training kernel path vs plain path, f32 ------------------
    train_f32_check(torch, fa, LlamaConfig, LlamaForCausalLM)

    torch.cuda.empty_cache()

    # -- phase 7: generate() at Llama-3-8B widths ---------------------------
    cfg = LlamaConfig.llama3_8b()
    cfg.dtype = "bfloat16"
    t0 = time.monotonic()
    model = LlamaForCausalLM(cfg, device="cuda", seed=SEED + 3)
    torch.cuda.synchronize()
    log(f"phase 7: Llama-3-8B, {cfg.num_hidden_layers} layers bf16, init "
        f"{time.monotonic() - t0:.1f}s; {GENERATE['batch']} prompts of "
        f"{GENERATE['prompt']} tokens, {GENERATE['new']} new, greedy")
    gen_launches = generate_run(torch, kernels, model, LlamaConfig,
                                LlamaForCausalLM)
    for k in GENERATE_KERNELS:
        launches[k] = sum(r[k] for r in gen_launches.values())
    del model
    torch.cuda.empty_cache()

    # -- phase 8: generate() kernel path vs plain path, f32 ----------------
    generate_f32_check(torch, pda, LlamaConfig, LlamaForCausalLM)
    torch.cuda.empty_cache()

    # -- phase 9: DeepSeek-MoE-16B serving and generate() -------------------
    serve9, gen9 = moe_serving_phase(
        torch, kernels, ServingEngine, ServingConfig, DeepseekMoeForCausalLM,
        deepseek_moe_16b, llama_reads)
    torch.cuda.empty_cache()

    # -- phase 10: MoE kernel path vs plain path, f32 -----------------------
    moe_f32_check(torch, kernels, df, rpa, mg, pda, ServingEngine,
                  ServingConfig, DeepseekMoeForCausalLM, deepseek_moe_16b)
    torch.cuda.empty_cache()

    # -- phase 11: Qwen2-MoE at Qwen2-57B-A14B widths -----------------------
    fused11, sorted11 = qwen2_phase(torch, kernels, ServingEngine,
                                    ServingConfig, Qwen2MoeConfig,
                                    Qwen2MoeForCausalLM)
    # every main-path run's launches: the Llama and MoE engines, generate()
    # on both models
    moe_runs = [serve9, fused11, sorted11] + list(gen9.values())
    for k in ("ragged_paged_attention",) + GENERATE_KERNELS + MOE_KERNELS \
            + ("moe_gmm",):
        launches[k] = launches.get(k, 0) + sum(r.get(k, 0)
                                               for r in moe_runs)
    torch.cuda.empty_cache()

    # -- phase 12: MoE training, bf16 ---------------------------------------
    train12 = moe_train_phase(torch, kernels, DeepseekMoeForCausalLM,
                              deepseek_moe_16b, Qwen2MoeConfig,
                              Qwen2MoeForCausalLM, AdamW, TrainStep)
    for k in TRAINING_KERNELS + MOE_KERNELS + ("moe_gmm",) \
            + MOE_BWD_KERNELS:
        launches[k] = launches.get(k, 0) + sum(r.get(k, 0)
                                               for r in train12.values())
    torch.cuda.empty_cache()

    # -- phase 13: MoE training gradients, f32, kernels vs plain ------------
    moe_grad_check(torch, kernels, fa, mg, moe, DeepseekMoeForCausalLM,
                   deepseek_moe_16b)
    torch.cuda.empty_cache()

    # -- phase 14: dense Qwen2-7B serving, and f32 kernels vs plain ---------
    serve14 = qwen2_dense_phase(torch, kernels, df, rpa, ServingEngine,
                                ServingConfig, Qwen2Config, Qwen2ForCausalLM)
    for k in SERVING_KERNELS:
        launches[k] += serve14[k]

    # -- phase 15: FlashMask attention, fwd + bwd at 16k -------------------
    launches.update(flashmask_phase(torch, kernels, fa, fm, PF))
    torch.cuda.empty_cache()

    # -- phase 16: int8 KV pools: serving, generate(), f32 check ----------
    int8_runs = int8_phase(torch, kernels, df, rpa, pda, ServingEngine,
                           ServingConfig, LlamaConfig, LlamaForCausalLM,
                           streams3, st3["kv_pool_bytes"])
    for k in INT8_KERNELS:
        launches[k] = sum(r[k] for r in int8_runs.values())
    torch.cuda.empty_cache()

    # -- phase 17: speculative serving, and f32 kernels vs plain ----------
    spec_runs = spec_serving_phase(torch, kernels, df, rpa, pda,
                                   ServingEngine, ServingConfig, LlamaConfig,
                                   LlamaForCausalLM, args.layers, streams3)
    for k in SPEC_KERNELS:
        launches[k] = sum(r[k] for r in spec_runs.values())
    for k in SERVING_KERNELS + ("paged_decode_attention",):
        launches[k] += sum(r[k] for r in spec_runs.values())
    torch.cuda.empty_cache()

    # -- phase 18: GPT serving, speculation, generate(), training ---------
    gpt_runs = gpt_phase(torch, kernels, df, rpa, pda, fa, ServingEngine,
                         ServingConfig, GPTConfig, GPTForCausalLM, AdamW,
                         TrainStep)
    for k in F32POOL_KERNELS + ("ragged_paged_attention_int8",
                                "norm_matmul", "matmul_residual") \
            + TRAINING_KERNELS:
        launches[k] = launches.get(k, 0) + sum(r.get(k, 0)
                                               for r in gpt_runs.values())
    torch.cuda.empty_cache()

    # -- phase 20: the prefix cache, preemption, the request lifecycle ------
    for k, n in lifecycle_phase(torch, kernels, df, rpa, ServingEngine,
                                ServingConfig, LlamaConfig, LlamaForCausalLM,
                                args.layers).items():
        launches[k] += n

    # the per-width runs (phase 23) on the kernels they launched; the chunk
    # steps' K2v launches under their own row too
    for k in ("paged_decode_attention", "paged_verify_attention",
              "norm_matmul", "matmul_residual"):
        launches[k] += sum(r[k] for r in pw_runs.values())
    launches["paged_verify_attention_chunk"] = chunk_k2v

    # -- phase 25: activation recompute, dense and MoE ---------------------
    for k, n in recompute_phase(torch, kernels, LlamaConfig,
                                LlamaForCausalLM, DeepseekMoeForCausalLM,
                                deepseek_moe_16b, AdamW, card).items():
        if k in TRAINING_KERNELS + MOE_KERNELS + ("moe_gmm",) \
                + MOE_BWD_KERNELS:
            launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()

    # -- phase 26: the optimizers and TrainStep's telemetry on GPT ---------
    for k, n in optimizer_phase(torch, kernels, GPTConfig, GPTForCausalLM,
                                card).items():
        if k in TRAINING_KERNELS:
            launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()

    # -- phases 27-28: BERT-base pretraining, SST-2 fine-tune and inference --
    for k, n in bert_pretrain_phase(torch, kernels, card).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in bert_sst2_phase(torch, kernels, fa, card).items():
        launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()

    # -- phases 29-31: LeNet (config 1), ResNet-50 (config 2), card vs CPU --
    lenet_phase(torch, kernels, card)
    resnet50_phase(torch, kernels, card)
    vision_parity_phase(torch, kernels)
    torch.cuda.empty_cache()

    # -- report -------------------------------------------------------------
    fa_src = "paddle_tpu/ops/pallas/flash_attention_kernel.py"
    fm_src = "paddle_tpu/ops/pallas/flashmask_kernel.py"
    srcs = {"ragged_paged_attention": (
                "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:593"),
            "paged_decode_attention": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:439"),
            "paged_verify_attention": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:510"),
            "paged_verify_attention_chunk": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:510"),
            "ragged_paged_attention_int8": (
                "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:593"),
            "ragged_paged_attention_tree": (
                "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:593"),
            "ragged_paged_attention_tree_int8": (
                "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:593"),
            "paged_decode_attention_int8": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:439"),
            "paged_verify_attention_int8": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:510"),
            "paged_verify_attention_tree": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:510"),
            "paged_verify_attention_tree_int8": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:510"),
            "ragged_paged_attention_f32pool": (
                "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:593"),
            "ragged_paged_attention_tree_f32pool": (
                "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:593"),
            "paged_decode_attention_f32pool": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:439"),
            "paged_verify_attention_f32pool": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:510"),
            "paged_verify_attention_tree_f32pool": (
                "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:510"),
            "norm_matmul": ("paddle_tpu_torch/csrc/norm_matmul.cu",
                            "paddle_tpu/ops/pallas/decode_fused.py:300"),
            "matmul_residual": ("paddle_tpu_torch/csrc/matmul_residual.cu",
                                "paddle_tpu/ops/pallas/decode_fused.py:335"),
            "flash_attention_fwd": (
                "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                f"{fa_src}:164"),
            "flash_attention_dq": (
                "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                f"{fa_src}:311"),
            "flash_attention_dkv": (
                "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                f"{fa_src}:343"),
            "moe_gather_gmm_swiglu": (
                "paddle_tpu_torch/csrc/moe_gmm.cu",
                "paddle_tpu/ops/pallas/moe_gmm.py:320"),
            "moe_scatter_gmm": ("paddle_tpu_torch/csrc/moe_gmm.cu",
                                "paddle_tpu/ops/pallas/moe_gmm.py:320"),
            "moe_gmm": ("paddle_tpu_torch/csrc/moe_gmm.cu",
                        "paddle_tpu/distributed/moe.py:485"),
            "moe_gmm_t": ("paddle_tpu_torch/csrc/moe_gmm.cu",
                          "paddle_tpu/ops/pallas/moe_gmm.py:320"),
            "moe_scatter_gmm_t": ("paddle_tpu_torch/csrc/moe_gmm.cu",
                                  "paddle_tpu/ops/pallas/moe_gmm.py:320"),
            "moe_tgmm": ("paddle_tpu_torch/csrc/moe_gmm.cu",
                         "paddle_tpu/distributed/moe.py:512"),
            "flashmask_fwd": ("paddle_tpu_torch/csrc/flashmask_fwd.cu",
                              f"{fm_src}:202"),
            "flashmask_dq": ("paddle_tpu_torch/csrc/flashmask_bwd.cu",
                             f"{fm_src}:253"),
            "flashmask_dkv": ("paddle_tpu_torch/csrc/flashmask_bwd.cu",
                              f"{fm_src}:294"),
            "lora_gmm": ("paddle_tpu_torch/csrc/moe_gmm.cu",
                         "paddle_tpu/ops/pallas/moe_gmm.py:320"),
            "lora_scatter_gmm": ("paddle_tpu_torch/csrc/moe_gmm.cu",
                                 "paddle_tpu/ops/pallas/moe_gmm.py:320")}
    out = []
    for name, (src, rep) in srcs.items():
        r = table[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
