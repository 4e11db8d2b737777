#!/usr/bin/env python3
"""Phase 3 of ``chip_smoke.py`` (Llama-3-8B widths, 32 layers, bf16, 10
requests of 64..1024 prompt tokens, 32 new, 8 slots), or with ``--model
gpt`` phase 18 (a)'s engine (``GPTConfig()``'s 24 layers, bf16 over
float32 pools, the same traffic with prompts cut to 960 tokens), for two
checkouts in turns, each in a process of its own, on one GPU:

    python3 tools/serving_ab.py OLD_CHECKOUT .
    python3 tools/serving_ab.py --model gpt OLD_CHECKOUT .

``OLD_CHECKOUT`` is a parent's tree unpacked with ``git archive`` (it
needs ``chip_smoke.py`` and ``paddle_tpu_torch``) under the ignored
``build/``. Each run builds its checkout's kernels, serves the traffic
through one engine once to warm up (where a checkout with CUDA graphs
captures them) and once measured (tokens/s, TTFT), profiles 4 ticks of
a third wave and 4 pure ticks (every seated slot decoding) of a fourth
(device time, idle share), all through the checkout's own
``chip_smoke`` functions. The order is A B B A, ``--pairs`` times (the
host's speed drifts within a call, so only neighbouring runs compare).
Each run keeps its measured streams (under the ignored
``build/serving_ab/``), and every run after the first holds them against
the other checkout's last by ``chip_smoke.held_streams`` (equal, or each
first divergence logged with its top-2 margin against the bf16 near-tie
limit of phase 7's rule). Each profile also gives K3's device ms a tick
by kernel (the ``ptt::dg90`` kernels: either bf16 body and the
pre-passes).
"""
import argparse
import os
import subprocess
import sys

# each model's run: the phase whose engine and traffic it serves, the
# model and prompts (``model``, ``lens``, ``prompts``, ``engine``,
# ``want``), then the shared measurement in RUN
MODELS = {
    "llama": ("phase 3", r'''
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
cfg = LlamaConfig.llama3_8b()
cfg.dtype = "bfloat16"
model = LlamaForCausalLM(cfg, device="cuda", seed=cs.SEED)
lens, prompts = cs.serving_prompts(cfg.vocab_size, cs.REQUESTS, cs.SEED)
engine = ServingEngine(model, ServingConfig(
    num_slots=8, block_size=16, max_model_len=2048, prefill_chunk=128,
    max_new_tokens=32), device="cuda")
want = cs.SERVING_KERNELS
'''),
    "gpt": ("phase 18", r'''
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
cfg = GPTConfig()
model = GPTForCausalLM(cfg, device="cuda", seed=cs.SEED + 18).to(
    torch.bfloat16)
model.eval()
lens, prompts = cs.serving_prompts(cfg.vocab_size, cs.REQUESTS, cs.SEED)
lens = np.minimum(lens, cs.GPT_PROMPT_MAX)
prompts = [p[:cs.GPT_PROMPT_MAX] for p in prompts]
engine = ServingEngine(model, ServingConfig(
    num_slots=8, block_size=16, max_model_len=cs.GPT_MAX_LEN,
    prefill_chunk=128, max_new_tokens=32), device="cuda")
want = cs.GPT_SERVING_KERNELS
''')}

HEAD = r'''
import os, sys, torch
import numpy as np
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import _build
_build.build_all()
'''

RUN = r'''
tag = os.environ["AB_PHASE"]
for t in ("warm-up", tag):
    _, _, streams = cs.serve_run(torch, kernels, engine, prompts, lens, t,
                                 want)
side, out = os.environ["AB_SIDE"], os.environ["AB_OUT"]
name = os.environ["AB_MODEL"]
other = os.path.join(out, f"{name}_streams{1 - int(side)}.npy")
if os.path.exists(other):
    noise = cs.logit_noise(torch, model, torch.from_numpy(
        np.stack([p[:64] for p in prompts])).cuda())
    cs.held_streams(torch, model, f"{tag} vs the other checkout", prompts,
                    streams, list(np.load(other, allow_pickle=True)), None,
                    limit=noise)
np.save(os.path.join(out, f"{name}_streams{side}.npy"),
        np.asarray(streams, dtype=object), allow_pickle=True)


def k3(by_kernel, n, what):
    """K3's device ms a tick by kernel (the ptt::dg90 kernels)."""
    busy = sum(by_kernel.values())
    parts = {}
    for kname, ms in by_kernel.items():
        if "dg90" in kname:
            kind = next((k for k in ("decode_gemm_split", "decode_gemm",
                                     "normalize", "row_stats", "activate")
                         if k in kname), "other")
            parts[kind] = parts.get(kind, 0.0) + ms
    print(f"{tag} {what} K3: device {busy / n:.3f} ms a tick, K3 "
          f"{sum(parts.values()) / n:.3f} ms a tick: " + ", ".join(
              f"{k} {v / n:.4f}" for k, v in sorted(parts.items())),
          flush=True)


by_kernel = {}
cs.tick_window(torch, engine, prompts[:8], cs.TICK_WINDOW, tag, by_kernel)
k3(by_kernel, cs.TICK_WINDOW, "profiled ticks")
# 4 pure ticks (every seated slot decoding) of a fourth wave
for p in prompts[:8]:
    engine.submit(p)
while engine.num_queued or any(s is not None and s.pend_pos is not None
                               for s in engine._slots):
    engine.step()
by_kernel = {}
wall, busy, _ = cs.profiled(torch, engine.step, cs.TICK_WINDOW, 5,
                            by_kernel=by_kernel)
engine.run()
print(f"{tag} pure ticks: {cs.TICK_WINDOW} ticks, wall {wall:.3f} ms, "
      f"device busy {busy:.3f} ms -> idle share {1 - busy / wall:.4f}")
k3(by_kernel, cs.TICK_WINDOW, "pure ticks")
engine.shutdown()
'''


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2,
                    help="A B B A rounds (default 2)")
    ap.add_argument("--model", choices=sorted(MODELS), default="llama",
                    help="phase 3's Llama-3-8B (default) or phase 18's GPT")
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    trees = [args.old, args.new]
    keep = os.path.abspath(os.path.join("build", "serving_ab"))
    os.makedirs(keep, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    phase, prelude = MODELS[args.model]
    for i in [0, 1, 1, 0] * args.pairs:
        r = subprocess.run([sys.executable, "-c", HEAD + prelude + RUN],
                           cwd=trees[i], capture_output=True, text=True,
                           timeout=900,
                           env=dict(os.environ, AB_SIDE=str(i), AB_OUT=keep,
                                    AB_PHASE=phase, AB_MODEL=args.model))
        out = r.stdout + r.stderr
        print(f"[{i}] {trees[i]} rc {r.returncode}", flush=True)
        if r.returncode:
            print(out[-3000:], flush=True)
            return 1
        for line in out.splitlines():
            if line.lstrip().startswith(phase) \
                    and "launches" not in line:
                print("   ", line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
