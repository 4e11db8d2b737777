#!/usr/bin/env python3
"""Phase 3 of ``chip_smoke.py`` (Llama-3-8B widths, 32 layers, bf16, 10
requests of 64..1024 prompt tokens, 32 new, 8 slots) for two checkouts
in turns, each in a process of its own, on one GPU:

    python3 tools/serving_ab.py OLD_CHECKOUT .

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
limit of phase 7's rule).
"""
import argparse
import os
import subprocess
import sys

RUN = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import _build
_build.build_all()
cfg = LlamaConfig.llama3_8b()
cfg.dtype = "bfloat16"
model = LlamaForCausalLM(cfg, device="cuda", seed=cs.SEED)
lens, prompts = cs.serving_prompts(cfg.vocab_size, cs.REQUESTS, cs.SEED)
engine = ServingEngine(model, ServingConfig(
    num_slots=8, block_size=16, max_model_len=2048, prefill_chunk=128,
    max_new_tokens=32), device="cuda")
for tag in ("warm-up", "phase 3"):
    _, _, streams = cs.serve_run(torch, kernels, engine, prompts, lens, tag,
                                 cs.SERVING_KERNELS)
import os, numpy as np
side, out = os.environ["AB_SIDE"], os.environ["AB_OUT"]
other = os.path.join(out, f"streams{1 - int(side)}.npy")
if os.path.exists(other):
    noise = cs.logit_noise(torch, model, torch.from_numpy(
        np.stack([p[:64] for p in prompts])).cuda())
    cs.held_streams(torch, model, "phase 3 vs the other checkout", prompts,
                    streams, list(np.load(other, allow_pickle=True)), None,
                    limit=noise)
np.save(os.path.join(out, f"streams{side}.npy"),
        np.asarray(streams, dtype=object), allow_pickle=True)
cs.tick_window(torch, engine, prompts[:8], cs.TICK_WINDOW, "phase 3")
# 4 pure ticks (every seated slot decoding) of a third wave
for p in prompts[:8]:
    engine.submit(p)
while engine.num_queued or any(s is not None and s.pend_pos is not None
                               for s in engine._slots):
    engine.step()
wall, busy, _ = cs.profiled(torch, engine.step, cs.TICK_WINDOW, 5)
engine.run()
print(f"phase 3 pure ticks: {cs.TICK_WINDOW} ticks, wall {wall:.3f} ms, "
      f"device busy {busy:.3f} ms -> idle share {1 - busy / wall:.4f}")
engine.shutdown()
'''


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2,
                    help="A B B A rounds (default 2)")
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    trees = [args.old, args.new]
    keep = os.path.abspath(os.path.join("build", "serving_ab"))
    os.makedirs(keep, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for i in [0, 1, 1, 0] * args.pairs:
        r = subprocess.run([sys.executable, "-c", RUN], cwd=trees[i],
                           capture_output=True, text=True, timeout=900,
                           env=dict(os.environ, AB_SIDE=str(i), AB_OUT=keep))
        out = r.stdout + r.stderr
        print(f"[{i}] {trees[i]} rc {r.returncode}", flush=True)
        if r.returncode:
            print(out[-3000:], flush=True)
            return 1
        for line in out.splitlines():
            if line.lstrip().startswith("phase 3") \
                    and "launches" not in line:
                print("   ", line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
