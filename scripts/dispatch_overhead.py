#!/usr/bin/env python3
"""Times small kernel calls through two trees of the port in turns, to
read what a change to the wrappers' host path costs a call.

    python scripts/dispatch_overhead.py OLD_TREE NEW_TREE [--turns 2]

Each tree is a checkout (``git archive`` unpacked) whose ``src/`` holds
``repro_torch``.  The trees run in turns, old, new, new, old (``--turns``
such pairs), each in its own Python process with that tree's ``src`` first
on the path; both load the kernels built in this checkout's
``build/repro_torch_kernels`` (a library is named by the hash of its
source, so a tree whose sources are the same loads the same build, and
one whose sources differ builds its own there).  In each process, on the
same seeded inputs:

* flash attention at the served shape (B 1, S = T = 512, 16 heads over 8
  KV heads, D 128, causal, fp32) through ``ops.flash_attention``;
* the SSD scan at zamba2-2.7b's served prompt (B 1, L 128, H 80, G 1,
  N = P = 64, chunk 128, fp32) through ``ops.ssm_scan``;

each timed by ``repro_torch.kernels.timing.event_ms`` (CUDA events around
10 back-to-back calls, the median of 20 such runs, after 3 warm-ups: at
these sizes the wrapper's host path, not the kernel, sets the rate) under
``torch.inference_mode`` (how the serving engine and the estimators call
the kernels) and with autograd on (how ``chip_smoke.py`` times them), with
the kernel's device time from ``torch.profiler`` beside it.  One JSON line
per turn, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import json, sys
from pathlib import Path
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.kernels import build, ops, timing
build.BUILD_DIR = Path(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(0)

def rand(*shape):
    return torch.randn(*shape, generator=gen, device="cuda")

q, k, v = rand(1, 512, 16, 128), rand(1, 512, 8, 128), rand(1, 512, 8, 128)
x, dt, a = rand(1, 128, 80, 64), rand(1, 128, 80).abs() * 0.1, -rand(80).abs()
b, c = rand(1, 128, 1, 64), rand(1, 128, 1, 64)
calls = {"flash_attention": lambda: ops.flash_attention(q, k, v, causal=True),
         "ssm_scan": lambda: ops.ssm_scan(x, dt, a, b, c, chunk=128)}
with torch.inference_mode():
    row = {name: {"ms": timing.event_ms(fn), "device_ms": timing.device_ms(fn)}
           for name, fn in calls.items()}
for name, fn in calls.items():
    row[name]["grad_mode_ms"] = timing.event_ms(fn)
row["registered_ops"] = hasattr(torch.ops.repro_torch, "flash_attention")
print(json.dumps(row))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("old", help="the earlier tree")
    p.add_argument("new", help="the tree under test")
    p.add_argument("--turns", type=int, default=1,
                   help="pairs of (old, new, new, old) rounds (default 1)")
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, timing

    print(timing.card())
    build.build_all(["flash_attention", "ssm_scan"])
    for _ in range(args.turns):
        for label in ("old", "new", "new", "old"):
            tree = Path(getattr(args, label)).resolve()
            env = dict(os.environ, PYTHONPATH=str(tree / "src"))
            proc = subprocess.run([sys.executable, "-c", CHILD, str(build.BUILD_DIR)],
                                  capture_output=True, text=True, env=env, timeout=600)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": label, "path": str(tree), **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
