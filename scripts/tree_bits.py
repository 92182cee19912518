"""Whether two checkouts of the port give the same bits on the card.

Runs ``LM.forward`` of dbrx-132b at its published widths, cut to its
first layer as ``chip_smoke.py``'s ``moe_forward`` phase cuts it (random
fp32 weights from seed 0, 2048 tokens from seed 1, attention on flash),
and one train step's loss and gradients of the same layer over 512 of
those tokens on the plain path, with each checkout's ``src`` in a process
of its own (this checkout twice), with PyTorch's deterministic algorithms
where it has them, and compares the outputs bit for bit by checksums of
their bits taken on the card (the gradients of one dbrx layer are 15 GB:
nothing that size is written to disk).  Prints one
``TREE_BITS {...}`` line: the tensors that differ between the checkouts,
and those that differ between this checkout's two runs (what the card
does not repeat); exits 1 when a tensor differs between the checkouts
but not between the runs.  Run from the root of a checkout on a machine
with a card, naming the other one:

    python scripts/tree_bits.py path/to/other/checkout
"""
import json
import os
import subprocess
import sys
import tempfile

CHILD = """
import dataclasses, json, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.use_deterministic_algorithms(True, warn_only=True)
from repro_torch.configs import get_arch
from repro_torch.launch.serve import swap_spec_impl
from repro_torch.models.lm import LM
from repro_torch.train.step import make_loss_fn, param_dict, value_and_grad

full = get_arch("dbrx-132b").spec()
spec = dataclasses.replace(full, layers=full.layers[:1])
tokens = torch.randint(0, spec.vocab, (1, 2048), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(1))
model = LM(swap_spec_impl(spec, "pallas")).init(torch.Generator(device="cuda").manual_seed(0))

def checksum(t, step=1 << 26):
    # the bits as int32s: their sum and their sum weighted by position
    # (mod a prime), in int64 on the card, a slice at a time
    flat = t.detach().float().contiguous().view(torch.int32).reshape(-1)
    total = weighted = 0
    for i in range(0, flat.numel(), step):
        bits = flat[i:i + step].long()
        pos = torch.arange(i, i + bits.numel(), device=bits.device) % 1000003 + 1
        total += int(bits.sum())
        weighted += int((bits * pos).sum())
    return [total, weighted, float(t.float().abs().max())]

with torch.no_grad():
    out = {"logits": checksum(model.forward(tokens))}
del model
model = LM(spec).init(torch.Generator(device="cuda").manual_seed(0))
loss, grads = value_and_grad(make_loss_fn(model), param_dict(model), {"tokens": tokens[:, :512]})
out["loss"] = checksum(loss)
out.update({"grad/" + k: checksum(g) for k, g in grads.items()})
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def run(src: str, path: str) -> None:
    env = dict(os.environ, PYTHONPATH=src, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    subprocess.run([sys.executable, "-c", CHILD, path], env=env, check=True, timeout=600)


def main() -> None:
    other = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{n}.json") for n in ("here", "other", "again")]
        for src, path in zip((here, other, here), paths):
            run(os.path.join(src, "src"), path)
        x, y, z = (json.load(open(p)) for p in paths)

    def differ(a, b):  # each differing tensor's abs max in both
        return {k: [a[k][2], b[k][2]] for k in sorted(a) if k in b and a[k][:2] != b[k][:2]}

    across, again = differ(x, y), differ(x, z)
    row = {"tensors": len(x), "differ": across, "differ_run_to_run": again}
    print("TREE_BITS " + json.dumps(row), flush=True)
    sys.exit(1 if set(across) - set(again) or set(x) != set(y) else 0)


if __name__ == "__main__":
    main()
