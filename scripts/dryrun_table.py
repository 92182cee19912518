"""The dry run's records as one markdown table.

    PYTHONPATH=src python scripts/dryrun_table.py results/dryrun [--walls walls.txt] [--grouped]

One row a record (``<arch>__<shape>__<mesh>[__<variant>].json``, as
``python -m repro_torch.launch.dryrun`` writes them): status, the step's
seconds (``total_s``), collective GB a device by kind, argument and peak
GB a device, ``model_flops``, the local FLOPs, and the modelled roofline
terms of ``hwgen/roofline.py::roofline_from_record`` on the H100 (per
device, against its data-sheet peaks: modelled, not measured).  A
``--walls`` file of ``cell <arch> <shape> <mesh> exit <code> wall <s>``
lines adds each cell's process wall time.  The failures are listed after
the table with the last line of their traceback.

    PYTHONPATH=src python scripts/dryrun_table.py NEW_DIR --against OLD_DIR

compares two runs' records instead, one row a record whose counts moved:
FLOPs, each kind's collective count and bytes, argument bytes (which must
not move), and the new over the old ``bytes_accessed``, transcendentals
and peak; then the number of records compared and of those unchanged.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.hwgen.collectives import COLLECTIVES
from repro_torch.hwgen.roofline import roofline_from_record
from repro_torch.hwgen.targets import H100

SHORT = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS", "all-to-all": "A2A",
         "collective-permute": "CP"}


def _gb(x) -> str:
    return "" if x is None else f"{x / 1e9:.3g}"


def _walls(path):
    out = {}
    if path:
        with open(path) as f:
            for line in f:
                parts = line.split()
                if parts[:1] == ["cell"] and "wall" in parts:
                    out["__".join(parts[1:4])] = float(parts[parts.index("wall") + 1])
    return out


def rows(directory: str, walls=None):
    walls = walls or {}
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        name = os.path.basename(path)[:-5]
        cell = "__".join(name.split("__")[:3])
        coll = rec.get("collectives") or {}
        by_kind = " ".join(f"{SHORT[k]} {_gb(coll[k]['bytes'])}" for k in COLLECTIVES
                           if coll.get(k, {}).get("bytes"))
        mem = rec.get("memory") or {}
        row = {"cell": name, "status": rec.get("status"), "total_s": rec.get("total_s"),
               "wall_s": walls.get(cell), "collective_gb": _gb(rec.get("collective_bytes")),
               "by_kind": by_kind, "argument_gb": _gb(mem.get("argument_bytes")),
               "peak_gb": _gb(mem.get("peak_bytes_per_device")),
               "model_flops": rec.get("model_flops"),
               "flops": (rec.get("cost") or {}).get("flops"), "reason": rec.get("reason"),
               "error": None, "roofline": None}
        if rec.get("status") == "error":
            row["error"] = rec.get("traceback", "").strip().splitlines()[-1][:200]
        if rec.get("status") == "ok" and rec.get("cost"):
            r = roofline_from_record(rec, H100)
            row["roofline"] = {"compute_s": r.compute_s, "memory_s": r.memory_s,
                               "collective_s": r.collective_s, "dominant": r.dominant}
        yield row


def _terms(roof) -> str:
    if not roof:
        return ""
    return (f"{roof['compute_s']:.3g} / {roof['memory_s']:.3g} / {roof['collective_s']:.3g} "
            f"({roof['dominant']})")


def grouped(table) -> None:
    """One row an (arch, shape): the single-pod baseline in full, then
    the multi-pod and the optimized variant's step seconds, collective and
    peak GB a device (and the optimized one's modelled terms)."""
    by = {}
    for r in table:
        parts = r["cell"].split("__")
        key = tuple(parts[:2])
        kind = "single" if parts[2] == "single" and len(parts) == 3 else (
            "multi" if parts[2] == "multi" else "opt")
        by.setdefault(key, {})[kind] = r
    print("| arch, shape | status | step s | coll. GB/dev by kind | args GB | peak GB "
          "| model FLOPs | FLOPs/dev | modelled compute / memory / collective s (H100) "
          "| multi: s, coll., peak GB | opt: s, coll., peak GB; modelled s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    skipped = []
    for (arch, shape), cells in by.items():
        base = cells.get("single")
        if base and base["status"] == "skipped":
            skipped.append(f"{arch} {shape}")
            continue

        def brief(r, terms=False):
            if not r:
                return ""
            if r["status"] != "ok":
                return r["status"]
            out = f"{r['total_s']}, {r['collective_gb']}, {r['peak_gb']}"
            return out + (f"; {_terms(r['roofline'])}" if terms and r["roofline"] else "")

        b = base or {}
        flops = "" if b.get("flops") is None else f"{b['flops']:.3g}"
        mflops = "" if b.get("model_flops") is None else f"{b['model_flops']:.3g}"
        print(f"| {arch} {shape} | {b.get('status', '')} | {b.get('total_s') or ''} "
              f"| {b.get('collective_gb', '')} ({b.get('by_kind', '')}) | "
              f"{b.get('argument_gb', '')} | {b.get('peak_gb', '')} | {mflops} | {flops} "
              f"| {_terms(b.get('roofline'))} | {brief(cells.get('multi'))} "
              f"| {brief(cells.get('opt'), terms=True)} |")
    print(f"\nskipped (every mesh and variant): {', '.join(skipped)}")


def _counts(rec) -> dict:
    cost, mem = rec.get("cost") or {}, rec.get("memory") or {}
    return {"flops": cost.get("flops"), "collectives": rec.get("collectives"),
            "argument_bytes": mem.get("argument_bytes"),
            "bytes_accessed": cost.get("bytes_accessed"),
            "transcendentals": cost.get("transcendentals"),
            "peak": mem.get("peak_bytes_per_device")}


def against(new_dir: str, old_dir: str) -> int:
    """Print the records of ``new_dir`` whose counts differ from
    ``old_dir``'s; returns how many moved a count that must not move."""
    def ratio(a, b):
        return "" if a is None or b is None else ("1" if a == b else f"{a / b:.6g}" if b else "inf")

    print("| record | FLOPs, collectives, args | bytes_accessed new/old | transcendentals "
          "new/old | peak new/old |")
    print("| --- | --- | --- | --- | --- |")
    compared = unchanged = fixed_moved = 0
    for path in sorted(glob.glob(os.path.join(new_dir, "*.json"))):
        old_path = os.path.join(old_dir, os.path.basename(path))
        if not os.path.exists(old_path):
            continue
        with open(path) as f, open(old_path) as g:
            new, old = _counts(json.load(f)), _counts(json.load(g))
        compared += 1
        if new == old:
            unchanged += 1
            continue
        fixed = all(new[k] == old[k] for k in ("flops", "collectives", "argument_bytes"))
        fixed_moved += not fixed
        print(f"| {os.path.basename(path)[:-5]} | {'equal' if fixed else 'MOVED'} "
              f"| {ratio(new['bytes_accessed'], old['bytes_accessed'])} "
              f"| {ratio(new['transcendentals'], old['transcendentals'])} "
              f"| {ratio(new['peak'], old['peak'])} |")
    print(f"\n{compared} records compared: {unchanged} unchanged, "
          f"{compared - unchanged} moved, {fixed_moved} of them in FLOPs, collectives "
          f"or argument bytes")
    return fixed_moved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("directory")
    p.add_argument("--walls", default=None)
    p.add_argument("--json", action="store_true", help="one JSON object a row")
    p.add_argument("--grouped", action="store_true",
                   help="one row an (arch, shape): single, multi and the --opt variant")
    p.add_argument("--against", default=None, metavar="OLD_DIR",
                   help="compare the records with another run's")
    args = p.parse_args(argv)
    if args.against:
        return 1 if against(args.directory, args.against) else 0
    table = list(rows(args.directory, _walls(args.walls)))
    if args.json:
        for row in table:
            print(json.dumps(row))
        return 0
    if args.grouped:
        grouped(table)
        failed = [r for r in table if r["status"] not in ("ok", "skipped")]
        for r in failed:
            print(f"- {r['cell']}: {r['status']}: {r['error']}")
        return 0
    print("| cell | status | step s | wall s | coll. GB/dev | by kind | args GB | peak GB "
          "| model FLOPs | FLOPs/dev | modelled compute / memory / collective s (H100) |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in table:
        if r["status"] == "skipped":
            continue
        terms = _terms(r["roofline"])
        flops = "" if r["flops"] is None else f"{r['flops']:.3g}"
        mflops = "" if r["model_flops"] is None else f"{r['model_flops']:.3g}"
        print(f"| {r['cell']} | {r['status']} | {r['total_s'] or ''} | {r['wall_s'] or ''} "
              f"| {r['collective_gb']} | {r['by_kind']} | {r['argument_gb']} | {r['peak_gb']} "
              f"| {mflops} | {flops} | {terms} |")
    skipped = [r["cell"] for r in table if r["status"] == "skipped"]
    failed = [r for r in table if r["status"] not in ("ok", "skipped")]
    print(f"\n{len(table)} records: {len(table) - len(skipped) - len(failed)} ok, "
          f"{len(skipped)} skipped, {len(failed)} failed")
    for r in failed:
        print(f"- {r['cell']}: {r['status']}: {r['error']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
