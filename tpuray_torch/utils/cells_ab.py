"""The benchmark's cells in two source trees, in alternating pairs, to
compare two versions of the port on one card in one run.

    python -m tpuray_torch.utils.cells_ab [--cells a,b] [--pairs 10]
        [--seed 0] [--out rows.jsonl] PARENT CHANGE
    python -m tpuray_torch.utils.cells_ab --read rows.jsonl [more.jsonl]

Each tree is a directory that holds a ``tpuray_torch`` package (this
checkout, or a ``git archive`` of another commit unpacked somewhere).  Each
pair runs every cell of ``--cells`` once in each tree, each run a process
of its own (``python -m tpuray_torch.benchmarks.cells`` from the tree's
root), the parent first in even pairs and the change first in odd ones.
Each run's last line, with its tree (``parent`` or ``change``), pair and
wall seconds, is appended to ``--out``, and its metrics printed.  Either
form then prints one JSON line per cell: for each tree, the runs'
end-to-end metric (``frame_ms`` or
``step_ms``) with its median and quartiles, the medians of the per-layer
metrics, and how many runs were correct; and the pairs the change won on
the end-to-end metric (ties count for neither).  A run that fails is
printed and left out; the command then exits nonzero.  Needs a CUDA device
(the cells' own rule).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TREES = ("parent", "change")
PER_LAYER = ("kernel_ms", "host_ms", "replay_ms", "device_ops", "peak_mib")


def run_cell(tree: str, cell: str, seed: int) -> dict:
    """One run of ``cell`` from ``tree``'s root: its last line, with
    ``wall_s``; a run that fails gives ``{"cell", "error"}``."""
    env = dict(os.environ, PYTHONPATH=tree)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpuray_torch.benchmarks.cells", "--cell",
         cell, "--seed", str(seed)], cwd=tree, env=env, capture_output=True,
        text=True)
    if proc.returncode:
        return {"cell": cell, "error": f"exit {proc.returncode}: "
                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}"}
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    row["wall_s"] = time.perf_counter() - t0
    return row


def quartiles(values):
    if len(values) < 2:
        return [values[0], values[0]] if values else [None, None]
    q = statistics.quantiles(values, n=4)
    return [q[0], q[2]]


def metric_of(row: dict) -> str:
    return "step_ms" if "step_ms" in row else "frame_ms"


def summarize(rows) -> dict:
    """cell -> {tree -> {metric, runs, median, quartiles, correct, the
    per-layer medians}, "change_wins", "pairs"} over the correct rows."""
    out = {}
    for cell in dict.fromkeys(r["cell"] for r in rows):
        mine = [r for r in rows if r["cell"] == cell and "error" not in r]
        if not mine:
            continue
        metric = metric_of(mine[0])
        entry = {"metric": metric}
        by_pair = {}
        for tree in TREES:
            runs = [r for r in mine if r["tree"] == tree]
            good = [r for r in runs if r.get("correct")]
            values = [r[metric] for r in good]
            entry[tree] = {
                "runs": values, "correct": f"{len(good)}/{len(runs)}",
                "median": statistics.median(values) if values else None,
                "quartiles": quartiles(values),
                **{k: statistics.median(v) for k in PER_LAYER
                   if (v := [r[k] for r in good
                             if r.get(k) is not None])}}
            for r in good:
                by_pair.setdefault(r["pair"], {})[tree] = r[metric]
        pairs = [p for p in by_pair.values() if len(p) == 2]
        entry["pairs"] = len(pairs)
        entry["change_wins"] = sum(p["change"] < p["parent"] for p in pairs)
        entry["parent_wins"] = sum(p["parent"] < p["change"] for p in pairs)
        out[cell] = entry
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trees", nargs="*", metavar="TREE")
    ap.add_argument("--cells", default="render_map_512x384_d3_train")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--read", nargs="+", default=None)
    args = ap.parse_args(argv)
    failed = []
    if args.read:
        rows = [json.loads(line) for path in args.read
                for line in open(path) if line.strip()]
    else:
        if len(args.trees) != 2:
            ap.error("give two trees: PARENT CHANGE")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(card, flush=True)
        trees = dict(zip(TREES, map(os.path.abspath, args.trees)))
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
        rows = []
        for pair in range(args.pairs):
            order = TREES if pair % 2 == 0 else TREES[::-1]
            for cell in args.cells.split(","):
                for tree in order:
                    row = dict(run_cell(trees[tree], cell, args.seed),
                               tree=tree, pair=pair, card=card)
                    if "error" in row:
                        print(json.dumps(row), flush=True)
                        failed.append((tree, cell, pair))
                        continue
                    print(json.dumps({k: row.get(k) for k in (
                        "cell", "tree", "pair", "correct", metric_of(row),
                        *PER_LAYER, "wall_s")}), flush=True)
                    rows.append(row)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps(row) + "\n")
    summary = summarize(rows)
    for cell, entry in summary.items():
        print(json.dumps({"cell": cell, **entry}), flush=True)
    if failed:
        raise SystemExit(f"cells_ab: runs failed: {failed}")
    return summary


if __name__ == "__main__":
    main()
