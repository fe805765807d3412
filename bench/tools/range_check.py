"""Check of the program's profiler ranges on one traced run of a cell (a
diagnostic: no cell runs it, and it reports no metric).

    python3 bench/tools/range_check.py --workload olmo-1b.chat --seed 7 [--out x.json]

Runs the cell as ``bench/run.py --trace 1`` does, keeps the raw trace of its
slice, and prints the result line, then one JSON summary of the program's
ranges (``serve.*``, ``plain_attention``, ``adamw_update``):

- ``host`` / ``device``: count and ms of each range's host spans and of its
  device spans (``gpu_user_annotation``);
- ``leaves``: for each forward range the metrics read (``serve.chunk_forward``,
  ``serve.whole_forward``), the program ranges found inside its host spans
  (a leaf has none) and how many device ops launched inside a host span lie
  inside one of the range's device spans, and how many outside;
- ``idle_ms_by_range``: the slice's idle time split over the innermost
  program range open on the host at each idle instant (main thread), or
  ``(no program range)``.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

PROGRAM = ("plain_attention", "adamw_update")
LEAVES = ("serve.chunk_forward", "serve.whole_forward")
NONE = "(no program range)"


def _program(name: str) -> bool:
    return name.startswith("serve.") or name in PROGRAM


def _count_ms(spans) -> tuple[dict, dict]:
    count, ms = {}, {}
    for a, b, n in spans:
        count[n] = count.get(n, 0) + 1
        ms[n] = ms.get(n, 0.0) + (b - a) / 1e3
    return count, ms


def _leaf(leaf, host, dev, launches, kern) -> dict:
    spans = [(a, b) for a, b, n, _ in host if n == leaf]
    nested = sorted({m for a, b in spans for c, d, m, _ in host
                     if m != leaf and a <= c and d <= b})
    dspans = sorted((a, b) for a, b, n in dev if n == leaf)
    dstarts = [a for a, _ in dspans]
    lts = [t for t, _ in launches]
    inside = outside = 0
    for a, b in spans:
        for i in range(bisect.bisect_left(lts, a), bisect.bisect_right(lts, b)):
            for k0, k1 in kern.get(launches[i][1], []):
                j = bisect.bisect_right(dstarts, k0) - 1
                if j >= 0 and k1 <= dspans[j][1] + 0.01:
                    inside += 1
                else:
                    outside += 1
    return {"host_spans": len(spans), "nested_program_ranges": nested,
            "device_ops_in_projection": inside, "device_ops_outside": outside}


def _idle_by_range(host, busy, s0, s1) -> dict:
    merged: list = []
    for a, b in sorted(busy):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps, t = [], s0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if s1 > t:
        gaps.append((t, s1))
    tids: dict = {}
    for *_, tid in host:
        tids[tid] = tids.get(tid, 0) + 1
    main = max(tids, key=tids.get) if tids else None
    edges = sorted([(a, 1, -b, n) for a, b, n, tid in host if tid == main]
                   + [(b, 0, 0, n) for a, b, n, tid in host if tid == main])
    segs, stack, t = [], [], s0
    for tb, opens, _, n in edges:
        if tb > t:
            segs.append((t, tb, stack[-1] if stack else NONE))
            t = tb
        if opens:
            stack.append(n)
        elif stack:
            stack.pop()
    segs.append((t, s1, NONE))
    out: dict = {}
    ends = [g1 for _, g1 in gaps]
    for a, b, n in segs:
        for g0, g1 in gaps[bisect.bisect_left(ends, a):]:
            if g0 >= b:
                break
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                out[n] = out.get(n, 0.0) + ov / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def summarise(doc: dict) -> dict:
    """The summary above from a chrome trace as ``torch.profiler`` exports
    it (the slice is the harness's ``bench:slice`` span; times in us)."""
    from bench.lib.trace import DEVICE_CATS, PREFIX
    evs = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    end = lambda e: e["ts"] + e["dur"]  # noqa: E731
    sl = [e for e in evs if e.get("name") == PREFIX + "slice"]
    s0, s1 = (sl[0]["ts"], end(sl[0])) if sl else (
        min((e["ts"] for e in evs), default=0.0), max((end(e) for e in evs), default=0.0))
    host = sorted((e["ts"], end(e), e["name"], e.get("tid")) for e in evs
                  if e.get("cat") == "user_annotation" and _program(e["name"]))
    dev = [(e["ts"], end(e), e["name"]) for e in evs
           if e.get("cat") == "gpu_user_annotation" and _program(e["name"])]
    launches = sorted((e["ts"], e.get("args", {}).get("correlation")) for e in evs
                      if e.get("cat") == "cuda_runtime" and "aunch" in e.get("name", ""))
    kern: dict = {}
    busy = []
    for e in evs:
        if e.get("cat") in DEVICE_CATS:
            kern.setdefault(e.get("args", {}).get("correlation"), []).append((e["ts"], end(e)))
            if end(e) > s0 and e["ts"] < s1:
                busy.append((max(e["ts"], s0), min(end(e), s1)))
    hc, hm = _count_ms((a, b, n) for a, b, n, _ in host)
    dc, dm = _count_ms(dev)
    return {"slice_ms": (s1 - s0) / 1e3,
            "host": {"count": hc, "ms": hm}, "device": {"count": dc, "ms": dm},
            "leaves": {leaf: _leaf(leaf, host, dev, launches, kern)
                       for leaf in LEAVES if any(n == leaf for *_, n, _t in host)},
            "idle_ms_by_range": _idle_by_range(host, busy, s0, s1)}


def main(argv=None) -> int:
    t_proc0 = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result line and the summary here")
    args = ap.parse_args(argv)
    from bench.lib import harness
    from bench.lib import trace as T
    summary: dict = {}
    parse = T.parse

    def parse_and_keep(doc):
        summary.update(summarise(doc))
        return parse(doc)

    T.parse = parse_and_keep
    try:
        res, _ = harness.run_cell(args.workload, args.seed, args.seconds, True,
                                  args.device, t_proc0)
    finally:
        T.parse = parse
    line = {k: v for k, v in res.items() if k != "breakdown"}
    print(json.dumps(line), flush=True)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"result": res, "ranges": summary}, f)
    return 0


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path[:0] = [root, os.path.join(root, "src")]
    sys.exit(main())
