"""Pod-scale dry run on meta tensors (port of ``repro.launch.dryrun``): every
(arch x shape) cell on the single-pod (16 data x 16 model = 256 ranks) and
multi-pod (2 pods = 512 ranks) production meshes, as rank 0 of a
``launch.mesh.DryMesh`` sees it.

It allocates nothing on any device and runs on a machine with no GPU and
no process group: every argument is a ``meta`` tensor at rank 0's local
shape (``launch.cells.build_cell``), so kimi-k2's 1.042 T parameters
never exist, and the step the card runs is driven eagerly under
``launch.dry_costs.DryCounter``.  A full-depth pass gives the memory
record (``argument_bytes``, ``output_bytes``, ``temp_bytes`` -- the peak
less the arguments --, ``alias_bytes``: outputs that are arguments'
storages, decode's caches written in place, 0 for train and prefill, whose
steps are pure and donate nothing -- and ``peak_per_device_gib``), the
kernels' calls and the collectives; passes at main-stage depths 1 and 2
(``attn_chunk=0``) give the roofline terms (``launch.roofline.
terms_from_pair``), reckoned for the H100 SXM5's data-sheet peaks, not
measured.  The record's keys are the reference's where they mean the
same thing.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells, 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both      # and the 512-rank pass
    ... --set remat_policy=dots --tag mytag                             # config overrides

Results land in out/dryrun_torch/<mesh>/<arch>--<shape>[--tag].json (an
existing file is kept unless ``--force``).  A cell that fails is recorded
with its trace and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ASSIGNED, SHAPES, cell_skip_reason, get_config, parse_sets
from repro_torch.launch import roofline as RL
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dry_costs import DryCounter
from repro_torch.launch.mesh import DryMesh, dry_production_mesh
from repro_torch.training.optimizer import AdamWConfig

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "out", "dryrun_torch")


def count(cell) -> DryCounter:
    """Run ``cell``'s step once on its meta arguments under a fresh counter."""
    c = DryCounter()
    c.arguments(cell.args)
    with c:
        out = cell.fn(*cell.args)
    c.outputs(out)
    return c


def fresh(mesh: DryMesh) -> DryMesh:
    """A new dry mesh like ``mesh``, its counts and records empty."""
    return DryMesh(tuple(mesh.shape.values()), mesh.axis_names, mesh.rank)


def run_cell(arch: str, shape_name: str, mesh: DryMesh, mesh_name: str, *,
             overrides: dict, opt: AdamWConfig, do_roofline: bool,
             tag: str = "") -> dict:
    cfg = get_config(arch)
    overrides = dict(overrides or {})
    accum = int(overrides.pop("accum_steps", 1))
    compress_pod = bool(overrides.pop("compress_pod", False))
    if overrides:
        cfg = cfg.with_(**overrides)
    shape = SHAPES[shape_name]
    skip = cell_skip_reason(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": mesh.size_total, "overrides": overrides, "tag": tag}
    if skip:
        rec["skipped"] = skip
        return rec

    # full depth: the memory record, the kernels' calls and the collectives.
    # The plain attention query-chunked as the reference's full compile
    # (the flash kernel takes the whole block); the cost passes use 0.
    chunk = 0 if shape.step == "decode" else min(2048, shape.seq_len // 2)
    t0 = time.time()
    m = fresh(mesh)
    cell = build_cell(cfg, shape, m, opt=opt, attn_chunk=chunk, accum_steps=accum,
                      compress_pod=compress_pod)
    c = count(cell)
    rec["dry_s"] = round(time.time() - t0, 1)
    rec["memory"] = c.memory()
    rec["kernel_calls"] = dict(c.kernel_calls)
    rec["collectives"] = RL.collective_bytes(m.records)
    rec["mesh_counts"] = {"collectives": m.collectives, "wire_bytes": m.wire_bytes}

    if do_roofline:
        stages = cell.cfg.stages()
        repeats = max(s.repeats for s in stages)
        costs, colls, attn = [], [], []
        for r in (1, 2):
            m = fresh(mesh)
            c = count(build_cell(cfg, shape, m, opt=opt, main_repeats=r, attn_chunk=0))
            costs.append({"flops": c.flops, "bytes accessed": c.bytes})
            colls.append(RL.collective_bytes(m.records))
            attn.append(RL.scope_output_bytes(c.scope_bytes))
        terms = RL.terms_from_pair(costs[0], costs[1], colls[0], colls[1], repeats,
                                   attn[0], attn[1])
        mf = RL.model_flops(cell.cfg, shape)
        per_chip = mf / mesh.size_total
        r = rec["roofline"] = terms.as_dict()
        r["coll_counts"] = {k: RL.extrapolate(colls[0]["counts"][k], colls[1]["counts"][k],
                                              repeats) for k in colls[0]["counts"]}
        r["model_flops_total"] = mf
        r["model_flops_per_chip"] = per_chip
        r["useful_ratio"] = per_chip / max(terms.flops, 1.0)
        r["t_bound_overlap_s"] = terms.t_bound_overlap
        r["t_bound_serial_s"] = terms.t_bound_serial
        r["roofline_fraction"] = (per_chip / RL.PEAK_FLOPS) / max(terms.t_bound_overlap, 1e-30)
        r["roofline_fraction_flash"] = ((per_chip / RL.PEAK_FLOPS)
                                        / max(terms.t_bound_overlap_flash, 1e-30))
    return rec


def status(rec: dict) -> str:
    """One line of a record: skip, error, or the peak and, with the
    roofline, its terms."""
    if "skipped" in rec:
        return "SKIP " + rec["skipped"][:40]
    if "error" in rec:
        return "ERROR " + rec["error"][:60]
    line = f"ok mem={rec['memory']['peak_per_device_gib']}GiB"
    r = rec.get("roofline")
    if r:
        line += (f" t_comp={r['t_compute_s']:.4g}s t_mem={r['t_memory_s']:.4g}s "
                 f"t_coll={r['t_collective_s']:.4g}s {r['bottleneck']} "
                 f"useful={r['useful_ratio']:.3f} frac={r['roofline_fraction']:.4f}")
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    help="config override key=value (repeatable)")
    ap.add_argument("--moments", default="f32", choices=["f32", "bf16", "int8"])
    ap.add_argument("--tag", default="", help="suffix for the output json")
    ap.add_argument("--force", action="store_true", help="recompute existing")
    args = ap.parse_args(argv)

    overrides = parse_sets(args.sets)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    opt = AdamWConfig(moments_dtype=args.moments)

    failures = []
    for multi in meshes:
        mesh = dry_production_mesh(multi_pod=multi)
        mname = "pod2x16x16" if multi else "pod16x16"
        mdir = os.path.join(OUT_DIR, mname)
        os.makedirs(mdir, exist_ok=True)
        for arch in archs:
            for shape in shapes:
                suffix = f"--{args.tag}" if args.tag else ""
                fn = os.path.join(mdir, f"{arch}--{shape}{suffix}.json")
                if os.path.exists(fn) and not args.force:
                    print(f"[skip existing] {mname} {arch} {shape}")
                    continue
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, mesh, mname, overrides=overrides, opt=opt,
                                   do_roofline=(not args.no_roofline and not multi),
                                   tag=args.tag)
                except Exception as e:  # a cell failure is a bug: record it
                    rec = {"arch": arch, "shape": shape, "mesh": mname,
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    failures.append((mname, arch, shape, str(e)[:120]))
                with open(fn, "w") as f:
                    json.dump(rec, f, indent=1, default=float)
                print(f"[{time.time() - t0:6.1f}s] {mname} {arch:22s} {shape:12s} "
                      f"{status(rec)}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", *f_)
        raise SystemExit(1)
    print("\nDRY-RUN PASS")


if __name__ == "__main__":
    main()
