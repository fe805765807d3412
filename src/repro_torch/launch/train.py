"""Training driver (port of ``repro.launch.train``, with the same flags):

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced --steps 20

Seeded random weights (``model.init``), the deterministic synthetic stream,
checkpoints every ``--ckpt-every`` steps with resume from the latest, the
straggler monitor, gradient accumulation, f32 / bf16 / int8 moments, and
the config's activation rematerialisation (``remat_policy``: ``full`` for
a full config, ``none`` for a reduced one).  It runs on ``cuda`` unless
given ``--device cpu``.

``--mesh DxM --backend {nccl,gloo}`` trains over a ``data x model`` mesh,
as the reference's ``--mesh``: ``main`` starts one process per mesh
position (``launch.dist.spawn``; or, inside a process group its caller
started, it runs as that rank and the mesh must match the world size).
The config goes through ``launch.cells.prepare_arch`` (heads padded to the
model axis, MoE groups = data ranks), every rank draws the same seed-0
state and keeps its shard (``training.step.shard_state``: tensor parallel
over ``model``, FSDP over ``data`` when ``cfg.fsdp``), the step takes each
rank's rows of the global batch, and checkpoints hold the logical tree.
Rank 0 prints the reference's lines.  A mesh has no default backend: NCCL
needs one card a rank; gloo serves ranks that share a card (or the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --steps 20 --mesh 2x1 --backend gloo

``--set key=value`` overrides a config field (the dry run's flag; the
reference's launcher has none), e.g. ``--set parallel_mode=fsdp``: no
tensor parallelism, the batch and parameters over both axes, so a MoE
model's dispatch groups span ranks::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
        --reduced --steps 20 --mesh 1x2 --backend gloo --set parallel_mode=fsdp
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import types

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, parse_sets, reduce_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import dist as D
from repro_torch.launch.cells import prepare_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.params import count_params
from repro_torch.runtime import StragglerMonitor, TrainRunner
from repro_torch.training import AdamWConfig, init_state, make_train_step
from repro_torch.training.step import shard_state, state_pspecs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--moments", default="f32", choices=["f32", "bf16", "int8"])
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch for a quick run")
    ap.add_argument("--mesh", default="1x1", help="data x model, e.g. 4x2")
    ap.add_argument("--backend", default=None, choices=list(D.BACKENDS),
                    help="the mesh's process-group backend: nccl (one card a rank) "
                         "or gloo (ranks may share a card, or run on the CPU)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    help="config override key=value (repeatable), as the dry run's, "
                         "e.g. parallel_mode=fsdp")
    return ap


def launch_config(args):
    """The arch config a run trains: ``--arch`` (``--reduced``), then each
    ``--set`` override (``configs.parse_sets``)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    overrides = parse_sets(args.sets)
    return cfg.with_(**overrides) if overrides else cfg


def _train(args, device, mesh=None):
    """Train as one process (or one rank of ``mesh``); rank 0 prints."""
    cfg = launch_config(args)
    shape = {"data": 1, "model": 1} if mesh is None else dict(mesh.shape)
    cfg = prepare_arch(cfg, mesh if mesh is not None else types.SimpleNamespace(shape=shape))
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                      total_steps=args.steps, moments_dtype=args.moments)
    state = init_state(cfg, opt, 0, device)
    n = count_params(M.param_specs(cfg))
    lead = mesh is None or mesh.rank == mesh.peers(None)[0]
    say = print if lead else (lambda *a, **k: None)
    say(f"arch={cfg.name} params={n:,} mesh={shape} accum={args.accum} "
        f"moments={args.moments} device={device} remat={cfg.remat_policy}")
    specs = None
    if mesh is not None:
        state = shard_state(cfg, opt, state, mesh)
        specs = state_pspecs(cfg, opt, mesh)

    step = make_train_step(cfg, opt, accum_steps=args.accum, mesh=mesh)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq)
    mgr = CheckpointManager(args.ckpt_dir, keep_n=3, mesh=mesh, specs=specs)
    losses = []
    t_start = time.time()
    t_log = [time.time()]

    def logged_step(st, batch):
        st, m = step(st, batch)
        s = int(m["step"])
        losses.append(float(m["loss"]))
        if (s + 1) % args.log_every == 0:
            tput = args.batch * args.seq * args.log_every / (time.time() - t_log[0])
            t_log[0] = time.time()
            say(f"step {s + 1:5d} loss {np.mean(losses[-args.log_every:]):.4f} "
                f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f} "
                f"{tput:.0f} tok/s", flush=True)
        return st, m

    runner = TrainRunner(logged_step, data.batch_at, mgr, ckpt_every=args.ckpt_every,
                         monitor=StragglerMonitor(), mesh=mesh)
    state, report = runner.run(state, args.steps)
    say(f"done: {report.final_step} steps in {time.time() - t_start:.0f}s, "
        f"restarts={report.restarts}, stragglers={report.straggler_flags}, "
        f"loss {report.losses[0]:.3f} -> {np.mean(report.losses[-10:]):.3f}", flush=True)
    return report


def _mesh_shape(ap, text: str) -> tuple[int, int]:
    try:
        dp, tp = (int(v) for v in text.split("x"))
    except ValueError:
        ap.error(f"--mesh {text}: expected DxM, e.g. 4x2")
    if dp < 1 or tp < 1:
        ap.error(f"--mesh {text}: axes must be >= 1")
    return dp, tp


def _rank(rank, argv):
    args = parser().parse_args(argv)
    dp, tp = _mesh_shape(parser(), args.mesh)
    mesh = make_production_mesh(shape=(dp, tp), axes=("data", "model"))
    _train(args, D.rank_device(rank, args.backend, args.device), mesh)


def main(argv=None):
    """Train from the command line.  Returns the run's report (rank 0's
    when this process is a rank of a started group); ``None`` when it
    spawned the mesh's ranks, which print the lines themselves."""
    ap = parser()
    args = ap.parse_args(argv)
    dp, tp = _mesh_shape(ap, args.mesh)
    if dp * tp == 1:
        return _train(args, args.device)
    if args.backend is None:
        ap.error(f"--mesh {args.mesh} needs --backend: nccl (one card a rank) or gloo "
                 f"(ranks may share a card, or run on the CPU)")
    if dist.is_initialized():  # started by the caller: train as this rank
        if dist.get_backend() != args.backend:
            raise ValueError(f"--backend {args.backend}, but the process group runs "
                             f"{dist.get_backend()}")
        mesh = make_production_mesh(shape=(dp, tp), axes=("data", "model"))
        return _train(args, D.rank_device(dist.get_rank(), args.backend, args.device), mesh)
    D.spawn(_rank, dp * tp, args.backend,
            args=(list(sys.argv[1:] if argv is None else argv),))
    return None


if __name__ == "__main__":
    main()
