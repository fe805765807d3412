"""Single-device training driver (port of ``repro.launch.train``, with the
same flags):

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced --steps 20

Seeded random weights (``model.init``), the deterministic synthetic stream,
checkpoints every ``--ckpt-every`` steps with resume from the latest, the
straggler monitor, gradient accumulation, f32 / bf16 / int8 moments, and
the config's activation rematerialisation (``remat_policy``: ``full`` for
a full config, ``none`` for a reduced one).  It runs on ``cuda`` unless
given ``--device cpu``.  Only ``--mesh 1x1`` is accepted: meshes are
ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.runtime import StragglerMonitor, TrainRunner
from repro_torch.training import AdamWConfig, init_state, make_train_step


def main(argv=None):
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
    ap.add_argument("--mesh", default="1x1", help="data x model; only 1x1 here")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: the port trains on one device; meshes are "
                 f"ROADMAP Queue 1 item 13")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                      total_steps=args.steps, moments_dtype=args.moments)
    state = init_state(cfg, opt, 0, args.device)
    n = sum(x.numel() for x in tree_leaves(state.params))
    print(f"arch={cfg.name} params={n:,} device={args.device} accum={args.accum} "
          f"moments={args.moments} remat={cfg.remat_policy}")

    step = make_train_step(cfg, opt, accum_steps=args.accum)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq)
    mgr = CheckpointManager(args.ckpt_dir, keep_n=3)
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
            print(f"step {s + 1:5d} loss {np.mean(losses[-args.log_every:]):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f} "
                  f"{tput:.0f} tok/s", flush=True)
        return st, m

    runner = TrainRunner(logged_step, data.batch_at, mgr, ckpt_every=args.ckpt_every,
                         monitor=StragglerMonitor())
    state, report = runner.run(state, args.steps)
    print(f"done: {report.final_step} steps in {time.time() - t_start:.0f}s, "
          f"restarts={report.restarts}, stragglers={report.straggler_flags}, "
          f"loss {report.losses[0]:.3f} -> {np.mean(report.losses[-10:]):.3f}")
    return report


if __name__ == "__main__":
    main()
