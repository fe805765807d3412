"""Serving driver (port of ``repro.launch.serve``, with the same flags and
summary line): a Poisson arrival process streamed through the paged
continuous-batching engine.  Requests are admitted into pages of the shared
KV pool as they free up (common prompt prefixes share pages through the
radix cache), so the decode batch stays full.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
        --requests 16 --max-new 32 --rate 8

It runs on ``cuda`` unless given ``--device cpu``.  The weights are seeded
random (``model.init``, seed 0).  ``--reduced`` is on by default, as in the
reference, and ``--no-reduced`` serves the config at full width.  There is
no ``--kernel-mode``: a tensor's device picks each kernel or its plain
version.  The summary line prints ``device=`` where the reference prints
``kernel_mode=``.

``--mesh DxM --backend {nccl,gloo}`` serves mesh-sharded: ``main`` starts
one process per mesh position (``launch.dist.spawn``; or, inside a process
group its caller started, it runs as that rank), each drawing the same
seed-0 weights and keeping its slice, and rank 0 prints the summary line
and a ``mesh=`` line.  A mesh has no default backend: NCCL needs one card a
rank; gloo serves ranks that share a card (or the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \
        --mesh 1x2 --backend gloo --requests 8 --max-new 16
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import dist as D
from repro_torch.models import model as M
from repro_torch.serving import (ChaosInjector, Engine, EngineConfig, MeshSpec,
                                 bytes_tokenizer_encode)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="shrink the arch (default; --no-reduced serves it at full width)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s); 0 = all at once")
    ap.add_argument("--batch", type=int, default=8,
                    help="max concurrent sequences (decode batch)")
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--pages", type=int, default=None,
                    help="KV page-pool size (default: batch*max_len worth)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable radix prefix reuse")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunked-prefill budget: at most this many prompt "
                         "tokens per tick, run together with in-flight "
                         "decodes in one mixed step (default: whole-suffix "
                         "prefill)")
    ap.add_argument("--quant", default=None, choices=["none", "w8a8"],
                    help="w8a8: int8-quantize weights at load and serve "
                         "through the packed int8 GEMM kernel")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a data x model mesh of ranks (e.g. 1x2), one "
                         "process each; needs --backend")
    ap.add_argument("--backend", default=None, choices=list(D.BACKENDS),
                    help="the mesh's process-group backend: nccl (one card a rank) "
                         "or gloo (ranks may share a card, or run on the CPU)")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-request deadline in seconds (queueing + "
                         "execution); expired requests retire "
                         "FinishReason.DEADLINE")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission queue bound; past it requests finish "
                         "immediately as REJECTED with a retry_after_s hint")
    ap.add_argument("--preemption", default="off",
                    choices=["off", "recompute", "drop"],
                    help="page-pressure policy: 'recompute' admits on "
                         "prompt-only page reservations and preempts the "
                         "lowest-priority decode on exhaustion (requeue + "
                         "recompute); 'drop' sheds the victim with its "
                         "partial output")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="attach a seeded ChaosInjector (transient "
                         "pool.alloc / runner.mixed faults + rare NaN "
                         "logits) to exercise the degraded paths")
    ap.add_argument("--device", default="cuda")
    return ap


def _prompt_stream(n: int, vocab: int, seed: int):
    rng = np.random.RandomState(seed)
    prompts = [bytes_tokenizer_encode(f"request {i}: " + "x" * rng.randint(4, 40), vocab)
               for i in range(n)]
    return prompts, rng


def make_prompts(n: int, vocab: int, seed: int = 0) -> list[list[int]]:
    """The reference's prompts: ``"request i: "`` and 4-39 ``x``s, drawn
    from ``RandomState(seed)``, byte-tokenized (``repro/launch/serve.py:
    97-100``)."""
    return _prompt_stream(n, vocab, seed)[0]


def run(cfg, params, args):
    """Serve ``args.requests`` prompts (:func:`make_prompts`, seed 0) with
    ``params`` on ``args.device``: all at once (``args.rate`` 0), or
    arriving as a Poisson process of that rate, its gaps drawn from the
    same ``RandomState`` after the prompts, as the reference's.  Request i
    samples with seed i.  Returns (results, stats, engine); the engine is
    closed, its paging state reconciled."""
    chaos = None
    if args.chaos is not None:
        chaos = ChaosInjector(seed=args.chaos, rates={"pool.alloc": 0.05,
                                                      "runner.mixed": 0.05,
                                                      "logits.nan": 0.01})
    eng = Engine(cfg, params, EngineConfig(
        max_len=args.max_len, max_batch=args.batch, page_size=args.page_size,
        n_pages=args.pages, prefix_cache=not args.no_prefix_cache,
        chunk_tokens=args.chunk_tokens, max_queue=args.max_queue,
        deadline_s=args.deadline, preemption=args.preemption, quant=args.quant,
        mesh=args.mesh), device=args.device, chaos=chaos)
    prompts, rng = _prompt_stream(args.requests, cfg.vocab_size, 0)
    results = []
    if args.rate > 0:  # streaming arrivals
        due = np.cumsum(rng.exponential(1.0 / args.rate, len(prompts)))
        t0, nxt = time.time(), 0
        while nxt < len(prompts) or eng.num_queued or eng.num_active:
            now = eng.shared(time.time() - t0)  # rank 0's clock on a mesh
            while nxt < len(prompts) and now >= due[nxt]:
                eng.submit(prompts[nxt], args.max_new, args.temperature, seed=nxt)
                nxt += 1
            if not (eng.num_queued or eng.num_active):
                time.sleep(min(0.01, max(0.0, due[nxt] - now)))  # idle: wait
                continue
            results.extend(eng.step())
    else:
        for i, p in enumerate(prompts):
            eng.submit(p, args.max_new, args.temperature, seed=i)
        results = eng.run()
    results.extend(eng.close())  # drain + reconcile the paging state
    return results, eng.stats, eng


def latency_percentiles(results) -> tuple[float, float]:
    """(p50, p99) of the healthy requests' latency in seconds, as the
    reference computes them."""
    lat = sorted(r.latency_s for r in results if r.ok) or [0.0]
    return lat[len(lat) // 2], lat[min(len(lat) - 1, int(len(lat) * 0.99))]


def summary_lines(cfg, eng, results, args) -> list[str]:
    """The reference's summary line (``device=`` in place of
    ``kernel_mode=``) and, when a request was degraded, its second line."""
    stats = eng.stats
    ok = [r for r in results if r.ok]
    p50, p99 = latency_percentiles(results)
    lines = [f"arch={cfg.name} device={eng.device.type} "
             f"quant={eng.config.quant or 'none'} requests={len(results)} ok={len(ok)} "
             f"batch={args.batch} pages={eng.pool.n_pages} "
             f"prefill={stats.prefill_s:.2f}s decode={stats.decode_s:.2f}s "
             f"throughput={stats.tokens_per_s:.1f} tok/s "
             f"prefix_hit={eng.prefix_hit_rate:.0%} "
             f"p50={p50:.2f}s p99={p99:.2f}s"]
    if (stats.preempted or stats.rejected or stats.deadline_expired
            or stats.cancelled or stats.faults_isolated):
        lines.append(f"degraded: preempted={stats.preempted} "
                     f"rejected={stats.rejected} "
                     f"deadline_expired={stats.deadline_expired} "
                     f"cancelled={stats.cancelled} "
                     f"faults_isolated={stats.faults_isolated}")
    return lines


def _serve(args, device):
    """Serve as one process (or one rank): seed-0 weights on ``device``,
    :func:`run`, and the summary lines, printed by rank 0 only; on a mesh
    one ``mesh=`` line follows them."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    params = M.init(cfg, seed=0, device=device)
    args.device = str(device)
    results, _, eng = run(cfg, params, args)
    agree = eng.ranks_agree(results)
    if eng.mesh is None or eng.mesh.rank == eng.mesh.peers(None)[0]:
        for line in summary_lines(cfg, eng, results, args):
            print(line)
        if eng.mesh is not None:
            print(f"mesh={args.mesh} backend={eng.mesh.backend} ranks={eng.mesh.size_total} "
                  f"ranks_agree={agree} decode_graph={eng.runner.graph.graphed}", flush=True)
    if not agree:
        raise RuntimeError("the mesh's ranks emitted different tokens")
    return results


def _rank(rank, argv):
    args = parser().parse_args(argv)
    _serve(args, D.rank_device(rank, args.backend, args.device))


def main(argv=None):
    """Serve from the command line.  Returns the results (rank 0's when
    this process is a rank of a started group); ``None`` when it spawned
    the mesh's ranks, which print the summary themselves."""
    args = parser().parse_args(argv)
    if args.mesh is None:
        return _serve(args, args.device)
    spec = MeshSpec.parse(args.mesh)
    if args.backend is None:
        raise ValueError(f"--mesh {args.mesh} needs --backend: nccl (one card a rank) "
                         f"or gloo (ranks may share a card, or run on the CPU)")
    if dist.is_initialized():  # started by the caller: serve as this rank
        if dist.get_backend() != args.backend:
            raise ValueError(f"--backend {args.backend}, but the process group runs "
                             f"{dist.get_backend()}")
        return _serve(args, D.rank_device(dist.get_rank(), args.backend, args.device))
    D.spawn(_rank, spec.size, args.backend,
            args=(list(sys.argv[1:] if argv is None else argv),))
    return None


if __name__ == "__main__":
    main()
