"""One decode step replayed as a CUDA graph: the port's counterpart of the
JAX runner's compiled decode chunk (``repro.serving.engine.ModelRunner
._decode_chunk``, a ``lax.scan`` under ``jit``).

Eager, a decode step of full olmo-1b with its sampling tail is ~460 kernel
launches, each a Python wrapper and a CUDA API call, so the card waits for
the host.  :class:`DecodeGraph` captures one ``model.decode_step``
with ``torch.cuda.CUDAGraph`` on static device buffers and replays it: one
``cudaGraphLaunch`` a step.  The captured function runs from the token to
the f32 logits slice ``lf`` and the per-slot finite flags, the chaos
harness's ``nanmask`` poison included:

- inputs: ``cur`` [B] int32, ``pos`` [B] int32, ``pages`` [B, npp] int32
  (page pools) or none (slot caches), ``nanmask`` [B] bool;
- outputs: ``lf`` [B, V] f32 (rows in ``nanmask`` all NaN) and ``finite``
  [B] bool.

The caller's sample-and-update tail (argmax, per-request generators, the
``where``s of fault isolation) stays eager: a generator's draws cannot be
replayed inside a graph without registering it, and the tail is ~12 small
launches a step.

Capture is at the first :meth:`run` on the card; a failed capture raises
(no eager fallback on the card).  On the CPU :meth:`run` calls the same
function eagerly, so the CPU tests run what the card captures.

On a mesh the step holds its collectives.  NCCL's can be captured, so
under NCCL the step is graphed as above, collectives inside.  gloo's run
on the host and cannot be, so under gloo the step runs eagerly by rule
(:attr:`graphed` is False), and asking for a graph there raises.

What capture needs of the kernels' wrappers:

- every per-step value is one of the static buffers, filled with
  ``copy_`` before each replay (a Python int would become a constant);
- the split kernels' scratch (``_build.scratch``, keyed by device and
  stream) is sized by a warm-up run on the capture stream before capture,
  and the graph holds those entries (``_build.stream_scratch``), so a later
  larger call that grows them cannot hand their memory to someone else;
  the ticket counters reset themselves at the end of every launch;
- ``cudaFuncSetAttribute`` and the bindings run in the warm-up too;
- a decode step writes its KV row (the same row again on a rerun) but
  advances SSD state (not idempotent): the warm-up's step must not count,
  so the state leaves (:attr:`state`) are saved before it and restored
  after, and the first replay is the step's first run;
- the launch counters are Python increments, which only the capture would
  see: the graph records each wrapper's launches during capture, takes
  them back (capture launches nothing) and adds them on every replay.
"""
from __future__ import annotations

import gc
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import LAUNCH_COUNTERS
from repro_torch.models import model as M


class DecodeGraph:
    """``model.decode_step`` of ``batch`` slots over ``caches`` (page pools
    when ``pages_per_seq`` is given, else slot caches), captured once and
    replayed.  :meth:`load` fills the static buffers with one step's inputs
    (a decode loop then advances :attr:`cur` and :attr:`pos` in place);
    :meth:`run` steps.  ``capture``: None graphs the step on the card unless
    ``mesh`` runs gloo (then eager, by rule); True asks for the graph and is
    refused on a gloo mesh on the card; False runs eagerly."""

    def __init__(self, cfg, params, caches, batch: int,
                 pages_per_seq: int | None = None, device=None, mesh=None,
                 capture: bool | None = None):
        dev = torch.device(device) if device is not None else params["embed"].device
        gloo = mesh is not None and mesh.backend == "gloo"
        if capture and dev.type == "cuda" and gloo:
            raise ValueError("a decode graph was asked for on a gloo mesh: gloo "
                             "collectives run on the host and cannot be captured; serve "
                             "it eagerly (decode_graph=None or False) or start the ranks "
                             "on nccl, one card each")
        #: True when :meth:`run` replays a captured graph; False: eager steps
        self.graphed = dev.type == "cuda" and (not gloo if capture is None else capture)
        self.cfg, self.params, self.caches = cfg, params, caches
        self.device = dev
        self.cur = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.pages = (None if pages_per_seq is None else
                      torch.zeros(batch, pages_per_seq, dtype=torch.int32, device=dev))
        self.nanmask = torch.zeros(batch, dtype=torch.bool, device=dev)
        #: the slot-indexed state leaves: SSD's h and conv tails, which a
        #: step advances in place, and a cross layer's image K/V, which it
        #: only reads (none for other attention models)
        self.state = [leaf for spec, leaf in M.cache_leaves(M.cache_specs(cfg, 1, 1), caches)
                      if "kv_seq" not in spec.axes]
        self.graph: torch.cuda.CUDAGraph | None = None
        self.stream = None
        #: launches one replay makes, by wrapper (recorded at capture)
        self.per_replay: dict = {}
        self.replays = 0
        self.capture_s = 0.0
        self._held: list = []
        self._out = None

    def load(self, cur, pos, pages=None, nanmask=None):
        """Copy one step's inputs into the static buffers (``nanmask`` None:
        no slot poisoned)."""
        self.cur.copy_(torch.as_tensor(cur))
        self.pos.copy_(torch.as_tensor(pos))
        if (pages is None) != (self.pages is None):
            raise ValueError("pages must be given exactly when the graph runs on page pools")
        if pages is not None:
            self.pages.copy_(torch.as_tensor(pages))
        if nanmask is None:
            self.nanmask.zero_()
        else:
            self.nanmask.copy_(torch.as_tensor(nanmask))

    def eager(self):
        """The captured function, run eagerly on the current stream from the
        static buffers: ``(lf [B, V] f32, finite [B] bool)``.  The decode
        step writes its KV row in place, as a replay does."""
        logits, _ = M.decode_step(self.cfg, self.params, self.caches,
                                  self.cur[:, None], self.pos, pages=self.pages)
        lf = logits[:, -1, : self.cfg.vocab_size].masked_fill(
            self.nanmask[:, None], float("nan"))
        return lf, torch.isfinite(lf).all(-1)

    def run(self):
        """One decode step from the static buffers: a graph replay on the
        card (captured at the first call), :meth:`eager` on the CPU.
        Returns ``(lf, finite)``; on the card both are the graph's static
        outputs, overwritten by the next replay."""
        if not self.graphed:
            return self.eager()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        for fn, n in self.per_replay.items():
            fn.launches += n
        return self._out

    def _capture(self):
        t0 = time.time()
        dev = self.device
        stream = torch.cuda.Stream(dev)
        saved = [t.clone() for t in self.state]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.eager()  # warm-up: bindings, attributes, scratch at these shapes
        torch.cuda.current_stream(dev).wait_stream(stream)
        for t, old in zip(self.state, saved):  # undo the warm-up's state step
            t.copy_(old)
        before = {fn: fn.launches for fn in LAUNCH_COUNTERS}
        graph = torch.cuda.CUDAGraph()
        # No cycle collection during the capture: a dead engine's graph freed
        # there calls cudaGraphExecDestroy on a capturing stream, which
        # invalidates the capture (the step's next cuBLAS call then fails).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                out = self.eager()
        finally:
            if collecting:
                gc.enable()
        self.per_replay = {fn: fn.launches - before[fn] for fn in LAUNCH_COUNTERS
                           if fn.launches != before[fn]}
        for fn in LAUNCH_COUNTERS:
            fn.launches = before[fn]
        self._held = _build.stream_scratch(stream.cuda_stream)
        self.graph, self.stream, self._out = graph, stream, out
        self.capture_s = time.time() - t0
