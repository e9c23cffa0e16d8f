"""LBIM fused step — decode (memory-bound) + prefill chunk (compute-bound)
(port of ``repro.core.interleave``).

The JAX package compiles each of its three step programs into one XLA
program (``jax.jit``), so that the scheduler can hide the decode's cache and
weight stream under the prefill chunk's GEMMs. The port's counterpart of a
``jax.jit`` program is a captured CUDA graph: :class:`StepGraphs` holds the
captured programs of one engine (the engine owns it and frees it with
itself). A graph is keyed as a ``jax.jit`` cache entry is, by the program,
``cfg``, its static arguments and every input tensor's shape, dtype, stride
and address (a changed address gives a new capture, never a stale replay);
the tokens, the one input that changes every step, are copied from pinned
host memory into the graph's own static buffer before each replay. A key's
first call runs eagerly (the warm-up PyTorch needs before a capture: cuBLAS
handles, the allocator; it is the real step, since the caches are written in
place and must not be written twice), the second captures and replays, every
later call replays. A ragged tail chunk seen once stays eager. On the CPU
there is no graph: the same functions run eagerly over the kernels' plain
versions. :func:`eager` turns capture off (the counterpart of
``jax.disable_jit``), for the tests and ``chip_smoke.py``'s A/B; the engine
never uses it. A capture that fails raises :class:`CaptureError`, naming the
line that broke it (a host sync, ``.item()``, a copy from pageable memory):
no step quietly runs eagerly instead.

``fused_step``'s graph has two branches: the decode half on the capture
stream and the prefill chunk on a second stream forked from it and joined
back before the graph ends, so the card may run the GEMV-class half (W8A8
GEMVs, flash decode: B1-B4) beside the GEMM-class one (float GEMMs, dense
attention), the paper's Pbank split. The two halves write disjoint cache
tensors: the pool's pages or lanes, and the admission stream's fresh pages or
its persistent staging lanes. The one page both touch is the dummy page
free decode lanes write into and the stream's table maps its unwritten
blocks to; the prefill reads it only at masked positions (weight exactly 0,
and every value there finite), so the order of the two halves changes no
token. A replayed graph runs no Python, so each graph's kernel launches,
counted once at capture, are added to ``kernels.launch_counts()`` on every
replay: the counts equal the eager path's. A graph's outputs are its static
buffers, which its next replay overwrites: callers read them (or copy them)
first.

The same object holds the engine's other compiled program, the pool's
sampling step (:meth:`StepGraphs.sample`, the jitted ``sample_masked``), and
the speculative draft's feeds run its ``decode_only_step`` graphs over the
draft decoder's persistent batch-1 lane (``serve.spec``).

Every step program writes its cache IN PLACE, its fill ``pos`` included:
``pos`` advances by the chunk's tokens in the tensor the caller passed, so a
cache dict holds the same tensors step after step (the pool refreshes them
from its host state before each step).

Prefill chunks run in sub-chunks of ``sub_chunk`` tokens (the engine passes
its admission chunk); the captured unit of ``prefill_chunk_step`` is one
sub-chunk's ``decode_step``. The admission quantum differs between modes,
and a GEMM of a different row count may round differently on the card;
cutting every chunk at the same token boundaries makes each token's
arithmetic independent of the quantum, so greedy tokens stay identical
across BLOCKED/HBCEM/LBIM. A token-coupled config
(``ModelConfig.token_coupled``: the MoE capacity dispatch, where which picks
drop depends on the tokens of the call) is never cut: a chunk is one forward
over all its tokens, as the JAX package runs it, and its tokens may then
differ between modes, as the JAX engine's do.
"""
from __future__ import annotations

import contextlib
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

_EAGER = [0]   # depth of nested eager() blocks
_TORCH_DIR = str(Path(torch.__file__).resolve().parent)


class CaptureError(RuntimeError):
    """A step program could not be captured into a CUDA graph."""


@contextlib.contextmanager
def eager():
    """Run every step program eagerly inside the block (nests)."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def capture_enabled() -> bool:
    return _EAGER[0] == 0


# ---------------------------------------------------------------------------
# the programs (their eager bodies)
# ---------------------------------------------------------------------------


def _unit(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig, gemm: bool,
          mesh=None):
    """One ``decode_step`` (partitioned over ``mesh`` where given), its fill
    advanced in the caller's ``pos``."""
    logits, out = M.decode_step(params, cache, tokens, cfg, gemm=gemm, mesh=mesh)
    pos = cache["pos"]
    pos.copy_(out["pos"])      # in place
    out["pos"] = pos
    return logits, out


def _prefill(cache: dict, tokens: torch.Tensor, cfg: ModelConfig, sub_chunk, gemm: bool,
             run: Callable):
    """A chunk as sub-chunks through ``run(cache, tokens, gemm)``: the logits
    of the last sub-chunk and the cache after all of them."""
    t = tokens.shape[1]
    step = t if not sub_chunk or cfg.token_coupled else int(sub_chunk)
    gemm = gemm or t > 1
    logits = None
    for lo in range(0, t, step):
        logits, cache = run(cache, tokens[:, lo:lo + step], gemm)
    return logits, cache


def _fused(params, dec_cache, dec_tokens, pre_cache, pre_tokens, cfg, sub_chunk,
           side: Optional[torch.cuda.Stream]):
    """The decode half, then the prefill chunk; with ``side`` (capture only)
    the prefill runs on that stream, forked from the current one and joined
    back, so the graph holds two branches."""
    run = lambda c, tk, g: _unit(params, c, tk, cfg, g)  # noqa: E731
    if side is None:
        dec = _unit(params, dec_cache, dec_tokens, cfg, False)
        return (*dec, *_prefill(pre_cache, pre_tokens, cfg, sub_chunk, False, run))
    main = torch.cuda.current_stream()
    side.wait_stream(main)                       # fork
    dec = _unit(params, dec_cache, dec_tokens, cfg, False)
    with torch.cuda.stream(side):
        pre = _prefill(pre_cache, pre_tokens, cfg, sub_chunk, False, run)
    main.wait_stream(side)                       # join
    return (*dec, *pre)


def _on(tokens: torch.Tensor, cache: dict) -> torch.Tensor:
    return tokens.to(cache["pos"].device)


def fused_step(params: dict, dec_cache: dict, dec_tokens: torch.Tensor, pre_cache: dict,
               pre_tokens: torch.Tensor, cfg: ModelConfig, *,
               sub_chunk: Optional[int] = None, graphs: Optional["StepGraphs"] = None):
    """Returns (dec_logits, dec_cache', pre_logits, pre_cache'); through
    ``graphs`` (the engine's captured programs) when given, else eagerly."""
    if graphs is not None:
        return graphs.fused_step(params, dec_cache, dec_tokens, pre_cache, pre_tokens, cfg,
                                 sub_chunk=sub_chunk)
    return _fused(params, dec_cache, _on(dec_tokens, dec_cache), pre_cache,
                  _on(pre_tokens, pre_cache), cfg, sub_chunk, None)


def decode_only_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                     graphs: Optional["StepGraphs"] = None):
    if graphs is not None:
        return graphs.decode_only_step(params, cache, tokens, cfg)
    return _unit(params, cache, _on(tokens, cache), cfg, False)


def prefill_chunk_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
                       *, sub_chunk: Optional[int] = None, gemm: bool = False,
                       graphs: Optional["StepGraphs"] = None):
    """Chunked prefill = multi-token decode step(s) extending the cache.
    Returns the logits of the last sub-chunk and the cache after all of them.

    A chunk of more than one token takes the GEMM form in every sub-chunk,
    a one-token sub-chunk included, as the JAX package computes the whole
    chunk as one multi-token step; a one-token chunk is a decode step. A
    token-coupled config takes the whole chunk in one step."""
    if graphs is not None:
        return graphs.prefill_chunk_step(params, cache, tokens, cfg, sub_chunk=sub_chunk,
                                         gemm=gemm)
    return _prefill(cache, tokens, cfg, sub_chunk, gemm,
                    lambda c, tk, g: _unit(params, c, _on(tk, c), cfg, g))


# ---------------------------------------------------------------------------
# captured programs
# ---------------------------------------------------------------------------


def _leaves(tree, out: list) -> list:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):    # layer lists, PreparedLinear
        for v in tree:
            _leaves(v, out)
    return out


def _fill(buf: torch.Tensor, x: torch.Tensor) -> None:
    """A host (or device) tensor into a static buffer; to the card through
    pinned memory (the pinned block is not reused before the copy has run)."""
    if buf.is_cuda and x.device.type == "cpu":
        x = x.pin_memory()
    buf.copy_(x, non_blocking=True)


def _where(exc: BaseException) -> str:
    """The innermost frame outside torch (and outside this module) of the
    first error: ``exc``, or the error it was raised while handling (a
    capture's end raises again when its body failed)."""
    here = str(Path(__file__).resolve())
    chain, e = [], exc
    while e is not None and all(e is not c for c in chain):
        chain.append(e)
        e = e.__context__
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if not f.filename.startswith(_TORCH_DIR) and f.filename != here]
        if frames:
            f = frames[-1]
            return f"{f.filename}:{f.lineno} in {f.name}: {f.line}"
    return "an unknown frame"


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple          # static input buffers
    out: tuple             # static outputs
    launches: dict         # kernel launches of one replay


class GraphCache:
    """Captured CUDA graphs by key: the machinery of a ``jax.jit`` cache,
    shared by the engine's :class:`StepGraphs` and the training loop's
    ``train.train_step.TrainGraphs``.

    :meth:`run` calls ``body(inputs, side)``, which returns a tuple. On the
    CPU, under :func:`eager` or with ``capture=False`` (a body that reads a
    tensor lying in no :meth:`held` buffer) the body runs eagerly over
    ``inputs`` moved to the device, and no key is made. On the card a key's
    first call runs eagerly over fresh static copies of ``inputs`` (its
    warm-up), its second copies ``inputs`` into those buffers, captures the
    body over them and replays, later calls copy and replay. With
    ``warm_on_side`` the warm-up runs on a side stream, so that autograd's
    lazy state is built outside the graph (the train step); a step program
    has no autograd, and warms up where it runs, so that its activations
    stay in the current stream's memory pool. A capture that fails raises
    :class:`CaptureError`; with ``branches`` the capture hands the body a
    side stream (``side``) to fork a second branch onto. A replay adds the
    kernel launches counted at capture to ``kernels.launch_counts()`` and
    returns the static outputs, which the next replay overwrites.

    ``stats()`` counts live graphs, keys (captured or warm), captures,
    replays, eager steps (each key's first call; every call on the CPU or
    under :func:`eager`), ``unheld`` calls (run eagerly on the card with
    ``capture=False``), the host seconds spent capturing and the bytes the
    graphs' private memory pools reserved. ``trace``, when set to a list,
    receives each replay's program name in launch order (a profile's graph
    launches map onto it). Dropping the object frees its graphs and their
    pools."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: dict[tuple, _Graph] = {}
        self._warm: dict[tuple, tuple] = {}      # key -> input buffers after its first call
        self._held: set[int] = set()             # storages of static outputs and kept buffers
        self._side: Optional[torch.cuda.Stream] = None
        self.trace: Optional[list] = None
        self._stats = {"captures": 0, "replays": 0, "eager_steps": 0, "unheld": 0,
                       "capture_s": 0.0, "pool_bytes": 0}

    def stats(self) -> dict:
        return {"graphs": len(self._graphs), **self._stats,
                "keys": len(self._graphs) + len(self._warm)}

    def programs(self) -> dict:
        """Keys (captured or warm) by program name."""
        out: dict[str, int] = {}
        for key in (*self._graphs, *self._warm):
            out[key[0]] = out.get(key[0], 0) + 1
        return out

    @staticmethod
    def signature(tree) -> tuple:
        """Every tensor's address, dtype, shape and stride: a key's part for
        tensors a graph reads or writes where they lie."""
        return tuple((t.data_ptr(), t.dtype, t.shape, t.stride()) for t in _leaves(tree, []))

    def keep(self, t: torch.Tensor) -> None:
        """Declares ``t`` a buffer its owner keeps while this object lives
        (the engine's verify logits), as a graph's static outputs are."""
        self._held.add(t.untyped_storage().data_ptr())

    def held(self, t: torch.Tensor) -> bool:
        """Whether ``t`` lies in a kept buffer or a graph's static output."""
        return t.untyped_storage().data_ptr() in self._held

    def run(self, program: str, cfg, key: Callable[[], tuple], inputs: tuple,
            body: Callable, *, warm_on_side: bool = False, branches: bool = False,
            capture: bool = True) -> tuple:
        dev = self.device
        captures = self._captures()
        if not (capture and captures):
            self._stats["unheld" if captures else "eager_steps"] += 1
            return body(tuple(t.to(dev) for t in inputs), None)
        k = key()
        g = self._graphs.get(k)
        if g is None:
            bufs = self._warm.get(k)
            if bufs is None:       # the key's first call: eager, the warm-up
                bufs = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev) for t in inputs)
                for b, t in zip(bufs, inputs):
                    _fill(b, t)
                self._warm[k] = bufs
                self._stats["eager_steps"] += 1
                return self._on_side(body, bufs) if warm_on_side else body(bufs, None)
            del self._warm[k]
            for b, t in zip(bufs, inputs):
                _fill(b, t)
            g = self._graphs[k] = self._capture(program, cfg, bufs, body, branches)
            self._held.update(t.untyped_storage().data_ptr() for t in _leaves(g.out, []))
        else:
            for b, t in zip(g.inputs, inputs):
                _fill(b, t)
        from repro_torch.kernels import add_launches

        g.graph.replay()
        add_launches(g.launches)
        self._stats["replays"] += 1
        if self.trace is not None:
            self.trace.append(program)
        return tuple(dict(o) if isinstance(o, dict) else o for o in g.out)

    def _captures(self) -> bool:
        return self.device.type == "cuda" and capture_enabled()

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def _on_side(self, body: Callable, bufs: tuple) -> tuple:
        main = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = body(bufs, None)
        main.wait_stream(side)
        return out

    def _capture(self, program: str, cfg, bufs: tuple, body: Callable,
                 branches: bool) -> _Graph:
        from repro_torch.kernels import add_launches, launch_counts

        dev = self.device
        side = self._side_stream() if branches else None
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = body(bufs, side)
        except Exception as e:  # noqa: BLE001 — re-raised with the culprit named
            raise CaptureError(f"capturing {program} of {getattr(cfg, 'name', 'the pool')} "
                               f"failed at {_where(e)}: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            after = launch_counts()
            add_launches({k: before[k] - after[k] for k in after})   # nothing ran
        self._stats["captures"] += 1
        self._stats["capture_s"] += time.perf_counter() - t0
        self._stats["pool_bytes"] += torch.cuda.memory_reserved(dev) - reserved
        return _Graph(graph, bufs, tuple(out),
                      {k: after[k] - before[k] for k in after if after[k] != before[k]})


class StepGraphs(GraphCache):
    """One engine's captured step programs (its ``jax.jit`` cache).

    A params tree is read-only while an engine serves it (the serving
    artifact's), so its leaves' signature is taken once per tree object and
    keys hold a small id for it: a full-width tree has hundreds of leaves."""

    def __init__(self, device):
        super().__init__(device)
        self._params: dict[int, tuple] = {}      # id(tree) -> (tree, signature id)
        self._param_sigs: dict[tuple, int] = {}

    # ------------------------------------------------------------- programs

    def decode_only_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                         cfg: ModelConfig, mesh=None):
        """The decode-only program; with ``mesh`` the rank's partitioned step
        (``models.model.decode_step(..., mesh=)``), keyed by the mesh too."""
        statics = () if mesh is None else (id(mesh),)
        return self.run("decode_only", cfg,
                        lambda: self.key("decode_only", params, (cache,), (tokens,), cfg,
                                         statics),
                        (tokens,),
                        lambda tks, side: _unit(params, cache, tks[0], cfg, False, mesh))

    def prefill_chunk_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                           cfg: ModelConfig, *, sub_chunk: Optional[int] = None,
                           gemm: bool = False):
        def run(c, tk, g):
            return self.run("prefill_chunk", cfg,
                            lambda: self.key("prefill_chunk", params, (c,), (tk,), cfg, (g,)),
                            (tk,), lambda tks, side: _unit(params, c, tks[0], cfg, g))
        return _prefill(cache, tokens, cfg, sub_chunk, gemm, run)

    def fused_step(self, params: dict, dec_cache: dict, dec_tokens: torch.Tensor,
                   pre_cache: dict, pre_tokens: torch.Tensor, cfg: ModelConfig, *,
                   sub_chunk: Optional[int] = None):
        return self.run(
            "fused", cfg,
            lambda: self.key("fused", params, (dec_cache, pre_cache), (dec_tokens, pre_tokens),
                             cfg, (sub_chunk,)),
            (dec_tokens, pre_tokens),
            lambda tks, side: _fused(params, dec_cache, tks[0], pre_cache, tks[1], cfg,
                                     sub_chunk, side),
            branches=True)

    def sample(self, logits: torch.Tensor, done: torch.Tensor, keys=None, temperature=None,
               top_k=None, top_p=None, *, pad_id: int = 0) -> torch.Tensor:
        """The decode pool's sampling step (the counterpart of the jitted
        ``sample_masked``): ``sampling.sample_masked`` over ``logits`` (B, 1,
        V), or ``sampling.greedy_masked`` when no ``keys`` are given. The
        logits are read where they lie, so their address is part of the key,
        and only logits in a graph's static output or a kept buffer (the
        engine's verify logits) go through a graph: others (a step key's
        eager first call) are sampled eagerly, leaving no key that would
        never replay. The per-lane host inputs (``done``, ``keys``,
        ``temperature``, ``top_k``, ``top_p``) are copied into the
        program's static device buffers from pinned memory. Returns the (B,)
        int32 tokens, a static output on a replay."""
        from repro_torch.serve import sampling

        if keys is None:
            program, inputs = "greedy_sample", (done,)

            def body(xs, side):
                return (sampling.greedy_masked(logits, xs[0], pad_id),)
        else:
            program, inputs = "sample", (done, keys, temperature, top_k, top_p)

            def body(xs, side):
                return (sampling.sample_masked(logits, xs[0], keys=xs[1], temperature=xs[2],
                                               top_k=xs[3], top_p=xs[4], pad_id=pad_id),)
        return self.run(program, None,
                        lambda: self.key(program, None, (logits,), inputs, None, (pad_id,)),
                        inputs, body, capture=self.held(logits))[0]

    def keys_over(self, t: torch.Tensor) -> int:
        """Keys (captured or warm) one of whose cache tensors is ``t``."""
        ptr = t.data_ptr()
        return sum(any(leaf[0] == ptr for leaf in key[4])
                   for key in (*self._graphs, *self._warm))

    def key(self, program: str, params, caches: tuple, tokens: tuple, cfg,
            statics: tuple = ()) -> tuple:
        """A graph's key: the program, ``cfg``, the static arguments, every
        params and cache tensor's address, dtype, shape and stride, and the
        tokens' shapes and dtypes (they are copied into the graph's own
        buffers). The sampling program's "cache" is the logits it reads and
        its "tokens" are the per-lane inputs."""
        return (program, cfg, statics, self._params_id(params), self.signature(caches),
                tuple((t.shape, t.dtype) for t in tokens))

    def _params_id(self, params) -> int:
        got = self._params.get(id(params))
        if got is None:
            sig = self.signature(params)
            got = self._params[id(params)] = (params, self._param_sigs.setdefault(
                sig, len(self._param_sigs)))
        return got[1]
