"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch
llama3-8b --smoke --mode lbim`` — request-level generation through the
CD-PIM-mode engine on the card (``--device cuda``, the default) or on the
CPU (``--device cpu``, the plain PyTorch versions).

It takes every flag of ``repro.launch.serve``. The model is prepared once
(``ServingModel.prepare``: random weights from a seeded ``torch.Generator``,
W8A8 images under ``--quantized-decode``), then every request rides its own
``GenerationRequest``: budget, eos, sampling (``--temperature/--top-k/
--top-p/--seed``) and, with ``--stream``, a callback printing tokens as they
emit. ``--shared-prefix N`` gives every request the same N-token system
prompt for ``--prefix-cache`` (on by default) to reuse. ``--faults SEED``
injects a seeded ``FaultPlan``; ``--ttft-deadline``/``--deadline`` bound each
request in engine steps. ``--arrival-rate R`` drives the requests through a
seeded Poisson arrival process (R arrivals per engine step), ``--trace FILE``
replays a saved ``serve.traffic`` trace, and ``--mode-policy auto`` installs
the per-step SLO-aware policy in place of the ``--mode`` pin. Every run
prints the tokens, the latency summary on the engine-step clock, and the
health counters with the pool's occupancy. Every arch of the JAX package is
registered; ``seamless-m4t-large-v2`` fails at admission, as the JAX CLI does
(served requests carry no source frames).

``main(argv)`` runs in-process and returns 0.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.pim_modes import Mode, SloAwarePolicy
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serve import traffic
from repro_torch.serve.api import GenerationRequest, SamplingParams
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.serving_model import ServingModel
from repro_torch.serve.spec import SpecConfig

def _params(cfg, seed: int, device: torch.device) -> dict:
    return init_params(cfg, torch.Generator(device=device).manual_seed(seed), device=device)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels; the default) or cpu (plain versions)")
    ap.add_argument("--mode", choices=[m.value for m in Mode], default="hbcem")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire a slot the step it emits this token "
                         "(default: the arch config's eos_id)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (exact argmax); >0 samples")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus cutoff in (0, 1] (1 = disabled)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed of each request's private RNG lane (request i uses "
                         "seed + i) and of the arrival process")
    ap.add_argument("--quantized-decode", action="store_true",
                    help="route decode projections through the pre-quantized W8A8 "
                         "PIM-GEMV kernel (quantized at load)")
    ap.add_argument("--spec-draft", default=None, metavar="ARCH",
                    help="speculative decoding: prepare this arch as the draft model "
                         "(the target arch itself for a self-draft)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft depth per verify round (with --spec-draft)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction, default=True,
                    help="share content-hashed prompt-prefix blocks across requests")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many identical system-prompt tokens to every "
                         "request (demonstrates prefix reuse)")
    ap.add_argument("--stream", action="store_true",
                    help="print each token the step it is emitted")
    ap.add_argument("--faults", type=int, default=None, metavar="SEED",
                    help="inject a seeded FaultPlan (alloc failures, kernel faults, NaN "
                         "logits, slow steps) and print the ladder and the plan after")
    ap.add_argument("--ttft-deadline", type=int, default=None,
                    help="per-request first-token deadline in engine steps")
    ap.add_argument("--deadline", type=int, default=None,
                    help="per-request total deadline in engine steps")
    ap.add_argument("--arrival-rate", type=float, default=None, metavar="R",
                    help="Poisson arrival process at mean R requests per engine step "
                         "(seeded by --seed)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="replay a saved serve.traffic trace file instead of generating "
                         "requests (overrides --arrival-rate)")
    ap.add_argument("--mode-policy", default=None, choices=["auto"] + [m.value for m in Mode],
                    help="per-step mode policy: 'auto' = SLO-aware LBIM/HBCEM choice each "
                         "step; a mode name pins it (as --mode)")
    return ap.parse_args(argv)


def build_requests(args, vocab: int) -> list[GenerationRequest]:
    """The run's requests: a replayed trace, a Poisson trace, or a fixed set."""
    if args.trace is not None or args.arrival_rate is not None:
        if args.trace is not None:
            trace = traffic.TrafficTrace.load(args.trace)
            print(f"traffic: replaying {len(trace.requests)} requests from {args.trace}")
        else:
            trace = traffic.generate(traffic.TrafficConfig(
                n_requests=args.requests, seed=args.seed, rate=args.arrival_rate,
                prompt_len=(args.prompt_len, args.prompt_len),
                max_new=(args.max_new, args.max_new), vocab=vocab,
                ttft_deadline=args.ttft_deadline, deadline=args.deadline))
            print(f"traffic: poisson rate={args.arrival_rate}/step seed={args.seed} "
                  f"({len(trace.requests)} requests)")
        return trace.to_requests()
    rng = np.random.default_rng(0)
    shared = list(map(int, rng.integers(1, vocab, args.shared_prefix)))
    reqs = []
    for i in range(args.requests):
        prompt = shared + list(map(int, rng.integers(1, vocab, args.prompt_len)))
        on_token = ((lambda t, i=i: print(f"  [stream] req{i} -> {t}", flush=True))
                    if args.stream else None)
        reqs.append(GenerationRequest(
            prompt=prompt, max_new_tokens=args.max_new, eos_id=args.eos_id,
            sampling=SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                    top_p=args.top_p, seed=args.seed + i),
            on_token=on_token, ttft_deadline=args.ttft_deadline, deadline=args.deadline))
    return reqs


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)   # cuda without a card raises here
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.quantized_decode:
        cfg = cfg.replace(quantized_decode=True)
    reqs = build_requests(args, cfg.vocab_size)
    # room for the longest request (a replayed trace may exceed the flags' lengths)
    max_len = max([args.prompt_len + args.max_new + 8]
                  + [len(r.prompt) + r.max_new_tokens for r in reqs])
    sm = ServingModel.prepare(cfg, _params(cfg, 0, dev), slots=args.slots, max_len=max_len,
                              device=dev)
    print(f"prepared {cfg.name}: device={dev} prequantized={sm.prequantized}")
    spec = None
    if args.spec_draft is not None:
        dcfg = get_config(args.spec_draft, smoke=args.smoke)
        dsm = sm if dcfg.name == cfg.name else ServingModel.prepare(
            dcfg, _params(dcfg, 1, dev), slots=args.slots, max_len=max_len, device=dev)
        spec = SpecConfig(draft=dsm, k=args.spec_k)
        print(f"speculative decoding: draft={dcfg.name} k={args.spec_k}")

    policy = None
    mode = Mode(args.mode)
    if args.mode_policy == "auto":
        policy = SloAwarePolicy()
    elif args.mode_policy is not None:
        mode = Mode(args.mode_policy)
    eng = sm.engine(mode=mode, chunk=args.chunk, prefix_cache=args.prefix_cache, spec=spec,
                    step_policy=policy)
    if args.faults is not None:
        eng.fault_plan = FaultPlan.seeded(args.faults)
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    rep = eng.schedule_report()
    print(f"mode={args.mode_policy or args.mode} generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) schedule={rep.to_json()}")
    # latency + SLO summary always (engine-step clock)
    lat = rep["latency"]
    ttft, tpot, qw = lat["ttft_steps"], lat["tpot_steps"], lat["queue_wait_steps"]
    print(f"latency (steps): ttft p50={ttft.get('p50')} p95={ttft.get('p95')} "
          f"p99={ttft.get('p99')} | tpot p50={tpot.get('p50')} p95={tpot.get('p95')} | "
          f"queue-wait p50={qw.get('p50')} p95={qw.get('p95')}")
    slo = lat.get("slo")
    if slo is not None:
        print(f"SLO attainment: {slo['met']}/{lat['requests']} ({slo['attainment']:.2%}; "
              f"{slo['declared']} requests declared deadlines) mode_steps={rep['mode_steps']}")
    if eng.prefix_cache:
        print(f"prefix cache: {rep['prefix']['prefix_hits']} hits / "
              f"{rep['prefix']['prefix_lookups']} lookups, "
              f"{rep['reused_prefix_tokens']} prefill tokens skipped")
    if spec is not None:
        sp = rep["spec"]
        print(f"spec: {sp['rounds']} rounds, accepted {sp['accepted']}/{sp['proposed']} "
              f"drafts (rate {sp['acceptance_rate']:.2f}), {sp['draft_steps']} draft GEMV "
              f"steps, {sp['verify_tokens']} verify tokens")
    for i, r in enumerate(results[:3]):
        print(f"  req{i} ({r.state.value}/{r.finish_reason}): {r.tokens}")
    # health + occupancy always: a clean run prints its zeros, the evidence that
    # nothing leaked or failed
    h = eng.health()
    occ = h["occupancy"]
    print(f"health: degraded={h['degraded']} counters={h['counters']}")
    print(f"occupancy: slots {occ['slots_used']}/{occ['slots_total']} "
          f"pages {occ['pages_used']}/{occ['pages_total']} prefix_pins={occ['prefix_pins']}")
    if args.faults is not None:
        print(f"ladder: {h['ladder']} fault_plan: {h['fault_plan']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
