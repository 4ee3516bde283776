"""Cascade serving CLI for the port: small + large model, Gatekeeper
deferral, on CUDA by default.

Counterpart of `repro.launch.serve` with the same flags, defaults and
argparse-time rejections of contradictory combinations. Flags for what
the port does not run yet are rejected by name at argparse time (see
ROADMAP.md): architectures of unported families, ladders of more than
two tiers, the semantic-agreement signal, online recalibration, and the
/metrics endpoint and profiler flags. Memory pressure (--oversubscribe,
--pressure-policy, --max-preemptions, --swap-blocks), admission overload
control (--max-queue, --deadline-ms) and the M_L backends run as in JAX,
with its validations: --large-backend sync (inline), thread (a worker
thread, on a CUDA stream of its own on the card), stub (serialized pipe,
--stub-latency), socket (one M_L server: --ml-address host:port, started
with `python -m repro_torch.launch.ml_server`) or pool (several, with
health checks and re-dispatch); --ml-spawn N starts N in-process servers
instead. One flag is new: --device (default: cuda, which must exist).
`--arch` takes the JAX CLI's decoders, reduced as JAX reduces them:
internlm2-1.8b and llama3-405b (dense GQA), qwen1.5-4b and qwen1.5-32b
(dense MHA with a QKV bias), deepseek-v2-236b (MLA + MoE),
kimi-k2-1t-a32b (GQA + MoE), rwkv6-3b (RWKV6, attention-free) and
zamba2-1.2b (Mamba2 with a shared attention block): the last two on the
slot backend only, as in JAX, whose paged pool refuses a recurrent state.
whisper-small and phi-3-vision-4.2b take frames or patches, which the
engine does not take (nor does JAX's): refused at argparse time; they run
through `launch.steps`.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 \\
        --max-new 8 --engine continuous --backend paged --ragged-min 8 \\
        --ragged-max 32 --block-size 8 --prefill-chunk 8

    # M_L in another process (same --arch, --seed, --max-new and --device)
    PYTHONPATH=src python -m repro_torch.launch.ml_server --port 7070
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --large-backend socket --ml-address 127.0.0.1:7070
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.data.synthetic import make_lm_stream, make_ragged_lm_stream
from repro_torch.models import transformer as tfm
from repro_torch.serving import (CascadeEngine, CascadeSpec, CascadeTier,
                                 ContinuousCascadeEngine, DeferralEdge,
                                 EngineConfig, MLBackendConfig, ModelRunner,
                                 PagedConfig, PressureConfig, make_requests,
                                 poisson_arrivals)
from repro_torch.serving.obs import (Observability, add_obs_args,
                                     obs_config_from_args)
from repro_torch.serving.obs.config import UNPORTED_FLAGS
from repro_torch.serving.paged_pool import validate_pageable

# flags of the JAX CLI whose features are not ported yet (dest, flag)
_UNPORTED = (("recalibrate", "--recalibrate"),
             ("recalib_target", "--recalib-target"),
             ("recalib_step", "--recalib-step"),
             ("recalib_deadband", "--recalib-deadband"),
             ("recalib_warmup", "--recalib-warmup"),
             ("signal_k", "--signal-k"),
             ("signal_temperature", "--signal-temperature"),
             ) + UNPORTED_FLAGS


def _tier_seed(seed: int, tier: int) -> int:
    return int(np.random.SeedSequence([seed, tier]).generate_state(1)[0])


def build_ladder(arch: str, seed: int, n_tiers: int, reduce: bool = True,
                 device=None):
    """One ModelRunner per tier: tier 0 is `arch` (its `reduced` variant
    unless reduce=False, which keeps the published widths), the last tier
    the demo "large" model (see `ladder_from_config`)."""
    if n_tiers != 2:
        raise NotImplementedError(f"{n_tiers}-tier ladders are not ported "
                                  f"yet (see ROADMAP.md)")
    small_cfg = get_config(arch)
    return ladder_from_config(reduced(small_cfg) if reduce else small_cfg,
                              seed, device)


def build_runners(arch: str, seed: int, device=None):
    """(small, large, small's config): the reduced two-tier ladder, as
    the JAX CLI builds it. An M_L server and an engine built from the same
    `arch` and `seed` on one device type hold the same large weights."""
    small, large = build_ladder(arch, seed, 2, device=device)
    return small, large, small.cfg


def large_tier_config(small_cfg: ModelConfig) -> ModelConfig:
    """The demo "large" tier over `small_cfg`: 4 layers, twice the width
    and FFN, 8 query heads, as JAX's `build_ladder` makes it. Its KV heads
    are the small tier's, except where those exceed the 8 query heads
    (qwen1.5's MHA at 20 and 40 heads, published width only): an
    attention with more KV heads than query heads is no GQA, so such a
    dense or MoE tier without MLA keeps 8 KV heads, one per query head.
    Every config whose large tier JAX builds (the reduced ones) is
    untouched."""
    cfg = small_cfg.replace(
        name=small_cfg.name + "-large", n_layers=4,
        d_model=small_cfg.d_model * 2, n_heads=8, d_ff=small_cfg.d_ff * 2)
    if (cfg.family in ("dense", "moe") and cfg.mla is None
            and cfg.n_kv_heads > cfg.n_heads):
        cfg = cfg.replace(n_kv_heads=cfg.n_heads)
    return cfg


def tier_runner(small_cfg: ModelConfig, seed: int, tier: int, device=None
                ) -> ModelRunner:
    """One tier of `ladder_from_config`'s ladder alone, with the same
    seeded weights (an M_L server process builds only tier 1): tier 0 is
    `small_cfg`, tier 1 `large_tier_config(small_cfg)`."""
    cfg = small_cfg if tier == 0 else large_tier_config(small_cfg)
    return ModelRunner(cfg, tfm.init_params(cfg, _tier_seed(seed, tier),
                                            resolve_device(device)))


def ladder_from_config(small_cfg: ModelConfig, seed: int, device=None):
    """The two-tier ladder over a resolved tier-0 config (`tier_runner`'s
    two tiers). Weights are random, seeded per tier."""
    device = resolve_device(device)
    return [tier_runner(small_cfg, seed, i, device) for i in (0, 1)]


def make_remote_factory(kind: str, addresses, *, connect_timeout: float,
                        request_timeout: float, retries: int,
                        health_interval: float):
    """Callable `large_backend` for the engine: builds the socket/pool
    backend with the engine-supplied context (max_new, metrics registry)
    plus the addresses/timeouts closed over here. The runner argument is
    ignored — with a remote tier, M_L compute lives in the server."""
    from repro_torch.serving.remote import ReplicaPool, SocketBackend

    def factory(runner=None, max_new=0, large_batch=None, max_wait=None,
                stub_latency=0.0, registry=None):
        if kind == "socket":
            return SocketBackend(addresses[0],
                                 connect_timeout=connect_timeout,
                                 request_timeout=request_timeout,
                                 retries=retries, registry=registry)
        return ReplicaPool(addresses,
                           connect_timeout=connect_timeout,
                           request_timeout=request_timeout,
                           retries=retries,
                           health_interval=health_interval,
                           max_new=max_new, large_batch=large_batch,
                           registry=registry)

    return factory


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--deferral-ratio", type=float, default=0.3)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--min-tokens", type=int, default=2)
    ap.add_argument("--margin", type=float, default=0.0)
    ap.add_argument("--no-early-exit", action="store_true")
    ap.add_argument("--tiers", type=int, default=2,
                    help="cascade ladder depth (only 2 is ported)")
    ap.add_argument("--signal",
                    choices=("mean_confidence", "semantic_agreement"),
                    default="mean_confidence",
                    help="deferral signal (only mean_confidence is ported)")
    ap.add_argument("--signal-k", type=int, default=4)
    ap.add_argument("--signal-temperature", type=float, default=0.8)
    ap.add_argument("--recalibrate", action="store_true")
    ap.add_argument("--recalib-target", type=float, default=-1.0)
    ap.add_argument("--recalib-step", type=float, default=0.08)
    ap.add_argument("--recalib-deadband", type=float, default=0.1)
    ap.add_argument("--recalib-warmup", type=int, default=32)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals/s; 0 = all at t=0")
    ap.add_argument("--large-backend",
                    choices=("sync", "thread", "stub", "socket", "pool"),
                    default="sync",
                    help="M_L regeneration backend: inline (sync), "
                         "worker thread overlapped with M_S decode, on a "
                         "CUDA stream of its own on the card (thread), "
                         "serialized RPC stub (stub), one remote M_L "
                         "server (socket), or N replicas with health "
                         "checks + re-dispatch (pool)")
    ap.add_argument("--ml-address", default="",
                    help="socket/pool: comma-separated host:port of "
                         "running M_L servers (repro_torch.launch."
                         "ml_server); empty with --ml-spawn starts "
                         "in-process servers")
    ap.add_argument("--ml-spawn", type=int, default=0,
                    help="socket/pool: start this many in-process M_L "
                         "servers on ephemeral ports instead of "
                         "connecting to --ml-address")
    ap.add_argument("--ml-connect-timeout", type=float, default=2.0)
    ap.add_argument("--ml-request-timeout", type=float, default=30.0)
    ap.add_argument("--ml-retries", type=int, default=3,
                    help="socket/pool: RPC retry attempts "
                         "(exponential backoff) before giving up")
    ap.add_argument("--ml-health-interval", type=float, default=2.0,
                    help="pool: seconds between replica health probes")
    ap.add_argument("--large-batch", type=int, default=0,
                    help="M_L regeneration batch size (0 = one "
                         "exact-size batch at end of run)")
    ap.add_argument("--large-max-wait", type=float, default=0.0,
                    help="seconds a partial M_L batch may wait before "
                         "flushing padded (0 = wait for a full batch)")
    ap.add_argument("--stub-latency", type=float, default=0.0,
                    help="injected per-batch RPC latency for "
                         "--large-backend stub")
    ap.add_argument("--audit-log", default=None,
                    help="JSONL audit log path (continuous engine)")
    ap.add_argument("--backend", choices=("slot", "paged"), default="slot",
                    help="continuous engine KV-cache backend")
    ap.add_argument("--block-size", type=int, default=8,
                    help="paged backend: tokens per cache block")
    ap.add_argument("--blocks", type=int, default=0,
                    help="paged backend: physical block budget "
                         "(0 = worst case, always fits)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="paged backend: prefill chunk tokens "
                         "(0 = whole prompt in one chunk)")
    ap.add_argument("--paged-kernel", choices=("auto", "on", "off"),
                    default="auto",
                    help="paged backend: route decode, prefill "
                         "attention and the deferral signal through the "
                         "CUDA kernels (auto = on for CUDA tensors; env "
                         "REPRO_PAGED_KERNEL overrides auto)")
    ap.add_argument("--serial-prefill", action="store_true",
                    help="paged backend: disable batched same-offset "
                         "prefill chunk dispatch")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="paged backend: disable copy-on-write prefix "
                         "sharing")
    ap.add_argument("--oversubscribe", type=float, default=1.0,
                    help="paged backend: admit against a virtual budget "
                         "of round(blocks * factor); > 1.0 allows block "
                         "pressure, handled by --pressure-policy "
                         "(1.0 = classic reservation invariant)")
    ap.add_argument("--pressure-policy",
                    choices=("preempt", "defer", "shed"), default="preempt",
                    help="paged backend under --oversubscribe > 1: evict "
                         "the youngest running request by preempt-and-"
                         "requeue (bit-exact resume), defer-on-OOM to "
                         "M_L, or shed (REJECTED)")
    ap.add_argument("--max-preemptions", type=int, default=2,
                    help="preempt policy: preemption bound per request "
                         "before escalating to defer-on-OOM")
    ap.add_argument("--swap-blocks", type=int, default=0,
                    help="paged backend: host-RAM swap-tier capacity in "
                         "blocks for cold registered prefix blocks "
                         "(0 = evicted cold blocks are dropped)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission overload control: bound on the ready "
                         "arrival queue; overflow is shed newest-first "
                         "as REJECTED (0 = unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request queueing deadline in ms from "
                         "arrival; requests still queued past it are "
                         "shed as EXPIRED (0 = no deadlines)")
    ap.add_argument("--ragged-min", type=int, default=0,
                    help=">0: ragged prompt lengths uniform in "
                         "[ragged-min, ragged-max] (continuous engine)")
    ap.add_argument("--ragged-max", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    add_obs_args(ap)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    def given(dest: str) -> bool:
        return getattr(args, dest) != ap.get_default(dest)

    if args.ragged_min > 0 and args.engine == "static":
        ap.error("--ragged-min/--ragged-max need --engine continuous "
                 "(the static engine serves lock-step uniform batches)")
    obs_cfg = obs_config_from_args(args)
    if args.engine == "static" and obs_cfg.any_enabled:
        ap.error("observability flags (--trace-out/--metrics-out/"
                 "--device-timing) need --engine continuous")
    # reject contradictory flag combinations up front: a tuning flag that
    # the selected backend/engine would silently ignore is a user error,
    # not a no-op
    remote = args.large_backend in ("socket", "pool")
    if not remote:
        for dest in ("ml_address", "ml_spawn", "ml_connect_timeout",
                     "ml_request_timeout", "ml_retries",
                     "ml_health_interval"):
            if given(dest):
                ap.error(f"--{dest.replace('_', '-')} needs "
                         f"--large-backend socket|pool (got "
                         f"--large-backend {args.large_backend}, which "
                         f"would silently ignore it)")
    if args.large_backend != "stub" and given("stub_latency"):
        ap.error(f"--stub-latency needs --large-backend stub (got "
                 f"--large-backend {args.large_backend}, which would "
                 f"silently ignore it)")
    if args.backend != "paged":
        for dest in ("block_size", "blocks", "prefill_chunk",
                     "paged_kernel", "serial_prefill", "no_prefix_sharing",
                     "oversubscribe", "pressure_policy", "max_preemptions",
                     "swap_blocks"):
            if given(dest):
                ap.error(f"--{dest.replace('_', '-')} needs --backend "
                         f"paged (got --backend {args.backend}, which "
                         f"would silently ignore it)")
    if args.oversubscribe < 1.0:
        ap.error(f"--oversubscribe must be >= 1.0 (1.0 = reservation-"
                 f"only), got {args.oversubscribe}")
    if args.oversubscribe == 1.0:
        # pressure can only fire past the reservation invariant: tuning
        # its handling without enabling it is a silent no-op
        for dest in ("pressure_policy", "max_preemptions"):
            if given(dest):
                ap.error(f"--{dest.replace('_', '-')} needs "
                         f"--oversubscribe > 1.0 (reservation-only "
                         f"admission never hits block pressure)")
    if args.pressure_policy != "preempt" and given("max_preemptions"):
        ap.error(f"--max-preemptions needs --pressure-policy preempt "
                 f"(got --pressure-policy {args.pressure_policy}, which "
                 f"never preempts)")
    if args.oversubscribe > 1.0 and not given("blocks"):
        ap.error("--oversubscribe > 1.0 needs an explicit --blocks "
                 "budget (the worst-case default never runs out)")
    if args.max_queue < 0:
        ap.error(f"--max-queue must be >= 0, got {args.max_queue}")
    if args.deadline_ms < 0:
        ap.error(f"--deadline-ms must be >= 0, got {args.deadline_ms}")
    if args.tiers < 2:
        ap.error(f"--tiers must be >= 2, got {args.tiers}")
    if remote:
        if args.tiers != 2:
            ap.error("--large-backend socket|pool drives the final "
                     "(remote) tier of a 2-tier cascade; --tiers > 2 "
                     "needs a local backend per intermediate tier")
        if args.ml_spawn <= 0 and not args.ml_address:
            ap.error("--large-backend socket/pool needs --ml-address "
                     "host:port[,host:port...] or --ml-spawn N")
        if (args.large_backend == "socket" and args.ml_address
                and len(args.ml_address.split(",")) != 1):
            ap.error("--large-backend socket takes exactly one "
                     "--ml-address; use --large-backend pool for several")
    # what the port does not run yet: rejected by name, never ignored
    unported = [flag for dest, flag in _UNPORTED if given(dest)]
    if args.tiers != 2:
        unported.append(f"--tiers {args.tiers}")
    if args.signal != "mean_confidence":
        unported.append(f"--signal {args.signal}")
    if unported:
        ap.error(f"{', '.join(unported)}: not ported to repro_torch yet "
                 f"(see ROADMAP.md)")
    try:
        arch_cfg = get_config(args.arch)
        tfm.check_ported(arch_cfg, engine=True)
    except (NotImplementedError, ValueError) as e:
        ap.error(f"--arch {args.arch}: {e}")
    if args.backend == "paged":
        try:
            validate_pageable(arch_cfg, args.prompt_len + args.max_new)
        except NotImplementedError as e:
            ap.error(f"--backend paged --arch {args.arch}: {e}")

    device = resolve_device(args.device)
    small, large = build_ladder(args.arch, args.seed, 2, device=device)
    small_cfg = small.cfg

    ragged = args.ragged_min > 0
    cal_len = ((args.ragged_min + max(args.ragged_max, args.ragged_min))
               // 2 if ragged else args.prompt_len)
    cal = make_lm_stream([args.seed, 1], args.requests, cal_len,
                         small_cfg.vocab_size)
    if ragged:
        live = make_ragged_lm_stream(
            [args.seed, 2], args.requests, args.ragged_min,
            max(args.ragged_max, args.ragged_min), small_cfg.vocab_size)
    else:
        live = make_lm_stream([args.seed, 2], args.requests,
                              args.prompt_len, small_cfg.vocab_size)

    if args.engine == "static":
        engine = CascadeEngine(small, large)
        tau = engine.calibrate(cal, args.prompt_len, args.max_new,
                               args.deferral_ratio)
        print(f"calibrated tau={tau:.4f} for target deferral "
              f"{args.deferral_ratio}")
        res = engine.serve(live, args.prompt_len, args.max_new)
        print(f"served {len(live)} requests on {device}: deferral_ratio="
              f"{res.deferral_ratio:.3f}, compute_cost={res.compute_cost:.3f}x,"
              f" mean_confidence={res.confidence.mean():.4f}")
        print("first tokens:", res.tokens[:4].tolist())
        return res

    ml_servers = []
    large_backend = args.large_backend
    if remote:
        if args.ml_spawn > 0:
            from repro_torch.serving.remote import MLServer
            n = max(args.ml_spawn,
                    2 if args.large_backend == "pool" else 1)
            for _ in range(n):
                ml_servers.append(MLServer(
                    large, max_new=args.max_new,
                    large_batch=args.large_batch or None,
                    max_wait=args.large_max_wait or None).start())
            addresses = [srv.address for srv in ml_servers]
            print(f"spawned {n} in-process M_L server(s): "
                  + ", ".join(f"{h}:{p}" for h, p in addresses))
        else:
            addresses = args.ml_address.split(",")
        large_backend = make_remote_factory(
            args.large_backend, addresses,
            connect_timeout=args.ml_connect_timeout,
            request_timeout=args.ml_request_timeout,
            retries=args.ml_retries,
            health_interval=args.ml_health_interval)

    spec = CascadeSpec(
        tiers=[CascadeTier(small_cfg.name, runner=small, cost=0.2),
               CascadeTier(large.cfg.name, runner=large, cost=1.0,
                           backend=large_backend if remote else None)],
        edges=[DeferralEdge(margin=args.margin, min_tokens=args.min_tokens)])
    pressure = (PressureConfig(oversubscribe=args.oversubscribe,
                               policy=args.pressure_policy,
                               max_preemptions=args.max_preemptions,
                               swap_blocks=args.swap_blocks)
                if args.oversubscribe > 1.0 or args.swap_blocks > 0
                else None)
    config = EngineConfig(
        n_slots=args.slots, early_exit=not args.no_early_exit,
        backend=args.backend,
        max_queue=args.max_queue or None,
        deadline_s=args.deadline_ms / 1e3 if args.deadline_ms else None,
        paged=PagedConfig(
            block_size=args.block_size,
            n_blocks=args.blocks or None,
            prefill_chunk=args.prefill_chunk or None,
            paged_kernel={"auto": None, "on": True,
                          "off": False}[args.paged_kernel],
            batch_prefill=not args.serial_prefill,
            prefix_sharing=not args.no_prefix_sharing,
            pressure=pressure),
        ml=MLBackendConfig(kind="sync" if remote else args.large_backend,
                           large_batch=args.large_batch or None,
                           max_wait=args.large_max_wait or None,
                           stub_latency=args.stub_latency))
    engine = ContinuousCascadeEngine(spec, config)
    tau = engine.calibrate(cal, cal_len, args.max_new, args.deferral_ratio)
    print(f"calibrated tau {tau:.4f} for target deferral "
          f"{args.deferral_ratio}")
    arrivals = (poisson_arrivals(len(live), args.arrival_rate, args.seed)
                if args.arrival_rate > 0 else None)
    reqs = make_requests(live, args.max_new, arrivals)
    obs = Observability(obs_cfg)
    try:
        res = engine.run(reqs, args.max_new, audit_path=args.audit_log,
                         obs=obs)
    finally:
        obs.finish()
        for srv in ml_servers:
            srv.stop()
    print(f"served {len(live)} requests on {args.slots} slots "
          f"({args.backend} backend, M_L via {args.large_backend}, "
          f"{device}) in "
          f"{res.steps} M_S steps: deferral_ratio={res.deferral_ratio:.3f}, "
          f"early_exits={int(res.early_exited.sum())}, "
          f"saved_M_S_steps={res.saved_steps}")
    if pressure is not None or args.max_queue or args.deadline_ms:
        st = res.stats
        print(f"pressure/overload: preemptions={st['n_preemptions']}, "
              f"oom_deferrals={st['oom_deferrals']}, "
              f"rejected={st['n_rejected']}, expired={st['n_expired']}, "
              f"swap_outs={st.get('swap_outs', 0)}, "
              f"swap_ins={st.get('swap_ins', 0)}")
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in res.stats.items()}, indent=1))
    if args.audit_log:
        print(f"audit log written to {args.audit_log}")
    if args.trace_out:
        print(f"trace written to {args.trace_out}")
    if args.metrics_out:
        print(f"metrics scrape written to {args.metrics_out}")
    print("first tokens:", res.tokens[:4].tolist())
    return res


if __name__ == "__main__":
    main()
