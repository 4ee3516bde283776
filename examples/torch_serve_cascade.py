"""End-to-end serving example on the PyTorch port: the paper's Fig. 1
deployment topology run several ways on the same request stream.

Port of examples/serve_cascade.py on `repro_torch`:

1. Static cascade: lock-step batches; low-confidence requests are
   regenerated by M_L.
2. Continuous batching with IN-FLIGHT deferral on a slot KV pool: a
   request whose running mean eq.-8 confidence drops below tau - margin
   leaves M_S early, saving the remaining small-model steps.
3. Paged continuous batching on RAGGED traffic over the block-paged KV
   cache, long prefills chunked and interleaved with resident decoding,
   inside a block budget sized for the mean request.
4. Non-blocking M_L: the THREADED large-model backend; its tokens must
   equal the sync run's.
5. A 3-tier cascade ladder (`CascadeSpec`) with a calibrated gate on
   every edge and online tau recalibration.

Runs on the GPU unless --device cpu is given; the sizes are flags, so a
test can make it tiny. The last line of its output is a JSON record of
the results.

    PYTHONPATH=src python examples/torch_serve_cascade.py [--device cpu]
"""
import argparse
import json

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core.calibration import calibrate_edges
from repro_torch.data.synthetic import make_lm_stream, make_ragged_lm_stream
from repro_torch.models import transformer as tfm
from repro_torch.serving import (CascadeEngine, CascadeSpec, CascadeTier,
                                 ContinuousCascadeEngine, DeferralEdge,
                                 EngineConfig, MLBackendConfig, ModelRunner,
                                 PagedConfig, RecalibConfig, make_requests)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--requests", type=int, default=64,
                    help="prompts drawn: half calibrate, half are served")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--ragged", type=int, default=32,
                    help="ragged prompts of the paged run")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    s_cfg = reduced(get_config("qwen1.5-4b"))
    l_cfg = s_cfg.replace(name="qwen-large-proxy", n_layers=4,
                          d_model=2 * s_cfg.d_model, n_heads=8,
                          d_ff=2 * s_cfg.d_ff)
    print(f"M_S: {s_cfg.name} ({s_cfg.n_layers}L x {s_cfg.d_model})  "
          f"M_L: {l_cfg.name} ({l_cfg.n_layers}L x {l_cfg.d_model})  "
          f"on {device}")
    small = ModelRunner(s_cfg, tfm.init_params(s_cfg, 0, device))
    large = ModelRunner(l_cfg, tfm.init_params(l_cfg, 1, device))

    prompt_len, max_new, slots = args.prompt_len, args.max_new, args.slots
    prompts = make_lm_stream([0, 2], args.requests, prompt_len,
                             s_cfg.vocab_size)
    half = args.requests // 2
    cal, live = prompts[:half], prompts[half:]
    record = {"example": "torch_serve_cascade", "device": str(device)}

    engine = CascadeEngine(small, large, cost_small=0.2)
    record["static"] = []
    for target in (0.1, 0.3, 0.6):
        tau = engine.calibrate(cal, prompt_len, max_new, target)
        res = engine.serve(live, prompt_len, max_new)
        print(f"static target deferral={target:.1f}: tau={tau:+.3f} "
              f"realized={res.deferral_ratio:.2f} "
              f"compute={res.compute_cost:.2f}x "
              f"mean g_NENT={res.confidence.mean():+.3f}")
        record["static"].append({"target": target, "tau": round(tau, 4),
                                 "deferral": round(res.deferral_ratio, 4)})

    # continuous batching with in-flight deferral at the 0.3-target tau
    tau = engine.calibrate(cal, prompt_len, max_new, 0.3)
    cont = ContinuousCascadeEngine(
        CascadeSpec.two_tier(small, large, tau=tau, min_tokens=2),
        EngineConfig(n_slots=slots))
    cres = cont.run(make_requests(live, max_new), max_new)
    s = cres.stats
    print(f"continuous ({slots} slots, in-flight deferral): "
          f"{cres.steps} M_S steps for {len(live)} reqs "
          f"(static lock-step would take "
          f"{(len(live) + slots - 1) // slots * (max_new - 1)}), "
          f"early_exits={int(cres.early_exited.sum())}, "
          f"saved_M_S_steps={cres.saved_steps}")
    print(f"  deferral={cres.deferral_ratio:.2f} "
          f"throughput={s['throughput_tok_s']:.1f} tok/s "
          f"p50={s['latency_p50_s'] * 1e3:.0f}ms "
          f"p99={s['latency_p99_s'] * 1e3:.0f}ms")
    print("sample continuations (first 3):")
    for row in cres.tokens[:3]:
        print("  ", row.tolist())
    record["continuous"] = {"steps": int(cres.steps),
                            "deferral": round(cres.deferral_ratio, 4),
                            "saved_steps": int(cres.saved_steps)}

    # ragged mixed-length traffic over the block-paged cache
    ragged = make_ragged_lm_stream([0, 3], args.ragged, 6, 24,
                                   s_cfg.vocab_size)
    mean_len = int(np.mean([p.shape[0] for p in ragged]))
    bs = 8
    n_blocks = max(slots * ((mean_len + max_new) // bs + 1),
                   (24 + max_new) // bs + 1)
    paged = ContinuousCascadeEngine(
        CascadeSpec.two_tier(small, large, tau=tau, min_tokens=2),
        EngineConfig(n_slots=slots, backend="paged",
                     paged=PagedConfig(block_size=bs, n_blocks=n_blocks,
                                       prefill_chunk=8)))
    pres = paged.run(make_requests(ragged, max_new), max_new)
    ps = pres.stats
    print(f"paged ragged (prompts 6..24 tokens, {n_blocks} x {bs}-token "
          f"blocks = {n_blocks * bs} cache tokens vs slot worst case "
          f"{slots * (24 + max_new)}): deferral={pres.deferral_ratio:.2f} "
          f"throughput={ps['throughput_tok_s']:.1f} tok/s "
          f"peak_blocks={ps['peak_blocks']} "
          f"prefill_chunks={ps['prefill_chunks']}")
    record["paged"] = {"deferral": round(pres.deferral_ratio, 4),
                       "peak_blocks": int(ps["peak_blocks"]),
                       "prefill_chunks": int(ps["prefill_chunks"])}

    # non-blocking M_L: deferrals regenerate on a worker thread while M_S
    # decodes; outputs must match the sync run bit-exactly
    threaded = ContinuousCascadeEngine(
        CascadeSpec.two_tier(small, large, tau=tau, min_tokens=2),
        EngineConfig(n_slots=slots, ml=MLBackendConfig(kind="thread",
                                                       large_batch=4,
                                                       max_wait=0.02)))
    tres = threaded.run(make_requests(live, max_new), max_new)
    ts = tres.stats
    if not np.array_equal(tres.tokens, cres.tokens):
        raise AssertionError("the threaded M_L backend changed the outputs")
    print(f"threaded M_L backend: same tokens as sync, "
          f"{ts['ml_batches']} M_L batches "
          f"(occupancy {ts['ml_batch_occupancy']:.2f}), "
          f"queue depth peak {ts['ml_queue_depth_peak']}")
    record["threaded_same_tokens"] = True

    # 3-tier ladder with every edge calibrated on the traffic reaching it,
    # plus the online tau controller holding the target ratio
    m_cfg = s_cfg.replace(name="qwen-mid-proxy", n_layers=3,
                          d_ff=2 * s_cfg.d_ff)
    mid = ModelRunner(m_cfg, tfm.init_params(m_cfg, 4, device))
    spec = CascadeSpec(
        tiers=[CascadeTier(s_cfg.name, runner=small, cost=0.2),
               CascadeTier(m_cfg.name, runner=mid, cost=0.45),
               CascadeTier(l_cfg.name, runner=large, cost=1.0)],
        edges=[DeferralEdge(min_tokens=2), DeferralEdge()])
    taus = calibrate_edges(spec, cal, max_new=max_new,
                           prompt_len=prompt_len, deferral_ratio=0.3)
    ladder = ContinuousCascadeEngine(
        spec, EngineConfig(n_slots=slots,
                           recalibration=RecalibConfig(warmup=8),
                           recalib_target=0.3))
    lres = ladder.run(make_requests(live, max_new), max_new)
    ls = lres.stats
    print(f"3-tier ladder (taus {taus[0]:+.3f}/{taus[1]:+.3f}): "
          f"tier_served={ls['tier_served']} "
          f"edge_deferrals={ls['edge_deferrals']} "
          f"compute={ls['compute_cost']:.2f}x")
    rc = ls["recalibration"]
    print(f"  online recalibration: tau_final="
          f"{[round(t, 3) for t in rc['tau_final']]} "
          f"updates={rc['tau_updates']} ewma={rc['ewma_ratio']}")
    record["ladder"] = {"tier_served": ls["tier_served"],
                        "compute": round(float(ls["compute_cost"]), 4)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
