"""How far `chip_smoke.py` phase 19b's prefill check sits from a wrong
prefill attention, on the CPU.

    PYTHONPATH=src python3 tools/prefill_fault_probe.py [--layers 8]
        [--batch 2] [--seq 512] [--threads 4]

Phase 19b (iv) holds internlm2-1.8b's bf16 prefill with the
`flash_attention` kernel against the plain prefill by the K/V that every
layer writes: the largest relative difference of one position's K or V
(its KV heads x head dim) over the layers, rows and positions, and the
last position's logits. This script measures both readings at
internlm2-1.8b's published widths (cut in depth), bf16 activations and
N(0, 0.02) leaves from seed 0 (`launch.dryrun.materialize`, as 19b draws
them), with the prefill attention of the kernel path (on the CPU, the
kernel's plain version) replaced in turn by:

  plain version   the kernel's plain version (one fp32 softmax) against
                  the plain path's chunked attention: bf16 reordering only
  one future key  each query also sees the key after its own
  last tile's V   the V of the last 64 keys read as zero
  first key's V   the V of key 0 read as zero
  scale 1/hd      the softmax scale 1/hd for 1/sqrt(hd)
  out x (1+2^-8)  the output one part in 256 high, under one bf16 step

It prints one line each and, last, one JSON object of every reading.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import InputShape, get_config
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import dryrun, specs
from repro_torch.models import transformer as tfm
from repro_torch.sharding import MeshLayout


def _future_key(q, k, v, q_offset=0, **kw):
    return flash_attention_plain(q, k, v, q_offset=q_offset + 1, **kw)


def _last_tile_v(q, k, v, **kw):
    v = v.clone()
    v[:, -64:] = 0
    return flash_attention_plain(q, k, v, **kw)


def _first_key_v(q, k, v, **kw):
    v = v.clone()
    v[:, :1] = 0
    return flash_attention_plain(q, k, v, **kw)


def _bad_scale(q, k, v, scale=None, **kw):
    return flash_attention_plain(q, k, v, scale=1.0 / q.shape[-1], **kw)


def _biased(q, k, v, **kw):
    out = flash_attention_plain(q, k, v, **kw)
    return (out.float() * (1 + 2 ** -8)).to(out.dtype)


FAULTS = (("plain version", flash_attention_plain),
          ("one future key", _future_key), ("last tile's V", _last_tile_v),
          ("first key's V", _first_key_v), ("scale 1/hd", _bad_scale),
          ("out x (1+2^-8)", _biased))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def position_rel(a, b) -> torch.Tensor:
    """Per layer, the largest relative difference of one position's K or
    V over the rows and positions of two [L, B, S, KV, hd] leaves."""
    a, b = a.flatten(3).float(), b.flatten(3).float()
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).flatten(1).amax(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    shape = InputShape("probe", args.seq, args.batch, "prefill")
    cfg = specs.adapt_for_shape(get_config("internlm2-1.8b"),
                                shape).replace(n_layers=args.layers)
    _, meta, _ = dryrun.step_and_inputs(
        cfg, shape, MeshLayout((1, 1), ("data", "model")))

    def prefill(kernel: bool):
        params, cache, batch = dryrun.materialize(
            meta, "cpu", torch.Generator().manual_seed(0), cfg.vocab_size)
        logits, _ = tfm.prefill(params, cfg, batch["tokens"], cache,
                                last_only=True, paged_kernel=kernel)
        return [t.clone() for t in _leaves(cache)], logits[:, -1].float()

    t0 = time.perf_counter()
    ref_cache, ref_logits = prefill(False)
    print(f"internlm2-1.8b, {args.layers} layers, bf16, {args.batch} x "
          f"{args.seq}: plain prefill {time.perf_counter() - t0:.1f} s, "
          f"last logits' std {float(ref_logits.std()):.4g}", flush=True)
    readings = {}
    wrapper = kernel_ops.flash_attention
    try:
        for name, fault in FAULTS:
            kernel_ops.flash_attention = fault
            cache, logits = prefill(True)
            rel = torch.stack([position_rel(a, b) for a, b in
                               zip(cache, ref_cache)]).amax(0)
            err = float((logits - ref_logits).abs().max())
            readings[name] = {"kv_rel": float(rel.max()),
                              "kv_rel_by_layer": [float(x) for x in rel],
                              "logits_max_abs": err}
            print(f"{name}: K/V worst position's relative error "
                  f"{float(rel.max()):.4g} (by layer "
                  f"{[round(float(x), 3) for x in rel]}), last logits "
                  f"max|d| {err:.4g}", flush=True)
    finally:
        kernel_ops.flash_attention = wrapper
    print(json.dumps({"layers": args.layers, "batch": args.batch,
                      "seq": args.seq, "readings": readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
