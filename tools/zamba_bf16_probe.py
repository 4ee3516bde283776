"""Where zamba2-1.2b's bf16 kernel-vs-plain logits difference comes from,
on one CUDA card.

    python3 tools/zamba_bf16_probe.py [--seeds 0 1 2] [--src DIR]
    python3 tools/zamba_bf16_probe.py --device cpu --reduced   # dry run

`chip_smoke.py` phase 11 holds the full-width zamba2-1.2b prefill and
decode step, the kernel path against the plain path, by logits: within
1e-3 with fp32 activations, and under a guard with the config's bf16
activations. This script reads the bf16 difference apart. For each seed:
zamba2-1.2b at its published widths (fp32 weights from the seed, bf16
activations), chip_smoke's draw of 8 prompts of 128 tokens for that seed,
one prefill (the last position's logits) and one decode step from the
kernel path's prefilled state, each taken six ways against the plain
path:

  kernels       both kernels (`wkv_scan` and the shared block's
                `flash_attention`), phase 11's reading
  wkv only      `wkv_scan` on, the shared block's attention plain
  flash only    `flash_attention` on, the recurrence plain
  reordered     no kernel: the plain recurrence in chunks of 1 instead of
                64 (the same fp32 function summed in another order)
  fp32 kernels  both kernels with fp32 activations
  fp32 reorder  the reordering with fp32 activations

Each line prints max|dlogit|, the logits' std and the argmax agreement;
then, for the kernels' bf16 prefill, the residual stream after each
Mamba2 layer: max|dx| over the stream's std and the share of its bf16
elements that differ. Last, the card's name and power limit and one JSON
object of every reading.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "zamba2-1.2b"
N_ROWS, PROMPT = 8, 128
WAYS = ("kernels", "wkv only", "flash only", "reordered", "fp32 kernels",
        "fp32 reorder")


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a dry run of the script's flow, the "
                         "kernels' plain versions on both sides")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a dry run's size)")
    args = ap.parse_args()
    import numpy as np
    import torch
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv_scan import wkv_scan_plain
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = "cpu (dry run)"
    if dev == "cuda":
        _build.build_all()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    base = get_config(ARCH)
    if args.reduced:
        base = reduced(base).replace(compute_dtype="bfloat16")
    real_attend = attn_lib._prefill_attend
    real_mamba_config = tfm.mamba_config
    real_block = ssm_lib.mamba2_block_forward

    def plain_attend(*a, **kw):              # the shared block's attention
        a = list(a)
        a[5] = False                         # `kernel`
        return real_attend(*a, **kw)

    def plain_wkv(q, k, v, logw, u, s0, *, mode, out=None):
        return wkv_scan_plain(q, k, v, logw, u, s0, mode=mode, chunk=64,
                              out=out)

    def chunk_one(cfg):
        return dataclasses.replace(real_mamba_config(cfg), chunk=1)

    def run(params, cfg, toks, kernel, way, cache=None, record=None):
        """Prefill (cache None) or one decode step from `cache`, the way's
        patches on: (last logits [B, V], cache)."""
        stack = contextlib.ExitStack()
        with stack:
            if kernel and way == "wkv only":
                stack.enter_context(patched(attn_lib, "_prefill_attend",
                                            plain_attend))
            if kernel and way == "flash only":
                stack.enter_context(patched(ssm_lib, "wkv_scan", plain_wkv))
            if way in ("reordered", "fp32 reorder") and kernel:
                stack.enter_context(patched(tfm, "mamba_config", chunk_one))
            if record is not None:
                def block(*a, **kw):
                    x, new = real_block(*a, **kw)
                    record.append(x.detach().clone())
                    return x, new
                stack.enter_context(patched(ssm_lib, "mamba2_block_forward",
                                            block))
            # "reordered" is plain against plain: its "kernel" side runs
            # the plain path with the reordering
            use = kernel and way not in ("reordered", "fp32 reorder")
            if cache is None:
                c = tfm.init_cache(cfg, N_ROWS, PROMPT + 1, device=dev)
                logits, c = tfm.prefill(params, cfg, toks, c, last_only=True,
                                        paged_kernel=use)
                return logits[:, -1], c
            c = {kind: {k: t.clone() for k, t in leaves.items()}
                 for kind, leaves in cache.items()}
            logits, c = tfm.decode_step(params, cfg, toks, PROMPT, c,
                                        paged_kernel=use)
            return logits, c

    readings = {}
    with torch.inference_mode():
        for seed in args.seeds:
            params = tfm.init_params(base, seed, dev)
            toks = torch.from_numpy(np.random.default_rng(seed + 21).integers(
                0, base.vocab_size, (N_ROWS, PROMPT))).to(dev)
            for way in WAYS:
                cfg = (base.replace(compute_dtype="float32")
                       if way.startswith("fp32") else base)
                rec = {True: [], False: []} if way == "kernels" else None
                pre, caches = {}, {}
                for kernel in (True, False):
                    pre[kernel], caches[kernel] = run(
                        params, cfg, toks, kernel, way,
                        record=None if rec is None else rec[kernel])
                tok = pre[True].argmax(-1)
                step = {k: run(params, cfg, tok, k, way, caches[True])[0]
                        for k in (True, False)}
                if dev == "cuda":
                    torch.cuda.synchronize()
                for what, out in (("prefill", pre), ("decode", step)):
                    err = float((out[True] - out[False]).abs().max())
                    agree = float((out[True].argmax(-1)
                                   == out[False].argmax(-1)).float().mean())
                    std = float(out[False].std())
                    readings[f"seed {seed} {way} {what}"] = err
                    print(f"[zamba-probe] seed {seed} {way:12s} {what:7s}: "
                          f"max|dlogit| {err:.4g}, logit std {std:.3g}, "
                          f"argmax agreement {agree:.3f}")
                if rec is not None:
                    for i, (a, b) in enumerate(zip(rec[True], rec[False])):
                        d = (a.float() - b.float()).abs()
                        share = float((a != b).float().mean())
                        rel = float(d.max()) / float(b.float().std())
                        print(f"[zamba-probe] seed {seed} layer {i:2d}: "
                              f"max|dx| / std {rel:.3g}, bf16 elements "
                              f"differing {share:.4f}")
                        readings[f"seed {seed} layer {i} share"] = share
                del pre, caches, step, rec
            del params
            if dev == "cuda":
                torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
