"""Time the port's fp32 `flash_attention` at forced key-split counts, on
one CUDA card.

    python3 tools/flash_split_sweep.py [--src DIR]

The shapes are those where `kv_split` may split, because the grid is
under one wave of CTAs: whisper-small's cross-attention at prefill (16
queries) and at a decode step (1 query) over 1500 encoder states
(non-causal, 8 rows, 12 heads of 64); the paged engine's internlm2-1.8b
prefill dispatches of 1, 2, 4 and 8 rows (128 queries at q_offset 0 and 128
over a 288-position view, causal, 16/8 heads of 128); and zamba2-1.2b's
shared block at 1 and 2 rows (32/32 heads of 64, window 288). At each,
the keys some query sees (`seen_keys`) are cut into 1, 2, 3, 4, 6, 8, 12
and 24 splits as `split_span` cuts them (counts that leave a split past
the last seen key are left out), and each launch is timed with
`chip_smoke.time_ms` (CUDA events, device milliseconds a call). `kv_split`'s
own choice is printed beside. `--src` takes the `repro_torch` of another
source directory. One line a shape, then the card's name and power limit,
then one JSON object of every time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COUNTS = (1, 2, 3, 4, 6, 8, 12, 24)
# label, B, T, S, H, KV, hd, causal, window, q_offset
SHAPES = (
    ("whisper cross prefill", 8, 16, 1500, 12, 12, 64, False, 0, 0),
    ("whisper cross decode", 8, 1, 1500, 12, 12, 64, False, 0, 0),
    *((f"internlm2 chunk {rows} rows q_offset {off}", rows, 128, 288, 16, 8,
       128, True, 0, off) for rows in (1, 2, 4, 8) for off in (0, 128)),
    *((f"zamba2 shared block {rows} rows", rows, 128, 288, 32, 32, 64, True,
       288, 0) for rows in (1, 2)),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    from chip_smoke import time_ms
    from repro_torch.kernels import flash_attention as fa
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = fa.kv_split
    g = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for label, B, T, S, H, KV, hd, causal, window, off in SHAPES:
        mask = dict(causal=causal, window=window, q_offset=off)
        q = torch.randn((B, T, H, hd), generator=g, device="cuda")
        k, v = (torch.randn((B, S, KV, hd), generator=g, device="cuda")
                for _ in range(2))
        first, last = fa.seen_keys(T, S, **mask)
        ref = fa.flash_attention_plain(q, k, v, **mask)
        row = {}
        try:
            for n in COUNTS:
                span, got = fa.split_span(last - first, n)
                if got != n and n > 1:
                    continue
                fa.kv_split = (lambda *_, span=span, got=got, **__:
                               (first, span, got) if got > 1 else (0, S, 1))
                out = fa.flash_attention(q, k, v, **mask)
                err = float((out - ref).abs().max())
                if err > 1e-4:
                    raise AssertionError(f"{label}, {n} splits: max|err| "
                                         f"{err}")
                row[n] = time_ms(lambda: fa.flash_attention(q, k, v, **mask))
        finally:
            fa.kv_split = chosen
        pick = chosen(B, T, S, H, hd, n_sms, **mask)[2]
        times[label] = dict(ms_by_splits=row, kv_split=pick)
        print(f"[sweep] {label}: keys {first}..{last - 1}; ms by splits "
              + ", ".join(f"{n}: {t:.4f}" for n, t in row.items())
              + f"; kv_split's {pick}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
