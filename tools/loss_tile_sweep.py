"""Time the port's `gatekeeper_loss_tokens` at forced token tiles and
vocabulary splits, on one CUDA card.

    python3 tools/loss_tile_sweep.py [--src DIR]

The shapes are the Stage-2 ones of `chip_smoke.py` phase 7a, with bf16 x
and an fp32 table as the main paths give them: internlm2-1.8b (2048 x
92544, d 2048), whisper-small (128 x 51865, d 768), phi-3-vision-4.2b
over all its 4632 positions and over the 24 rows its loss reads (32064,
d 3072). At each, the wrapper's own launch is first split by kernel under
torch.profiler (partial and merge kernels, device ms a call); then, where
the tree has `token_tile` (its parent has not), the kernel is timed at
every token tile of 32, 64 and 128 rows and splits aimed at 1, 2, 4 and 8
CTAs a resident slot, each checked against the plain version (ce / kl /
entropy within 1e-3) and timed with `chip_smoke.time_ms` (CUDA events,
device milliseconds a call). The wrapper's own choice is printed beside.
`--src` takes the `repro_torch` of another source directory. One line a
configuration, then the card's name and power limit, then one JSON
object of every time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILES = (32, 64, 128)
WAVES = (1, 2, 4, 8)
# label, T, V, d
SHAPES = (("internlm2-1.8b", 2048, 92544, 2048),
          ("whisper-small", 128, 51865, 768),
          ("phi-3-vision-4.2b all rows", 4632, 32064, 3072),
          ("phi-3-vision-4.2b loss rows", 24, 32064, 3072))


def split_for(T: int, V: int, n_sms: int, bm: int, waves: int):
    """`vocab_split`'s rule at a forced tile and CTAs per slot."""
    n_tiles = -(-V // 128)
    slots = n_sms * (1 if bm == 128 else 2)
    want = min(n_tiles, max(1, -(-waves * slots // -(-T // bm))))
    per = -(-n_tiles // want)
    return per, -(-n_tiles // per)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    from chip_smoke import kernel_split, time_ms
    from repro_torch.kernels import gatekeeper_loss as gk
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    sweep = hasattr(gk, "token_tile")
    tile0, split0 = (gk.token_tile if sweep else None), gk.vocab_split
    times = {}
    for label, T, V, d in SHAPES:
        x = torch.randn((T, d), generator=g, device="cuda").bfloat16()
        table = torch.randn((V, d), generator=g, device="cuda") / d ** 0.5
        tgt = torch.randint(0, V, (T,), generator=g, device="cuda",
                            dtype=torch.int32)
        want = gk.gatekeeper_loss_tokens_plain(x, table, tgt)
        row = {"default": time_ms(
            lambda: gk.gatekeeper_loss_tokens(x, table, tgt), iters=10),
            "by_kernel": kernel_split(
                torch, lambda: gk.gatekeeper_loss_tokens(x, table, tgt), 10,
                r"(gk_\w+_kernel)")}
        pick = (tile0(T), split0(T, V, n_sms)) if sweep else None
        try:
            for bm in (TILES if sweep else ()):
                for waves in WAVES:
                    per, n = split_for(T, V, n_sms, bm, waves)
                    key = f"bm {bm} per {per} splits {n}"
                    if key in row:
                        continue
                    gk.token_tile = lambda _T, bm=bm: bm
                    gk.vocab_split = lambda *_, s=(per, n): s
                    got = gk.gatekeeper_loss_tokens(x, table, tgt)
                    err = max(float((a - b).abs().max())
                              for i, (a, b) in enumerate(zip(got, want))
                              if i != 2)
                    if err > 1e-3:
                        raise AssertionError(f"{label}, {key}: max|err| "
                                             f"{err}")
                    row[key] = time_ms(
                        lambda: gk.gatekeeper_loss_tokens(x, table, tgt),
                        iters=10)
        finally:
            if sweep:
                gk.token_tile, gk.vocab_split = tile0, split0
        times[label] = row
        print(f"{label} (T {T}, V {V}, d {d}, bf16 x; wrapper's choice "
              f"{pick}): " + ", ".join(
                  f"{k} {v if isinstance(v, dict) else round(v, 4)}"
                  for k, v in row.items()))
        del x, table, tgt, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
