"""M_L server process: the out-of-process half of the distributed tier.

Counterpart of `repro.launch.ml_server`, with one flag more: --device
(default: cuda, which must exist). Owns the large `ModelRunner` and
serves batched regeneration over the socket RPC protocol of
`repro_torch.serving.remote`. The serving engine connects with
``--large-backend socket --ml-address host:port`` (or ``--large-backend
pool`` across several of these); greedy parity across processes holds
because `build_runners(arch, seed)` derives the large model's parameters
deterministically from ``--arch``/``--seed`` — run the server and the
engine with the same values and the same device type. On the card the
server holds its own CUDA context, and its worker thread runs under a
CUDA stream of its own.

    # one replica on a fixed port
    PYTHONPATH=src python -m repro_torch.launch.ml_server --port 7070

    # the engine, in another shell
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --large-backend socket --ml-address 127.0.0.1:7070

Batching policy (--large-batch / --max-wait) lives server-side: the
server owns the `BatchPolicy`, so batch shapes — and therefore padding
behavior — are decided where the compute runs. Ctrl-C (or a client
``shutdown`` frame) stops the server after the current batch.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.launch.serve import build_runners
from repro_torch.serving.remote import MLServer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    help="architecture preset; must match the engine's "
                         "--arch for cross-process greedy parity")
    ap.add_argument("--seed", type=int, default=0,
                    help="parameter seed; must match the engine's --seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist); "
                         "must match the engine's device type")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral, printed at startup)")
    ap.add_argument("--max-new", type=int, default=8,
                    help="regeneration length; must match the engine's "
                         "--max-new")
    ap.add_argument("--large-batch", type=int, default=0,
                    help="regeneration batch size (0 = one exact-size "
                         "batch at drain)")
    ap.add_argument("--max-wait", type=float, default=0.0,
                    help="seconds a partial batch may wait before "
                         "flushing padded (0 = wait for a full batch)")
    ap.add_argument("--latency", type=float, default=0.0,
                    help="injected per-batch response delay (benches)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    _small, large, _cfg = build_runners(args.arch, args.seed, device=device)
    srv = MLServer(large, max_new=args.max_new,
                   large_batch=args.large_batch or None,
                   max_wait=args.max_wait or None,
                   host=args.host, port=args.port,
                   latency=args.latency).start()
    host, port = srv.address
    print(f"M_L server ({args.arch}, seed {args.seed}, {device}) listening "
          f"on {host}:{port} — connect with --large-backend socket "
          f"--ml-address {host}:{port}", flush=True)
    try:
        while srv.running:
            time.sleep(0.2)
        print("shutdown frame received, stopping")
    except KeyboardInterrupt:
        print("interrupted, stopping")
    finally:
        srv.stop()
    print(f"served {len(srv.batch_log)} batches", flush=True)


if __name__ == "__main__":
    main()
