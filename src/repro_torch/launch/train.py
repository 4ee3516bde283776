"""End-to-end training entry point of the port, on CUDA by default.

The paper's two-stage recipe (§3.2), as `repro.launch.train` runs it:
Stage 1 trains M_S with standard cross-entropy on full logits
(`training.loop.make_train_step(loss_kind="ce")`, MoE aux weight 0.01);
Stage 2 tunes its confidence with the Gatekeeper token loss fused with
the unembedding (`launch.steps.make_train_step`: on CUDA the loss is the
CUDA kernel `gatekeeper_loss_tokens`). Both stages use AdamW with
JAX's learning rates, warmup and schedule, and a checkpoint in the JAX
package's format is written after each stage with --ckpt.

Same flags as `repro.launch.train` plus --device (default: cuda, which must
exist). --arch takes the eight decoders: the dense and MoE ones
(internlm2-1.8b, qwen1.5-4b, qwen1.5-32b, llama3-405b, deepseek-v2-236b,
kimi-k2-1t-a32b), RWKV6 (rwkv6-3b) and the Mamba2 hybrid (zamba2-1.2b),
whose recurrence runs the `wkv_scan` kernel forward on CUDA. The config's
`remat` and `attn_chunk` apply as in JAX; --remat (none, full or dots)
replaces the config's `remat`, a flag JAX's trainer lacks (its dry run
has one). whisper-small and
phi-3-vision-4.2b take frames or patches, which this CLI (like JAX's)
cannot feed: they are rejected at argparse time, by name.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --stage1-steps 200 --stage2-steps 100 --alpha 0.3
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.core.gatekeeper import GatekeeperConfig
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import make_lm_stream, make_qa
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint, optim
from repro_torch.training.loop import make_train_step as make_stage1_step

PRESET_100M = ModelConfig(
    name="repro-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=8192,
    qkv_bias=False, rope_theta=10000.0, tie_embeddings=True,
    source="paper-scale trainer (~100M params)")


def build_cfg(args) -> ModelConfig:
    if args.preset == "100m":
        cfg = PRESET_100M
    else:
        cfg = get_config(args.arch)
        cfg = reduced(cfg) if args.reduced else cfg
    remat = getattr(args, "remat", None)
    return cfg.replace(remat=remat) if remat else cfg


def make_data(cfg: ModelConfig, args, seed) -> dict:
    """Training arrays (numpy): QA sequences with their answer mask, or
    the Zipf-Markov stream shifted by one token."""
    if args.task == "qa":
        qa = make_qa(seed, args.n_train, n_symbols=min(cfg.vocab_size - 16, 16))
        return {"tokens": qa.inputs, "targets": qa.targets,
                "loss_mask": qa.loss_mask}
    stream = make_lm_stream(seed, args.n_train, args.seq_len + 1,
                            cfg.vocab_size)
    return {"tokens": stream[:, :-1], "targets": stream[:, 1:]}


def run(args, log_fn=None):
    """Both stages. Returns (params, {stage: [logged metrics]}); each
    logged record holds "step", "time_s" (wall seconds since the stage
    began, the device synchronised) and the step's scalar metrics.
    `log_fn(stage, record)` is called after each record is printed."""
    device = resolve_device(args.device)
    cfg = build_cfg(args)
    print(f"config: {cfg.name} ({cfg.family}), vocab={cfg.vocab_size}, "
          f"d_model={cfg.d_model}, layers={cfg.n_layers}, device={device}")
    params = tfm.init_params(cfg, args.seed, device)
    n_params = sum(p.numel() for p in optim.tree_leaves(params))
    print(f"params: {n_params / 1e6:.1f}M")
    data = make_data(cfg, args, [args.seed, 1])
    it = BatchIterator(data, args.batch, seed=[args.seed, 2]).forever()

    history = {}
    for stage, steps in ((1, args.stage1_steps), (2, args.stage2_steps)):
        if steps <= 0:
            continue
        opt_cfg = optim.AdamWConfig(
            lr=args.lr if stage == 1 else args.lr * 0.3,
            warmup_steps=min(50, steps // 5), total_steps=steps)
        if stage == 1:
            def apply_fn(p, batch):
                return tfm.forward(p, cfg, batch["inputs"], return_aux=True)
            step_fn = make_stage1_step(apply_fn, opt_cfg, loss_kind="ce",
                                       aux_weight=0.01)
        else:
            step_fn = make_train_step(cfg, GatekeeperConfig(alpha=args.alpha),
                                      opt_cfg)
        opt_state = optim.adamw_init(params)
        log = history[stage] = []
        t0 = time.perf_counter()
        for i in range(steps):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in next(it).items()}
            if stage == 1:
                batch["inputs"] = batch["tokens"]
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if (i + 1) % args.log_every == 0 or i == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()
                     if v.dim() == 0}
                dt = time.perf_counter() - t0
                print(f"stage{stage} step {i + 1}/{steps} "
                      f"({dt / (i + 1):.2f}s/step): {m}")
                rec = {"step": i + 1, "time_s": dt, **m}
                log.append(rec)
                if log_fn:
                    log_fn(stage, rec)
        if args.ckpt:
            path = f"{args.ckpt}/stage{stage}"
            checkpoint.save_checkpoint(path, params, step=steps)
            print(f"checkpoint -> {path}")
        opt_state = None        # free the moments before the next stage's
    return params, history


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--preset", default=None, choices=[None, "100m"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--task", default="stream", choices=["stream", "qa"])
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--stage1-steps", type=int, default=100)
    ap.add_argument("--stage2-steps", type=int, default=50)
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"],
                    help="activation checkpointing per layer (default: the "
                         "config's, none)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.preset is None:
        try:
            tfm.check_ported(get_config(args.arch), training=True,
                             engine=True)
        except (NotImplementedError, ValueError) as e:
            ap.error(f"--arch {args.arch}: {e}")
    return run(args)


if __name__ == "__main__":
    main()
