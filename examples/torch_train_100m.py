"""End-to-end run on the PyTorch port: train a ~100M-parameter decoder
for a few hundred steps (Stage 1 CE + Stage 2 Gatekeeper) on the
synthetic LM stream.

Port of examples/train_100m.py on `repro_torch`, through
`repro_torch.launch.train`: on the GPU Stage 2's loss is the fused
`gatekeeper_loss_tokens` kernel. Runs on the GPU unless --device cpu is
given. `--size reduced` trains the reduced internlm2-1.8b instead of the
100M preset (a quick look, or a test). The last line of its output is a
JSON record of each stage's first and last logged loss.

    PYTHONPATH=src python examples/torch_train_100m.py --stage1-steps 300 \\
        --stage2-steps 100 [--device cpu]
"""
import argparse
import json

from repro_torch.launch import train as train_launch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage1-steps", type=int, default=300)
    ap.add_argument("--stage2-steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--size", choices=("100m", "reduced"), default="100m")
    ap.add_argument("--ckpt", default=None,
                    help="write a checkpoint after each stage here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    cli = (["--preset", "100m"] if args.size == "100m"
           else ["--arch", "internlm2-1.8b", "--reduced"])
    cli += ["--task", "stream",
            "--stage1-steps", str(args.stage1_steps),
            "--stage2-steps", str(args.stage2_steps),
            "--batch", str(args.batch), "--seq-len", str(args.seq_len),
            "--n-train", str(args.n_train), "--log-every", "10"]
    if args.ckpt:
        cli += ["--ckpt", args.ckpt]
    if args.device:
        cli += ["--device", args.device]
    _, history = train_launch.main(cli)
    record = {"example": "torch_train_100m", "size": args.size}
    for stage, log in history.items():
        record[f"stage{stage}"] = {
            "steps": log[-1]["step"], "loss_first": log[0]["loss"],
            "loss_last": log[-1]["loss"], "time_s": round(log[-1]["time_s"],
                                                          3)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
