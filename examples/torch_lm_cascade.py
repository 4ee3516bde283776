"""Token-level Gatekeeper on decoder LMs (paper §4.2 shape), on the
PyTorch port.

Port of examples/lm_cascade.py on `repro_torch`. Trains a 1-layer M_S and
a 4-layer M_L on the synthetic closed-form QA task, fine-tunes M_S with
the token-level Gatekeeper loss (eqs. 4-5), and compares the g_NENT
deferral signal (eq. 8) before and after, beside the App. B.2 prompting
baselines. Runs on the GPU unless --device cpu is given; the last line
of its output is a JSON record of the results.

    PYTHONPATH=src python examples/torch_lm_cascade.py [--device cpu]
"""
import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.core.baselines import PromptingBaseline
from repro_torch.core.deferral import sequence_negative_entropy
from repro_torch.core.gatekeeper import GatekeeperConfig
from repro_torch.core.metrics import summarize_deferral
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import make_qa
from repro_torch.models import transformer as tfm
from repro_torch.training import optim
from repro_torch.training.loop import make_train_step, train


def mk_cfg(name, layers, d):
    return ModelConfig(name=name, family="dense", n_layers=layers, d_model=d,
                       n_heads=4, n_kv_heads=4, head_dim=d // 4, d_ff=4 * d,
                       vocab_size=32, tie_embeddings=True)


def fit(cfg, data, steps, device, *, loss="ce", alpha=None, init=None,
        lr=3e-3, seed=0, batch=256):
    params = init if init is not None else tfm.init_params(cfg, seed, device)
    it = BatchIterator({"inputs": data.inputs, "targets": data.targets,
                        "loss_mask": data.loss_mask}, batch, seed=seed)
    step = make_train_step(
        lambda p, b: tfm.forward(p, cfg, b["inputs"]),
        optim.AdamWConfig(lr=lr, total_steps=steps), loss_kind=loss,
        gk_cfg=GatekeeperConfig(alpha=alpha) if alpha else None)
    return train(params, step, it.forever(), steps, log_every=10**9).params


@torch.no_grad()
def answer_eval(cfg, params, data, device, baseline=None):
    """(confidence, correctness) of the answer tokens: g_NENT over the
    loss mask, or a prompting baseline's confidence on its inputs."""
    inputs = torch.as_tensor(data.inputs, device=device)
    if baseline is not None:
        inputs = baseline.modify_inputs(inputs)
    logits = tfm.forward(params, cfg, inputs)
    pos = data.answer_pos - 1
    preds = logits[:, pos, :].argmax(-1).cpu().numpy()
    correct = (preds == data.targets[:, pos]).astype(float)
    if baseline is not None:
        conf = baseline.confidence_from_logits(logits[:, pos, :])
    else:
        conf = sequence_negative_entropy(
            logits, torch.as_tensor(data.loss_mask, device=device))
    return conf.float().cpu().numpy(), correct


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--n-train", type=int, default=8000)
    ap.add_argument("--n-cal", type=int, default=4000)
    ap.add_argument("--n-eval", type=int, default=3000)
    ap.add_argument("--small-steps", type=int, default=400)
    ap.add_argument("--large-steps", type=int, default=600)
    ap.add_argument("--tune-steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    tr = make_qa(0, args.n_train)
    cal = make_qa([0, 7], args.n_cal)
    te = make_qa([0, 1], args.n_eval)
    s_cfg, l_cfg = mk_cfg("small", 1, 64), mk_cfg("large", 4, 192)

    print(f"training M_S / M_L on closed-form QA on {device} ...")
    small = fit(s_cfg, tr, args.small_steps, device, batch=args.batch)
    large = fit(l_cfg, tr, args.large_steps, device, seed=1,
                batch=args.batch)
    _, lcorr = answer_eval(l_cfg, large, te, device)
    print(f"  acc(M_L) = {lcorr.mean():.3f}")
    record = {"example": "torch_lm_cascade", "device": str(device),
              "acc_large": round(float(lcorr.mean()), 4)}

    def report(name, conf, corr):
        m = summarize_deferral(conf, corr, lcorr)
        record[name] = {k: round(float(m[k]), 4)
                        for k in ("acc_small", "s_d", "auroc")}
        print(f"  {name}: acc={m['acc_small']:.3f} s_d={m['s_d']:.3f} "
              f"auroc={m['auroc']:.3f}")

    report("baseline", *answer_eval(s_cfg, small, te, device))
    for kind in ("reduce_confidence", "answer_n"):
        report(f"prompt_{kind}", *answer_eval(s_cfg, small, te, device,
                                              PromptingBaseline(kind)))

    print("Gatekeeper token-level fine-tune (alpha=0.1) ...")
    tuned = fit(s_cfg, cal, args.tune_steps, device, loss="gatekeeper",
                alpha=0.1, init=optim.tree_map(torch.clone, small),
                lr=1e-3, batch=args.batch)
    report("gatekeeper", *answer_eval(s_cfg, tuned, te, device))
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
