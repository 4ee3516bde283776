"""Quickstart on the PyTorch port: build a Gatekeeper cascade.

Port of examples/quickstart.py on `repro_torch`. Trains a weak M_S and a
strong M_L on the synthetic classification task, confidence-tunes M_S
with the Gatekeeper loss (paper eqs. 1-3), calibrates a deferral
threshold, and reports the joint accuracy / compute trade-off. Runs on
the GPU unless --device cpu is given; the last line of its output is a
JSON record of the results.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.core.cascade import Cascade
from repro_torch.core.gatekeeper import GatekeeperConfig
from repro_torch.core.metrics import summarize_deferral
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import make_classification
from repro_torch.models.classifier import (MLPClassifierConfig,
                                           classifier_forward,
                                           init_classifier)
from repro_torch.training import optim
from repro_torch.training.loop import evaluate_classifier, make_train_step, train


def fit(cfg, data, steps, device, *, loss="ce", alpha=None, init=None,
        lr=3e-3, seed=0, batch=256):
    params = init if init is not None else init_classifier(cfg, seed, device)
    it = BatchIterator({"inputs": data.x, "targets": data.y}, batch,
                       seed=seed)
    step = make_train_step(
        lambda p, b: classifier_forward(p, cfg, b["inputs"]),
        optim.AdamWConfig(lr=lr, total_steps=steps), loss_kind=loss,
        gk_cfg=GatekeeperConfig(alpha=alpha) if alpha else None)
    return train(params, step, it.forever(), steps, log_every=10**9).params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--n-small", type=int, default=2000)
    ap.add_argument("--n-large", type=int, default=15000)
    ap.add_argument("--n-eval", type=int, default=3000)
    ap.add_argument("--small-steps", type=int, default=1500)
    ap.add_argument("--large-steps", type=int, default=2500)
    ap.add_argument("--tune-steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    tr_s = make_classification(0, args.n_small, n_classes=8)
    tr_l = make_classification([0, 5], args.n_large, 8)
    cal = make_classification([0, 7], args.n_eval, 8)
    te = make_classification([0, 1], args.n_eval, 8)

    d_in = tr_s.x.shape[1]
    s_cfg = MLPClassifierConfig(d_in=d_in, n_classes=8, hidden=(64, 64))
    l_cfg = MLPClassifierConfig(d_in=d_in, n_classes=8, hidden=(256, 256))
    print(f"Stage 1: standard training on {device} ...")
    small = fit(s_cfg, tr_s, args.small_steps, device, batch=args.batch)
    large = fit(l_cfg, tr_l, args.large_steps, device, seed=1,
                batch=args.batch)

    print("Stage 2: Gatekeeper confidence tuning (alpha=0.05) ...")
    tuned = fit(s_cfg, cal, args.tune_steps, device, loss="gatekeeper",
                alpha=0.05, init={k: v.clone() for k, v in small.items()},
                lr=5e-3, batch=args.batch)

    _, _, lcorr = evaluate_classifier(
        lambda p, x: classifier_forward(p, l_cfg, x), large, te.x, te.y)
    record = {"example": "torch_quickstart", "device": str(device)}
    for name, params in [("baseline", small), ("gatekeeper", tuned)]:
        _, conf, corr = evaluate_classifier(
            lambda p, x: classifier_forward(p, s_cfg, x), params, te.x, te.y)
        m = summarize_deferral(conf, corr, lcorr)
        record[name] = {k: round(float(m[k]), 4)
                        for k in ("acc_small", "s_d", "s_o", "auroc")}
        print(f"  {name:10s}: acc(M_S)={m['acc_small']:.3f} "
              f"s_d={m['s_d']:.3f} s_o={m['s_o']:.3f} "
              f"auroc={m['auroc']:.3f}")

    print("Stage 3: thresholded cascade at a 30% deferral budget ...")
    n_cal = len(te.y) // 3
    cascade = Cascade(
        small_apply=lambda p, x: classifier_forward(p, s_cfg, x),
        large_apply=lambda p, x: classifier_forward(p, l_cfg, x),
        small_params=tuned, large_params=large, cost_small=0.2)
    cascade.calibrate_tau(torch.as_tensor(te.x[:n_cal], device=device),
                          deferral_ratio=0.3)
    res = cascade.predict_sparse(torch.as_tensor(te.x[n_cal:], device=device))
    acc = float((res.predictions == te.y[n_cal:]).mean())
    print(f"  joint accuracy={acc:.3f} at deferral={res.deferral_ratio:.2f} "
          f"compute={res.compute_cost:.2f}x of always-large")
    record["cascade"] = {"joint_accuracy": round(acc, 4),
                         "deferral": round(float(res.deferral_ratio), 4),
                         "compute": round(float(res.compute_cost), 4)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
