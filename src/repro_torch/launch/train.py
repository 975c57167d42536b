"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...] [--device cpu]``.

Runs any config of the repo end to end (smoke configs by default, in
float32; ``--full`` for the published widths) on the card, or on the
CPU with ``--device cpu``; ``make_batch_for`` gives vlm batches their
patches and audio batches their frames.  ``--rules`` is parsed and not
used, as in the reference (its sharding rules wait for a mesh).
"""
from __future__ import annotations

import argparse
import time

from ..checkpoint import Checkpointer
from ..checkpoint.checkpointer import latest_step
from ..configs import ARCH_IDS, get_config
from ..configs.base import ShapeSpec
from ..models import build_model
from ..training import (AdamWConfig, TrainStepConfig, adamw_init,
                        make_batch_for, make_train_step)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--rules", default="baseline")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    model = build_model(cfg, args.device)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq}")

    params = model.init_params(seed=0)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=min(30, args.steps // 3),
                       total_steps=args.steps)
    opt = adamw_init(params, ocfg)
    tcfg = TrainStepConfig(microbatches=args.microbatches, remat=args.remat)
    step_fn = make_train_step(model, ocfg, tcfg)

    ck = Checkpointer(args.ckpt_dir or f"results/train-{cfg.name}", keep=2)
    start = 0
    if args.resume:
        last = latest_step(ck.directory)
        if last:
            restored, mani = ck.restore({"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
            start = mani["step"]
            print(f"resumed from step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        batch = make_batch_for(cfg, shape, i, task="copy",
                               device=model.device)
        params, opt, met = step_fn(params, opt, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(met['loss']):.4f} "
                  f"lr {float(met['lr']):.2e}")
        if i and i % args.ckpt_every == 0:
            # labelled with the steps taken, so a resume starts at the
            # next one (the reference labels it i and repeats step i)
            ck.save(i + 1, {"params": params, "opt": opt})
    ck.save(args.steps, {"params": params, "opt": opt}, blocking=True)
    print(f"done in {time.time()-t0:.1f}s; checkpoints in {ck.directory}")


if __name__ == "__main__":
    main()
