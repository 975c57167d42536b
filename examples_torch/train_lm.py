"""End-to-end training driver: train a ~100M-param smollm-family LM for a
few hundred steps with the full production stack — AdamW, micro-batched
gradient accumulation, remat, async checkpointing with restart,
deterministic data.

    python examples_torch/train_lm.py [steps] [--restart-demo]
        [--device DEVICE]

``--device`` (default: the card) is where the model trains; ``--device
cpu`` runs on the CPU.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import latest_step
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, TrainStepConfig, adamw_init,
                                  copy_task_batch, make_train_step)

OUT = "results/train_lm"


def main():
    argv = sys.argv[1:]
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    args = [a for a in argv if not a.startswith("--")]
    steps = int(args[0]) if args else 300
    restart_demo = "--restart-demo" in argv

    # ~100M-class: smollm-360m family at reduced depth/width (vocab kept
    # small so the copy task's learning signal is visible within a few
    # hundred steps: uniform floor ln(2048)=7.62, copy floor ~4.9)
    cfg = get_config("smollm-360m").replace(
        name="smollm-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=6, head_dim=64, d_ff=2560, vocab_size=2048,
        tie_embeddings=True, dtype="float32")
    model = build_model(cfg, device)
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M")

    params = model.init_params(seed=0)
    ocfg = AdamWConfig(lr=1.5e-3, warmup_steps=40, total_steps=steps)
    opt = adamw_init(params, ocfg)
    tcfg = TrainStepConfig(microbatches=1, remat="none")
    step_fn = make_train_step(model, ocfg, tcfg)

    ck = Checkpointer(os.path.join(OUT, "ckpt"), keep=2)
    batch_size, seq = 4, 128
    log = []
    t0 = time.time()
    start_step = 0

    if restart_demo:
        last = latest_step(os.path.join(OUT, "ckpt"))
        if last:
            restored, mani = ck.restore({"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
            start_step = mani["step"]
            print(f"restored checkpoint at step {start_step}")

    for i in range(start_step, steps):
        batch = copy_task_batch(cfg, batch_size, seq, i, device=model.device)
        params, opt, met = step_fn(params, opt, batch)
        if i % 20 == 0 or i == steps - 1:
            loss = float(met["loss"])
            log.append({"step": i, "loss": round(loss, 4),
                        "lr": float(met["lr"]),
                        "elapsed_s": round(time.time() - t0, 1)})
            print(f"step {i:4d}  loss {loss:.4f}  "
                  f"gnorm {float(met['grad_norm']):.2f}  "
                  f"{(i - start_step + 1) * batch_size * seq / max(time.time()-t0, 1e-9):,.0f} tok/s")
        if i > 0 and i % 100 == 0:
            # labelled with the steps taken (the reference labels it i,
            # so a restart from it repeats step i)
            ck.save(i + 1, {"params": params, "opt": opt})   # async
    ck.save(steps, {"params": params, "opt": opt}, blocking=True)

    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "log.json"), "w") as fh:
        json.dump(log, fh, indent=1)
    first, last = log[0]["loss"], log[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first * 0.7 else 'improving'})")


if __name__ == "__main__":
    main()
