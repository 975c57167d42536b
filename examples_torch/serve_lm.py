"""Serving example: continuous batching over fixed decode slots.

A small LM serves a queue of requests through fixed batch slots: admit ->
prefill the prompt alone into its slot -> step the whole batch each
decode tick -> retire finished requests and refill slots
(``repro_torch.launch.serve.serve_requests``).  Each request gets the
tokens greedy generation gives its prompt alone (the reference writes a
prompt by running a decode step of every slot per prompt token).

    python examples_torch/serve_lm.py [n_requests] [--device DEVICE]

``--device`` (default: the card) is where the model runs; ``--device
cpu`` runs the kernels' plain versions.
"""
import os
import random
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_requests
from repro_torch.models import build_model
from repro_torch.serving import Request, RequestBatcher

MAX_SEQ = 128
SLOTS = 4


def main():
    argv = sys.argv[1:]
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    args = [a for a in argv if not a.startswith("--")]
    n_requests = int(args[0]) if args else 12
    cfg = get_config("smollm-360m", smoke=True)
    model = build_model(cfg, device)
    params = model.init_params(seed=0)

    rb = RequestBatcher(SLOTS)
    rng = random.Random(0)
    for i in range(n_requests):
        rb.submit(Request(id=f"req{i}",
                          prompt=[rng.randint(2, cfg.vocab_size - 1)
                                  for _ in range(rng.randint(4, 12))],
                          max_new_tokens=rng.randint(8, 24)))

    t0 = time.time()
    generated, steps = serve_requests(model, params, rb, MAX_SEQ)
    dt = time.time() - t0
    print(f"served {len(rb.completed)} requests, {generated} tokens in "
          f"{dt:.1f}s ({generated/dt:.0f} tok/s, {steps} batch steps)")
    for r in rb.completed[:3]:
        print(f"  {r.id}: prompt={r.prompt[:4]}... -> {r.generated[:8]}...")


if __name__ == "__main__":
    main()
