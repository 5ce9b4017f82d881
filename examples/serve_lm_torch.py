"""Batched serving example on the PyTorch/CUDA port: prefill a batch of
prompts, then greedy decode.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch xlstm-1.3b \\
        [--device cuda|cpu]

The same run as ``examples/serve_lm.py``, on ``repro_torch``: the
arch's reduced config, random weights drawn by ``Model.init`` from
``torch.Generator`` seeded with 0 on the CPU and moved to the device, the
prompts of ``make_batch(cfg, batch, prompt_len, 0, 0)``, and
``launch.serve.generate``.  It runs on the CUDA card unless ``--device
cpu`` is given (on the card the attention and sLSTM layers go through
their kernels) and raises ``DeviceUnavailableError`` when a card is asked
for and there is none.  ``main`` returns the facts it printed.
"""
import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.data.lm import make_batch
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models.model import build_model
from repro_torch.train.optim import tree_map


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    params = tree_map(lambda t: t.to(dev), model.init(
        torch.Generator().manual_seed(0), cast=True))
    batch = make_batch(cfg, args.batch, args.prompt_len, 0, 0)
    batch.pop("labels", None)

    stats = {}
    t0 = time.perf_counter()
    toks = generate(model, params, batch, steps=args.gen_len,
                    cache_len=args.prompt_len + args.gen_len, stats=stats)
    dt = time.perf_counter() - t0
    print(f"{cfg.name} ({cfg.family}): {toks.shape[0]}x{toks.shape[1]} "
          f"tokens in {dt:.2f}s "
          f"({args.batch*args.gen_len/dt:.1f} tok/s incl. any first-use "
          f"kernel build)")
    for row in range(min(2, toks.shape[0])):
        print(f"  seq {row}:", toks[row, :16].tolist())
    return {"arch": cfg.name, "family": cfg.family, "device": str(dev),
            "tokens_shape": list(toks.shape), "tokens": toks.tolist(),
            "padded_vocab": cfg.padded_vocab,
            "logits_finite": stats["logits_finite"], "seconds": dt}


if __name__ == "__main__":
    main()
