"""Serving launcher: batched prefill + greedy decode.

    python -m repro_torch.launch.serve --arch qwen3-1.7b [--reduced]
        [--batch 4] [--prompt-len 32] [--gen-len 16] [--device cuda]
        [--seed 0]

The port of ``src/repro/launch/serve.py``, for every architecture of
``ARCHS``, MoE included (the recurrent caches ignore the cache length;
the VLM's patch embeddings and the encoder–decoder's frames are the
configs' stubs from ``make_batch``).  It runs on the CUDA card unless ``--device cpu`` is given, and raises ``DeviceUnavailableError``
when a card is asked for and there is none.  Weights are random, drawn
from ``torch.Generator(seed)`` on the device, and the prompts come from
``make_batch(cfg, batch, prompt_len, seed, 0)``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.data.lm import make_batch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshEnv
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import Model, Params, build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model: Model, params: Params, batch: Dict[str, torch.Tensor],
             *, steps: int, cache_len: int,
             stats: Optional[dict] = None,
             env: Optional[MeshEnv] = None) -> torch.Tensor:
    """Prefill the prompt, then greedy-decode: returns ``steps`` tokens
    (B, steps) int32, the first from the prefill's logits, as the JAX
    ``generate`` does (it also runs ``steps`` decode steps, the last one's
    token unused).  The argmax runs over the padded vocabulary.

    ``params`` are ``model.cast_params``'s.  Every entry of ``batch``
    goes to ``prefill`` (the VLM's ``patch_embeds``, the encoder–decoder's
    ``frames``), as in JAX.  The decode position lives on
    the device and is advanced there, so the loop makes no host round
    trip.  With ``stats`` (a dict) the call synchronises after the prefill
    and at the end and records ``prefill_s``, ``decode_s`` (host clock)
    and ``logits_finite`` (every logit of every step finite).

    With ``env`` (JAX's ``generate(model, params, batch, env, ...)``): the
    prefill and the steps run on the grid, the tokens chosen on its first
    cell; the CLI stays on one device, as JAX's does.  The weights are
    cut into their pieces once, before the prefill
    (``sharding.pieces``), so no decode step moves a weight.
    """
    if env is not None:
        params = sh.pieces(params, env)
    dev = env.first if env is not None else params["embed"].device
    batch = {k: v.to(dev) for k, v in batch.items()}
    s = batch["tokens"].shape[1]
    finite = torch.ones((), dtype=torch.bool, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, batch, cache_len=cache_len,
                                       env=env)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        if stats is not None:
            finite &= torch.isfinite(logits).all()
            _sync(dev)
            t1 = time.perf_counter()
            stats["prefill_s"] = t1 - t0
        pos = torch.tensor(s, dtype=torch.int32, device=dev)
        out = []
        for _ in range(steps):
            out.append(tok)
            lg, caches = model.decode_step(params, caches, tok, pos, env=env)
            tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
            pos += 1
            if stats is not None:
                finite &= torch.isfinite(lg).all()
        toks = torch.cat(out, dim=1)
        if stats is not None:
            _sync(dev)
            stats["decode_s"] = time.perf_counter() - t1
            stats["logits_finite"] = bool(finite)
    return toks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, cast=True)
    batch = make_batch(cfg, args.batch, args.prompt_len, args.seed, 0)
    batch.pop("labels", None)
    t0 = time.perf_counter()
    toks = generate(model, params, batch, steps=args.gen_len,
                    cache_len=args.prompt_len + args.gen_len)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"{cfg.name} on {dev}: generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen_len / dt:.1f} tok/s)")
    print("sample:", toks[0].tolist())


if __name__ == "__main__":
    main()
