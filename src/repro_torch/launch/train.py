"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-360m --reduced \\
        --steps 20 --device cpu
    python -m repro_torch.launch.train --arch qwen3-1.7b --batch 2 \\
        --seq 4096 --steps 6
    python -m repro_torch.launch.train --arch qwen3-1.7b --shape train_4k \\
        --dry

The port of ``src/repro/launch/train.py``: ``Trainer.fit`` over
``batch_stream`` for any architecture of ``ARCHS`` (the full config, or
``--reduced``, the per-arch smoke config), with a checkpoint directory to
resume from (``--ckpt-dir``).  It runs on the CUDA card unless
``--device cpu`` is given, and raises ``DeviceUnavailableError`` when a
card is asked for and there is none.  Weights are random, drawn by
``Model.init`` from ``torch.Generator(0)`` on the device.  ``--dry``
costs one step of the full cell (``--shape``, ``train_4k`` by default)
on both grids of ``launch/mesh.py`` without running it: the same path
as ``launch/dryrun.py`` for one cell, in this process (no device count
has to be forced), records under ``--out``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_arch
from repro_torch.data.lm import batch_stream
from repro_torch.models.model import build_model
from repro_torch.train.optim import OptimizerConfig
from repro_torch.train.trainer import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="run the smoke-scale config")
    ap.add_argument("--dry", action="store_true",
                    help="cost the full cell on fake cards instead of "
                         "running it")
    ap.add_argument("--out", default="experiments/dryrun_torch",
                    help="where --dry writes its records")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.dry:
        from repro_torch.launch import dryrun
        raise SystemExit(dryrun.main(
            ["--arch", args.arch, "--shape", args.shape, "--mesh",
             "card,node", "--out", args.out]))

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    opt = OptimizerConfig(name=args.optimizer, lr=args.lr,
                          warmup_steps=max(args.steps // 10, 1))
    trainer = Trainer(model, opt, ckpt_dir=args.ckpt_dir,
                      remat=not args.reduced, device=args.device)
    state = trainer.restore_or_init()
    print(f"{cfg.name}: {model.param_count(state.params):,} params, "
          f"start step {int(state.step)}, on {trainer.device}")
    stream = batch_stream(cfg, args.batch, args.seq,
                          start_cursor=state.data_cursor,
                          device=trainer.device)
    state = trainer.fit(state, stream, args.steps, log_every=5)
    print(f"finished at step {int(state.step)}")


if __name__ == "__main__":
    main()
