"""Train a reduced assigned-architecture LM end to end on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen3-1.7b \\
        --steps 100 [--device cuda|cpu]

The same run as ``examples/train_lm.py``, on ``repro_torch``: config
resolution, model construction, the train step (loss, gradients,
AdamW), the deterministic data pipeline, a checkpoint every 25 steps and
at the end, and a restart from it that trains 10 more steps.  It runs on
the CUDA card unless ``--device cpu`` is given and raises
``DeviceUnavailableError`` when a card is asked for and there is none.
Training launches no kernel (gradients never pass through one).
``main`` returns the facts it printed.
"""
import argparse
import tempfile

from repro_torch.configs import ARCHS, get_arch
from repro_torch.data.lm import batch_stream
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import build_model
from repro_torch.train.optim import OptimizerConfig
from repro_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    losses = []

    def log(line: str) -> None:
        # Trainer.fit's line: "step <n> loss <l> gnorm <g> (<s>s/step)"
        print(line)
        words = line.split()
        losses.append([int(words[1]), float(words[3])])

    with tempfile.TemporaryDirectory() as ckpt_dir:
        opt = OptimizerConfig(lr=3e-3, warmup_steps=10)
        trainer = Trainer(model, opt, ckpt_dir=ckpt_dir, save_every=25,
                          remat=False, device=dev)
        state = trainer.restore_or_init()
        n_params = model.param_count(state.params)
        print(f"{cfg.name}: {n_params:,} params "
              f"({cfg.family}, {cfg.n_layers}L d={cfg.d_model})")
        stream = batch_stream(cfg, args.batch, args.seq, seed=0, device=dev)
        state = trainer.fit(state, stream, args.steps, log_every=10,
                            log_fn=log)

        # simulate preemption: restore from the checkpoint and continue
        trainer2 = Trainer(model, opt, ckpt_dir=ckpt_dir, remat=False,
                           device=dev)
        state2 = trainer2.restore_or_init()
        resumed = (int(state2.step), int(state2.data_cursor))
        print(f"restart: resumed at step {resumed[0]} "
              f"(cursor {resumed[1]}) — continuing 10 more")
        stream2 = batch_stream(cfg, args.batch, args.seq, seed=0,
                               start_cursor=state2.data_cursor, device=dev)
        state2 = trainer2.fit(state2, stream2, 10, log_every=5, log_fn=log)
    return {"arch": cfg.name, "device": str(dev), "params": n_params,
            "tokens_shape": [args.batch, args.seq], "losses": losses,
            "resumed_step": resumed[0], "resumed_cursor": resumed[1],
            "final_step": int(state2.step)}


if __name__ == "__main__":
    main()
