"""``launch.serve.generate`` on a grid cuts the weights into their pieces
once, before the prefill, so its decode steps move activations only.

Costed on the "node" grid's fake cards (``launch/mesh.py``, the dry
run's counter ``launch/cost.py``), a reduced model given whole weights
(on the host): the bytes the cards receive through copies in one decode
step of ``generate(env=)`` (2 steps less 1) equal those of a decode step
on weights cut beforehand; a decode step handed the whole weights
instead receives more than half the weights' bytes on top, the pieces
copied to their cards again.
"""
import pytest

torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data.lm import encoder_frames  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.cost import OpCounter  # noqa: E402
from repro_torch.launch.mesh import make_env  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.specs import init_params  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402

B, S, CACHE = 8, 16, 24


def _received(fm, fn) -> float:
    """The bytes every fake card receives through copies while ``fn``
    runs, summed."""
    with fm, OpCounter() as c, torch.inference_mode():
        fn()
    return c.total("copy_bytes_in")


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "recurrentgemma-9b",
                                  "whisper-tiny"))
def test_generate_cuts_the_weights_once(arch):
    cfg = ARCHS[arch].reduced()
    env = make_env("node", "train")
    fm = FakeTensorMode()
    with fm:
        model = build_model(cfg)
        params = init_params(model, cast=True)
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.zeros((B, encoder_frames(cfg),
                                           cfg.d_model))
        weights = sum(t.numel() * t.element_size() for t in leaves(params))
        cut = sh.pieces(params, env)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=env.first)
        pos = torch.tensor(S, dtype=torch.int32, device=env.first)
    a_step = [_received(fm, lambda n=n: generate(
        model, params, batch, steps=n, cache_len=CACHE, env=env))
        for n in (1, 2)]
    with fm, torch.inference_mode():
        _, caches = model.prefill(cut, batch, cache_len=CACHE, env=env)
    steps = {name: _received(fm, lambda w=w: model.decode_step(
        w, caches, tok, pos, env=env)) for name, w in (("cut", cut),
                                                     ("whole", params))}
    assert a_step[1] - a_step[0] == steps["cut"]
    assert steps["whole"] - steps["cut"] > weights / 2
