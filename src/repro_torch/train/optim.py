"""Optimizers: AdamW and Adafactor on trees of tensors.

The port of ``src/repro/train/optim.py``, JAX's formulas on torch
tensors (not ``torch.optim``, whose ``AdamW`` decays every leaf and
orders its arithmetic otherwise).  A tree is nested dicts and lists of
tensors, as the model's parameters are.  AdamW keeps float32 (m, v) per
parameter; Adafactor factors the second moment of a matrix into row and
column statistics where ``_is_factored``.  Both expose the same
(init, update) pair:

    state = init(params)
    new_params, new_state, gnorm = update(grads, state, params, step)

JAX stacks the layers of its pattern groups (and the encoder and cross
layers) on a leading axis, and two of its rules read that layout: a
leaf decays when it is ≥2-D, so a stacked norm scale decays where the
tail's does not, and Adafactor clips each leaf's update to RMS ≤ 1 over
the whole stack.  The port keeps one tensor per layer, so
``build_optimizer`` takes ``stacks``: the groups of leaves (indices in
``leaves`` order) that JAX holds as one stacked leaf, each with its
stacked flag (``Model.jax_stacks`` gives them for a model's parameters);
without it every leaf stands alone, unstacked.

On a grid (``env``) the leaves are ``Sharded`` pieces: the masters, the
gradients and the state each by its ``infer_param_specs`` layout, and
the update runs on the pieces (JAX pins the gradients to the masters'
layout, so XLA updates each device's shard).  Each distinct piece is
updated once, on its own device, with the clip scale and the learning
rate sent there as 0-d tensors; no whole leaf is built.  The rules that
read a whole leaf sum over its pieces in a fixed order: the global norm
adds one sum of squares per part of each leaf (a replicated part once),
in leaf order, then part order, on the first cell; Adafactor's row and
column means add the pieces' sums along the cut dimension in rank order
(``sharding.psum``) and divide by the whole dimension, and its RMS clip
adds the stack's parts as the norm does.  A factored moment is computed
in its gradient's rows' (or columns') layout and laid out again by its
own spec (``sharding.relayout``).  With one piece a leaf (a grid of one
cell) the arithmetic is the one-device update's, bit for bit.

``step`` is a 0-d int32 tensor on the parameters' device; the learning
rate and the bias corrections are computed from it there, so an update
reads nothing back to the host.  ``update`` is functional: it returns
new tensors and leaves its arguments as they were.  The global-norm clip
scales each gradient leaf inside its own update (JAX scales the whole
tree first: the same products), so no scaled copy of the gradients is
held beside them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshEnv, Sharded

Tree = Any
Stacks = Sequence[Tuple[Sequence[int], bool]]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # adafactor
    decay_offset: float = 0.8    # beta2_t = 1 - step^-decay_offset
    factored_min_dim: int = 128


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in JAX's leaf order
    (dict keys sorted, lists in order); a ``Sharded`` is one leaf."""
    if isinstance(tree, Sharded):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _flatten_up_to(structure: Tree, tree: Tree) -> List[Any]:
    """``tree``'s subtrees at the leaves of ``structure`` (an Adafactor
    state's (vr, vc) tuples at the parameters' leaves)."""
    if isinstance(structure, dict):
        return [x for k in sorted(structure)
                for x in _flatten_up_to(structure[k], tree[k])]
    if isinstance(structure, list) and not isinstance(structure, Sharded):
        return [x for s, t in zip(structure, tree)
                for x in _flatten_up_to(s, t)]
    return [tree]


def unflatten(structure: Tree, values: List[Any]) -> Tree:
    """A tree shaped like ``structure`` (dicts, lists, tuples) holding
    ``values`` in ``leaves`` order."""
    return _build(structure, iter(values))


def _build(node: Tree, it: Iterator[Any]) -> Tree:
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, and its iterator would hold ``values`` (a step's
    # gradients, say) until the garbage collector ran
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)) and not isinstance(node, Sharded):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def tree_map(fn: Callable, tree: Tree) -> Tree:
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then constant: a 0-d float32 tensor."""
    warm = torch.clamp((step.float() + 1.0) / max(cfg.warmup_steps, 1),
                       max=1.0)
    return cfg.lr * warm


def _square_sums(x, env: Optional[MeshEnv]) -> List[torch.Tensor]:
    """A leaf's sum of squares in float32: one for a tensor; for a
    ``Sharded``, one per part (a replicated part once), in part order,
    each on the first cell's device."""
    if not isinstance(x, Sharded):
        return [torch.sum(torch.square(x.float()))]
    return [torch.sum(torch.square(t.float())).to(env.first)
            for t in sh.distinct_pieces(x, env)]


def global_norm(grads: Tree, env: Optional[MeshEnv] = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in
    float32, summed in leaf order (JAX's Python ``sum``); a ``Sharded``
    leaf's parts in part order (``env``: their grid)."""
    return torch.sqrt(sum(s for g in leaves(grads)
                          for s in _square_sums(g, env)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, the global
    norm before scaling)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def _shape(x, env: Optional[MeshEnv]) -> Tuple[int, ...]:
    """A leaf's whole shape."""
    return sh.whole_shape(x, env) if isinstance(x, Sharded) else \
        tuple(x.shape)


def _pmap(fn: Callable, *xs):
    """``fn`` on a leaf's pieces: on tensors, ``fn(*xs)``; on ``Sharded``
    leaves whose cells line up (cell c of each holds the part of cell c's
    piece of the first), once per distinct tuple of pieces, on their
    device, the result laid out as the first (a tuple result: a tuple of
    leaves)."""
    if not isinstance(xs[0], Sharded):
        return fn(*xs)
    out = sh.cellwise(fn, *xs)
    if isinstance(out[0], tuple):
        return tuple(Sharded(list(o), xs[0].spec) for o in zip(*out))
    return Sharded(out, xs[0].spec)


def _at_devices(*scalars: torch.Tensor) -> Callable:
    """device -> the 0-d ``scalars`` on it (sent once per device; on
    their own device, themselves)."""
    sent: dict = {}

    def at(device):
        if device not in sent:
            sent[device] = tuple(x.to(device) for x in scalars)
        return sent[device]

    return at


def _mean(x, dim: int, env: Optional[MeshEnv]):
    """``x.mean(dim)`` of a leaf.  A ``Sharded`` whose ``dim`` is cut
    adds its pieces' sums along ``dim`` in rank order (``psum`` over the
    cutting axes) and divides by the whole dimension; the result is laid
    out by the spec without ``dim``."""
    if not isinstance(x, Sharded):
        return x.mean(dim)
    spec = sh._full_spec(x.spec, x[0].dim())
    dim %= len(spec)
    rest = sh.P(*(spec[:dim] + spec[dim + 1:]))
    axes = sh._axes(spec[dim])
    if env.size(axes) == 1:
        return Sharded(sh.cellwise(lambda t: t.mean(dim), x), rest)
    n = _shape(x, env)[dim]
    total = sh.psum(sh.cellwise(lambda t: t.sum(dim), x), env, axes)
    return Sharded(sh.cellwise(lambda t: t / n, total), rest)


def _lay(x, spec, env: Optional[MeshEnv], own: bool = False):
    """A leaf laid out by ``spec`` (a tensor, or ``spec`` None: as it
    is); with ``own``, pieces that are views of larger ones copied, so an
    output owns its storage."""
    if spec is None or not isinstance(x, Sharded):
        return x
    x = sh.relayout(x, spec, env)
    return sh.own_pieces(x) if own else x


def _groups(stacks: Optional[Stacks], n: int) -> Stacks:
    groups = stacks if stacks is not None else [([i], False)
                                                 for i in range(n)]
    if sorted(i for idx, _ in groups for i in idx) != list(range(n)):
        raise ValueError(f"stacks must cover the {n} leaves once each")
    return groups


def _apply(upd: Callable, stacks: Optional[Stacks], grads: Tree,
           params: Tree, *states: Tree) -> Tuple[List[Any], ...]:
    """``upd(ps, gs, ss, stacked)`` over each group of ``stacks`` (lists of
    the group's parameter and gradient leaves and the states' subtrees at
    them), returning per member a tuple of outputs; returns one list per
    output, in leaf order."""
    p_flat = leaves(params)
    g_flat = leaves(grads)
    s_flats = [_flatten_up_to(params, s) for s in states]
    outs: List[Any] = [None] * len(p_flat)
    for idx, stacked in _groups(stacks, len(p_flat)):
        got = upd([p_flat[i] for i in idx], [g_flat[i] for i in idx],
                  [[sf[i] for sf in s_flats] for i in idx], stacked)
        for i, o in zip(idx, got):
            outs[i] = o
    return tuple(list(o) for o in zip(*outs))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(cfg: OptimizerConfig, stacks: Optional[Stacks] = None,
          env: Optional[MeshEnv] = None):
    def init(params: Tree) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads: Tree, state: dict, params: Tree, step: torch.Tensor):
        with torch.no_grad():
            gn = global_norm(grads, env)
            scale = _clip_scale(gn, cfg.grad_clip)
            lr = schedule(cfg, step)
            t = step.float() + 1.0
            at = _at_devices(scale, lr, 1.0 - torch.pow(cfg.b1, t),
                             1.0 - torch.pow(cfg.b2, t))

            def upd1(p, g, m, v, stacked):
                # JAX's expressions, each product and sum rounded as
                # there; the in-place ops act on temporaries only
                scale, lr, bc1, bc2 = at(p.device)
                g = (g * scale.to(g.dtype)).float()
                m = cfg.b1 * m
                m += (1 - cfg.b1) * g
                g.square_()
                g *= 1 - cfg.b2
                v = cfg.b2 * v
                v += g
                del g
                step_ = m / bc1
                step_ /= torch.sqrt(v / bc2).add_(cfg.eps)
                if p.dim() + stacked >= 2:   # no decay on 1-D leaves
                    step_ += cfg.weight_decay * p.float()
                step_ *= lr
                return (p.float() - step_).to(p.dtype), m, v

            def upd(ps, gs, ss, stacked):
                return [_pmap(lambda p, g, m, v: upd1(p, g, m, v, stacked),
                              p, g, m, v)
                        for p, g, (m, v) in zip(ps, gs, ss)]

            new_p, new_m, new_v = _apply(upd, stacks, grads, params,
                                         state["m"], state["v"])
        return (unflatten(params, new_p),
                {"m": unflatten(params, new_m),
                 "v": unflatten(params, new_v)}, gn)

    return init, update


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------

def _is_factored(p: torch.Tensor, min_dim: int) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= min_dim and \
        p.shape[-2] >= min_dim


def adafactor(cfg: OptimizerConfig, stacks: Optional[Stacks] = None,
              env: Optional[MeshEnv] = None):
    def init(params: Tree) -> dict:
        def st(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)
            if _is_factored(p, cfg.factored_min_dim):
                return (zeros(p.shape[:-1]),                       # vr
                        zeros(p.shape[:-2] + p.shape[-1:]))        # vc
            return (zeros(p.shape),)                               # v
        return {"s": tree_map(st, params)}

    def update(grads: Tree, state: dict, params: Tree, step: torch.Tensor):
        with torch.no_grad():
            gn = global_norm(grads, env)
            scale = _clip_scale(gn, cfg.grad_clip)
            lr = schedule(cfg, step)
            t = step.float() + 1.0
            beta2 = 1.0 - torch.pow(t, -cfg.decay_offset)
            at = _at_devices(scale, beta2)

            def direction(g, s):
                # on a grid: vr in the layout of g's rows, vc of its
                # columns, each laid out by its own spec when it is stored
                g = _pmap(lambda g: (g * at(g.device)[0].to(g.dtype))
                          .float(), g)
                g2 = _pmap(lambda g: torch.square(g) + 1e-30, g)

                def moment(s, mean):
                    return _pmap(lambda s, m: at(s.device)[1] * s
                                 + (1 - at(s.device)[1]) * m,
                                 _lay(s, mean.spec if isinstance(
                                     mean, Sharded) else None, env), mean)

                if len(s) == 2:
                    vr = moment(s[0], _mean(g2, -1, env))
                    vc = moment(s[1], _mean(g2, -2, env))
                    del g2
                    rm = _mean(vr, -1, env)
                    d = _pmap(lambda g, vr, vc, rm: g / torch.clamp(
                        torch.sqrt(vr[..., :, None] * vc[..., None, :]
                                   / torch.clamp(rm[..., None, None],
                                                 min=1e-30)), min=1e-30),
                              g, vr, vc, rm)
                    ns = (vr, vc)
                else:
                    v = moment(s[0], g2)
                    del g2
                    d = _pmap(lambda g, v: g / torch.clamp(torch.sqrt(v),
                                                           min=1e-30), g, v)
                    ns = (v,)
                if isinstance(g, Sharded):
                    ns = tuple(_lay(n, sp.spec, env, own=True)
                               for n, sp in zip(ns, s))
                return d, ns

            def upd(ps, gs, ss, stacked):
                shape0 = _shape(ps[0], env)
                if stacked and len(shape0) == 1 and min(
                        len(ps), shape0[0]) >= cfg.factored_min_dim:
                    raise NotImplementedError(
                        "JAX factors this stack across its layer axis; the "
                        "port keeps one tensor per layer")
                dirs = [direction(g, s) for g, (s,) in zip(gs, ss)]
                # Adafactor's update clipping (RMS <= 1), over the stack
                sq = sum(x for d, _ in dirs for x in _square_sums(d, env))
                count = 0
                for d, _ in dirs:
                    n = 1
                    for x in _shape(d, env):
                        n *= x
                    count += n
                rms = torch.sqrt(sq / count + 1e-30)
                at_r = _at_devices(rms, lr)

                def new_p(p, step_):
                    rms, lr = at_r(p.device)
                    step_ = step_ / torch.clamp(rms, min=1.0)
                    if p.dim() + stacked >= 2:
                        step_ = step_ + cfg.weight_decay * p.float()
                    return (p.float() - lr * step_).to(p.dtype)

                return [(_pmap(new_p, p, step_), ns)
                        for p, (step_, ns) in zip(ps, dirs)]

            new_p, new_s = _apply(upd, stacks, grads, params, state["s"])
        return unflatten(params, new_p), {"s": unflatten(params, new_s)}, gn

    return init, update


def build_optimizer(cfg: OptimizerConfig, stacks: Optional[Stacks] = None,
                    env: Optional[MeshEnv] = None):
    """The (init, update) pair of ``cfg.name``; ``stacks`` and ``env`` (the
    grid of an update on ``Sharded`` leaves) as the module docstring
    says."""
    if cfg.name == "adamw":
        return adamw(cfg, stacks, env)
    if cfg.name == "adafactor":
        return adafactor(cfg, stacks, env)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
