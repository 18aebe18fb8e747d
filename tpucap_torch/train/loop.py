"""Train step, the optimizers and their lr schedules (port of
``tpucap.train.loop``).

Single device, one optimizer step per batch. An optimizer is a pair of
plain functions over param trees, ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, chained in optax's
order (``build_optimizer``): a global-norm clip, then Adam's moments with
bias correction, sgd's momentum trace, rmsprop's or adagrad's root scaling,
adamw's decayed weights, then ``-lr`` or ``-schedule(count)``;
``apply_updates`` adds the updates to the params. The arithmetic is
optax's, written out in torch, the schedules in f32 on a count tensor;
where the two round differently the tests say by how much.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from tpucap_torch.core import tree_leaves, tree_map, tree_map_with_path
from tpucap_torch.train.loss import (
    caption_loss_sums,
    loss_from_sums,
    warn_if_attention_reg_unused,
)


@dataclasses.dataclass
class TrainState:
    """``rng`` is the ``torch.Generator`` dropout draws from (tpucap keeps
    a jax key there and splits it every step)."""

    step: int
    params: Any
    opt_state: Any
    rng: Any

    @classmethod
    def create(cls, params, optimizer, rng):
        return cls(step=0, params=params, opt_state=optimizer.init(params), rng=rng)


def own_state(state: TrainState) -> TrainState:
    """Copy every tensor of the state, so that a step that updates in
    place (``donate=True``) leaves the caller's tensors alone."""
    return TrainState(
        step=state.step,
        params=tree_map(torch.clone, state.params),
        opt_state=tree_map(torch.clone, state.opt_state),
        rng=state.rng,
    )


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    """``stateless`` members keep no state: ``init`` gives None and
    ``update`` passes the state through (``chain`` stores nothing for
    them)."""

    init: Callable
    update: Callable
    stateless: bool = False


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """optax.scale_by_adam: state {count, mu, nu}; the update is
    mu_hat / (sqrt(nu_hat) + eps) with the moments bias-corrected by
    1 - b**count, computed in f32."""

    def init(params):
        leaf = tree_leaves(params)[0]
        return {
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    def update(grads, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=c.device) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=c.device) ** c
        updates = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def trace(decay: float):
    """optax.trace (no Nesterov): state {trace}; t' = g + decay * t is both
    the update and the new trace (sgd's momentum)."""

    def update(grads, state, params=None):
        new = tree_map(lambda g, t: g + decay * t, grads, state["trace"])
        return new, {"trace": new}

    return GradientTransformation(lambda params: {"trace": tree_map(torch.zeros_like, params)}, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0):
    """optax.scale_by_rms (eps inside the root, no bias correction): state
    {nu}, nu' = (1 - decay) g^2 + decay nu, update rsqrt(nu' + eps) * g."""

    def update(grads, state, params=None):
        nu = tree_map(lambda g, v: (1 - decay) * (g * g) + decay * v, grads, state["nu"])
        return tree_map(lambda v, g: torch.rsqrt(v + eps) * g, nu, grads), {"nu": nu}

    def init(params):
        return {"nu": tree_map(lambda p: torch.full_like(p, initial_scale), params)}

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1, eps: float = 1e-7):
    """optax.scale_by_rss (adagrad): state {sum_of_squares}, s' = g^2 + s,
    update (rsqrt(s' + eps) where s' > 0, else 0) * g."""

    def update(grads, state, params=None):
        ss = tree_map(lambda g, s: g * g + s, grads, state["sum_of_squares"])
        scale = tree_map(lambda s: torch.where(s > 0, torch.rsqrt(s + eps), 0.0), ss)
        return tree_map(lambda a, g: a * g, scale, grads), {"sum_of_squares": ss}

    def init(params):
        return {
            "sum_of_squares": tree_map(
                lambda p: torch.full_like(p, initial_accumulator_value), params
            )
        }

    return GradientTransformation(init, update)


_INT32_MAX = 2**31 - 1


def scale_by_schedule(step_size_fn):
    """optax.scale_by_schedule: state {count} (int32); the updates are
    multiplied by ``step_size_fn(count)`` at the count before the step,
    then the count goes up by one (saturating, optax's safe_increment)."""

    def init(params):
        leaf = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(updates, state, params=None):
        count = state["count"]
        step_size = step_size_fn(count)
        updates = tree_map(lambda g: step_size.to(g.dtype) * g, updates)
        return updates, {"count": torch.where(count < _INT32_MAX, count + 1, count)}

    return GradientTransformation(init, update)


def _stateless(fn):
    return GradientTransformation(lambda params: None, fn, stateless=True)


def add_decayed_weights(weight_decay: float):
    return _stateless(
        lambda u, s, p: (tree_map(lambda a, b: a + weight_decay * b, u, p), s)
    )


def scale_by_learning_rate(lr: float):
    return _stateless(lambda u, s, p=None: (tree_map(lambda a: -lr * a, u), s))


def clip_by_global_norm(max_norm: float):
    """optax.clip_by_global_norm: g / ||g|| * max_norm where the global
    norm is at least max_norm."""

    def update(u, s, p=None):
        norm = torch.sqrt(sum((g * g).sum() for g in tree_leaves(u)))
        keep = norm < max_norm
        return tree_map(lambda g: torch.where(keep, g, (g / norm) * max_norm), u), s

    return _stateless(update)


def chain(*transforms):
    """optax.chain. Its state holds the stateful members' states only: a
    tuple of them in chain order, the one member's own state when there is
    one (plain Adam's ``{"count", "mu", "nu"}``), None when there is none
    (sgd at a constant lr)."""
    live = [t for t in transforms if not t.stateless]

    def pack(states):
        return states[0] if len(states) == 1 else (tuple(states) or None)

    def init(params):
        return pack([t.init(params) for t in live])

    def update(updates, state, params=None):
        states = iter([state] if len(live) == 1 else (state or ()))
        new = []
        for t in transforms:
            if t.stateless:
                updates, _ = t.update(updates, None, params)
            else:
                updates, s = t.update(updates, next(states), params)
                new.append(s)
        return updates, pack(new)

    return GradientTransformation(init, update, stateless=not live)


# -- lr schedules: count (an int32 tensor) -> lr (an f32 tensor on its device),
# in f32 as optax computes them under jit. Divisors are tensors on the count's
# device: CUDA divides by a host scalar as a multiplication by its reciprocal.


def _f32(value, like):
    return torch.full((), value, dtype=torch.float32, device=like.device)


def constant_schedule(value: float):
    return lambda count: _f32(value, count)


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """optax.cosine_decay_schedule (alpha 0, exponent 1): init_value *
    0.5 (1 + cos(pi min(count, decay_steps) / decay_steps))."""
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps}."
        )

    def schedule(count):
        steps = _f32(float(decay_steps), count)
        c = torch.minimum(count.float(), steps)
        return init_value * (0.5 * (1 + torch.cos(math.pi * c / steps)))

    return schedule


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float):
    """optax.exponential_decay (no staircase, no transition_begin, no
    end_value): init_value * decay_rate ** (count / transition_steps)."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(count):
        p = count / _f32(float(transition_steps), count)
        decayed = init_value * torch.pow(_f32(decay_rate, count), p)
        return torch.where(count <= 0, _f32(init_value, count), decayed)

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule (polynomial, power 1)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        frac = 1 - torch.clamp(count, 0, transition_steps) / _f32(float(transition_steps), count)
        return (init_value - end_value) * frac + end_value

    return schedule


def join_schedules(schedules, boundaries):
    """optax.join_schedules: past each boundary the next schedule, which
    sees the count less the boundary."""

    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, sched(count - boundary))
        return out

    return schedule


def lr_schedule(cfg, total_steps: int = 0):
    """TrainConfig's schedule as tpucap builds it, or None for a constant lr
    without warmup (a plain scale, no count in the state). cosine decays to
    0 over the post-warmup horizon max(1, (total_steps or lr_decay_steps) -
    warmup_steps); exponential multiplies by lr_decay_rate every
    lr_decay_steps; warmup_steps > 0 prepends a linear ramp from 0."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        sched = None if not cfg.warmup_steps else constant_schedule(lr)
    elif cfg.lr_schedule == "cosine":
        horizon = max(1, (total_steps or cfg.lr_decay_steps) - cfg.warmup_steps)
        sched = cosine_decay_schedule(lr, horizon)
    elif cfg.lr_schedule == "exponential":
        sched = exponential_decay(lr, max(1, cfg.lr_decay_steps), cfg.lr_decay_rate)
    else:
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; have constant|cosine|exponential"
        )
    if cfg.warmup_steps:
        sched = join_schedules(
            [linear_schedule(0.0, lr, cfg.warmup_steps), sched], [cfg.warmup_steps]
        )
    return sched


OPTIMIZERS = ("adagrad", "adam", "adamw", "rmsprop", "sgd")


def freeze_subtree_updates(optimizer, is_frozen):
    """Zero the updates whose key path (a tuple of dict keys and list
    indices) satisfies ``is_frozen(path)`` after the base optimizer has run,
    so that no term of it (adamw's decayed weights included) moves a frozen
    leaf. State-transparent: ``init`` and the state are the base
    optimizer's, so a checkpoint made with the freeze restores into a
    template made without it."""

    def update(updates, state, params=None):
        updates, state = optimizer.update(updates, state, params)
        updates = tree_map_with_path(
            lambda path, u: torch.zeros_like(u) if is_frozen(path) else u, updates
        )
        return updates, state

    return GradientTransformation(optimizer.init, update, optimizer.stateless)


def build_optimizer(cfg, total_steps: int = 0):
    """TrainConfig -> optimizer, as tpucap's ``build_optimizer`` chains
    optax: adam, adamw, sgd (with ``momentum`` > 0 a trace), rmsprop
    (decay 0.9, Keras's rho) or adagrad, at ``lr_schedule``'s lr, which
    ``total_steps`` (epochs x steps a epoch; 0 falls back to
    lr_decay_steps) anchors for cosine; ``grad_clip_norm`` > 0 clips by the
    global norm first. With every knob at its default this is plain Adam,
    whose state is the ``{"count", "mu", "nu"}`` dict that the port's
    earlier checkpoints hold."""
    sched = lr_schedule(cfg, total_steps)
    if sched is None:
        scale = scale_by_learning_rate(cfg.learning_rate)
    else:
        scale = scale_by_schedule(lambda count: -sched(count))
    if cfg.optimizer == "adam":
        base = chain(scale_by_adam(), scale)
    elif cfg.optimizer == "adamw":
        base = chain(scale_by_adam(), add_decayed_weights(cfg.weight_decay), scale)
    elif cfg.optimizer == "sgd":
        base = chain(trace(cfg.momentum), scale) if cfg.momentum else chain(scale)
    elif cfg.optimizer == "rmsprop":
        base = chain(scale_by_rms(decay=0.9), scale)
    elif cfg.optimizer == "adagrad":
        base = chain(scale_by_rss(), scale)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; have {list(OPTIMIZERS)}")
    if cfg.grad_clip_norm:
        return chain(clip_by_global_norm(cfg.grad_clip_norm), base)
    return base


def apply_updates(params, updates, *, in_place: bool = False):
    """params + updates; with ``in_place`` the params' own tensors take the
    sums (the step owns them, ``donate=True``)."""
    if in_place:
        return tree_map(lambda p, u: p.copy_(p + u), params, updates)
    return tree_map(lambda p, u: p + u, params, updates)


def trainable(tree):
    """Leaves of ``tree`` as new autograd leaves (sharing storage)."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def grads_of(loss, tree, *, retain_graph: bool = False):
    """d loss / d leaf for every leaf of ``tree``; a leaf that does not
    require grad, or that the loss does not reach, gets zeros.
    ``retain_graph`` keeps the graph for another backward."""
    leaves = tree_leaves(tree)
    live = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(loss, live, allow_unused=True, retain_graph=retain_graph))
    out = iter(
        [
            (g if (g := next(got)) is not None else torch.zeros_like(t))
            if t.requires_grad
            else torch.zeros_like(t)
            for t in leaves
        ]
    )
    return tree_map(lambda _: next(out), tree)


def check_compute_dtype(compute_dtype):
    """None (f32) or bf16, with f32 master params, as tpucap trains."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise NotImplementedError(f"compute_dtype={compute_dtype} is not ported (None or bfloat16)")


def refuse_unported(**knobs):
    """knobs: name -> (value, default). Raise for the first knob of
    tpucap's signature that the port does not have and that was given a
    value other than its default."""
    for name, (value, default) in knobs.items():
        if value != default:
            raise NotImplementedError(f"{name}={value!r} is not ported (only {default!r})")


def _tree_add(acc, tree):
    return tree if acc is None else tree_map(torch.add, acc, tree)


def accumulated_sum_grads(sums_fn, params, features, tokens, *, steps: int, use_reg: bool = False):
    """Gradient accumulation in sum form: ``steps`` microbatches (rows
    [i mb, (i + 1) mb) of the batch, in order), accumulating the sum-form
    loss pieces (``sums_fn(params, features, tokens)`` ->
    ``caption_loss_sums``' dict) and the gradients of the raw,
    unnormalized sums. -> (g_nll, g_reg, sums), g_reg None unless
    ``use_reg`` (the attention regularizer's head, a second backward
    through the same forward).

    Normalizing once by the accumulated counts (``normalized_accum_grads``)
    gives the full-batch gradient up to f32 reassociation, since the loss
    is linear in the sums; averaging the microbatches' mean-loss gradients
    would not be exact when their pad counts differ. The logits and the
    activations live one microbatch at a time."""
    B = features.shape[0]
    if B % steps:
        raise ValueError(f"batch size {B} not divisible by grad_accum_steps {steps}")
    mb = B // steps
    g_nll = g_reg = sums = None
    for i in range(steps):
        s = sums_fn(params, features[i * mb : (i + 1) * mb], tokens[i * mb : (i + 1) * mb])
        if use_reg:
            g_reg = _tree_add(g_reg, grads_of(s["reg_sum"], params, retain_graph=True))
        g_nll = _tree_add(g_nll, grads_of(s["nll_sum"], params))
        sums = _tree_add(sums, {k: v.detach() for k, v in s.items()})
    return g_nll, g_reg, sums


def normalized_accum_grads(g_nll, g_reg, sums, *, attention_reg: float):
    """Accumulated raw-sum gradients -> the full-batch gradient:
    g_nll / tokens (+ attention_reg * g_reg / rows)."""
    denom = sums["tokens"].clamp(min=1.0)
    grads = tree_map(lambda g: g / denom, g_nll)
    if g_reg is not None:
        rows = sums["batch"].clamp(min=1.0)
        grads = tree_map(lambda g, h: g + attention_reg * (h / rows), grads, g_reg)
    return grads


def make_train_step(
    decoder,
    optimizer,
    *,
    pad_id: int = 0,
    label_smoothing: float = 0.0,
    attention_reg: float = 0.0,
    deterministic: bool = False,
    grad_accum_steps: int = 1,
    compute_dtype=None,
    donate: bool = False,
    scheduled_sampling: bool = False,
    multi_steps: int = 1,
) -> Callable:
    """Single-device step: (state, features, tokens) -> (state, metrics),
    metrics as device scalars.

    ``scheduled_sampling=True`` makes the signature (state, features,
    tokens, ss_eps): each input token at position >= 1 is replaced by the
    model's own gradient-free first-pass prediction with probability
    ``ss_eps`` (``train/scheduled.py``), the coin drawn from ``state.rng``
    before the dropout, once a microbatch when accumulating.
    ``multi_steps=N`` > 1 gives a step over stacked inputs, features (N, B,
    F) and tokens (N, B, T): the single step N times in one call, the
    update sequence that of N single calls, the metrics summed over the N
    steps on the device (the caller divides by the step count).

    ``compute_dtype=torch.bfloat16`` is mixed precision: the forward and
    backward in bf16 from a cast made inside the differentiated function,
    f32 master params, optimizer state and loss reductions.
    ``donate=True`` updates the state's tensors in place (the caller owns
    the state and rebinds it every call, ``state, m = step(state, ...)``).
    ``attention_reg`` > 0 adds the doubly-stochastic regularizer for a
    decoder with attention maps (a warning for the others).
    ``grad_accum_steps`` = A > 1 splits the batch into A microbatches run
    one after another (``accumulated_sum_grads``): the full-batch update up
    to f32 reassociation, at 1/A of the activation memory; the batch must
    divide by A.
    """
    check_compute_dtype(compute_dtype)
    warn_if_attention_reg_unused(decoder, attention_reg)
    use_reg = attention_reg > 0.0 and hasattr(decoder, "forward_train_with_alphas")

    def step(state: TrainState, features, tokens, ss_eps=None):
        params = trainable(state.params)
        if not scheduled_sampling:
            ss_eps = None

        def sums_fn(p, f, t):
            return caption_loss_sums(
                decoder,
                p,
                f,
                t,
                rng=state.rng,
                deterministic=deterministic,
                pad_id=pad_id,
                label_smoothing=label_smoothing,
                attention_reg=attention_reg,
                compute_dtype=compute_dtype,
                ss_eps=ss_eps,
                ss_rng=None if ss_eps is None else state.rng,
            )

        grads, metrics = loss_and_grads(
            sums_fn, params, features, tokens, grad_accum_steps, use_reg, attention_reg
        )
        return optimizer_step(state, optimizer, grads, metrics, donate)

    if multi_steps > 1:

        def multi(state: TrainState, features, tokens, ss_eps=None):
            sums = None
            for f, t in zip(features, tokens):
                state, m = step(state, f, t, ss_eps)
                sums = m if sums is None else {k: sums[k] + v for k, v in m.items()}
            return state, sums

        return multi
    return step


def loss_and_grads(sums_fn, params, features, tokens, grad_accum_steps, use_reg, attention_reg):
    """-> (grads, metrics) of the loss from ``sums_fn(params, features,
    tokens)``: one backward of the normalized loss, or with
    ``grad_accum_steps`` > 1 the accumulated sum-form gradients normalized
    once."""
    if grad_accum_steps > 1:
        g_nll, g_reg, sums = accumulated_sum_grads(
            sums_fn, params, features, tokens, steps=grad_accum_steps, use_reg=use_reg
        )
        grads = normalized_accum_grads(g_nll, g_reg, sums, attention_reg=attention_reg)
        return grads, loss_from_sums(sums, attention_reg=attention_reg)[1]
    loss, metrics = loss_from_sums(sums_fn(params, features, tokens), attention_reg=attention_reg)
    return grads_of(loss, params), metrics


def optimizer_step(state, optimizer, grads, metrics, donate, mask_updates=None):
    """The step's second half: updates from the gradients (then
    ``mask_updates``), the new params and optimizer state (in the state's
    own tensors with ``donate``), metrics detached."""
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        if mask_updates is not None:
            updates = mask_updates(updates)
        if donate:
            opt_state = tree_map(lambda old, new: old.copy_(new), state.opt_state, opt_state)
        params = apply_updates(state.params, updates, in_place=donate)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return TrainState(step=state.step + 1, params=params, opt_state=opt_state, rng=state.rng), metrics


def make_eval_step(
    decoder,
    *,
    pad_id: int = 0,
    attention_reg: float = 0.0,
    label_smoothing: float = 0.0,
    compute_dtype=None,
) -> Callable:
    """(params, features, tokens) -> metrics of the training objective,
    dropout off, no gradient: ``make_eval_sums_step`` normalized."""
    sums_step = make_eval_sums_step(
        decoder,
        pad_id=pad_id,
        attention_reg=attention_reg,
        label_smoothing=label_smoothing,
        compute_dtype=compute_dtype,
    )

    def step(params, features, tokens):
        return loss_from_sums(sums_step(params, features, tokens), attention_reg=attention_reg)[1]

    return step


def make_eval_sums_step(
    decoder,
    *,
    pad_id: int = 0,
    attention_reg: float = 0.0,
    label_smoothing: float = 0.0,
    compute_dtype=None,
) -> Callable:
    """(params, features, tokens) -> the sum-form pieces of the training
    objective for one fixed-shape chunk (``caption_loss_sums``), dropout
    off, no gradient, no generator drawn. Add the chunks' dicts and
    normalize once with ``loss_from_sums``: the loss over the whole set,
    zero-padded tail rows adding nothing to any sum."""
    check_compute_dtype(compute_dtype)

    @torch.no_grad()
    def step(params, features, tokens):
        return caption_loss_sums(
            decoder,
            params,
            features,
            tokens,
            deterministic=True,
            pad_id=pad_id,
            label_smoothing=label_smoothing,
            attention_reg=attention_reg,
            compute_dtype=compute_dtype,
        )

    return step
