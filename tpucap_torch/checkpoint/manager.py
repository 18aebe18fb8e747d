"""The port's checkpoint manager: the surface of ``tpucap.checkpoint.
CheckpointManager`` that ``fit`` and the CLI reach, on a format of its own.

tpucap's manager is orbax's, and the port reads no orbax. Here a step is
one directory ``<step>/`` holding ``state.npz`` (the step, the params and
the optimizer state if it has one, each leaf with its dtype as
``convert.save_npz`` keeps it, and the dropout generator's state as
``rng``) and ``metrics.json`` (the step's metrics, or null). A save
writes ``<step>.tmp/`` and renames it into place once both files are
written, and a deletion renames the step away before removing it, so a
process killed at any point leaves no directory that reads as a complete
step. A directory that holds orbax checkpoints is refused.

Which steps are kept and which is best follow orbax 0.11.32 as tpucap
configures it (``checkpoint_manager.py``'s ``should_save``, ``latest_step``,
``best_step`` and the ``BestN`` / ``LatestN`` preservation policies with
``keep_checkpoints_without_metrics=True``):

- a save of a step at or below the latest is skipped;
- with ``best_metric``, once more than ``max_to_keep`` steps exist, the
  ``max_to_keep`` best steps that have metrics stay, and so does every
  step saved without metrics; ``best_step()`` is the best step with
  metrics (None if none has any); ties go to the later step, as Python's
  stable sort leaves them;
- with ``best_metric=None``, the newest ``max_to_keep`` steps stay,
  ``best_step()`` is ``latest_step()`` and no metrics are kept.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from tpucap_torch.convert import load_npz, save_npz
from tpucap_torch.core import check_same_layout, tree_leaves, tree_map
from tpucap_torch.train.loop import TrainState

STATE_FILE = "state.npz"
METRICS_FILE = "metrics.json"
_TMP = ".tmp"


class CheckpointManager:
    def __init__(
        self,
        directory,
        *,
        max_to_keep: int | None = 3,
        best_metric: str | None = "val_loss",
        best_mode: str = "min",
        async_save: bool = False,
    ):
        if async_save:
            raise NotImplementedError("async_save=True is not ported (saves are synchronous)")
        if best_mode not in ("min", "max"):
            raise ValueError('`best_mode` must be one of: "min", "max"')
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        # (step, metrics or None), in step order.
        self._checkpoints = self._read_steps()

    def _read_steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if os.path.isdir(path) and (
                os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
                or "orbax-checkpoint-tmp" in name
            ):
                raise ValueError(
                    f"{self.directory} holds orbax checkpoints (tpucap's format), which "
                    "tpucap_torch does not read; restore them with tpucap and write the "
                    "params with convert.save_npz(path, convert.params_from_jax(params))"
                )
            if name.endswith(_TMP) and name[: -len(_TMP)].isdigit():
                shutil.rmtree(path)  # a save or a deletion that was cut off
            elif name.isdigit() and os.path.exists(os.path.join(path, STATE_FILE)):
                with open(os.path.join(path, METRICS_FILE)) as f:
                    steps.append((int(name), json.load(f)))
        return sorted(steps, key=lambda c: c[0])

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, state: TrainState, metrics: dict | None = None) -> bool:
        """Write ``state`` as step ``state.step`` with ``metrics`` (floats),
        then drop the steps the retention policy no longer keeps. A step at
        or below the latest is skipped (-> False), as orbax skips it."""
        step = int(state.step)
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        # orbax keeps a step's metrics only while it tracks a best metric.
        clean = {k: float(v) for k, v in metrics.items()} if metrics and self.best_metric else None
        payload = {"step": torch.tensor(step, dtype=torch.int64), "params": state.params}
        if state.opt_state is not None:
            payload["opt_state"] = state.opt_state
        if state.rng is not None:
            payload["rng"] = state.rng.get_state()
        tmp = self._path(step) + _TMP
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_npz(os.path.join(tmp, STATE_FILE), payload)
        with open(os.path.join(tmp, METRICS_FILE), "w") as f:
            json.dump(clean, f)
        # A <step>/ without state.npz is what a killed deletion leaves.
        shutil.rmtree(self._path(step), ignore_errors=True)
        os.replace(tmp, self._path(step))
        self._checkpoints.append((step, clean))
        for old in self._steps_to_remove():
            self._delete(old)
        return True

    def _delete(self, step: int) -> None:
        gone = self._path(step) + _TMP
        os.replace(self._path(step), gone)
        shutil.rmtree(gone)
        self._checkpoints = [c for c in self._checkpoints if c[0] != step]

    def save_rescue(self, state: TrainState) -> None:
        """A mid-epoch rescue or step-interval checkpoint, saved without
        metrics: the best-metric retention can then neither pick it as best
        nor evict it (metric-less steps are kept). Once it lands, older
        metric-less steps are deleted, so at most one is kept (epoch saves
        carry metrics and are not touched). Nothing happens when the latest
        step is this one (an interval save meeting an epoch save)."""
        step = int(state.step)
        if self.latest_step() == step:
            return
        self.save(state, metrics=None)
        if self.best_metric:
            for s, metrics in list(self._checkpoints):
                if s < step and metrics is None:
                    self._delete(s)

    def _ranked(self) -> list:
        """(index, (step, metrics)) of the steps with metrics, worst first,
        in the order orbax sorts them."""
        return sorted(
            ((i, c) for i, c in enumerate(self._checkpoints) if c[1] is not None),
            key=lambda ic: ic[1][1][self.best_metric],
            reverse=self.best_mode == "min",
        )

    def _steps_to_remove(self) -> list[int]:
        ckpts, n = self._checkpoints, self.max_to_keep
        if n is None or len(ckpts) <= n:
            return []
        if n == 0:
            keep = set()
        elif self.best_metric:
            keep = {i for i, _ in self._ranked()[-n:]}
            keep |= {i for i, c in enumerate(ckpts) if c[1] is None}
        else:
            keep = set(range(len(ckpts) - n, len(ckpts)))
        return [c[0] for i, c in enumerate(ckpts) if i not in keep]

    def latest_step(self) -> int | None:
        return self._checkpoints[-1][0] if self._checkpoints else None

    def best_step(self) -> int | None:
        if not self.best_metric:
            return self.latest_step()
        ranked = self._ranked()
        return ranked[-1][1][0] if ranked else None

    def all_steps(self) -> list[int]:
        return [c[0] for c in self._checkpoints]

    def metrics(self, step: int) -> dict | None:
        return dict(self._checkpoints)[step]

    def restore(self, template_state: TrainState, step: int | None = None) -> TrainState:
        """Step ``step`` (the latest by default) in the layout, dtypes and
        device of ``template_state`` (a freshly created state of the same
        model and optimizer); its generator gets the saved state."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        payload = load_npz(os.path.join(self._path(step), STATE_FILE))
        check_same_layout(template_state.params, payload["params"], "params")
        # Another optimizer's state (other flags) is refused here.
        check_same_layout(template_state.opt_state, payload.get("opt_state"), "opt_state")
        device = tree_leaves(template_state.params)[0].device
        rng = template_state.rng
        if rng is not None:
            rng = torch.Generator(device=rng.device)
            rng.set_state(payload["rng"])
        move = lambda t: t.to(device)  # noqa: E731
        return TrainState(
            step=int(payload["step"]),
            params=tree_map(move, payload["params"]),
            # In the template's containers: a chain's tuple is read back as a list.
            opt_state=tree_map(lambda _, t: move(t), template_state.opt_state, payload.get("opt_state")),
            rng=rng,
        )

    def average_params(self, template_state: TrainState, *, steps=None, last_k: int | None = None):
        """The uniform average of retained steps' params (``steps``, the
        newest ``last_k``, or all): float leaves summed in f32 one step at a
        time and cast back to their stored dtype, other leaves the newest
        step's."""
        have = self.all_steps()
        if not have:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if steps is None:
            steps = have[-last_k:] if last_k else have
        missing = sorted(set(steps) - set(have))
        if missing:
            raise ValueError(f"steps {missing} not among retained checkpoints {have}")
        steps = sorted(steps)
        n = float(len(steps))
        acc = last = None
        for s in steps:
            tree = self.restore(template_state, step=s).params
            if acc is None:
                acc = tree_map(lambda t: t.float() if t.is_floating_point() else t, tree)
            else:
                acc = tree_map(lambda a, t: a + t.float() if t.is_floating_point() else a, acc, tree)
            last = tree
        return tree_map(
            lambda a, t: (a / n).to(t.dtype) if t.is_floating_point() else t, acc, last
        )

    def save_sharded(self, *args, **kwargs):
        raise NotImplementedError("CheckpointManager.save_sharded is not ported")

    def restore_sharded(self, *args, **kwargs):
        raise NotImplementedError("CheckpointManager.restore_sharded is not ported")

    def close(self) -> None:
        """Nothing is pending: every save is complete when it returns."""
