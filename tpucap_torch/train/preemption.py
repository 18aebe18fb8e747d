"""Graceful preemption: SIGTERM -> mid-epoch checkpoint -> clean exit (port
of ``tpucap.train.preemption``, standard library only).

``fit(handle_preemption=True)`` and ``fit_finetune(handle_preemption=True)``
install a :class:`PreemptionGuard`, check it after every step, and on the
first signal save a mid-epoch rescue checkpoint and return with a
``{"preempted": True}`` history entry. Rerunning with ``resume=True``
continues exactly where the run stopped: the epoch and batch are derived
from the checkpoint's step counter (``batch_iterator`` drops remainders, so
an epoch has a fixed number of steps), the host shuffle generator replays
the consumed per-epoch permutations, and the step generator (dropout,
augmentation) travels in the checkpoint, so the resumed trajectory is
bit-identical to an uninterrupted run.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Latching signal flag. Installed on ``__enter__`` (main thread only:
    Python takes signal handlers on the main thread alone; elsewhere the
    guard stays inert and ``fired`` is set only through :meth:`request`),
    restored on ``__exit__``. The handler only sets the flag: the training
    loop acts after the in-flight step, so the rescue checkpoint is a
    complete, ordinary checkpoint."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self._fired = threading.Event()

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def request(self) -> None:
        """Programmatic trigger (tests; cooperative shutdown)."""
        self._fired.set()

    def _handle(self, signum, frame):
        del frame
        self._fired.set()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        return None
