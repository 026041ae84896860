"""Preemption-safe training shutdown (``psld_tpu/train/interrupt.py``).

SIGTERM and SIGINT (the signals a preempting scheduler delivers) set a
flag; the epoch loop notices it at the next step boundary, writes a
checkpoint marked incomplete, and returns, so the process exits with 0.
Relaunching the same command with ``training.auto_resume=true`` (or
``restore_path=latest``) replays the interrupted epoch from that
checkpoint.

Under a process group a signal reaches the ranks at different moments,
and a rank that left while the others wait in a collective would hang
the job. The loop therefore reads :meth:`GracefulShutdown.agreed` once a
step: the flag OR-ed over the ranks, so all of them checkpoint and exit
at the same step.
"""

from __future__ import annotations

import logging
import signal

from psld_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)


class GracefulShutdown:
    """Context manager that turns SIGTERM/SIGINT into a flag to poll.

    The first signal asks for a graceful stop; a second SIGINT raises
    KeyboardInterrupt, so an interactive user can still stop at once.
    Off the main thread (where Python takes no signal handler) it installs
    nothing and the flag stays down.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous = {}
        self.requested = False
        self._agreed = False

    def _handle(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            raise KeyboardInterrupt
        logger.warning(
            "received %s: finishing the current step and checkpointing",
            signal.Signals(signum).name)
        self.requested = True

    def agreed(self) -> bool:
        """True on every rank once the flag is up on any. Every rank must
        call it at the same points (the loop: once a step); after it
        first returns True it asks no rank again."""
        self._agreed = self._agreed or distributed.any_rank(self.requested)
        return self._agreed

    def install(self) -> "GracefulShutdown":
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except ValueError:  # not on the main thread
                pass
        return self

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous = {}

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
