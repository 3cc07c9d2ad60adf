"""SIGINT/SIGTERM interrupt handling with an external checkpoint callback.

Copy of fava_tpu/utils/interrupt.py: on interrupt the pipeline's
checkpoint callback is invoked so a resumable JSON checkpoint lands on
disk before the process dies; the original handlers are restored
afterwards.
"""

from __future__ import annotations

import signal
from typing import Callable, Optional


class InterruptHandler:
    signals_caught = [signal.SIGINT, signal.SIGTERM]

    def __init__(self, external_handler: Optional[Callable[[], None]] = None) -> None:
        self.external_handler = external_handler

    def __enter__(self) -> "InterruptHandler":
        self.interrupted = False
        self.released = False
        self.signal: Optional[signal.Signals] = None
        self.original_handlers = {sig: signal.getsignal(sig) for sig in self.signals_caught}

        def handler(signum, frame) -> None:
            name = signal.Signals(signum).name
            print(f"Caught {name}...", flush=True)
            self.signal = signum
            self.release()
            self.interrupted = True

        for sig in self.signals_caught:
            signal.signal(sig, handler)
        return self

    def __exit__(self, exc_type, exc_value, tb) -> None:
        self.release()

    def release(self) -> bool:
        if self.released:
            return False

        if self.external_handler is not None:
            print("Calling external handler", flush=True)
            self.external_handler()

        # Restore every original handler, on clean exit as well as on
        # interrupt: a second Ctrl-C then reaches the default handler
        # and kills.
        for sig, orig in self.original_handlers.items():
            signal.signal(sig, orig)

        self.released = True
        return True


# Alias under the reference's class name.
FAVAInterruptHandler = InterruptHandler
