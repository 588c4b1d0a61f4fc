"""Small shared utilities: dumpable conversion, signals, progress, text boxes.

Parity target: reference GaPFlow/utils.py:30-104.
"""

import signal
import sys

import numpy as np

_quiet = False


def set_quiet(flag):
    """Silence protocol banners (GP training blocks, MD run boxes).

    Set by :class:`~gapflow_torch.problem.Problem` from ``options: silent``
    so that a silent run writes nothing to stdout (reference GaPFlow
    prints these unconditionally; here they are part of the verbose
    protocol trace only)."""
    global _quiet
    _quiet = bool(flag)


def echo(*args, **kwargs):
    """``print`` gated on the ``options: silent`` flag."""
    if not _quiet:
        print(*args, **kwargs)


def progressbar(it, prefix="", size=40, out=sys.stdout):
    """Yield items of ``it`` while drawing a simple terminal progress bar."""
    count = len(it)

    def show(j):
        filled = int(size * j / max(count, 1))
        print(f"{prefix}|{'█' * filled}{'.' * (size - filled)}| {j}/{count}",
              end="\r", file=out, flush=True)

    show(0)
    for i, item in enumerate(it):
        yield item
        show(i + 1)
    print("\n", flush=True, file=out)


def bordered_text(text):
    """Wrap a multi-line string in a unicode box."""
    lines = text.splitlines()
    width = max(len(s) for s in lines)
    res = ["┌" + "─" * width + "┐"]
    for s in lines:
        res.append("│" + (s + " " * width)[:width] + "│")
    res.append("└" + "─" * width + "┘")
    return "\n".join(res)


def make_dumpable(obj):
    """Recursively convert numpy/torch containers into YAML/JSON-native types."""
    if isinstance(obj, dict):
        return {make_dumpable(k): make_dumpable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return type(obj)(make_dumpable(x) for x in obj)
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (bytes, bytearray)):
        return obj.decode("utf-8", errors="replace")
    if hasattr(obj, "tolist") and not isinstance(obj, str):
        try:
            out = obj.tolist()
        except Exception:
            return obj
        # 0-d arrays (incl. torch scalars) come back as python scalars
        return out
    return obj


def get_termination_signals():
    """Signals that should cleanly stop a running simulation."""
    signals = [signal.SIGINT]
    for name in ("SIGTERM", "SIGHUP", "SIGUSR1", "SIGBREAK"):
        if hasattr(signal, name):
            signals.append(getattr(signal, name))
    return signals


def handle_signals(func):
    """Install ``func`` as handler for all termination signals."""
    for s in get_termination_signals():
        try:
            signal.signal(s, func)
        except (ValueError, OSError):
            # not in main thread, or signal unsupported on this platform
            pass
