"""The launch counts of every kernel module, taken together.

A CUDA graph's capture records launches without making them, and each
replay makes them again without calling a wrapper. The sampler's captured
batch step (``sampler._StepGraph``) therefore takes what the wrappers
counted while it captured (:func:`since`) off again (:func:`restore`) and
adds it at every replay (:func:`add`), so that a count still says how many
times a kernel ran.
"""

from __future__ import annotations

from . import exact_eval, noise_draw, sample_eval

MODULES = (sample_eval, exact_eval, noise_draw)


def snapshot() -> list:
    """Every module's counts and per-device counts, copied."""
    return [
        (dict(m.launch_counts), {d: dict(c) for d, c in m.device_launch_counts.items()}) for m in MODULES
    ]


def restore(snap: list) -> None:
    """Set every count back to ``snap``."""
    for m, (counts, per_device) in zip(MODULES, snap):
        m.launch_counts.update(counts)
        m.device_launch_counts.clear()
        m.device_launch_counts.update({d: dict(c) for d, c in per_device.items()})


def since(snap: list) -> list:
    """What every count rose by since ``snap``: [(name, device, launches)]."""
    rises = []
    for m, (_, per_device) in zip(MODULES, snap):
        for device, counts in m.device_launch_counts.items():
            before = per_device.get(device, {})
            rises += [(m, name, device, n - before.get(name, 0)) for name, n in counts.items()
                      if n > before.get(name, 0)]
    return rises


def add(rises: list) -> None:
    """Count the launches ``rises`` (from :func:`since`) once more."""
    for m, name, device, n in rises:
        m.launch_counts[name] += n
        per_device = m.device_launch_counts.setdefault(device, dict.fromkeys(m.launch_counts, 0))
        per_device[name] = per_device.get(name, 0) + n
