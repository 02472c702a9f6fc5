"""Event-keyed component dispatch.

A copy of ``tartangan_tpu/train/components/container.py``: components
receive the trainer and hooks fire in registration order; hooks are
collected once at registration into per-event call lists, so ``invoke`` is
a plain iteration over bound methods, and components that don't override a
hook cost nothing at dispatch time.
"""
from __future__ import annotations

from .base import TrainerComponent

EVENTS = ("train_begin", "train_end", "batch_begin", "batch_end",
          "epoch_begin", "epoch_end")


class ComponentContainer:
    """Holds the trainer's components and fans trainer events out to the
    hooks they actually override."""

    def __init__(self):
        self.components = []
        self._hooks = {event: [] for event in EVENTS}
        self.trainer = None

    def add_components(self, *components):
        for component in components:
            component.trainer = self.trainer
            self.components.append(component)
            for event in EVENTS:
                name = f"on_{event}"
                # register only real overrides; base no-ops are skipped
                if (getattr(type(component), name, None)
                        is not getattr(TrainerComponent, name)):
                    self._hooks[event].append(getattr(component, name))

    def invoke(self, event, *args, **kwargs):
        for hook in self._hooks[event]:
            hook(*args, **kwargs)
