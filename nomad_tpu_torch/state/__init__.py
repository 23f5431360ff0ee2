from .store import PeriodicLaunch, StateSnapshot, StateStore
from . import watch

__all__ = ["PeriodicLaunch", "StateSnapshot", "StateStore", "watch"]
